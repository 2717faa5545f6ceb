// Metropolis-Hastings single-flip sampler on bit-packed chains.
//
// Replaces rlsolver_tpu/ops/pallas/mh_sampler.py:_mh_stream_kernel (K2,
// randomness streamed in) and :_mh_fused_kernel (K3, randomness drawn in
// the kernel), and the two kernels that take the randomness as (node,
// uniform) pairs [R, B]: :_mh_kernel (K11, f32 one-hot state, the accept
// test u * q < 1 - q made in the kernel) and :_mh_packed_kernel (K12,
// packed state, both conditional accepts made outside as a 2-bit acc2).
// Per round each chain proposes flipping one node and accepts with
// probability min(1, (1-q)/q), q = P(current value of the node), so the
// chain targets the Bernoulli(probs) product measure.
//
// What bounds it on an H100: the state of 10^6 chains x 2000 nodes is 264 MB
// of words and each round touches one word per chain, so streaming the state
// from device memory every round would cost 400 x 264 MB per call. Each
// block therefore keeps its chains in shared memory for all rounds (32 KB
// for 128 chains at N = 2000) and reads and writes device memory once. What
// is left per proposal is a few integer operations, one shared-memory word
// read and write, and one threshold read from a [2, N] table that stays in
// L1; K3 adds a quarter of a Philox4x32-10 call (one call yields four
// draws), which makes it bound by integer multiplies. K2, K11 and K12 also
// read their streams, 4 or 8 bytes a proposal, which bound them by bytes.
//
// The TPU kernel looked the thresholds up with a one-hot MXU product because
// Mosaic cannot index lanes dynamically, and it needed a second draw per
// round for N >= 2^15 because Mosaic has no 64-bit or high-half multiply.
// Here the table is indexed directly, and for N >= 2^15 the node comes from
// __umulhi of a full 32-bit draw (see mh_fused). K11 kept a block's chains
// as f32 {0, 1} in VMEM and found the proposed node by a one-hot pass over
// all N lanes; here its chains are bits in shared memory, as K12's, and the
// node is indexed directly.
//
// The streams (K2, K11, K12). The port's first forms read them from device
// memory every round, one 4-byte load a thread that the round's update
// waits on: K11 0.737 ms and K12 0.263 ms for 1024 rounds, about 1,400
// cycles a round; K2 1.322 ms at 2^20 chains x 400 rounds, half its byte
// bound, with too few bytes in flight to cover device memory's latency
// (scripts/torch_mh_tile.py). The TPU kernels staged (rounds_chunk,
// block_chains) blocks of the stream in VMEM; here their Hopper form, one
// ring kernel for all three: a block of a tile of chains (one thread each)
// and one producer thread, which keeps a few stages of rounds in flight in
// a ring in shared memory, one bulk copy per round row of the tile and
// stream (K2's one stream, K11's nodes and u, K12's nodes and acc2),
// completing on the stage's mbarrier. The consumers' round loop then reads
// only shared memory and, for K11, probs[node] (8 KB at N = 2000, in L1);
// what is left a round is the chain's own dependence, its state word read,
// tested and written back. Each kernel has its ring's shape: K11 and K12 at
// 8192 chains a deep ring of long stages (tiles of 32 to 128 chains came
// within 14% of each other), K2 at 2^20 chains a ring of short stages, so
// that more blocks share an SM, whose consumers read a stage's 8 rounds
// before applying them; and each block loads its chains with 8 loads in
// flight a thread. K2 then runs 2^20 x 400 rounds in about 0.89 ms (PERF.md).
//
// K3 has two forms, chosen by shape in ops/kernels/mh_sampler.py
// (`fused_form`). The chain form runs one thread a chain and is near its
// INT32 bound at 2^20 chains; at 8192 chains it fills half the SMs with one
// block each, and at 128 chains one block, so that each chain's serial
// rounds go uncovered, and wide chains leave few of its blocks an SM. The
// split form runs kLanes lanes of a warp a chain. Proposals on different
// bits commute (a proposal's accept test reads only its own bit and the
// threshold table), so lane l owns the chain's words w with w % kLanes == l
// and applies, in round order, the proposals that land in them: the result
// is the sequential chain's, bit for bit (mh_fused_split_kernel).
#include "common.cuh"

namespace {

// One proposal given both conditional accepts: bit c of acc2 = accept given
// the current bit == c (K2 and K12).
__device__ __forceinline__ void flip_by_acc2(uint32_t* my, uint32_t word, uint32_t bit, uint32_t acc2) {
  const uint32_t cur = (my[word] >> bit) & 1u;
  my[word] ^= ((acc2 >> cur) & 1u) << bit;
}

__device__ __forceinline__ void propose(uint32_t* my, uint32_t node, uint32_t u16,
                                        const float* __restrict__ thr, int N) {
  const uint32_t word = node >> 5, bit = node & 31u;
  const uint32_t cur = (my[word] >> bit) & 1u;
  // thr[cur * N + node]: u16-scaled accept threshold given the current bit
  const bool acc = static_cast<float>(u16) < __ldg(thr + cur * N + node);
  my[word] ^= static_cast<uint32_t>(acc) << bit;
}

// The rings' shapes (scripts/torch_mh_tile.py): chains a block (a multiple
// of 32), rounds a stage, stages in flight at most, and rounds a consumer
// reads from the ring before it applies them (the state write could alias a
// later ring read, so the compiler does not move those reads ahead of it).
// Batches of 8 rounds took K2 2-10% faster and K11 and K12 29-38% slower.
constexpr int kOnehotTile = 64;    // K11 and K12
constexpr int kOnehotChunk = 32;
constexpr int kOnehotStages = 4;
constexpr int kOnehotBatch = 1;
constexpr int kStreamTile = 64;    // K2
constexpr int kStreamChunk = 8;
constexpr int kStreamStages = 4;
constexpr int kStreamBatch = 8;
constexpr int kRingOffset = 128;   // bytes of the barriers before the ring
// loads a thread keeps in flight while a block loads its chains (K2, K3, K11, K12)
constexpr int kChainLoads = 8;

struct RingArgs {
  const uint32_t* first;   // [R, Bp] K2's packed proposals, K11's and K12's nodes; 16-byte aligned, Bp % 4 == 0
  const uint32_t* second;  // [R, Bp] K11's u (f32 bits) or K12's acc2, likewise; K2 has none
  uint32_t* words;         // [B, W] chains, updated in place
  int B, Bp, W, R;
  int S;                   // ring stages; 0: no ring, the streams are read from device memory
};

// A step applies one round's proposal from the round's `kStreams` stream
// values (the second is 0 where there is one stream), and is a no-op where
// the proposal is not valid.

// K2's step: s = word << 7 | bit << 2 | acc2, acc2 bit c = accept given the
// current bit c; a word outside [0, W) is a no-op.
struct StreamStep {
  static constexpr int kStreams = 1, kTile = kStreamTile, kChunk = kStreamChunk, kStages = kStreamStages,
                       kBatch = kStreamBatch;
  uint32_t W;
  __device__ __forceinline__ void operator()(uint32_t* my, uint32_t s, uint32_t) const {
    const uint32_t word = s >> 7;
    if (word < W) flip_by_acc2(my, word, (s >> 2) & 31u, s);
  }
};

// K11's step: probs [N] f32; accept when u q < 1 - q, q = P(current value),
// rounded as in f32. A node outside [0, N) is a no-op, as in the TPU kernel.
struct OnehotStep {
  static constexpr int kStreams = 2, kTile = kOnehotTile, kChunk = kOnehotChunk, kStages = kOnehotStages,
                       kBatch = kOnehotBatch;
  const float* probs;
  uint32_t N;
  __device__ __forceinline__ void operator()(uint32_t* my, uint32_t node, uint32_t u) const {
    if (node >= N) return;
    const uint32_t word = node >> 5, bit = node & 31u;
    const float p = __ldg(probs + node);
    const uint32_t x = my[word];
    const float q = (x >> bit) & 1u ? p : __fsub_rn(1.0f, p);
    my[word] = x ^ (static_cast<uint32_t>(__fmul_rn(__uint_as_float(u), q) < __fsub_rn(1.0f, q)) << bit);
  }
};

// K12's step: acc2 bit c = accept given the current bit c; a node outside
// [0, N) is a no-op.
struct PackedStep {
  static constexpr int kStreams = 2, kTile = kOnehotTile, kChunk = kOnehotChunk, kStages = kOnehotStages,
                       kBatch = kOnehotBatch;
  uint32_t N;
  __device__ __forceinline__ void operator()(uint32_t* my, uint32_t node, uint32_t acc2) const {
    if (node < N) flip_by_acc2(my, node >> 5, node & 31u, acc2);
  }
};

// K2, K11 and K12: the streams [R, B] through the ring, each round applied
// by `step`. Threads 0..T-1 run the block's chains; thread T issues the
// copies. Stage g holds rounds [g C, g C + C) of the tile's columns of each
// stream in ring slot g % S: slot s's `full` barrier completes a phase when
// its copies have landed, its `empty` barrier when all T consumers have
// read it. The ring is read-only for the consumers, so a padded or partial
// tile's extra columns are never read by a live chain. Where not even one
// stage fits beside the chains (S = 0), the consumers read their streams
// from device memory.
template <class Step>
__global__ void mh_ring_kernel(const RingArgs a, const Step step) {
  constexpr int C = Step::kChunk, kStreams = Step::kStreams, kBatch = Step::kBatch;
  static_assert(2 * Step::kStages * sizeof(uint64_t) <= kRingOffset, "the barriers overlap the ring");
  const int S = a.S;
  extern __shared__ __align__(128) unsigned char smem[];
  const int T = blockDim.x - 32;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + Step::kStages;
  uint32_t* ring = reinterpret_cast<uint32_t*>(smem + kRingOffset);  // [kStreams][S, C, T]
  uint32_t* sm = ring + kStreams * S * C * T;
  const long long b0 = (long long)blockIdx.x * T;
  const int nb = min((long long)T, a.B - b0);
  const uint32_t row_bytes = 4u * min((long long)T, a.Bp - b0);  // a multiple of 16
  const int G = S ? (a.R + C - 1) / C : 0;
  const bool producer = threadIdx.x == T;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      rl::mbar_init(full + s, 1);
      rl::mbar_init(empty + s, T);
    }
  }
  __syncthreads();
  auto issue = [&](int g) {
    const int s = g % S, rows = min(C, a.R - g * C);
    rl::mbar_expect(full + s, kStreams * rows * row_bytes);
    for (int r = 0; r < rows; ++r) {
      const long long src = (long long)(g * C + r) * a.Bp + b0;
      rl::bulk_copy(ring + (s * C + r) * T, a.first + src, row_bytes, full + s);
      if (kStreams == 2) rl::bulk_copy(ring + ((S + s) * C + r) * T, a.second + src, row_bytes, full + s);
    }
  };
  if (producer)
    for (int g = 0; g < min(G, S); ++g) issue(g);  // while the chains load
  rl::load_chains<kChainLoads>(sm, a.words, b0, nb, a.W);
  if (producer) {
    for (int g = S; g < G; ++g) {
      rl::mbar_wait(empty + g % S, (g / S - 1) & 1);
      issue(g);
    }
  } else if (threadIdx.x < T) {
    const int t = threadIdx.x;
    const bool live = t < nb;
    uint32_t* my = sm + (live ? t : 0) * rl::smem_stride(a.W);
    if (S == 0 && live)
      for (int r = 0; r < a.R; ++r) {
        const long long at = (long long)r * a.Bp + b0 + t;
        step(my, __ldg(a.first + at), kStreams == 2 ? __ldg(a.second + at) : 0u);
      }
    for (int g = 0; g < G; ++g) {
      const int s = g % S, rows = min(C, a.R - g * C);
      rl::mbar_wait(full + s, (g / S) & 1);
      const uint32_t* r1 = ring + s * C * T + t;
      const uint32_t* r2 = ring + (S + s) * C * T + t;
      if (live) {
#pragma unroll 4
        for (int r = 0; r < rows; r += kBatch) {
          uint32_t v1[kBatch], v2[kBatch];  // the batch's stream values, read before any is applied
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            v1[u] = r + u < rows ? r1[(r + u) * T] : 0u;
            v2[u] = kStreams == 2 && r + u < rows ? r2[(r + u) * T] : 0u;
          }
#pragma unroll
          for (int u = 0; u < kBatch; ++u)
            if (r + u < rows) step(my, v1[u], v2[u]);
        }
      }
      rl::mbar_arrive(empty + s);
    }
  }
  rl::store_chains(sm, a.words, b0, nb, a.W);
}

template <bool kWide>
__global__ void mh_fused_kernel(const float* __restrict__ thr, uint32_t* __restrict__ words,
                                int B, int W, int N, int R, uint32_t seed) {
  extern __shared__ uint32_t sm[];
  const long long b0 = (long long)blockIdx.x * blockDim.x;
  const int nb = min((long long)blockDim.x, B - b0);
  rl::load_chains<kChainLoads>(sm, words, b0, nb, W);
  if (threadIdx.x < nb) {
    uint32_t* my = sm + threadIdx.x * rl::smem_stride(W);
    const uint32_t chain = static_cast<uint32_t>(b0 + threadIdx.x);
    // narrow: one draw per round, draws t = r. wide: two draws per round,
    // t = 2r (node) and 2r + 1 (u16). Either way 4 draws per Philox call.
    const int per_call = kWide ? 2 : 4;
    for (int r0 = 0; r0 < R; r0 += per_call) {
      const int t0 = kWide ? 2 * r0 : r0;
      const uint4 d = rl::philox4x32_10(make_uint4(t0 >> 2, chain, 0u, 0u), seed, rl::kTagMH);
#pragma unroll
      for (int q = 0; q < per_call; ++q) {
        if (r0 + q >= R) break;
        uint32_t node, u16;
        if (kWide) {
          node = __umulhi(rl::pick(d, 2 * q), (uint32_t)N);
          u16 = rl::pick(d, 2 * q + 1) & 0xFFFFu;
        } else {
          const uint32_t x = rl::pick(d, q);
          node = ((x >> 16) * (uint32_t)N) >> 16;  // < 2^31 for N < 2^15
          u16 = x & 0xFFFFu;
        }
        propose(my, node, u16, thr, N);
      }
    }
  }
  rl::store_chains(sm, words, b0, nb, W);
}

// K3's split form (scripts/torch_mh_tile.py --k3).
constexpr int kSplitChunk = 256;    // rounds whose draws a chain stages at a time, a multiple of 32
constexpr int kSplitThreads = 128;  // threads a block, at most

// kLanes lanes a chain, the lanes of a chain in one warp. A chain's serial
// cost in the chain form is a round's dependent latency (its state word
// read, a threshold read that waits on it, the write back: 0.10-0.21 us on
// an H100, one chain's launches) times R; here each lane pays a shorter
// one, and only for the rounds it owns (0.006-0.06 us a round of the
// chain). Per chunk of kSplitChunk rounds, lane l makes the chunk's Philox
// calls i = l, l + kLanes, ... (the chain form's counters, 4 rounds a call,
// 2 where wide), reads both thresholds of each proposal and
// writes it to the chain's draw row as K2's proposals are packed, node << 2
// | acc2 (acc2 bit c: accept given the current bit c), and sets its bit in
// the owning lane's mask of rounds. After the chain's lanes meet, each lane
// applies its own rounds in round order, so that a round costs a mask step,
// the draw's read and the state word's read and write; they meet again
// before the next chunk. Warps hold 32 / kLanes chains.
template <bool kWide, int kLanes>
__global__ void mh_fused_split_kernel(const float* __restrict__ thr, uint32_t* __restrict__ words,
                                      int B, int W, int N, int R, uint32_t seed) {
  constexpr int K = kSplitChunk, KW = K / 32, per_call = kWide ? 2 : 4;
  constexpr int kRow = K + kLanes * KW;  // a chain's draws [K], then its lanes' masks [kLanes, KW]
  extern __shared__ uint32_t sm[];
  const int per_block = blockDim.x / kLanes;
  const long long b0 = (long long)blockIdx.x * per_block;
  const int nb = min((long long)per_block, B - b0);
  uint32_t* chains = sm + per_block * kRow;
  rl::load_chains<kChainLoads>(chains, words, b0, nb, W);
  const int c = threadIdx.x / kLanes;
  const uint32_t lane = threadIdx.x % kLanes;
  if (c < nb) {
    uint32_t* my = chains + c * rl::smem_stride(W);
    uint32_t* draws = sm + c * kRow;
    uint32_t* masks = draws + K;  // masks[l * KW + m] bit b: lane l owns round 32 m + b of the chunk
    uint32_t* mine = masks + lane * KW;
    const unsigned sync = (0xFFFFFFFFu >> (32 - kLanes)) << (threadIdx.x & 31u & ~(kLanes - 1u));  // the chain's lanes
    const uint32_t chain = static_cast<uint32_t>(b0 + c);
    for (int m = 0; m < KW; ++m) mine[m] = 0;
    __syncwarp(sync);
    for (int r0 = 0; r0 < R; r0 += K) {
      const int rows = min(K, R - r0);
      for (int i = lane; i * per_call < rows; i += kLanes) {
        const int t0 = kWide ? 2 * (r0 + i * per_call) : r0 + i * per_call;
        const uint4 d = rl::philox4x32_10(make_uint4(t0 >> 2, chain, 0u, 0u), seed, rl::kTagMH);
#pragma unroll
        for (int q = 0; q < per_call; ++q) {
          const int j = i * per_call + q;
          if (j >= rows) break;
          uint32_t node, u16;
          if (kWide) {
            node = __umulhi(rl::pick(d, 2 * q), (uint32_t)N);
            u16 = rl::pick(d, 2 * q + 1) & 0xFFFFu;
          } else {
            const uint32_t x = rl::pick(d, q);
            node = ((x >> 16) * (uint32_t)N) >> 16;
            u16 = x & 0xFFFFu;
          }
          const float u = static_cast<float>(u16);
          const uint32_t acc2 = static_cast<uint32_t>(u < __ldg(thr + node)) |
                                static_cast<uint32_t>(u < __ldg(thr + N + node)) << 1;
          draws[j] = node << 2 | acc2;
          atomicOr(masks + ((node >> 5) & (kLanes - 1u)) * KW + (j >> 5), 1u << (j & 31));
        }
      }
      __syncwarp(sync);
      int m = 0;
      uint32_t bits = mine[0];
      while (true) {
        while (bits == 0 && ++m < KW) bits = mine[m];
        if (bits == 0) break;
        const uint32_t s = draws[m * 32 + __ffs(bits) - 1];
        bits &= bits - 1;
        flip_by_acc2(my, s >> 7, (s >> 2) & 31u, s);
      }
      for (m = 0; m < KW; ++m) mine[m] = 0;
      __syncwarp(sync);
    }
  }
  rl::store_chains(chains, words, b0, nb, W);
}

using FusedKernel = void (*)(const float*, uint32_t*, int, int, int, int, uint32_t);

template <int kLanes>
FusedKernel split_kernel(bool wide) {
  return wide ? mh_fused_split_kernel<true, kLanes> : mh_fused_split_kernel<false, kLanes>;
}

}  // namespace

extern "C" int mh_fused(const float* thr, int32_t* words, int B, int W, int N, int R,
                        uint32_t seed, cudaStream_t st) {
  const bool wide = N >= (1 << 15);
  auto kernel = wide ? mh_fused_kernel<true> : mh_fused_kernel<false>;
  int threads;
  size_t smem;
  cudaError_t e = rl::prepare(kernel, W, &threads, &smem);
  if (e != cudaSuccess) return e;
  if (B > 0)
    kernel<<<(B + threads - 1) / threads, threads, smem, st>>>(
        thr, reinterpret_cast<uint32_t*>(words), B, W, N, R, seed);
  return cudaGetLastError();
}

// K3's split form with `lanes` (8, 16 or 32) lanes a chain. A block holds
// kSplitThreads / lanes chains, halved down to one warp's while their words,
// draws and masks do not fit its shared memory or the blocks are fewer than
// the SMs.
extern "C" int mh_fused_split(const float* thr, int32_t* words, int B, int W, int N, int R,
                              uint32_t seed, int lanes, cudaStream_t st) {
  const bool wide = N >= (1 << 15);
  const FusedKernel kernel = lanes == 8 ? split_kernel<8>(wide)
                             : lanes == 16 ? split_kernel<16>(wide)
                             : lanes == 32 ? split_kernel<32>(wide)
                                           : nullptr;
  if (kernel == nullptr) return cudaErrorInvalidValue;
  int device, sms;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return e;
  const size_t per_chain =
      ((size_t)kSplitChunk + lanes * (kSplitChunk / 32) + rl::smem_stride(W)) * sizeof(uint32_t);
  int threads = kSplitThreads;
  while (threads > 32 && (threads / lanes * per_chain > rl::kMaxSmem ||
                          (B + threads / lanes - 1) / (threads / lanes) < sms))
    threads /= 2;
  const size_t smem = threads / lanes * per_chain;
  if (smem > rl::kMaxSmem) return cudaErrorInvalidValue;
  e = rl::allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  const int per_block = threads / lanes;
  if (B > 0)
    kernel<<<(B + per_block - 1) / per_block, threads, smem, st>>>(
        thr, reinterpret_cast<uint32_t*>(words), B, W, N, R, seed);
  return cudaGetLastError();
}

// The streams: [R, Bp] with Bp >= B a multiple of 4, 16-byte aligned (the
// wrapper pads). While the ring and the tile's chains do not fit a block's
// shared memory, the tile halves from the step's down to one warp, then the
// ring's stages halve down to none; so K2, K11 and K12 take every W that a
// 32-chain tile of words alone fits.
template <class Step>
int launch_ring(const void* first, const void* second, int32_t* words, int B, int Bp, int W, int R,
                const Step step, cudaStream_t st) {
  if (Bp < B || Bp % 4 || reinterpret_cast<uintptr_t>(first) % 16 || reinterpret_cast<uintptr_t>(second) % 16)
    return cudaErrorInvalidValue;
  int tile = Step::kTile, stages = Step::kStages;
  auto smem_of = [&](int t, int s) {
    return (size_t)kRingOffset + Step::kStreams * (size_t)s * Step::kChunk * t * 4 +
           (size_t)t * rl::smem_stride(W) * sizeof(uint32_t);
  };
  while (tile > 32 && smem_of(tile, stages) > rl::kMaxSmem) tile /= 2;
  while (stages > 0 && smem_of(tile, stages) > rl::kMaxSmem) stages /= 2;
  const size_t smem = smem_of(tile, stages);
  if (smem > rl::kMaxSmem) return cudaErrorInvalidValue;
  const cudaError_t e = rl::allow_smem(mh_ring_kernel<Step>, smem);
  if (e != cudaSuccess) return e;
  const RingArgs a{static_cast<const uint32_t*>(first), static_cast<const uint32_t*>(second),
                   reinterpret_cast<uint32_t*>(words), B, Bp, W, R, stages};
  if (B > 0) mh_ring_kernel<Step><<<(B + tile - 1) / tile, tile + 32, smem, st>>>(a, step);
  return cudaGetLastError();
}

extern "C" int mh_stream(const int32_t* stream, int32_t* words, int B, int Bp, int W, int R, cudaStream_t st) {
  return launch_ring(stream, nullptr, words, B, Bp, W, R, StreamStep{(uint32_t)W}, st);
}

extern "C" int mh_onehot(const int32_t* nodes, const float* u, const float* probs, int32_t* words, int B, int Bp,
                         int W, int N, int R, cudaStream_t st) {
  return launch_ring(nodes, u, words, B, Bp, W, R, OnehotStep{probs, (uint32_t)N}, st);
}

extern "C" int mh_packed(const int32_t* nodes, const int32_t* acc2, int32_t* words, int B, int Bp, int W, int N,
                         int R, cudaStream_t st) {
  return launch_ring(nodes, acc2, words, B, Bp, W, R, PackedStep{(uint32_t)N}, st);
}
