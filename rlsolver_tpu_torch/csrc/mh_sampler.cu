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
// block therefore keeps its 128 chains in shared memory for all rounds
// (32 KB at N = 2000) and reads and writes device memory once. What is left
// per proposal is a few integer operations, one shared-memory word read and
// write, and one threshold read from a [2, N] table that stays in L1; K3
// adds a quarter of a Philox4x32-10 call (one call yields four draws), which
// makes it bound by integer multiplies. K2 also reads 4 bytes of stream per
// proposal, coalesced across the chains of a warp.
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
// K11 and K12 (the port's first forms read their streams from device memory
// every round) paid a device memory round trip a round: K11 0.737 ms and
// K12 0.263 ms for 1024 rounds, about 1,400 cycles a round for K11, whatever
// the tile (scripts/torch_mh_tile.py). The TPU kernels staged
// (rounds_chunk, block_chains) blocks of the stream in VMEM; here their
// Hopper form, one ring kernel for both: a block of kOnehotTile chains (one
// thread each) and one producer thread, which keeps kOnehotStages stages of
// kOnehotChunk rounds in flight in a ring in shared memory, one bulk copy
// per round row of the tile for the nodes and one for the other 4-byte
// stream (K11's u, K12's acc2), completing on the stage's mbarrier. The
// consumers' round loop then reads only shared memory and, for K11,
// probs[node] (8 KB at N = 2000, in L1); what is left a round is the
// chain's own dependence, its state word read, tested and written back. On
// an H100 K11 runs 8192 chains x 1024 rounds in 0.11-0.14 ms, about 220-270
// cycles a round; tiles of 32 to 128 chains came within 14% of each other,
// and the copies issued from all 32 lanes of the producer's warp were no
// faster (PERF.md).
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

__global__ void mh_stream_kernel(const uint32_t* __restrict__ stream, uint32_t* __restrict__ words,
                                 int B, int W, int R) {
  extern __shared__ uint32_t sm[];
  const long long b0 = (long long)blockIdx.x * blockDim.x;
  const int nb = min((long long)blockDim.x, B - b0);
  rl::load_chains(sm, words, b0, nb, W);
  if (threadIdx.x < nb) {
    uint32_t* my = sm + threadIdx.x * rl::smem_stride(W);
    const long long chain = b0 + threadIdx.x;
    for (int r = 0; r < R; ++r) {
      // word << 7 | bitpos << 2 | acc2, acc2 bit c = accept given bit == c
      const uint32_t s = __ldg(stream + (long long)r * B + chain);
      const uint32_t word = s >> 7, bit = (s >> 2) & 31u;
      if (word >= (uint32_t)W) continue;  // not a valid proposal: no-op
      flip_by_acc2(my, word, bit, s);
    }
  }
  rl::store_chains(sm, words, b0, nb, W);
}

// K11's and K12's tile and ring (scripts/torch_mh_tile.py).
constexpr int kOnehotTile = 64;    // chains a block, a multiple of 32
constexpr int kOnehotChunk = 32;   // rounds a ring stage holds
constexpr int kOnehotStages = 4;   // stages in flight, at most
constexpr int kRingOffset = 128;   // bytes of the barriers before the ring

struct RingArgs {
  const int32_t* nodes;  // [R, Bp] proposals, 16-byte aligned, Bp % 4 == 0
  const uint32_t* vals;  // [R, Bp] K11's u (f32 bits) or K12's acc2, likewise
  uint32_t* words;       // [B, W] chains, updated in place
  int B, Bp, W, N, R;
  int S;                 // ring stages; 0: no ring, the stream is read from device memory
};

// K11's step: probs [N] f32; accept when u q < 1 - q, q = P(current value),
// rounded as in f32.
struct OnehotStep {
  const float* probs;
  __device__ __forceinline__ void operator()(uint32_t* my, uint32_t node, uint32_t u) const {
    const uint32_t word = node >> 5, bit = node & 31u;
    const float p = __ldg(probs + node);
    const uint32_t x = my[word];
    const float q = (x >> bit) & 1u ? p : __fsub_rn(1.0f, p);
    my[word] = x ^ (static_cast<uint32_t>(__fmul_rn(__uint_as_float(u), q) < __fsub_rn(1.0f, q)) << bit);
  }
};

// K12's step: acc2 bit c = accept given the current bit c.
struct PackedStep {
  __device__ __forceinline__ void operator()(uint32_t* my, uint32_t node, uint32_t acc2) const {
    flip_by_acc2(my, node >> 5, node & 31u, acc2);
  }
};

// K11 and K12: the stream's (node, val) pairs [R, B] through the ring, each
// applied by `step`. A node outside [0, N) is a no-op, as in the TPU
// kernels. Threads 0..T-1 run the block's chains; thread T issues the
// copies. Stage g holds rounds [g C, g C + C) of the tile's columns in ring
// slot g % S: slot s's `full` barrier completes a phase when its copies have
// landed, its `empty` barrier when all T consumers have read it. The ring is
// read-only for the consumers, so a padded or partial tile's extra columns
// are never read by a live chain. Where not even one stage fits beside the
// chains (S = 0), the consumers read their stream from device memory.
template <class Step>
__global__ void mh_ring_kernel(const RingArgs a, const Step step) {
  constexpr int C = kOnehotChunk;
  const int S = a.S;
  extern __shared__ __align__(128) unsigned char smem[];
  const int T = blockDim.x - 32;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kOnehotStages;
  int32_t* ring_nodes = reinterpret_cast<int32_t*>(smem + kRingOffset);  // [S, C, T]
  uint32_t* ring_vals = reinterpret_cast<uint32_t*>(ring_nodes + S * C * T);  // [S, C, T]
  uint32_t* sm = ring_vals + S * C * T;
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
    rl::mbar_expect(full + s, 2u * rows * row_bytes);
    for (int r = 0; r < rows; ++r) {
      const long long src = (long long)(g * C + r) * a.Bp + b0;
      rl::bulk_copy(ring_nodes + (s * C + r) * T, a.nodes + src, row_bytes, full + s);
      rl::bulk_copy(ring_vals + (s * C + r) * T, a.vals + src, row_bytes, full + s);
    }
  };
  if (producer)
    for (int g = 0; g < min(G, S); ++g) issue(g);  // while the chains load
  rl::load_chains(sm, a.words, b0, nb, a.W);
  if (producer) {
    for (int g = S; g < G; ++g) {
      rl::mbar_wait(empty + g % S, (g / S - 1) & 1);
      issue(g);
    }
  } else if (threadIdx.x < T) {
    const int t = threadIdx.x;
    const bool live = t < nb;
    uint32_t* my = sm + (live ? t : 0) * rl::smem_stride(a.W);
    auto run = [&](uint32_t node, uint32_t v) {
      if (node < (uint32_t)a.N) step(my, node, v);
    };
    if (S == 0 && live)
      for (int r = 0; r < a.R; ++r) {
        const long long at = (long long)r * a.Bp + b0 + t;
        run(static_cast<uint32_t>(__ldg(a.nodes + at)), __ldg(a.vals + at));
      }
    for (int g = 0; g < G; ++g) {
      const int s = g % S, rows = min(C, a.R - g * C);
      rl::mbar_wait(full + s, (g / S) & 1);
      const int32_t* rn = ring_nodes + s * C * T + t;
      const uint32_t* rv = ring_vals + s * C * T + t;
      if (live) {
#pragma unroll 4
        for (int r = 0; r < rows; ++r) run(static_cast<uint32_t>(rn[r * T]), rv[r * T]);
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
  rl::load_chains(sm, words, b0, nb, W);
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

}  // namespace

extern "C" int mh_stream(const int32_t* stream, int32_t* words, int B, int W, int R,
                         cudaStream_t st) {
  int threads;
  size_t smem;
  cudaError_t e = rl::prepare(mh_stream_kernel, W, &threads, &smem);
  if (e != cudaSuccess) return e;
  if (B > 0)
    mh_stream_kernel<<<(B + threads - 1) / threads, threads, smem, st>>>(
        reinterpret_cast<const uint32_t*>(stream), reinterpret_cast<uint32_t*>(words), B, W, R);
  return cudaGetLastError();
}

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

// nodes, vals: [R, Bp] with Bp >= B a multiple of 4, 16-byte aligned (the
// wrapper pads). While the ring and the tile's chains do not fit a block's
// shared memory, the tile halves from kOnehotTile down to one warp, then the
// ring's stages halve down to none; so K11 and K12 take every W that a
// 32-chain tile of words alone fits.
template <class Step>
int launch_ring(const int32_t* nodes, const void* vals, int32_t* words, int B, int Bp, int W, int N, int R,
                const Step step, cudaStream_t st) {
  if (Bp < B || Bp % 4 || reinterpret_cast<uintptr_t>(nodes) % 16 || reinterpret_cast<uintptr_t>(vals) % 16)
    return cudaErrorInvalidValue;
  int tile = kOnehotTile, stages = kOnehotStages;
  auto smem_of = [&](int t, int s) {
    return (size_t)kRingOffset + 2 * (size_t)s * kOnehotChunk * t * 4 +
           (size_t)t * rl::smem_stride(W) * sizeof(uint32_t);
  };
  while (tile > 32 && smem_of(tile, stages) > rl::kMaxSmem) tile /= 2;
  while (stages > 0 && smem_of(tile, stages) > rl::kMaxSmem) stages /= 2;
  const size_t smem = smem_of(tile, stages);
  if (smem > rl::kMaxSmem) return cudaErrorInvalidValue;
  const cudaError_t e = rl::allow_smem(mh_ring_kernel<Step>, smem);
  if (e != cudaSuccess) return e;
  const RingArgs a{nodes, static_cast<const uint32_t*>(vals), reinterpret_cast<uint32_t*>(words), B, Bp, W, N, R,
                   stages};
  if (B > 0) mh_ring_kernel<Step><<<(B + tile - 1) / tile, tile + 32, smem, st>>>(a, step);
  return cudaGetLastError();
}

extern "C" int mh_onehot(const int32_t* nodes, const float* u, const float* probs, int32_t* words, int B, int Bp,
                         int W, int N, int R, cudaStream_t st) {
  return launch_ring(nodes, u, words, B, Bp, W, N, R, OnehotStep{probs}, st);
}

extern "C" int mh_packed(const int32_t* nodes, const int32_t* acc2, int32_t* words, int B, int Bp, int W, int N,
                         int R, cudaStream_t st) {
  return launch_ring(nodes, acc2, words, B, Bp, W, N, R, PackedStep{}, st);
}
