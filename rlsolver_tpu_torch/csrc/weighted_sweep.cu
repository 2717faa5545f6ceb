// Integer-weight sweeps: MCPG's noisy degree-ordered sweep on each step's
// neighbour list, and the greedy 1-flip sweep on each row's non-zero
// bit-plane words or on neighbour lists in a level schedule.
//
// Replaces rlsolver_tpu/ops/pallas/weighted_sweep.py:
//   _wsweep_kernel (K6)                 -> wsweep_kernel
//   _wsweep_chunked_kernel (K7)         -> wsweep_chunked_kernel
//   _wsweep_1flip_kernel (K8a)          -> wsweep_1flip_kernel
//   _wsweep_1flip_chunked_kernel (K8b)  -> wsweep_1flip_levels_kernel
//
// The sweep (K6, K7). Step k of sweep s sets node nodes[k] (descending
// degree) of each chain to (nbr + u16 * scale < thr[k]), with
//   nbr = sum over the step's list of c * x_j,
// one list entry {j, (w << 1) | earlier} per neighbour j of weight w:
// c = w in later sweeps, and in the first sweep c = w if j precedes step k
// and 2w if not (the mixed domain: processed neighbours count with their
// bit, unprocessed ones with 2x - 0.5). That is the integer the TPU kernel
// popcounts from its bit-planes, sum_b 2^b (2 pc(x & m_b) - pc(x & e & m_b))
// over signed planes m_b and the `earlier` row e, so the bits are the same.
// As in K4 the compare uses __fadd_rn/__fmul_rn (the library builds with
// -fmad=false), so it rounds like the f32 multiply-then-add of the plain
// version and of JAX, and the noise is K4's: injected [S*N, B], or draw
// t = s*N + k of each chain from Philox under (seed, kTagSweep). On a
// {0, +-1} graph these sweeps give K4's bits.
//
// What bounds them on an H100. The data needs one bit extract and one
// multiply-add per neighbour met (about 20 a step on W22-like, 2 on
// W70-like) and a step's own work (its Philox draw, compare and bit set).
// The bit-plane design of the TPU ANDed and popcounted every table word of
// every plane at every step, 11 times the work W22-like needs and 550
// times W70-like's; walking the list instead does no work on zero words.
//   K6 (wsweep_kernel): one thread per chain, the block's 128-chain tile in
//   shared memory at an odd word stride (32 KB at W = 63, so 7 blocks share
//   an SM), the list read with warp-uniform __ldg loads (two entries per
//   16-byte load), then one shared-memory read of the neighbour's word:
//   7 instructions a neighbour. Its time is instruction issue and the
//   latency of those loads, with at most 28 warps per SM (252 bytes of
//   shared memory a chain at W22-like's size).
//   K7 (wsweep_chunked_kernel): for graphs whose tile would leave few
//   blocks per SM (W70-like: one of 4 warps, 160 KB at W = 313), the chains
//   stay in device memory, chain-minor [W, B], so that word j of 32
//   neighbouring chains is 128 contiguous bytes: each neighbour read and
//   each bit set is one coalesced access, the 30.8 MB of W70-like's 24,576
//   chains stay in the 50 MB L2, and all warps are resident in one wave. The
//   lists are staged into shared memory with cp.async, `stage` entries at a
//   time, two stages deep, and every warp of the block reads them; a list
//   may span several stages. Per step, the node's own word and its
//   neighbours' words are loaded together and the Philox draw is made while
//   they are in flight. Its time is the latency of each chain's 80,000
//   dependent steps (W70-like, 8 sweeps), with 6 warps per SM to hide it.
// The TPU's chunked kernel reseeded its PRNG per grid cell; here a draw is
// keyed by (seed, chain, t) whatever the kernel, so K7 gives K6's bits.
//
// The 1-flip sweep (K8a, K8b) visits nodes in ascending order with
// P = sum_j w_ij x_j, cut = x_i ? wdeg_i - P : P, and a flip when
// wdeg_i - 2 cut > 0 (wdeg computed once with the tables, as K5's degrees
// are).
//   K8a (wsweep_1flip_kernel), on WeightedAdjPlanes' word entries: weights
//   |w| < 2^15 split into k <= 15 binary planes, positive and, on a graph
//   with negative weights, negative, P = sum_b 2^b (pc(x & pos_b) -
//   pc(x & neg_b)); row i's entries are its non-zero (plane, word) pairs,
//   {(c << 16) | w, mask} with c the plane's signed weight. The TPU kernel
//   popcounted every word of every plane (and the port's first K8a did so
//   with one thread a chain, 16 blocks on W22-like's 2048 chains: 16 of 132
//   SMs); most of those words are zero on a sparse graph. Here one warp
//   runs one chain, so 2048 chains are 2048 warps on every SM, and its
//   lanes split row i's entries, one popcount of one shared-memory chain
//   word each, before one warp reduction. The first 256 entries of each
//   of the next four rows wait in registers (a ring of slots, loaded four
//   steps ahead), so a step is the reduction's dependent chain with no load
//   on it, and costs about the same from 3 to 256 entries a row: 0.96-0.99
//   ms for 2000 steps of 2048 chains on an H100 (16 warps an SM), 2.4 ms at
//   375 entries, where the rest of each row is loaded at its step. A
//   popcount serves up to 32 neighbours, so K8a pays where rows are dense:
//   0.98 ms against K8b's 4.69 ms at 200 neighbours a node, where K8b's
//   lists are long and its schedule 341 levels deep. Fewer entries held
//   per row ran short rows faster (0.53 ms at 3 entries with 32 held), but
//   K8a runs only on dense rows, where K8b is slower (scripts/
//   torch_engine_share.py, PERF.md).
//   K8b (wsweep_1flip_levels_kernel), on WeightedAdjPlanes' natural-order
//   neighbour lists {j, w}: the sequential sweep is a chain of N dependent
//   steps, and one thread per chain left the card idle (W70-like's 768
//   warm-start chains filled 6 of 132 SMs, each thread walking 10,000
//   steps while it scanned all 6 x 313 plane words of a row, 550 times the
//   words the graph's 2 neighbours a node need). Node i's level is
//   1 + the largest level of its earlier neighbours (0 when it has none):
//   nodes of one level are never adjacent, earlier neighbours sit in lower
//   levels and later ones in higher levels, so visiting level by level, the
//   nodes of a level in any order, gives exactly the sequential sweep's
//   bits. One warp runs one chain, its words in shared memory, and its
//   lanes split each level's nodes: W70-like has 8 levels, so its 10,000
//   dependent steps become 8 rounds of about 1,250 independent nodes, and
//   768 chains are 768 warps on all SMs. What bounds it is the latency of
//   each lane's gathers (level_nodes, offsets, the list, the neighbour's
//   word), with a few warps per SM; the data needs one bit extract and
//   one multiply-add per neighbour. A deep schedule (a path: D = N) stays
//   exact and only runs slower.
#include <cuda_pipeline.h>

#include "common.cuh"

namespace {

constexpr int kWarpChainsPerBlock = 4;  // K8a, K8b: warps (chains) a block

// ---------------------------------------------------------------------------
// K6 and K7: the noisy sweep on neighbour lists

struct ListSweepArgs {
  const int32_t* nodes;    // [N] node of each step
  const float* thr1;       // [N] first-sweep thresholds, noise_scale / 2 included
  const float* thr2;       // [N] later-sweep thresholds
  const int32_t* offsets;  // [N + 1] start of each step's list in `entries`
  const int2* entries;     // [E] {j, (w << 1) | earlier}, 16-byte aligned
  const int32_t* noise;    // [S * N, B] injected u16, or null with use_prng
  uint32_t seed;
  float scale;  // noise_scale / 65536
  int use_prng;
  uint32_t* words;  // chains, updated in place: K6 [B, W], K7 [W, B]
  int B, W, N, S;
};

// The coefficient of an entry's neighbour: w, or in the first sweep 2w for
// a neighbour later in the order.
template <bool kFirst>
__device__ __forceinline__ int coefficient(int meta) {
  const int w = meta >> 1;
  return kFirst ? w * (2 - (meta & 1)) : w;
}

__device__ __forceinline__ int bit_of(uint32_t word, int j) { return static_cast<int>((word >> (j & 31)) & 1u); }

// K6: one chain's neighbour sum over entries [e0, e1), its words `my` in
// shared memory.
template <bool kFirst>
__device__ __forceinline__ int tile_sum(const uint32_t* my, const int2* __restrict__ entries, int e0, int e1) {
  int nbr = 0, e = e0;
  if ((e & 1) && e < e1) {
    const int2 q = __ldg(entries + e++);
    nbr += bit_of(my[q.x >> 5], q.x) * coefficient<kFirst>(q.y);
  }
  for (; e + 1 < e1; e += 2) {  // e even: two entries in one aligned 16-byte load
    const int4 q = __ldg(reinterpret_cast<const int4*>(entries + e));
    nbr += bit_of(my[q.x >> 5], q.x) * coefficient<kFirst>(q.y) + bit_of(my[q.z >> 5], q.z) * coefficient<kFirst>(q.w);
  }
  if (e < e1) {
    const int2 q = __ldg(entries + e);
    nbr += bit_of(my[q.x >> 5], q.x) * coefficient<kFirst>(q.y);
  }
  return nbr;
}

template <bool kFirst>
__device__ __forceinline__ void tile_sweep(uint32_t* my, int s, const ListSweepArgs& a, uint4& d, long long chain) {
  const float* thr = kFirst ? a.thr1 : a.thr2;
  int e1 = __ldg(a.offsets);
  for (int k = 0; k < a.N; ++k) {
    const int e0 = e1;
    e1 = __ldg(a.offsets + k + 1);
    const int nbr = tile_sum<kFirst>(my, a.entries, e0, e1);
    const uint32_t u16 = rl::sweep_u16(a.use_prng, d, s * a.N + k, chain, a.seed, a.noise, a.B);
    rl::set_bit(my, __ldg(a.nodes + k), rl::sweep_decide(nbr, u16, a.scale, __ldg(thr + k)));
  }
}

__global__ void wsweep_kernel(const ListSweepArgs a) {
  extern __shared__ uint32_t sm[];
  const long long b0 = (long long)blockIdx.x * blockDim.x;
  const int nb = min((long long)blockDim.x, a.B - b0);
  rl::load_chains(sm, a.words, b0, nb, a.W);
  if (threadIdx.x < nb) {
    uint32_t* my = sm + threadIdx.x * rl::smem_stride(a.W);
    const long long chain = b0 + threadIdx.x;
    uint4 d = make_uint4(0u, 0u, 0u, 0u);
    tile_sweep<true>(my, 0, a, d, chain);
    for (int s = 1; s < a.S; ++s) tile_sweep<false>(my, s, a, d, chain);
  }
  rl::store_chains(sm, a.words, b0, nb, a.W);
}

// K7: neighbour loads issued together, then summed
constexpr int kBatch = 4;

// The staged list of K7: the call's S sweeps walk S * E entries in order,
// entry v being entries[v % E]; stage g holds [g * stage, (g + 1) * stage)
// in buffer g & 1. Every thread of the block walks the same entries, so
// the block moves from stage to stage together.
struct ListStages {
  int2* buf;  // [2, stage] shared memory
  const int2* entries;
  int E, stage;
  long long total;  // S * E
  long long g;      // current stage
  int pos;          // the next entry's place in stage g

  __device__ void fetch(long long gs) {
    int2* dst = buf + (gs & 1) * stage;
    const long long v0 = gs * stage;
    const int cnt = (int)min((long long)stage, total - v0), start = (int)(v0 % E);
    for (int i = threadIdx.x; i < cnt; i += blockDim.x) {
      int src = start + i;
      if (src >= E) src %= E;
      __pipeline_memcpy_async(dst + i, entries + src, sizeof(int2));
    }
    __pipeline_commit();
  }

  __device__ void begin() {
    g = 0;
    pos = 0;
    fetch(0);
    if (stage < total) {
      fetch(1);
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();
  }

  // The next entry of the walk; crosses into the next stage, block-wide,
  // at the end of this one.
  __device__ int2 next() {
    if (pos == stage) {
      __pipeline_wait_prior(0);
      __syncthreads();  // stage g + 1 is in for every thread, stage g is done with
      ++g;
      pos = 0;
      if ((g + 1) * stage < total) fetch(g + 1);  // into the buffer stage g used
    }
    return buf[(g & 1) * stage + pos++];
  }
};

// Reads the walk's next `cnt` <= kBatch entries and issues the loads of
// their chain words (first: the first sweep's coefficients). A batch inside
// the current stage is read without the stage check.
__device__ __forceinline__ void read_entries(int (&j)[kBatch], int (&c)[kBatch], uint32_t (&x)[kBatch], int cnt,
                                             bool first, ListStages& ls, const uint32_t* col, bool live, size_t B) {
  if (ls.pos + cnt <= ls.stage) {
    const int2* p = ls.buf + (ls.g & 1) * ls.stage + ls.pos;
    ls.pos += cnt;
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      const int2 ent = q < cnt ? p[q] : make_int2(0, 0);
      j[q] = ent.x;
      c[q] = first ? coefficient<true>(ent.y) : coefficient<false>(ent.y);
    }
  } else {
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      const int2 ent = q < cnt ? ls.next() : make_int2(0, 0);
      j[q] = ent.x;
      c[q] = first ? coefficient<true>(ent.y) : coefficient<false>(ent.y);
    }
  }
#pragma unroll
  for (int q = 0; q < kBatch; ++q) x[q] = (live && q < cnt) ? col[(size_t)(j[q] >> 5) * B] : 0u;
}

// One sweep of K7 over the chain's column `col` (word j at col[j * B]): per
// step, the node's own word and the first kBatch neighbour words are loaded
// together, the Philox draw is made while they are in flight, and the bit
// is stored back.
template <bool kFirst>
__device__ __forceinline__ void column_sweep(uint32_t* col, bool live, int s, const ListSweepArgs& a, ListStages& ls,
                                             uint4& d, long long chain) {
  const size_t B = a.B;
  const float* thr = kFirst ? a.thr1 : a.thr2;
  int e1 = __ldg(a.offsets);
  for (int k = 0; k < a.N; ++k) {
    const int e0 = e1;
    e1 = __ldg(a.offsets + k + 1);
    const int node = __ldg(a.nodes + k), deg = e1 - e0;
    uint32_t* own = col + (size_t)(node >> 5) * B;
    const uint32_t cur = live ? *own : 0u;
    uint32_t u16 = 0u;
    int nbr = 0;
    for (int e = 0; e < deg || e == 0; e += kBatch) {  // once for an empty list: the draw is made
      int j[kBatch], c[kBatch];
      uint32_t x[kBatch];
      read_entries(j, c, x, min(deg - e, kBatch), kFirst, ls, col, live, B);
      if (e == 0 && live) u16 = rl::sweep_u16(a.use_prng, d, s * a.N + k, chain, a.seed, a.noise, a.B);
#pragma unroll
      for (int q = 0; q < kBatch; ++q) nbr += bit_of(x[q], j[q]) * c[q];
    }
    if (live) {
      const uint32_t m = 1u << (node & 31);
      *own = rl::sweep_decide(nbr, u16, a.scale, __ldg(thr + k)) ? (cur | m) : (cur & ~m);
    }
  }
}

__global__ void wsweep_chunked_kernel(const ListSweepArgs a, int stage) {
  extern __shared__ int2 stage_buf[];
  const long long chain = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = chain < a.B;  // every thread walks the stages; only live ones touch chains
  uint32_t* col = a.words + (live ? chain : 0);
  const int E = __ldg(a.offsets + a.N);
  ListStages ls{stage_buf, a.entries, E, stage, (long long)a.S * E, 0, 0};
  ls.begin();
  uint4 d = make_uint4(0u, 0u, 0u, 0u);
  column_sweep<true>(col, live, 0, a, ls, d, chain);
  for (int s = 1; s < a.S; ++s) column_sweep<false>(col, live, s, a, ls, d, chain);
}

// ---------------------------------------------------------------------------
// K8a: the greedy 1-flip sweep on each row's non-zero plane words

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kAhead = 4;  // K8a: rows a warp holds ahead of the one it decides
constexpr int kHeld = 8;   // K8a: entries a lane holds of each of those rows

// Whether node i of a chain flips: p = sum_j w_ij x_j, cut = x_i ? wdeg - p
// : p (the weight to the other side), strict improvement wdeg - 2 cut > 0.
__device__ __forceinline__ bool flips(const uint32_t* my, int i, int p, int wdeg) {
  const int cut = bit_of(my[i >> 5], i) ? wdeg - p : p;
  return wdeg - 2 * cut > 0;
}

struct WordFlipArgs {
  const int32_t* offsets;  // [N + 1] start of each row's entries
  const int2* entries;     // [E + 1] {(c << 16) | w, mask} by (w, plane), then {0, 0}
  const int32_t* wdeg;     // [N] integer weighted degrees
  uint32_t* words;         // [B, W] chains, updated in place
  int B, W, N, E;
};

// One entry's share of a row's sum: its plane's signed weight c (+2^p or
// -2^p) times the popcount of the chain's word w under the mask. The empty
// entry {0, 0} gives 0.
__device__ __forceinline__ int entry_sum(const uint32_t* my, int2 q) {
  return (q.x >> 16) * __popc(my[q.x & 0xFFFF] & static_cast<uint32_t>(q.y));
}

// What a lane holds of one row ahead: entries e0 + lane + 32 r (r < kHeld;
// the empty entry E past the row's end, so that every load is made and no
// select waits on one), where the rest of the row starts for this lane and
// where it ends, the row's weighted degree, and the end of the row that
// the slot holds next (offsets[row + kAhead + 1]).
struct Held {
  int2 q[kHeld];
  int rest, end, wdeg, next_end;
};

__device__ __forceinline__ void hold(Held& h, const WordFlipArgs& a, int row, int e0, int e1, int lane) {
#pragma unroll
  for (int r = 0; r < kHeld; ++r) {
    const int e = e0 + 32 * r + lane;
    h.q[r] = __ldg(a.entries + (e < e1 ? e : a.E));
  }
  h.rest = e0 + 32 * kHeld + lane;
  h.end = e1;
  h.wdeg = __ldg(a.wdeg + min(row, a.N - 1));
  h.next_end = __ldg(a.offsets + min(row + kAhead + 1, a.N));
}

// One warp per chain, kWarpChainsPerBlock chains a block in shared memory.
// Step i: each lane sums its entries of row i, one warp reduction gives P,
// lane 0 stores the flipped word and __syncwarp orders it before step
// i + 1's reads. A row's entries do not depend on any flip, so
// slot i % kAhead holds row i's first kHeld x 32 entries, loaded at step
// i - kAhead into the registers that step had just read; the loop is
// unrolled kAhead times so that no register is moved while its load is in
// flight. Rows longer than kHeld x 32 entries load the rest at their step.
__global__ void wsweep_1flip_kernel(const WordFlipArgs a) {
  extern __shared__ uint32_t sm[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int per_block = blockDim.x >> 5;
  const long long b0 = (long long)blockIdx.x * per_block;
  const int nb = min((long long)per_block, a.B - b0);
  rl::load_chains(sm, a.words, b0, nb, a.W);
  if (warp < nb) {
    uint32_t* my = sm + warp * rl::smem_stride(a.W);
    const int N = a.N;
    Held h[kAhead];
#pragma unroll
    for (int r = 0; r < kAhead; ++r)
      hold(h[r], a, r, __ldg(a.offsets + min(r, N)), __ldg(a.offsets + min(r + 1, N)), lane);
    for (int i = 0; i < N; i += kAhead) {
#pragma unroll
      for (int r = 0; r < kAhead; ++r) {
        const int node = i + r;
        if (node >= N) break;
        Held& cur = h[r];
        int part = 0;
#pragma unroll
        for (int q = 0; q < kHeld; ++q) part += entry_sum(my, cur.q[q]);
        for (int e = cur.rest; e < cur.end; e += 32) part += entry_sum(my, __ldg(a.entries + e));
        const int wdeg = cur.wdeg;
        // row node + kAhead starts where row node + kAhead - 1, held by the
        // previous slot, ends
        hold(cur, a, node + kAhead, h[(r + kAhead - 1) % kAhead].end, cur.next_end, lane);
        const int p = __reduce_add_sync(kFull, part);
        if (lane == 0 && flips(my, node, p, wdeg)) my[node >> 5] ^= 1u << (node & 31);
        __syncwarp();
      }
    }
  }
  rl::store_chains(sm, a.words, b0, nb, a.W);
}

// ---------------------------------------------------------------------------
// K8b: the greedy 1-flip sweep on neighbour lists, in a level schedule

struct LevelArgs {
  const int32_t* offsets;        // [N + 1] start of each node's list
  const int2* entries;           // [E] {j, w}, ascending j within a list
  const int32_t* level_nodes;    // [N] node ids sorted by (level, id)
  const int32_t* level_offsets;  // [D + 1] start of each level in level_nodes
  const int32_t* wdeg;           // [N] integer weighted degrees
  uint32_t* words;               // [B, W] chains, updated in place
  int B, W, D;
};

// One warp per chain, kWarpChainsPerBlock chains a block in shared memory.
// The lanes split each level's nodes; a flip is an atomicXor on the shared
// word, which other lanes of the level may be flipping other bits of. Nodes
// of a level are never adjacent, so no bit that a lane reads changes during
// the level; __syncwarp orders one level's flips before the next's reads.
__global__ void wsweep_1flip_levels_kernel(const LevelArgs a) {
  extern __shared__ uint32_t sm[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int per_block = blockDim.x >> 5;
  const long long b0 = (long long)blockIdx.x * per_block;
  const int nb = min((long long)per_block, a.B - b0);
  rl::load_chains(sm, a.words, b0, nb, a.W);
  if (warp < nb) {
    uint32_t* my = sm + warp * rl::smem_stride(a.W);
    int v1 = __ldg(a.level_offsets);
    for (int lv = 0; lv < a.D; ++lv) {
      const int v0 = v1;
      v1 = __ldg(a.level_offsets + lv + 1);
      for (int v = v0 + lane; v < v1; v += 32) {
        const int i = __ldg(a.level_nodes + v);
        const int e1 = __ldg(a.offsets + i + 1);
        int p = 0;
        for (int e = __ldg(a.offsets + i); e < e1; ++e) {
          const int2 q = __ldg(a.entries + e);
          p += bit_of(my[q.x >> 5], q.x) * q.y;
        }
        if (flips(my, i, p, __ldg(a.wdeg + i))) atomicXor(my + (i >> 5), 1u << (i & 31));
      }
      __syncwarp();
    }
  }
  rl::store_chains(sm, a.words, b0, nb, a.W);
}

// Launches kernel(args...) over ceil(B / threads) blocks of the largest
// chain tile that fits.
template <typename Fn, typename... Args>
cudaError_t launch(Fn kernel, int B, int W, cudaStream_t st, Args... args) {
  int threads;
  size_t smem;
  cudaError_t e = rl::prepare(kernel, W, &threads, &smem);
  if (e != cudaSuccess) return e;
  if (B > 0) kernel<<<(B + threads - 1) / threads, threads, smem, st>>>(args...);
  return cudaGetLastError();
}

// Launches a one-warp-per-chain kernel (K8a, K8b) over blocks of
// kWarpChainsPerBlock chains, fewer when their words do not fit.
template <typename Fn, typename Args>
cudaError_t launch_warps(Fn kernel, int B, int W, cudaStream_t st, const Args& a) {
  int chains = kWarpChainsPerBlock;
  size_t smem = (size_t)chains * rl::smem_stride(W) * sizeof(uint32_t);
  for (; chains > 1 && smem > rl::kMaxSmem; smem = (size_t)chains * rl::smem_stride(W) * sizeof(uint32_t)) chains /= 2;
  if (smem > rl::kMaxSmem) return cudaErrorInvalidValue;
  const cudaError_t e = rl::allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  if (B > 0) kernel<<<(B + chains - 1) / chains, 32 * chains, smem, st>>>(a);
  return cudaGetLastError();
}

ListSweepArgs list_args(const int32_t* nodes, const float* thr1, const float* thr2, const int32_t* offsets,
                        const int32_t* entries, const int32_t* noise, int use_prng, uint32_t seed, float scale,
                        int32_t* words, int B, int W, int N, int S) {
  return ListSweepArgs{nodes, thr1, thr2, offsets, reinterpret_cast<const int2*>(entries), noise, seed, scale,
                       use_prng, reinterpret_cast<uint32_t*>(words), B, W, N, S};
}

}  // namespace

extern "C" int wsweep(const int32_t* nodes, const float* thr1, const float* thr2, const int32_t* offsets,
                      const int32_t* entries, const int32_t* noise, int use_prng, uint32_t seed, float scale,
                      int32_t* words, int B, int W, int N, int S, cudaStream_t st) {
  const ListSweepArgs a = list_args(nodes, thr1, thr2, offsets, entries, noise, use_prng, seed, scale, words, B, W,
                                    N, S);
  return launch(wsweep_kernel, B, W, st, a);
}

// words: [W, B], chain-minor. One thread per chain in blocks of
// kChainsPerBlock, beside two stages of `stage` list entries.
extern "C" int wsweep_chunked(const int32_t* nodes, const float* thr1, const float* thr2, const int32_t* offsets,
                              const int32_t* entries, const int32_t* noise, int use_prng, uint32_t seed,
                              float scale, int32_t* words, int B, int W, int N, int S, int stage, cudaStream_t st) {
  if (stage < 1) return cudaErrorInvalidValue;
  const ListSweepArgs a = list_args(nodes, thr1, thr2, offsets, entries, noise, use_prng, seed, scale, words, B, W,
                                    N, S);
  const size_t smem = 2 * (size_t)stage * sizeof(int2);
  if (smem > rl::kMaxSmem) return cudaErrorInvalidValue;
  const cudaError_t e = rl::allow_smem(wsweep_chunked_kernel, smem);
  if (e != cudaSuccess) return e;
  const int threads = rl::kChainsPerBlock;
  if (B > 0) wsweep_chunked_kernel<<<(B + threads - 1) / threads, threads, smem, st>>>(a, stage);
  return cudaGetLastError();
}

// word_entries [E + 1, 2] int32 {(c << 16) | w, mask}, the last one {0, 0},
// 8-byte aligned; W < 2^16.
extern "C" int wsweep_1flip(const int32_t* word_offsets, const int32_t* word_entries, const int32_t* wdeg, int E,
                            int32_t* words, int B, int W, int N, cudaStream_t st) {
  if (W >= (1 << 16) || E < 0 || N < 1) return cudaErrorInvalidValue;
  const WordFlipArgs a{word_offsets, reinterpret_cast<const int2*>(word_entries), wdeg,
                       reinterpret_cast<uint32_t*>(words), B, W, N, E};
  return launch_warps(wsweep_1flip_kernel, B, W, st, a);
}

// entries [E, 2] int32 {j, w}, 8-byte aligned.
extern "C" int wsweep_1flip_levels(const int32_t* offsets, const int32_t* entries, const int32_t* level_nodes,
                                   const int32_t* level_offsets, const int32_t* wdeg, int32_t* words, int B, int W,
                                   int D, cudaStream_t st) {
  const LevelArgs a{offsets, reinterpret_cast<const int2*>(entries), level_nodes, level_offsets, wdeg,
                    reinterpret_cast<uint32_t*>(words), B, W, D};
  return launch_warps(wsweep_1flip_levels_kernel, B, W, st, a);
}
