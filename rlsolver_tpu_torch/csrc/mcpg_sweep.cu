// Degree-ordered anti-majority sweeps and the greedy 1-flip sweep on
// bit-packed chains.
//
// Replaces rlsolver_tpu/ops/pallas/mcpg_sweep.py:_mcpg_sweep_kernel (K4,
// reached by mcpg_sweep_packed with injected u16 noise and by
// mcpg_sweep_fused with in-kernel random bits) and :_sweep_1flip_kernel (K5).
//
// K4, per step k of sweep s (node i = nodes[k], descending degree): the
// neighbour sum is a popcount of the chain's words against static mask rows,
//   sweep 0: pc(x & m_proc[k]) + 2 pc(x & m_unproc[k])   (mixed domain)
//   later:   pc(x & m_all[k])
// minus the same popcounts against the negative-edge planes for +-1 graphs,
// and x_i = (nbr + u16 * scale < thr[k]). nbr is an exact integer; the sum
// and compare use __fadd_rn/__fmul_rn (and the library builds with
// -fmad=false) so they round exactly like the f32 multiply-then-add of the
// JAX and torch versions, and the result is bit-exact.
// K5, the greedy 1-flip sweep in ascending node order: P = sum_j +-x_j over
// node i's neighbours, cut = x_i ? wdeg_i - P : P with wdeg_i = deg+_i -
// deg-_i, and the bit flips when wdeg_i - 2 cut > 0.
//
// What bounds K4 on an H100: the popcounts the data needs, one per chain
// per non-zero mask word (17.1 of a row's 63 words on the G22-like graph,
// at most 30), at a quarter of the integer rate, and per word a read of the
// chain word from shared memory. The TPU kernel ANDed and popcounted every
// word of a row. Here each step walks a list of its row's non-zero words
// (PackedSweepTables.word_entries): one 16-byte entry {w, m_proc, m_unproc,
// m_all} per word w (a second one with the negative planes on a signed
// graph), read with a warp-uniform __ldg, so that no zero word is read or
// popcounted. Sweep 1 popcounts two masks per entry, later sweeps one. The
// lists (0.55 MB at G22-like's size) are the same for every chain and stay
// in L2 and L1. As in the MH kernel, one thread runs one chain and a block
// keeps its 128 chains in shared memory for all steps, at an odd word
// stride, so the threads of a warp reading word w hit distinct banks (28
// warps per SM at W = 63: shared memory bounds the residency). Its time
// follows its memory instructions, two per word (the entry load and the
// chain word's shared-memory read), as K6's follows its per neighbour:
// narrower entry loads in more instructions ran slower (PERF.md).
//
// What bounds K5: the sweep is a chain of N dependent steps per chain, and
// its data needs a bit extract and an add per neighbour. The TPU kernel
// ANDed and popcounted every word of every row, and the port's first K5 did
// so with one thread a chain: 16 of 132 SMs at 2048 chains, each thread
// making 2000 x 63 global reads where a G22-like row has 17 non-zero words.
// Here the sweep walks a level schedule (LevelLists in mcpg_sweep.py, the
// schedule K8b reads): node i's level is 1 + the largest level of its
// earlier neighbours, so no level holds an edge and visiting the levels in
// order, a level's nodes in any order, gives the sequential sweep's bits.
// One warp runs one chain, its words in shared memory, and its lanes split
// each level's nodes. The whole table (level offsets, one 8-byte record a
// node {list start, node | wdeg << 16}, the lists of 2-byte signed ids
// {sign << 15 | j}, so at most 2^15 nodes, in schedule order) is copied into every block's shared memory by bulk copies on an
// mbarrier, about 100 KB at G22-like's size, so that every gather of the
// sweep is a shared-memory read; 8 chains a block leave two blocks a SM
// there, and 2048 chains fill the card in one wave. A lane reads its list
// four entries ahead of the words they name, so the gathers overlap. On an
// H100 it sweeps G22-like's 2048 chains in 0.13 ms, K8b on the same lists in
// device memory in 0.27; reading the lists 8 bytes at a time was slower
// (PERF.md).
#include "common.cuh"

namespace {

// One chain's neighbour sum over the word entries [e0, e1) of a step; an
// entry is Q = 1 (unsigned) or 2 (signed) uint4 {w, m_proc, m_unproc, m_all},
// the second with the negative planes.
template <bool kSigned, bool kFirst>
__device__ __forceinline__ int word_sum(const uint32_t* my, const uint4* __restrict__ entries, int e0, int e1) {
  constexpr int Q = kSigned ? 2 : 1;
  int nbr = 0;
#pragma unroll 4
  for (int e = e0; e < e1; ++e) {
    const uint4 q = __ldg(entries + (size_t)e * Q);
    const uint32_t x = my[q.x];
    nbr += kFirst ? __popc(x & q.y) + 2 * __popc(x & q.z) : __popc(x & q.w);
    if (kSigned) {
      const uint4 r = __ldg(entries + (size_t)e * Q + 1);
      nbr -= kFirst ? __popc(x & r.y) + 2 * __popc(x & r.z) : __popc(x & r.w);
    }
  }
  return nbr;
}

struct WordSweepArgs {
  const int32_t* nodes;    // [N] node of each step
  const float* thr1;       // [N] first-sweep thresholds, noise_scale / 2 included
  const float* thr2;       // [N] later-sweep thresholds
  const int32_t* offsets;  // [N + 1] start of each step's entries
  const uint4* entries;    // [E, Q] word entries, 16-byte aligned
  const int32_t* noise;    // [S * N, B] injected u16, or null with kPrng
  uint32_t seed;
  float scale;      // noise_scale / 65536
  uint32_t* words;  // [B, W] chains, updated in place
  int B, W, N, S;
};

template <bool kSigned, bool kFirst, bool kPrng>
__device__ __forceinline__ void word_sweep(uint32_t* my, int s, const WordSweepArgs& a, uint4& d, long long chain) {
  const float* thr = kFirst ? a.thr1 : a.thr2;
  int e1 = __ldg(a.offsets);
  for (int k = 0; k < a.N; ++k) {
    const int e0 = e1;
    e1 = __ldg(a.offsets + k + 1);
    const int nbr = word_sum<kSigned, kFirst>(my, a.entries, e0, e1);
    const uint32_t u16 = rl::sweep_u16(kPrng, d, s * a.N + k, chain, a.seed, a.noise, a.B);
    rl::set_bit(my, __ldg(a.nodes + k), rl::sweep_decide(nbr, u16, a.scale, __ldg(thr + k)));
  }
}

template <bool kSigned, bool kPrng>
__global__ void mcpg_sweep_kernel(const WordSweepArgs a) {
  extern __shared__ uint32_t sm[];
  const long long b0 = (long long)blockIdx.x * blockDim.x;
  const int nb = min((long long)blockDim.x, a.B - b0);
  rl::load_chains(sm, a.words, b0, nb, a.W);
  if (threadIdx.x < nb) {
    uint32_t* my = sm + threadIdx.x * rl::smem_stride(a.W);
    const long long chain = b0 + threadIdx.x;
    uint4 d = make_uint4(0u, 0u, 0u, 0u);
    if (a.S > 0) word_sweep<kSigned, true, kPrng>(my, 0, a, d, chain);
    for (int s = 1; s < a.S; ++s) word_sweep<kSigned, false, kPrng>(my, s, a, d, chain);
  }
  rl::store_chains(sm, a.words, b0, nb, a.W);
}

constexpr int kLevelWarps = 8;  // K5: chains (warps) a block

struct LevelArgs {
  const unsigned char* table;  // the LevelLists blob, 16-byte aligned
  int table_bytes;             // a multiple of 16
  int depth;                   // levels
  int record_offset;           // bytes: uint2 records [V + 1]
  int entry_offset;            // bytes: the lists
  uint32_t* words;             // [B, W] chains, updated in place
  int B, W;
};

// +-x_j of a list entry {sign << 15 | j}.
__device__ __forceinline__ int signed_bit(const uint32_t* my, uint16_t q) {
  const uint32_t j = q & 0x7FFFu;
  const int s = static_cast<int>(q >> 15);
  const int bit = static_cast<int>((my[j >> 5] >> (j & 31)) & 1u);
  return (bit ^ -s) + s;  // s ? -bit : bit
}

// One warp per chain, kLevelWarps chains a block. Thread 0 copies the table
// into shared memory while the block loads its chains; then the lanes split
// each level's nodes. A flip is an atomicXor on the shared word, which other
// lanes of the level may be flipping other bits of; nodes of a level are
// never adjacent, so no bit a lane reads changes during the level, and
// __syncwarp orders one level's flips before the next level's reads.
__global__ void sweep_1flip_kernel(const LevelArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  unsigned char* tab = smem + 16;
  uint32_t* sm = reinterpret_cast<uint32_t*>(tab + a.table_bytes);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int per_block = blockDim.x >> 5;
  const long long b0 = (long long)blockIdx.x * per_block;
  const int nb = min((long long)per_block, a.B - b0);
  if (threadIdx.x == 0) rl::mbar_init(bar, 1);
  __syncthreads();
  if (threadIdx.x == 0) {
    rl::mbar_expect(bar, a.table_bytes);
    rl::bulk_copy(tab, a.table, a.table_bytes, bar);
  }
  rl::load_chains(sm, a.words, b0, nb, a.W);
  rl::mbar_wait(bar, 0);
  if (warp < nb) {
    uint32_t* my = sm + warp * rl::smem_stride(a.W);
    const int32_t* level_offsets = reinterpret_cast<const int32_t*>(tab);
    const uint2* records = reinterpret_cast<const uint2*>(tab + a.record_offset);
    const uint16_t* entries = reinterpret_cast<const uint16_t*>(tab + a.entry_offset);
    int v1 = level_offsets[0];
    for (int lv = 0; lv < a.depth; ++lv) {
      const int v0 = v1;
      v1 = level_offsets[lv + 1];
      for (int v = v0 + lane; v < v1; v += 32) {
        const uint2 rec = records[v];
        const int e1 = static_cast<int>(records[v + 1].x);
        const int i = static_cast<int>(rec.y & 0xFFFFu), wdeg = static_cast<int>(rec.y) >> 16;
        int e = static_cast<int>(rec.x), p = 0;
        for (; e + 4 <= e1; e += 4) {
          const uint16_t q0 = entries[e], q1 = entries[e + 1], q2 = entries[e + 2], q3 = entries[e + 3];
          p += signed_bit(my, q0) + signed_bit(my, q1) + signed_bit(my, q2) + signed_bit(my, q3);
        }
        for (; e < e1; ++e) p += signed_bit(my, entries[e]);
        const int cut = ((my[i >> 5] >> (i & 31)) & 1u) ? wdeg - p : p;
        if (wdeg - 2 * cut > 0) atomicXor(my + (i >> 5), 1u << (i & 31));  // strict improvement
      }
      __syncwarp();
    }
  }
  rl::store_chains(sm, a.words, b0, nb, a.W);
}

}  // namespace

// word_offsets [N + 1], word_entries [E, Q, 4] int32 (Q = 2 when is_signed).
extern "C" int mcpg_sweep(const int32_t* nodes, const float* thr1, const float* thr2, const int32_t* word_offsets,
                          const int32_t* word_entries, int is_signed, const int32_t* noise, int use_prng,
                          uint32_t seed, float scale, int32_t* words, int B, int W, int N, int S,
                          cudaStream_t st) {
  auto kernel = is_signed ? (use_prng ? mcpg_sweep_kernel<true, true> : mcpg_sweep_kernel<true, false>)
                          : (use_prng ? mcpg_sweep_kernel<false, true> : mcpg_sweep_kernel<false, false>);
  int threads;
  size_t smem;
  cudaError_t e = rl::prepare(kernel, W, &threads, &smem);
  if (e != cudaSuccess) return e;
  const WordSweepArgs a{nodes, thr1, thr2, word_offsets, reinterpret_cast<const uint4*>(word_entries),
                        noise, seed, scale, reinterpret_cast<uint32_t*>(words), B, W, N, S};
  if (B > 0) kernel<<<(B + threads - 1) / threads, threads, smem, st>>>(a);
  return cudaGetLastError();
}

// table: the LevelLists blob of `table_bytes` (a multiple of 16), 16-byte
// aligned, with `depth` levels, its records and lists at the byte offsets
// given.
extern "C" int sweep_1flip(const int32_t* table, int table_bytes, int depth, int record_offset, int entry_offset,
                           int32_t* words, int B, int W, cudaStream_t st) {
  if (table_bytes < 16 || table_bytes % 16 || reinterpret_cast<uintptr_t>(table) % 16) return cudaErrorInvalidValue;
  auto kernel = sweep_1flip_kernel;
  int chains = kLevelWarps;
  const size_t fixed = 16 + (size_t)table_bytes, chain = (size_t)rl::smem_stride(W) * sizeof(uint32_t);
  while (chains > 1 && fixed + chains * chain > rl::kMaxSmem) chains /= 2;
  const size_t smem = fixed + chains * chain;
  if (smem > rl::kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t e = rl::allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  const LevelArgs a{reinterpret_cast<const unsigned char*>(table), table_bytes, depth, record_offset, entry_offset,
                    reinterpret_cast<uint32_t*>(words), B, W};
  if (B > 0) kernel<<<(B + chains - 1) / chains, 32 * chains, smem, st>>>(a);
  return cudaGetLastError();
}
