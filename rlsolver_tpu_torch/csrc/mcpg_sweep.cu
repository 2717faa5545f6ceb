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
// K5, per node i in ascending order: gain = wdeg_i - 2 cut_i from popcounts
// of the adjacency row(s); the bit flips when the gain is > 0.
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

template <bool kSigned>
__global__ void sweep_1flip_kernel(const uint32_t* __restrict__ adj_pos, const uint32_t* __restrict__ adj_neg,
                                   const int32_t* __restrict__ deg_pos, const int32_t* __restrict__ deg_neg,
                                   uint32_t* __restrict__ words, int B, int W, int N) {
  extern __shared__ uint32_t sm[];
  const long long b0 = (long long)blockIdx.x * blockDim.x;
  const int nb = min((long long)blockDim.x, B - b0);
  rl::load_chains(sm, words, b0, nb, W);
  if (threadIdx.x < nb) {
    uint32_t* my = sm + threadIdx.x * rl::smem_stride(W);
    for (int i = 0; i < N; ++i) {
      const size_t row = (size_t)i * W;
      const uint32_t cur = (my[i >> 5] >> (i & 31)) & 1u;
      const int deg = __ldg(deg_pos + i);
      int p = 0, pn = 0;
      for (int j = 0; j < W; ++j) {
        const uint32_t x = my[j];
        p += __popc(x & __ldg(adj_pos + row + j));
        if (kSigned) pn += __popc(x & __ldg(adj_neg + row + j));
      }
      // cut weight at i: neighbours on the other side
      int cut = cur ? deg - p : p;
      int wdeg = deg;
      if (kSigned) {
        const int degn = __ldg(deg_neg + i);
        cut -= cur ? degn - pn : pn;
        wdeg -= degn;
      }
      if (wdeg - 2 * cut > 0) my[i >> 5] ^= 1u << (i & 31);  // strict improvement
    }
  }
  rl::store_chains(sm, words, b0, nb, W);
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

extern "C" int sweep_1flip(const int32_t* adj_pos, const int32_t* adj_neg, const int32_t* deg_pos,
                           const int32_t* deg_neg, int32_t* words, int B, int W, int N,
                           cudaStream_t st) {
  const bool is_signed = adj_neg != nullptr;
  auto kernel = is_signed ? sweep_1flip_kernel<true> : sweep_1flip_kernel<false>;
  int threads;
  size_t smem;
  cudaError_t e = rl::prepare(kernel, W, &threads, &smem);
  if (e != cudaSuccess) return e;
  if (B > 0)
    kernel<<<(B + threads - 1) / threads, threads, smem, st>>>(
        reinterpret_cast<const uint32_t*>(adj_pos), reinterpret_cast<const uint32_t*>(adj_neg), deg_pos,
        deg_neg, reinterpret_cast<uint32_t*>(words), B, W, N);
  return cudaGetLastError();
}
