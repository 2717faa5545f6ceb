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
// What bounds it on an H100: every step ANDs and popcounts all W words of
// every chain against a mask row (W = 63 at N = 2000), so at 10^6 chains one
// sweep is ~1.3e11 word operations; popcount issues at a quarter of the
// integer rate, and each word also costs a shared-memory read of the chain
// word and a broadcast read of the mask word. Device memory is not the
// limit: the chains are read and written once per call, and the mask tables
// (3 or 6 x N x W words, 1.5 MB at N = 2000) are the same for every chain, so
// they stay in L2 and L1 and each warp reads a mask word as one broadcast.
// The function needs less: a popcount only where a mask word is non-zero
// (27% of a row's words on the G22-like graph), which is what chip_smoke.py's
// bound counts. Scanning every word keeps the kernel simple; a list of each
// row's non-zero words would skip the rest. As in the MH kernel, one thread runs one chain and a block keeps its 128
// chains in shared memory for all steps.
#include "common.cuh"

namespace {

template <bool kSigned>
__device__ __forceinline__ int signed_popcount(const uint32_t* my, const uint32_t* __restrict__ pos,
                                               const uint32_t* __restrict__ neg, int W) {
  int p = 0;
  for (int j = 0; j < W; ++j) {
    const uint32_t x = my[j];
    p += __popc(x & __ldg(pos + j));
    if (kSigned) p -= __popc(x & __ldg(neg + j));
  }
  return p;
}

// masks: [P, N, W] planes, P = 3 (proc, unproc, all) or 6 (each followed by
// its negative plane). thr1/thr2 already include noise_scale / 2.
template <bool kSigned, bool kPrng>
__global__ void mcpg_sweep_kernel(const int32_t* __restrict__ nodes, const float* __restrict__ thr1,
                                  const float* __restrict__ thr2, const uint32_t* __restrict__ masks,
                                  const int32_t* __restrict__ noise, uint32_t seed, float scale,
                                  uint32_t* __restrict__ words, int B, int W, int N, int S) {
  extern __shared__ uint32_t sm[];
  const long long b0 = (long long)blockIdx.x * blockDim.x;
  const int nb = min((long long)blockDim.x, B - b0);
  rl::load_chains(sm, words, b0, nb, W);
  if (threadIdx.x < nb) {
    uint32_t* my = sm + threadIdx.x * rl::smem_stride(W);
    const long long chain = b0 + threadIdx.x;
    const size_t plane = (size_t)N * W;
    const int step = kSigned ? 2 : 1;  // plane index stride between kinds
    const uint32_t* m_proc = masks;
    const uint32_t* m_unproc = masks + step * plane;
    const uint32_t* m_all = masks + 2 * step * plane;
    uint4 d = make_uint4(0u, 0u, 0u, 0u);
    for (int sk = 0; sk < S * N; ++sk) {
      const int k = sk < N ? sk : sk % N;
      const size_t row = (size_t)k * W;
      int nbr;
      float thr;
      if (sk < N) {
        nbr = signed_popcount<kSigned>(my, m_proc + row, m_proc + plane + row, W) +
              2 * signed_popcount<kSigned>(my, m_unproc + row, m_unproc + plane + row, W);
        thr = __ldg(thr1 + k);
      } else {
        nbr = signed_popcount<kSigned>(my, m_all + row, m_all + plane + row, W);
        thr = __ldg(thr2 + k);
      }
      const uint32_t u16 = rl::sweep_u16(kPrng, d, sk, chain, seed, noise, B);
      const float lhs = __fadd_rn(static_cast<float>(nbr), __fmul_rn(static_cast<float>(u16), scale));
      rl::set_bit(my, __ldg(nodes + k), lhs < thr);
    }
  }
  rl::store_chains(sm, words, b0, nb, W);
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

extern "C" int mcpg_sweep(const int32_t* nodes, const float* thr1, const float* thr2,
                          const int32_t* masks, int is_signed, const int32_t* noise, int use_prng,
                          uint32_t seed, float scale, int32_t* words, int B, int W, int N, int S,
                          cudaStream_t st) {
  auto kernel = is_signed ? (use_prng ? mcpg_sweep_kernel<true, true> : mcpg_sweep_kernel<true, false>)
                          : (use_prng ? mcpg_sweep_kernel<false, true> : mcpg_sweep_kernel<false, false>);
  int threads;
  size_t smem;
  cudaError_t e = rl::prepare(kernel, W, &threads, &smem);
  if (e != cudaSuccess) return e;
  if (B > 0)
    kernel<<<(B + threads - 1) / threads, threads, smem, st>>>(
        nodes, thr1, thr2, reinterpret_cast<const uint32_t*>(masks), noise, seed, scale,
        reinterpret_cast<uint32_t*>(words), B, W, N, S);
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
