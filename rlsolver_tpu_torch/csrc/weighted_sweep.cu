// Integer-weight sweeps on signed bit-planes: MCPG's noisy degree-ordered
// sweep and the greedy 1-flip sweep, each with its table rows read in place
// or staged in shared memory a node chunk at a time.
//
// Replaces rlsolver_tpu/ops/pallas/weighted_sweep.py:
//   _wsweep_kernel (K6)                 -> wsweep_kernel
//   _wsweep_chunked_kernel (K7)         -> wsweep_chunked_kernel
//   _wsweep_1flip_kernel (K8a)          -> wsweep_1flip_kernel
//   _wsweep_1flip_chunked_kernel (K8b)  -> wsweep_1flip_chunked_kernel
//
// Weights |w| < 2^15 split into K <= 15 binary planes, positive and, on a
// graph with negative weights, negative. Per step k of sweep s (node
// nodes[k], descending degree), with e the `earlier` row (nodes before k):
//   first sweep: nbr = sum_b 2^b [(2 pc(x & pos_b) - pc(x & e & pos_b)) - (the same for neg_b)]
//   later:       nbr = sum_b 2^b [pc(x & pos_b) - pc(x & neg_b)]
// and x_i = (nbr + u16 * scale < thr[k]). As in K4 the compare uses
// __fadd_rn/__fmul_rn (the library builds with -fmad=false), so it rounds
// like the f32 multiply-then-add of the plain version and of JAX, and the
// noise is K4's: injected [S*N, B], or draw t = s*N + k of each chain from
// Philox under (seed, kTagSweep). So on a {0, +-1} graph these sweeps give
// K4's bits. The 1-flip sweep visits nodes in ascending order with
// P = sum_b 2^b (pc(x & pos_b) - pc(x & neg_b)), cut = x_i ? wdeg_i - P : P,
// and flips when wdeg_i - 2 cut > 0 (wdeg computed once with the planes, as
// K5's degrees are).
//
// What bounds them on an H100, as built: popcounts. Every step ANDs and
// popcounts each word of each chain against the node's rows: 4K popcounts
// per word in the first sweep of a signed graph, 2K later (K = 3: 12 and 6,
// twice and six times K4's), at 16 per clock per SM, a quarter of the
// integer rate. The function needs a popcount only where a row word is
// non-zero: 8.7% of a plane's words on W22-like, 0.18% on W70-like (about
// two neighbours per row), and chip_smoke.py's bound counts that, with each
// warp reading every row word once. So on sparse graphs these kernels do
// mostly work on zero words; skipping them is the lever, not the popcount
// rate. As in
// K4, one thread runs one chain, a block keeps its chains in shared memory
// (odd word stride) for the whole call, device memory sees the chains once,
// and the rows, the same for every chain, are read as warp broadcasts.
//   K6 and K8a read the rows in place through L1/L2 (__ldg): for tables that
//   stay in L2 (the rule is in ops/kernels/engine.py).
//   K7 and K8b are for tables beyond L2, where an in-place read would wait
//   on device memory at every step with few warps to cover it. The block
//   copies `chunk` rows of every plane into shared memory with cp.async, two
//   stages deep, so the next chunk arrives while this one is swept. Shared
//   memory is split between the chain tile and the stages: chains_per_block
//   fits the largest tile of 128, 64 or 32 chains beside 2 x P x chunk x W
//   words. At N = 10000 (W = 313) with P = 7 planes and chunk = 4 that is 128
//   chains (160 KB) and 70 KB of stages: one block, four warps, per SM.
// The TPU's chunked kernel reseeded its PRNG per grid cell; here a draw is
// keyed by (seed, chain, t) whatever the chunk, so K7 gives K6's bits.
#include <cuda_pipeline.h>

#include "common.cuh"

namespace {

constexpr int kMaxPlanes = 15;

template <bool kGlobal>
__device__ __forceinline__ uint32_t row_word(const uint32_t* p) {
  if constexpr (kGlobal) {
    return __ldg(p);
  } else {
    return *p;
  }
}

// Signed weighted popcount of one chain against one node's rows. `pos` is
// the node's row of positive plane 0; positive plane b's row is at
// pos + b * pstride, negative plane b's at pos + (K + b) * pstride.
// kFirst: the first sweep's mixed domain, with `e` the node's earlier row.
template <int K, bool kSigned, bool kFirst, bool kGlobal>
__device__ __forceinline__ int weighted_sum(const uint32_t* my, const uint32_t* e, const uint32_t* pos,
                                            size_t pstride, int W) {
  int acc[K];
#pragma unroll
  for (int b = 0; b < K; ++b) acc[b] = 0;
  for (int j = 0; j < W; ++j) {
    const uint32_t x = my[j];
    const uint32_t xe = kFirst ? x & row_word<kGlobal>(e + j) : 0u;
#pragma unroll
    for (int b = 0; b < K; ++b) {
      const uint32_t m = row_word<kGlobal>(pos + b * pstride + j);
      acc[b] += kFirst ? 2 * __popc(x & m) - __popc(xe & m) : __popc(x & m);
      if (kSigned) {
        const uint32_t mn = row_word<kGlobal>(pos + (K + b) * pstride + j);
        acc[b] -= kFirst ? 2 * __popc(x & mn) - __popc(xe & mn) : __popc(x & mn);
      }
    }
  }
  int s = 0;
#pragma unroll
  for (int b = 0; b < K; ++b) s += acc[b] << b;
  return s;
}

struct SweepArgs {
  const int32_t* nodes;  // [N] node of each step
  const float* thr1;     // [N] first-sweep thresholds, noise_scale / 2 included
  const float* thr2;     // [N] later-sweep thresholds
  const uint32_t* planes;  // [P, N, W]: earlier, K positive, K negative if signed
  const int32_t* noise;  // [S * N, B] injected u16, or null with use_prng
  uint32_t seed;
  float scale;  // noise_scale / 65536
  int use_prng;
  uint32_t* words;  // [B, W] chains, updated in place
  int B, W, N, S;
};

// Step sk = s * N + k of one chain; `e` and `pos` as in weighted_sum.
template <int K, bool kSigned, bool kGlobal>
__device__ __forceinline__ void sweep_step(uint32_t* my, int sk, int k, const uint32_t* e, const uint32_t* pos,
                                           size_t pstride, const SweepArgs& a, uint4& d, long long chain) {
  const bool first = sk < a.N;
  const int nbr = first ? weighted_sum<K, kSigned, true, kGlobal>(my, e, pos, pstride, a.W)
                        : weighted_sum<K, kSigned, false, kGlobal>(my, e, pos, pstride, a.W);
  const float thr = __ldg((first ? a.thr1 : a.thr2) + k);
  const uint32_t u16 = rl::sweep_u16(a.use_prng, d, sk, chain, a.seed, a.noise, a.B);
  const float lhs = __fadd_rn(static_cast<float>(nbr), __fmul_rn(static_cast<float>(u16), a.scale));
  rl::set_bit(my, __ldg(a.nodes + k), lhs < thr);
}

// One greedy 1-flip step at node i; `pos` as in weighted_sum.
template <int K, bool kSigned, bool kGlobal>
__device__ __forceinline__ void flip_step(uint32_t* my, int i, const uint32_t* pos, size_t pstride, int W,
                                          int wdeg) {
  const int p = weighted_sum<K, kSigned, false, kGlobal>(my, nullptr, pos, pstride, W);
  const uint32_t cur = (my[i >> 5] >> (i & 31)) & 1u;
  const int cut = cur ? wdeg - p : p;  // weight to the other side
  if (wdeg - 2 * cut > 0) my[i >> 5] ^= 1u << (i & 31);  // strict improvement
}

// Starts the asynchronous copy of rows [c0, c0 + rows) of planes [p0, P)
// into a stage laid out [P, chunk, W], as one committed batch.
__device__ __forceinline__ void stage_rows(uint32_t* stage, const uint32_t* __restrict__ planes, int p0,
                                           int P, int N, int W, int c0, int rows, int chunk) {
  const int per_plane = rows * W;
  for (int i = threadIdx.x; i < (P - p0) * per_plane; i += blockDim.x) {
    const int q = i / per_plane, r = i - q * per_plane;
    const int p = p0 + q;
    __pipeline_memcpy_async(stage + (size_t)p * chunk * W + r, planes + ((size_t)p * N + c0) * W + r,
                            sizeof(uint32_t));
  }
  __pipeline_commit();
}

template <int K, bool kSigned>
__global__ void wsweep_kernel(const SweepArgs a) {
  extern __shared__ uint32_t sm[];
  const long long b0 = (long long)blockIdx.x * blockDim.x;
  const int nb = min((long long)blockDim.x, a.B - b0);
  rl::load_chains(sm, a.words, b0, nb, a.W);
  if (threadIdx.x < nb) {
    uint32_t* my = sm + threadIdx.x * rl::smem_stride(a.W);
    const size_t pstride = (size_t)a.N * a.W;
    uint4 d = make_uint4(0u, 0u, 0u, 0u);
    for (int sk = 0; sk < a.S * a.N; ++sk) {
      const int k = sk % a.N;
      const uint32_t* e = a.planes + (size_t)k * a.W;
      sweep_step<K, kSigned, true>(my, sk, k, e, e + pstride, pstride, a, d, b0 + threadIdx.x);
    }
  }
  rl::store_chains(sm, a.words, b0, nb, a.W);
}

template <int K, bool kSigned>
__global__ void wsweep_chunked_kernel(const SweepArgs a, int chunk) {
  constexpr int P = 1 + (kSigned ? 2 : 1) * K;
  extern __shared__ uint32_t sm[];
  const int W = a.W, N = a.N;
  const long long b0 = (long long)blockIdx.x * blockDim.x;
  const int nb = min((long long)blockDim.x, a.B - b0);
  uint32_t* stages = sm + (size_t)blockDim.x * rl::smem_stride(W);
  const size_t stage_words = (size_t)P * chunk * W, pstride = (size_t)chunk * W;
  const int nchunks = (N + chunk - 1) / chunk, total = a.S * nchunks;
  auto fetch = [&](int g) {  // chunk g of all sweeps; the earlier plane only in the first
    const int c0 = (g % nchunks) * chunk;
    stage_rows(stages + (g & 1) * stage_words, a.planes, g < nchunks ? 0 : 1, P, N, W, c0, min(chunk, N - c0),
               chunk);
  };
  fetch(0);
  rl::load_chains(sm, a.words, b0, nb, W);
  uint32_t* my = sm + threadIdx.x * rl::smem_stride(W);
  uint4 d = make_uint4(0u, 0u, 0u, 0u);
  for (int g = 0; g < total; ++g) {
    if (g + 1 < total) {
      fetch(g + 1);  // into the stage that chunk g - 1 used
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();  // chunk g is in shared memory for every thread
    if (threadIdx.x < nb) {
      const uint32_t* st = stages + (g & 1) * stage_words;
      const int s = g / nchunks, c0 = (g % nchunks) * chunk, rows = min(chunk, N - c0);
      for (int r = 0; r < rows; ++r)
        sweep_step<K, kSigned, false>(my, s * N + c0 + r, c0 + r, st + r * W, st + pstride + r * W, pstride, a, d,
                                      b0 + threadIdx.x);
    }
    __syncthreads();  // every thread is done with chunk g's stage
  }
  rl::store_chains(sm, a.words, b0, nb, W);
}

struct FlipArgs {
  const uint32_t* planes;  // [P, N, W]: K positive, K negative if signed
  const int32_t* wdeg;     // [N] integer weighted degrees
  uint32_t* words;         // [B, W] chains, updated in place
  int B, W, N;
};

template <int K, bool kSigned>
__global__ void wsweep_1flip_kernel(const FlipArgs a) {
  extern __shared__ uint32_t sm[];
  const long long b0 = (long long)blockIdx.x * blockDim.x;
  const int nb = min((long long)blockDim.x, a.B - b0);
  rl::load_chains(sm, a.words, b0, nb, a.W);
  if (threadIdx.x < nb) {
    uint32_t* my = sm + threadIdx.x * rl::smem_stride(a.W);
    const size_t pstride = (size_t)a.N * a.W;
    for (int i = 0; i < a.N; ++i)
      flip_step<K, kSigned, true>(my, i, a.planes + (size_t)i * a.W, pstride, a.W, __ldg(a.wdeg + i));
  }
  rl::store_chains(sm, a.words, b0, nb, a.W);
}

template <int K, bool kSigned>
__global__ void wsweep_1flip_chunked_kernel(const FlipArgs a, int chunk) {
  constexpr int P = (kSigned ? 2 : 1) * K;
  extern __shared__ uint32_t sm[];
  const int W = a.W, N = a.N;
  const long long b0 = (long long)blockIdx.x * blockDim.x;
  const int nb = min((long long)blockDim.x, a.B - b0);
  uint32_t* stages = sm + (size_t)blockDim.x * rl::smem_stride(W);
  const size_t stage_words = (size_t)P * chunk * W, pstride = (size_t)chunk * W;
  const int nchunks = (N + chunk - 1) / chunk;
  auto fetch = [&](int g) {
    const int c0 = g * chunk;
    stage_rows(stages + (g & 1) * stage_words, a.planes, 0, P, N, W, c0, min(chunk, N - c0), chunk);
  };
  fetch(0);
  rl::load_chains(sm, a.words, b0, nb, W);
  uint32_t* my = sm + threadIdx.x * rl::smem_stride(W);
  for (int g = 0; g < nchunks; ++g) {
    if (g + 1 < nchunks) {
      fetch(g + 1);
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();
    if (threadIdx.x < nb) {
      const uint32_t* st = stages + (g & 1) * stage_words;
      const int c0 = g * chunk, rows = min(chunk, N - c0);
      for (int r = 0; r < rows; ++r)
        flip_step<K, kSigned, false>(my, c0 + r, st + r * W, pstride, W, __ldg(a.wdeg + c0 + r));
    }
    __syncthreads();
  }
  rl::store_chains(sm, a.words, b0, nb, W);
}

// One instantiation per plane count K = 1..15 and sign, picked at launch.
#define RL_BY_K(kern, sgn)                                                                              \
  {                                                                                                     \
    kern<1, sgn>, kern<2, sgn>, kern<3, sgn>, kern<4, sgn>, kern<5, sgn>, kern<6, sgn>, kern<7, sgn>, \
        kern<8, sgn>, kern<9, sgn>, kern<10, sgn>, kern<11, sgn>, kern<12, sgn>, kern<13, sgn>,       \
        kern<14, sgn>, kern<15, sgn>                                                                    \
  }

using SweepFn = void (*)(SweepArgs);
using SweepChunkedFn = void (*)(SweepArgs, int);
using FlipFn = void (*)(FlipArgs);
using FlipChunkedFn = void (*)(FlipArgs, int);

const SweepFn kSweep[2][kMaxPlanes] = {RL_BY_K(wsweep_kernel, false), RL_BY_K(wsweep_kernel, true)};
const SweepChunkedFn kSweepChunked[2][kMaxPlanes] = {RL_BY_K(wsweep_chunked_kernel, false),
                                                     RL_BY_K(wsweep_chunked_kernel, true)};
const FlipFn kFlip[2][kMaxPlanes] = {RL_BY_K(wsweep_1flip_kernel, false), RL_BY_K(wsweep_1flip_kernel, true)};
const FlipChunkedFn kFlipChunked[2][kMaxPlanes] = {RL_BY_K(wsweep_1flip_chunked_kernel, false),
                                                   RL_BY_K(wsweep_1flip_chunked_kernel, true)};

template <typename Fn>
Fn by_planes(const Fn (&table)[2][kMaxPlanes], int k, int is_signed) {
  return (k >= 1 && k <= kMaxPlanes) ? table[is_signed ? 1 : 0][k - 1] : nullptr;
}

// Launches kernel(args..., [chunk]) over ceil(B / threads) blocks of the
// largest chain tile that fits beside `extra` bytes of stages.
template <typename Fn, typename... Args>
cudaError_t launch(Fn kernel, int B, int W, size_t extra, cudaStream_t st, Args... args) {
  if (kernel == nullptr) return cudaErrorInvalidValue;
  int threads;
  size_t smem;
  cudaError_t e = rl::prepare(kernel, W, &threads, &smem, extra);
  if (e != cudaSuccess) return e;
  if (B > 0) kernel<<<(B + threads - 1) / threads, threads, smem, st>>>(args...);
  return cudaGetLastError();
}

SweepArgs sweep_args(const int32_t* nodes, const float* thr1, const float* thr2, const int32_t* planes,
                     const int32_t* noise, int use_prng, uint32_t seed, float scale, int32_t* words, int B, int W,
                     int N, int S) {
  return SweepArgs{nodes, thr1, thr2, reinterpret_cast<const uint32_t*>(planes), noise, seed, scale, use_prng,
                   reinterpret_cast<uint32_t*>(words), B, W, N, S};
}

}  // namespace

extern "C" int wsweep(const int32_t* nodes, const float* thr1, const float* thr2, const int32_t* planes, int k,
                      int is_signed, const int32_t* noise, int use_prng, uint32_t seed, float scale, int32_t* words,
                      int B, int W, int N, int S, cudaStream_t st) {
  const SweepArgs a = sweep_args(nodes, thr1, thr2, planes, noise, use_prng, seed, scale, words, B, W, N, S);
  return launch(by_planes(kSweep, k, is_signed), B, W, 0, st, a);
}

extern "C" int wsweep_chunked(const int32_t* nodes, const float* thr1, const float* thr2, const int32_t* planes,
                              int k, int is_signed, const int32_t* noise, int use_prng, uint32_t seed, float scale,
                              int32_t* words, int B, int W, int N, int S, int chunk, cudaStream_t st) {
  if (chunk < 1) return cudaErrorInvalidValue;
  chunk = min(chunk, N);
  const SweepArgs a = sweep_args(nodes, thr1, thr2, planes, noise, use_prng, seed, scale, words, B, W, N, S);
  const size_t stages = 2 * (size_t)(1 + (is_signed ? 2 : 1) * k) * chunk * W * sizeof(uint32_t);
  return launch(by_planes(kSweepChunked, k, is_signed), B, W, stages, st, a, chunk);
}

extern "C" int wsweep_1flip(const int32_t* planes, const int32_t* wdeg, int k, int is_signed, int32_t* words,
                            int B, int W, int N, cudaStream_t st) {
  const FlipArgs a{reinterpret_cast<const uint32_t*>(planes), wdeg, reinterpret_cast<uint32_t*>(words), B, W, N};
  return launch(by_planes(kFlip, k, is_signed), B, W, 0, st, a);
}

extern "C" int wsweep_1flip_chunked(const int32_t* planes, const int32_t* wdeg, int k, int is_signed,
                                    int32_t* words, int B, int W, int N, int chunk, cudaStream_t st) {
  if (chunk < 1) return cudaErrorInvalidValue;
  chunk = min(chunk, N);
  const FlipArgs a{reinterpret_cast<const uint32_t*>(planes), wdeg, reinterpret_cast<uint32_t*>(words), B, W, N};
  const size_t stages = 2 * (size_t)((is_signed ? 2 : 1) * k) * chunk * W * sizeof(uint32_t);
  return launch(by_planes(kFlipChunked, k, is_signed), B, W, stages, st, a, chunk);
}
