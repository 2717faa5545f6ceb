// Metropolis-Hastings single-flip sampler on bit-packed chains.
//
// Replaces rlsolver_tpu/ops/pallas/mh_sampler.py:_mh_stream_kernel (K2,
// randomness streamed in) and :_mh_fused_kernel (K3, randomness drawn in
// the kernel). Per round each chain proposes flipping one node and accepts
// with probability min(1, (1-q)/q), q = P(current value of the node), so the
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
// __umulhi of a full 32-bit draw (see mh_fused).
#include "common.cuh"

namespace {

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
      const uint32_t cur = (my[word] >> bit) & 1u;
      my[word] ^= ((s >> cur) & 1u) << bit;
    }
  }
  rl::store_chains(sm, words, b0, nb, W);
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
