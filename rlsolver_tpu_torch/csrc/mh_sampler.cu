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
// node is indexed directly. K11 and K12 read 8 bytes per proposal (node and
// u, or node and acc2), coalesced across a warp's chains. They take the
// common tile of 128 chains: neither 32 nor 64 beat it by more than 3% at
// 8192-131072 chains (scripts/torch_mh_tile.py).
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

// K11: nodes [R, B] int32, u [R, B] f32, probs [N] f32. A node outside
// [0, N) is a no-op, as in the one-hot TPU kernel.
__global__ void mh_onehot_kernel(const int32_t* __restrict__ nodes, const float* __restrict__ u,
                                 const float* __restrict__ probs, uint32_t* __restrict__ words,
                                 int B, int W, int N, int R) {
  extern __shared__ uint32_t sm[];
  const long long b0 = (long long)blockIdx.x * blockDim.x;
  const int nb = min((long long)blockDim.x, B - b0);
  rl::load_chains(sm, words, b0, nb, W);
  if (threadIdx.x < nb) {
    uint32_t* my = sm + threadIdx.x * rl::smem_stride(W);
    const long long chain = b0 + threadIdx.x;
#pragma unroll 4
    for (int r = 0; r < R; ++r) {
      const uint32_t node = static_cast<uint32_t>(__ldg(nodes + (long long)r * B + chain));
      const float uu = __ldg(u + (long long)r * B + chain);
      if (node >= (uint32_t)N) continue;
      const uint32_t word = node >> 5, bit = node & 31u;
      const float p = __ldg(probs + node);
      // q = P(current value); accept when u q < 1 - q, rounded as in f32
      const float q = (my[word] >> bit) & 1u ? p : __fsub_rn(1.0f, p);
      if (__fmul_rn(uu, q) < __fsub_rn(1.0f, q)) my[word] ^= 1u << bit;
    }
  }
  rl::store_chains(sm, words, b0, nb, W);
}

// K12: nodes [R, B] int32, acc2 [R, B] int32 (bit c = accept given bit c).
__global__ void mh_packed_kernel(const int32_t* __restrict__ nodes, const int32_t* __restrict__ acc2,
                                 uint32_t* __restrict__ words, int B, int W, int N, int R) {
  extern __shared__ uint32_t sm[];
  const long long b0 = (long long)blockIdx.x * blockDim.x;
  const int nb = min((long long)blockDim.x, B - b0);
  rl::load_chains(sm, words, b0, nb, W);
  if (threadIdx.x < nb) {
    uint32_t* my = sm + threadIdx.x * rl::smem_stride(W);
    const long long chain = b0 + threadIdx.x;
#pragma unroll 4
    for (int r = 0; r < R; ++r) {
      const uint32_t node = static_cast<uint32_t>(__ldg(nodes + (long long)r * B + chain));
      const uint32_t a = static_cast<uint32_t>(__ldg(acc2 + (long long)r * B + chain));
      if (node < (uint32_t)N) flip_by_acc2(my, node >> 5, node & 31u, a);
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

extern "C" int mh_onehot(const int32_t* nodes, const float* u, const float* probs, int32_t* words, int B, int W,
                         int N, int R, cudaStream_t st) {
  int threads;
  size_t smem;
  cudaError_t e = rl::prepare(mh_onehot_kernel, W, &threads, &smem);
  if (e != cudaSuccess) return e;
  if (B > 0)
    mh_onehot_kernel<<<(B + threads - 1) / threads, threads, smem, st>>>(
        nodes, u, probs, reinterpret_cast<uint32_t*>(words), B, W, N, R);
  return cudaGetLastError();
}

extern "C" int mh_packed(const int32_t* nodes, const int32_t* acc2, int32_t* words, int B, int W, int N, int R,
                         cudaStream_t st) {
  int threads;
  size_t smem;
  cudaError_t e = rl::prepare(mh_packed_kernel, W, &threads, &smem);
  if (e != cudaSuccess) return e;
  if (B > 0)
    mh_packed_kernel<<<(B + threads - 1) / threads, threads, smem, st>>>(
        nodes, acc2, reinterpret_cast<uint32_t*>(words), B, W, N, R);
  return cudaGetLastError();
}
