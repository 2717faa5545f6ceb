// Shared pieces of the bit-packed chain kernels.
//
// Layout: chains are int32 words [B, W], W = ceil(N / 32), node i in word
// i >> 5 at bit i & 31; bit work is done on uint32_t so shifts are logical.
// Each kernel runs one thread per chain and keeps a block's chains in shared
// memory for the whole call: the block's rows are one contiguous run of
// global memory, loaded and stored coalesced, and a chain's words sit at an
// odd stride so that threads reading the same word index hit distinct banks.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace rl {

// Plain integer literals: ops/kernels/build.py reads these two for the
// engine's chunk sizing (`header_constant`).
constexpr int kChainsPerBlock = 128;
constexpr size_t kMaxSmem = 232448;  // 227 KB, the dynamic shared memory a block may use on an H100

__host__ __device__ inline int smem_stride(int W) { return W | 1; }

// Copies the block's chains between global [B, W] and shared memory. Each
// thread issues kInFlight loads before it stores any, so that a block whose
// threads have many words each need not wait out a device-memory latency
// per word.
template <int kInFlight = 1>
__device__ inline void load_chains(uint32_t* sm, const uint32_t* __restrict__ words,
                                   long long b0, int nb, int W) {
  const int stride = smem_stride(W);
  const uint32_t* src = words + b0 * W;
  for (int i0 = threadIdx.x; i0 < nb * W; i0 += kInFlight * blockDim.x) {
    uint32_t v[kInFlight];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int i = i0 + u * blockDim.x;
      v[u] = i < nb * W ? src[i] : 0u;
    }
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int i = i0 + u * blockDim.x, c = i / W;
      if (i < nb * W) sm[c * stride + (i - c * W)] = v[u];
    }
  }
  __syncthreads();
}

__device__ inline void store_chains(const uint32_t* sm, uint32_t* __restrict__ words,
                                    long long b0, int nb, int W) {
  __syncthreads();
  const int stride = smem_stride(W);
  uint32_t* dst = words + b0 * W;
  for (int i = threadIdx.x; i < nb * W; i += blockDim.x) {
    const int c = i / W;
    dst[i] = sm[c * stride + (i - c * W)];
  }
}

// Philox4x32-10 (Salmon et al., SC'11). Draw t of chain c under key
// (seed, tag) is word t & 3 of philox(counter = (t >> 2, c, 0, 0)); the
// plain twin is rlsolver_tpu_torch/ops/kernels/philox.py.
__device__ inline uint4 philox4x32_10(uint4 c, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x), lo0 = 0xD2511F53u * c.x;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z), lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

__device__ inline uint32_t pick(const uint4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

constexpr uint32_t kTagMH = 0x4D48u;
constexpr uint32_t kTagSweep = 0x5357u;

// The u16 noise of sweep step t = s * N + k of a chain: injected
// (noise [S * N, B]) or word t & 3 of Philox under (seed, kTagSweep), where
// `d` carries the block of draws t & ~3 between calls (t rises from 0).
__device__ __forceinline__ uint32_t sweep_u16(bool prng, uint4& d, int t, long long chain, uint32_t seed,
                                              const int32_t* __restrict__ noise, int B) {
  if (prng) {
    if ((t & 3) == 0) d = philox4x32_10(make_uint4(t >> 2, (uint32_t)chain, 0u, 0u), seed, kTagSweep);
    return pick(d, t & 3) & 0xFFFFu;
  }
  return static_cast<uint32_t>(__ldg(noise + (long long)t * B + chain));
}

// The noisy sweep's bit: nbr + u16 * scale < thr, rounded as the f32
// multiply-then-add of the plain version and of JAX (the library builds
// with -fmad=false, and nbr is an exact integer).
__device__ __forceinline__ bool sweep_decide(int nbr, uint32_t u16, float scale, float thr) {
  return __fadd_rn(static_cast<float>(nbr), __fmul_rn(static_cast<float>(u16), scale)) < thr;
}

__device__ __forceinline__ void set_bit(uint32_t* my, int node, bool v) {
  const uint32_t m = 1u << (node & 31);
  my[node >> 5] = v ? (my[node >> 5] | m) : (my[node >> 5] & ~m);
}

// Threads per block and dynamic shared memory for a chain tile of W words
// plus `extra` bytes (a kernel's staging buffers), or 0 threads when even
// 32 chains do not fit.
inline int chains_per_block(int W, size_t* smem, size_t extra = 0) {
  int t = kChainsPerBlock;
  while (t >= 32) {
    *smem = (size_t)t * smem_stride(W) * sizeof(uint32_t) + extra;
    if (*smem <= kMaxSmem) return t;
    t /= 2;
  }
  return 0;
}

// Allows `smem` bytes of dynamic shared memory for `kernel` where it is
// above the 48 KB that needs no opt-in.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem > 48 * 1024) return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  return cudaSuccess;
}

template <typename K>
inline cudaError_t prepare(K kernel, int W, int* threads, size_t* smem, size_t extra = 0) {
  *threads = chains_per_block(W, smem, extra);
  if (*threads == 0) return cudaErrorInvalidValue;
  return allow_smem(kernel, *smem);
}

// Hopper's bulk copies (the TMA unit) from device memory into shared memory,
// completing on an mbarrier in shared memory. One thread issues a copy and
// the barrier counts its bytes; waiting threads spin on the barrier's phase.
// Addresses and sizes of a copy are multiples of 16 bytes.
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Sets up a barrier that completes a phase after `count` arrivals (and the
// bytes any arrival announced); by one thread, before a __syncthreads.
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Arrives on the barrier and announces `bytes` more to come from copies.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// Waits until the phase of parity `parity` has completed (phases count from
// 0, so the k-th use of a barrier waits for parity k & 1).
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// Copies `bytes` from device memory to shared memory; the barrier counts
// them when they have landed.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes), "r"(smem_addr(bar))
               : "memory");
}

}  // namespace rl

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
