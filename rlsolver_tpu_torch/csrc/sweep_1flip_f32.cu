// Greedy 1-flip sweep with f32 incremental gains, for any f32 weights.
//
// Replaces rlsolver_tpu/ops/pallas/sweep_kernel.py:_sweep_kernel (K10, f32
// adjacency rows by DMA) and :_sweep_kernel_vmem (the same sweep with a bf16
// adjacency resident in VMEM). Per node i in ascending order, each chain
// accepts the flip when its gain g_i > 0 and then updates every gain by the
// rank-1 term of row i:
//   g_j += ((-2 (s_i * accept)) * s_j) * A[i, j],   g_i <- -g_i,
//   s_i <- -s_i,   vs += g_i,
// rounding each product and the sum once, as the plain PyTorch loop does
// (__fmul_rn/__fadd_rn, and the library builds with -fmad=false). The
// products are exact (factors +-2, +-1), so only the add rounds: one
// __fmaf_rn(c * s_j, A[i, j], g_j) would give the same bits (unless 2 A[i, j]
// overflows f32), and the explicit roundings are not what keeps K10 exact.
//
// What bounds it on an H100: node i's decision depends on every flip at
// nodes < i, so a chain walks its N nodes in order. A step whose gain is not
// positive changes nothing (the rank-1 term is +-0), so the work the data
// needs is N f32 FMAs per accepted flip, plus a compare per (chain, node);
// the bytes are the adjacency once and the state in and out. One warp runs
// one chain: its gains live in shared memory (N floats) and its signs as
// bits (W words), so a step that rejects is a broadcast read and a compare
// with no barrier, and an accepted step streams row i of the adjacency (the
// same row for every chain, so it comes from L2 at N = 2000: 16 MB) across
// the 32 lanes, each lane updating the gains j = lane + 32 k with the sign
// bit `lane` of word k. A block holds a few chains; nothing is shared
// between them, so every warp reads its accepted rows from L2 on its own
// (4 N bytes per accepted flip), which likely keeps this kernel far from
// its bound (chip_smoke.py prints the rate of these reads).
//
// The TPU kernels reached column i through one-hot masks over the whole
// [block, N] state, because Mosaic cannot index the lane axis dynamically;
// here column i is one shared-memory word. They also updated every chain at
// every node; here a warp skips the update where its chain rejects, which
// leaves every value as the plain loop computes it (adding +-0 to a gain
// changes at most the sign of a zero gain, and no decision reads that sign).
#include "common.cuh"

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ float sign_of(const uint32_t* bits, int j) {
  return (bits[j >> 5] >> (j & 31)) & 1u ? 1.0f : -1.0f;
}

// adj [N, N] f32; s_io, g_io [B, N] f32 (s is +-1); vs_io [B] f32; all
// updated in place. Shared memory per warp: N gains, then W sign words.
__global__ void sweep_1flip_f32_kernel(const float* __restrict__ adj, float* __restrict__ s_io,
                                       float* __restrict__ g_io, float* __restrict__ vs_io, int B, int N) {
  extern __shared__ uint32_t sm[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long b = (long long)blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= B) return;  // the whole warp: the kernel has no block-wide barrier
  const int W = (N + 31) >> 5;
  float* g = reinterpret_cast<float*>(sm + (size_t)warp * (N + W));
  uint32_t* sb = sm + (size_t)warp * (N + W) + N;  // bit set: s = +1
  float* g_row = g_io + b * N;
  float* s_row = s_io + b * N;
  for (int j = lane; j < N; j += 32) g[j] = g_row[j];
  for (int k = 0; k < W; ++k) {
    const int j = 32 * k + lane;
    const uint32_t m = __ballot_sync(kFull, j < N && s_row[j] > 0.0f);
    if (lane == 0) sb[k] = m;
  }
  __syncwarp();
  float vs = vs_io[b];
  for (int i = 0; i < N; ++i) {
    const float gi = g[i];  // every lane reads the same word
    if (gi > 0.0f) {        // the same decision in every lane
      const float c = __fmul_rn(-2.0f, __fmul_rn(sign_of(sb, i), 1.0f));  // -2 (s_i * accept)
      __syncwarp();  // g[i] and the sign bits are read before any lane writes
      const float* row = adj + (size_t)i * N;
      for (int k = 0, j = lane; j < N; ++k, j += 32) {
        const float sj = (sb[k] >> lane) & 1u ? 1.0f : -1.0f;
        g[j] = __fadd_rn(g[j], __fmul_rn(__fmul_rn(c, sj), __ldg(row + j)));
      }
      __syncwarp();
      if (lane == 0) {
        g[i] = -gi;
        sb[i >> 5] ^= 1u << (i & 31);
      }
      __syncwarp();
      vs = __fadd_rn(vs, gi);
    } else {
      vs = __fadd_rn(vs, 0.0f);  // as the plain loop adds where(accept, g_i, 0)
    }
  }
  for (int j = lane; j < N; j += 32) {
    g_row[j] = g[j];
    s_row[j] = sign_of(sb, j);
  }
  if (lane == 0) vs_io[b] = vs;
}

}  // namespace

extern "C" int sweep_1flip_f32(const float* adj, float* s, float* gains, float* vs, int B, int N, cudaStream_t st) {
  const size_t per_chain = (size_t)(N + (N + 31) / 32) * sizeof(uint32_t);
  int warps = kWarpsPerBlock;
  while (warps > 1 && warps * per_chain > rl::kMaxSmem) warps /= 2;
  const size_t smem = warps * per_chain;
  if (smem > rl::kMaxSmem) return cudaErrorInvalidValue;  // N beyond about 56,000 nodes
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(sweep_1flip_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  if (B > 0 && N > 0)
    sweep_1flip_f32_kernel<<<(B + warps - 1) / warps, 32 * warps, smem, st>>>(adj, s, gains, vs, B, N);
  return cudaGetLastError();
}
