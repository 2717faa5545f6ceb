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
// positive changes nothing (the rank-1 term is +-0), and on an accepted step
// only the non-zero A[i, j] change a gain: the work the data needs is one
// f32 FMA per listed neighbour of each accepted flip, plus a compare per
// (chain, node); the bytes are the state in and out and the lists. One warp
// runs one chain: its gains live in shared memory (N floats) and its signs
// as bits (W words), so a step that rejects is a broadcast read and a
// compare with no barrier. An accepted step splits row i's neighbour list
// (F32AdjLists: {j, A_ij} in ascending j, built from the dense adjacency, so
// each weight is A[i, j] bit for bit) across the 32 lanes, 32 entries at a
// time; j is distinct within a row, so no two lanes write one gain. Each
// gain receives the same non-zero terms in the same order as the dense
// update over every j. The list bounds are loaded 32 rows ahead and read
// back by a shuffle. What is left is the latency of each warp's 2000
// dependent steps and of its accepted rows' loads from L2, with about 16
// warps per SM at L2A's 2048 chains. Loading rows ahead did not pay: the
// next row's entries each step, the next four rows' in registers, or only
// those whose gain was positive four steps before, all ran slower than
// loading an accepted row's list at its step (scripts/torch_engine_share.py,
// PERF.md): they read rows the chain rejects, about two in three on
// G22-like.
//
// The TPU kernels reached column i through one-hot masks over the whole
// [block, N] state, because Mosaic cannot index the lane axis dynamically;
// here column i is one shared-memory word. They also updated every chain at
// every node and every gain of a row; here a warp skips the update where its
// chain rejects and the gains whose A[i, j] is zero, which leaves every
// value as the plain loop computes it (adding +-0 to a gain changes at most
// the sign of a zero gain, and no decision reads that sign).
#include "common.cuh"

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ float sign_of(const uint32_t* bits, int j) {
  return (bits[j >> 5] >> (j & 31)) & 1u ? 1.0f : -1.0f;
}

// g_j += (c * s_j) * A_ij for the entry q = {j, A_ij}, rounded as the plain loop
__device__ __forceinline__ void add_term(float* g, const uint32_t* sb, int2 q, float c) {
  g[q.x] = __fadd_rn(g[q.x], __fmul_rn(__fmul_rn(c, sign_of(sb, q.x)), __int_as_float(q.y)));
}

// offsets [N + 1]; entries [E] {j, A_ij as f32 bits}, ascending j within a
// row; s (+-1), gains [B, N] and vs [B] updated in place.
// Shared memory per warp: N gains, then W sign words.
__global__ void sweep_1flip_f32_kernel(const int32_t* __restrict__ offsets, const int2* __restrict__ entries,
                                       float* __restrict__ s_io, float* __restrict__ g_io, float* __restrict__ vs_io,
                                       int B, int N) {
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
  // the list bounds, 32 rows a window: lane l holds offsets[32 t + l] of
  // window t (cur) and t + 1 (nxt, loaded 32 rows before it is first read);
  // any lane reads them back by a shuffle
  int t = 0;
  int cur = __ldg(offsets + min(lane, N)), nxt = __ldg(offsets + min(32 + lane, N));
  for (int i = 0; i < N; ++i) {
    if (i > 0 && (i & 31) == 0) {
      ++t;
      cur = nxt;
      nxt = __ldg(offsets + min(32 * (t + 1) + lane, N));
    }
    const float gi = g[i];  // every lane reads the same word
    if (gi > 0.0f) {        // the same decision in every lane
      const float c = __fmul_rn(-2.0f, __fmul_rn(sign_of(sb, i), 1.0f));  // -2 (s_i * accept)
      const int e0 = __shfl_sync(kFull, cur, i & 31);
      const int e1 = __shfl_sync(kFull, (i + 1) >> 5 == t ? cur : nxt, (i + 1) & 31);
      __syncwarp();  // g[i] and the sign bits are read before any lane writes
      for (int e = e0 + lane; e < e1; e += 32) add_term(g, sb, __ldg(entries + e), c);
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

// entries [E, 2] int32, 8-byte aligned.
extern "C" int sweep_1flip_f32(const int32_t* offsets, const int32_t* entries, float* s, float* gains, float* vs,
                               int B, int N, cudaStream_t st) {
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
    sweep_1flip_f32_kernel<<<(B + warps - 1) / warps, 32 * warps, smem, st>>>(
        offsets, reinterpret_cast<const int2*>(entries), s, gains, vs, B, N);
  return cudaGetLastError();
}
