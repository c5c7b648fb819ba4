// Shared device helpers for the port's hand-written Hopper kernels.
//
// Every kernel here is fp32 in and fp32 out, and every weight is read in
// torch.nn.Linear layout (out_features, in_features), row-major.
//
// The matrix products inside the kernels use one pattern, "row blocks": a
// block stages P activation rows in shared memory, and each thread owns one
// output column j, reading row j of the weight as float4 and keeping P
// accumulators in registers.  That is plain SIMT work (no tensor cores, no
// TMA): simple and right first, fast in later work.
#pragma once

#include <cuda_runtime.h>

#define TRAMBA_CHECK_LAUNCH()                 \
  do {                                        \
    cudaError_t e__ = cudaGetLastError();     \
    if (e__ != cudaSuccess) return (int)e__;  \
  } while (0)

// Rows per block P in {32, 16, 8, 4, 2, 1}: the largest whose shared-memory
// tile of P rows of `floats_per_row` floats fits in `budget_bytes`, lowered
// until the M rows make at least one block per SM (132 on an H100), so that
// small maps still spread over the card.
static inline int rows_per_block(long M, long floats_per_row, long budget_bytes) {
  int p = 32;
  while (p > 1 && ((long)p * floats_per_row * 4 > budget_bytes || M < 132L * p)) p /= 2;
  return p;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// acc[p] = sum_k As[p * lda + k] * w[k] for p < P.
// As: shared memory, rows 16-byte aligned (lda % 4 == 0); w: one weight row in
// global memory, 16-byte aligned; Kd % 4 == 0.
template <int P>
__device__ __forceinline__ void rows_dot(const float* __restrict__ As, int lda,
                                         const float* __restrict__ w, int Kd,
                                         float acc[P]) {
#pragma unroll
  for (int p = 0; p < P; ++p) acc[p] = 0.f;
  const float4* w4 = reinterpret_cast<const float4*>(w);
  for (int k4 = 0; k4 < Kd / 4; ++k4) {
    const float4 b = __ldg(w4 + k4);
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const float4 a = reinterpret_cast<const float4*>(As + p * lda)[k4];
      acc[p] = fmaf(a.x, b.x, acc[p]);
      acc[p] = fmaf(a.y, b.y, acc[p]);
      acc[p] = fmaf(a.z, b.z, acc[p]);
      acc[p] = fmaf(a.w, b.w, acc[p]);
    }
  }
}

// Copy rows [m0, m0 + P) of a row-major (M, K) global matrix into shared
// memory (row stride K), zero-filling rows past M.  K % 4 == 0.
template <int P>
__device__ __forceinline__ void load_rows(const float* __restrict__ src, long M, int K,
                                          long m0, float* __restrict__ dst) {
  const int k4n = K / 4;
  float4* d4 = reinterpret_cast<float4*>(dst);
  for (int i = threadIdx.x; i < P * k4n; i += blockDim.x) {
    const int p = i / k4n, k4 = i - p * k4n;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (m0 + p < M) v = __ldg(reinterpret_cast<const float4*>(src + (m0 + p) * K) + k4);
    d4[i] = v;
  }
}

// LayerNorm statistics of one shared-memory row of n floats, computed by one
// warp (two passes: mean, then the mean of squared deviations).
__device__ __forceinline__ void warp_row_stats(const float* row, int n, float eps,
                                               float* mean, float* rstd) {
  const int lane = threadIdx.x & 31;
  float s = 0.f;
  for (int i = lane; i < n; i += 32) s += row[i];
  const float mu = warp_sum(s) / n;
  float q = 0.f;
  for (int i = lane; i < n; i += 32) {
    const float d = row[i] - mu;
    q = fmaf(d, d, q);
  }
  *mean = mu;
  *rstd = rsqrtf(warp_sum(q) / n + eps);
}

__device__ __forceinline__ float gelu_exact(float x) {
  return 0.5f * x * (1.f + erff(x * 0.70710678118654752f));
}

constexpr long kRowBudget = 64 * 1024;  // shared-memory bytes for a block's row tile

#define TRAMBA_DISPATCH_P(P, ...)        \
  switch (P) {                           \
    case 32: { constexpr int kP = 32; __VA_ARGS__; } break; \
    case 16: { constexpr int kP = 16; __VA_ARGS__; } break; \
    case 8: { constexpr int kP = 8; __VA_ARGS__; } break;   \
    case 4: { constexpr int kP = 4; __VA_ARGS__; } break;   \
    case 2: { constexpr int kP = 2; __VA_ARGS__; } break;   \
    default: { constexpr int kP = 1; __VA_ARGS__; } break;  \
  }

// Sets the dynamic shared-memory limit of a kernel before its first launch.
template <typename Kern>
static inline cudaError_t allow_smem(Kern kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}
