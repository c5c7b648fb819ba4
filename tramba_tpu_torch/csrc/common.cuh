// Shared device helpers for the port's hand-written Hopper kernels.
//
// Every weight is read in torch.nn.Linear layout (out_features, in_features),
// row-major.  Activations and weights are fp32 or bf16 (`__nv_bfloat16`);
// arithmetic is always fp32, and a bf16 result is rounded once, to nearest
// even (`__float2bfloat16_rn`, as jnp's astype), where the TPU kernel rounds.
//
// Two patterns for matrix products inside the kernels:
// * "row blocks" (K1-K4): a block stages P activation rows in shared memory
//   as fp32, and each thread owns one output column j, reading row j of the
//   weight 16 bytes at a time and keeping P accumulators in registers.  Plain
//   SIMT FMA work (no tensor cores, no TMA).
// * "wmma tiles" (K5-K7, bf16 only): bf16 operands in 16x16x16 tensor-core
//   fragments (nvcuda::wmma) with fp32 accumulation; A from shared memory, B
//   straight from the weight in global memory (L2-resident) and shared by up
//   to four m-tiles, C through a shared fp32 tile.  bf16 x bf16 products are exact in fp32, so only the
//   summation order differs from the TPU's fp32-accumulating MXU.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

using bf16 = __nv_bfloat16;

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

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float v) { return __float2bfloat16_rn(v); }

// v rounded to the precision of T, kept as fp32.
template <typename T>
__device__ __forceinline__ float round_to(float v) { return to_f32(from_f32<T>(v)); }

// 16 bytes of T from global memory as fp32: 4 floats or 8 bf16.
template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void load(const float* p, float (&v)[4]) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  }
};
template <>
struct Vec16<bf16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void load(const bf16* p, float (&v)[8]) {
    const uint4 a = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&a);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// acc[p] = sum_k As[p * lda + k] * w[k] for p < P.
// As: shared memory fp32, rows 16-byte aligned (lda % 4 == 0); w: one weight
// row of T in global memory, 16-byte aligned; Kd a multiple of 16 / sizeof(T).
template <int P, typename T>
__device__ __forceinline__ void rows_dot(const float* __restrict__ As, int lda,
                                         const T* __restrict__ w, int Kd, float acc[P]) {
  constexpr int N = Vec16<T>::N;
#pragma unroll
  for (int p = 0; p < P; ++p) acc[p] = 0.f;
  for (int kv = 0; kv < Kd / N; ++kv) {
    float b[N];
    Vec16<T>::load(w + kv * N, b);
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const float4* a4 = reinterpret_cast<const float4*>(As + p * lda + kv * N);
#pragma unroll
      for (int q = 0; q < N / 4; ++q) {
        const float4 a = a4[q];
        acc[p] = fmaf(a.x, b[4 * q], acc[p]);
        acc[p] = fmaf(a.y, b[4 * q + 1], acc[p]);
        acc[p] = fmaf(a.z, b[4 * q + 2], acc[p]);
        acc[p] = fmaf(a.w, b[4 * q + 3], acc[p]);
      }
    }
  }
}

// Copy rows [m0, m0 + P) of a row-major (M, K) global matrix of T into shared
// memory as fp32 (row stride K), zero-filling rows past M.  K a multiple of
// 16 / sizeof(T).
template <int P, typename T>
__device__ __forceinline__ void load_rows(const T* __restrict__ src, long M, int K, long m0,
                                          float* __restrict__ dst) {
  constexpr int N = Vec16<T>::N;
  const int kvn = K / N;
  for (int i = threadIdx.x; i < P * kvn; i += blockDim.x) {
    const int p = i / kvn, kv = i - p * kvn;
    float v[N];
    if (m0 + p < M) {
      Vec16<T>::load(src + (m0 + p) * K + kv * N, v);
    } else {
#pragma unroll
      for (int q = 0; q < N; ++q) v[q] = 0.f;
    }
    float4* d4 = reinterpret_cast<float4*>(dst + p * K + kv * N);
#pragma unroll
    for (int q = 0; q < N / 4; ++q) d4[q] = make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
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

__device__ __forceinline__ float softplus(float v) {
  // log(1 + e^v) = max(v, 0) + log1p(e^-|v|), as jax.nn.softplus computes it
  return fmaxf(v, 0.f) + log1pf(expf(-fabsf(v)));
}

constexpr long kRowBudget = 64 * 1024;  // shared-memory bytes for a block's row tile

// Steps per staged chunk of the SS2D scans and the carries' stride: K1
// (ss2d.cu) writes the state entering each chunk, K8 (ss2d_bwd.cu) recomputes
// a chunk's states from it.  The library exports it as ss2d_scan_chunk(), and
// the Python wrappers size the carries from that.  A warp stages a chunk with
// two pixel indices per lane, so a chunk is two warps' width of steps.
constexpr int kScanChunk = 64;
static_assert(kScanChunk == 64, "the staging in ss2d.cu / ss2d_bwd.cu holds 2 steps per lane");

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

// ---------------------------------------------------------------------------
// wmma tiles (bf16 in, fp32 accumulate)
// ---------------------------------------------------------------------------

namespace wm = nvcuda::wmma;

constexpr int kMmaGroup = 4;  // m-tiles that share one B fragment per k-step

// C (+)= A * B^T over all 16x16 tiles of an (Mt*16) x (Nt*16) output.  Work
// item t is one n-tile and a group of up to kMmaGroup m-tiles, whose
// accumulators a warp keeps in registers, so each B fragment is loaded once
// per k-step for the whole group; items go to warp t % nwarps, so a warp meets
// the same tiles on every call with the same Mt, Nt.
//   A: bf16, shared memory, row-major, lda % 8 == 0, 32-byte aligned rows;
//   B: bf16 weight rows B[n * ldb + k] in global memory (32-byte aligned);
//   C: fp32, shared memory, row-major, ldc % 4 == 0; read first when
//      `accumulate`, else the tiles start from 0.
// K % 16 == 0.  The caller synchronises the block around the call.
__device__ __forceinline__ void mma_tiles(const bf16* A, int lda, const bf16* __restrict__ B,
                                          long ldb, float* C, int ldc, int Mt, int Nt, int K,
                                          bool accumulate) {
  const int warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const int groups = (Mt + kMmaGroup - 1) / kMmaGroup;
  for (int t = warp; t < Nt * groups; t += nwarps) {
    const int nt = t % Nt, m0 = (t / Nt) * kMmaGroup;
    const int mn = min(kMmaGroup, Mt - m0);
    wm::fragment<wm::accumulator, 16, 16, 16, float> c[kMmaGroup];
#pragma unroll
    for (int i = 0; i < kMmaGroup; ++i) {
      if (i >= mn) break;
      float* cp = C + (m0 + i) * 16 * ldc + nt * 16;
      if (accumulate) {
        wm::load_matrix_sync(c[i], cp, ldc, wm::mem_row_major);
      } else {
        wm::fill_fragment(c[i], 0.f);
      }
    }
    const bf16* bp = B + (long)nt * 16 * ldb;
    for (int k = 0; k < K; k += 16) {
      wm::fragment<wm::matrix_b, 16, 16, 16, bf16, wm::col_major> b;
      wm::load_matrix_sync(b, bp + k, (unsigned)ldb);
#pragma unroll
      for (int i = 0; i < kMmaGroup; ++i) {
        if (i >= mn) break;
        wm::fragment<wm::matrix_a, 16, 16, 16, bf16, wm::row_major> a;
        wm::load_matrix_sync(a, A + (m0 + i) * 16 * lda + k, lda);
        wm::mma_sync(c[i], a, b, c[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < kMmaGroup; ++i) {
      if (i >= mn) break;
      wm::store_matrix_sync(C + (m0 + i) * 16 * ldc + nt * 16, c[i], ldc, wm::mem_row_major);
    }
  }
}

// Stage channels [k0, k0 + KC) of a halo tile of a (B, H, W, C) bf16 map in
// shared memory: row e < E*Ex of `dst` (stride ldd) is pixel
// (y0 + e / Ex, x0 + e % Ex) of image b; rows outside the image and rows
// [E*Ex, rows) are zero.  C, k0, KC multiples of 8; ldd % 8 == 0.
__device__ __forceinline__ void stage_halo(const bf16* __restrict__ src, int b, int H, int W,
                                           int C, int y0, int x0, int Ey, int Ex, int rows,
                                           int k0, int KC, bf16* dst, int ldd) {
  const int vn = KC / 8;
  for (int i = threadIdx.x; i < rows * vn; i += blockDim.x) {
    const int e = i / vn, v = i - e * vn;
    const int gy = y0 + e / Ex, gx = x0 + e % Ex;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (e < Ey * Ex && gy >= 0 && gy < H && gx >= 0 && gx < W)
      val = __ldg(reinterpret_cast<const uint4*>(src + (((long)b * H + gy) * W + gx) * C + k0) + v);
    *reinterpret_cast<uint4*>(dst + e * ldd + v * 8) = val;
  }
}
