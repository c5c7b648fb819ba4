// Shared device helpers for the port's hand-written Hopper kernels.
//
// Every weight is read in torch.nn.Linear layout (out_features, in_features),
// row-major.  Activations and weights are fp32 or bf16 (`__nv_bfloat16`);
// arithmetic is always fp32, and a bf16 result is rounded once, to nearest
// even (`__float2bfloat16_rn`, as jnp's astype), where the TPU kernel rounds.
//
// Three patterns for matrix products inside the kernels:
// * "row blocks" (K1, K3, K4): a block stages P activation rows in shared
//   memory as fp32, and each thread owns one output column j, reading row j
//   of the weight 16 bytes at a time and keeping P accumulators in
//   registers.  Plain SIMT FMA work (no tensor cores, no TMA).
// * "wmma tiles" (K5, K7, K9-K13, bf16 only): bf16 operands in 16x16x16
//   tensor-core fragments (nvcuda::wmma) with fp32 accumulation; A from
//   shared memory, B straight from the weight in global memory (L2-resident)
//   and shared by up to four m-tiles, C through a shared fp32 tile.
// * "staged tiles" (K2, K6): the weight streams through a ring of
//   shared-memory stages filled several stages ahead of use, and the product
//   runs from shared memory.  K2: 16-byte cp.async copies (zero-filled past
//   the edges) into padded rows; bf16 as mma.sync m16n8k16 fragments loaded
//   by ldmatrix, fp32 as 4x4 register micro-tiles of SIMT FMAs.  K6: TMA
//   boxes (zeros past the edges) completing on mbarriers, in the 128-byte
//   swizzled layout (sw128_offset) that warpgroup wgmma m64n64k16 reads
//   through shared-memory descriptors, the fp32 sums in registers.
// bf16 x bf16 products are exact in fp32, so only the summation order
// differs from the TPU's fp32-accumulating MXU.
#pragma once

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

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

// Steps per chunk of the SS2D scans and the carries' stride: K1 (ss2d.cu)
// writes the state entering each chunk, K8 (ss2d_bwd.cu) recomputes a
// chunk's states from it.  The library exports it as ss2d_scan_chunk(), and
// the Python wrappers size the carries from that.  A block stages the inputs
// one chunk at a time, and a segment (below) is a whole number of chunks.
constexpr int kScanChunk = 64;

// ---------------------------------------------------------------------------
// Segments of the SS2D scans (K1, K8)
// ---------------------------------------------------------------------------
//
// Each direction's L steps are cut into S segments of seg_chunks chunks
// that run at once: a segment's recurrence from a zero state gives its
// summary, a carry pass over the summaries gives each segment the state it
// really starts from, and the segment is run again from there.  S is chosen
// so that a launch has about `warps` warps (one thread per channel, 32
// channels a warp) whatever the batch: K1 asks for kScanWarps, K8's longer
// steps for kScanBwdWarps, several waves of blocks over the 132 SMs each,
// so that the last wave's idle SMs cost little.
constexpr int kScanWarps = 4096;
constexpr int kScanBwdWarps = 8192;

// Chunks per segment for a (B, K, L, D) scan of about `warps` warps.
static inline int scan_seg_chunks(int B, int L, int D, int K, int warps) {
  const long base = (long)(D / 32) * K * B;  // warps with one segment per direction
  const long want = (warps + base - 1) / base;
  const int chunks = (L + kScanChunk - 1) / kScanChunk;
  const long per = chunks / want;
  return per < 1 ? 1 : (int)per;
}

static inline int scan_segments(int L, int seg_chunks) {
  return (L + kScanChunk * seg_chunks - 1) / (kScanChunk * seg_chunks);
}

// Channels per block of the segment kernels: the largest of `cap`, cap / 2,
// ..., 32 that divides D (D % 32 == 0).
static inline int scan_block_channels(int D, int cap) {
  int nc = cap;
  while (D % nc) nc /= 2;
  return nc;
}

// The constants of channel d of direction k that every step reads: its row
// of wdt (R <= RMAX, kept in registers), dt_bias, A = -exp(A_logs), Ds.
template <int RMAX>
struct ScanChannel {
  float w[RMAX];
  float bias, A, Dd;

  __device__ __forceinline__ ScanChannel(const float* __restrict__ wdt,
                                         const float* __restrict__ dt_bias,
                                         const float* __restrict__ A_logs,
                                         const float* __restrict__ Ds, int k, int D, int d,
                                         int R) {
#pragma unroll
    for (int r = 0; r < RMAX; ++r) w[r] = r < R ? wdt[((long)k * D + d) * R + r] : 0.f;
    bias = dt_bias[k * D + d];
    A = -expf(A_logs[k * D + d]);
    Dd = Ds[k * D + d];
  }

  // dt before the softplus at one step: bias + dbc[:R] . wdt[k, d], the
  // staged row db (16-byte aligned) read 16 bytes at a time; w[r] = 0 for
  // r >= R, so the row's B and C in the last group add nothing
  __device__ __forceinline__ float v(const float* db, int R) const {
    static_assert(RMAX % 4 == 0, "rows are read as float4");
    float v = bias;
#pragma unroll
    for (int r = 0; r < RMAX; r += 4) {
      if (r < R) {
        const float4 q = *reinterpret_cast<const float4*>(db + r);
        v = fmaf(q.x, w[r], v);
        v = fmaf(q.y, w[r + 1], v);
        v = fmaf(q.z, w[r + 2], v);
        v = fmaf(q.w, w[r + 3], v);
      }
    }
    return v;
  }
};

// Row stride of a (dt, B, C) row of C floats in shared memory (and of K8's
// d_dbc rows): C rounded up to whole 16-byte groups.
__host__ __device__ __forceinline__ int row_stride(int C) { return (C + 3) & ~3; }

// Asynchronous copies of chunk [t0, t0 + n) of direction k of image b into
// one stage buffer of the block: pix_s[t] = idx[k, t0 + t] and the C floats
// dbc_s[t * row_stride(C) + c] = dbc_b[(pix_s[t] * K + k) * C + c].  Every
// thread of the block takes part and commits one group (also when it
// copies nothing).
__device__ __forceinline__ void stage_scan_rows(int* pix_s, float* dbc_s,
                                                const int* __restrict__ idx_k,
                                                const float* __restrict__ dbc_b, int t0, int n,
                                                int K, int k, int C) {
  const int Cs = row_stride(C);
  for (int i = threadIdx.x; i < n * C; i += blockDim.x) {
    const int t = i / C, c = i - t * C;
    const int pix = __ldg(idx_k + t0 + t);
    if (c == 0) pix_s[t] = pix;
    __pipeline_memcpy_async(dbc_s + t * Cs + c, dbc_b + ((long)pix * K + k) * C + c, 4);
  }
  __pipeline_commit();
}

// Steps whose inputs a scan thread holds in registers ahead of use: the
// loads of the next kScanAhead steps are in flight while the current ones
// compute, so a step does not wait on its own gather.
constexpr int kScanAhead = 8;

// v[i] = src[pix_s[t + i] * D + d] as fp32 for t + i < n, else 0.
template <typename T>
__device__ __forceinline__ void load_steps(float (&v)[kScanAhead], const T* __restrict__ src,
                                           const int* pix_s, int t, int n, int D, int d) {
#pragma unroll
  for (int i = 0; i < kScanAhead; ++i)
    v[i] = t + i < n ? to_f32(src[(long)pix_s[t + i] * D + d]) : 0.f;
}

// v[i] = src[pix_s[t - i] * D + d] as fp32 for t - i >= 0, else 0 (steps
// taken backwards).
template <typename T>
__device__ __forceinline__ void load_steps_back(float (&v)[kScanAhead],
                                                const T* __restrict__ src, const int* pix_s,
                                                int t, int D, int d) {
#pragma unroll
  for (int i = 0; i < kScanAhead; ++i)
    v[i] = t - i >= 0 ? to_f32(src[(long)pix_s[t - i] * D + d]) : 0.f;
}

// Shared-memory bytes of the two stage buffers of stage_scan_rows.
static inline size_t scan_rows_smem(int C) {
  return (size_t)2 * kScanChunk * (row_stride(C) * 4 + 4);
}

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

// ---------------------------------------------------------------------------
// staged tiles (K2, K6)
// ---------------------------------------------------------------------------

// 16-byte asynchronous copy from global to shared memory; with valid ==
// false nothing is read and the 16 bytes are zero-filled.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Waits until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 b16 matrices from shared memory (lane l gives the address of row
// l % 8 of matrix l / 8); r[i] is this lane's pair of matrix i.
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* smem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// c += a b for one m16n8k16 tile: a the row-major A fragment (ldmatrix_x4
// of rows 0-15 at k 0 and k 8), b0 / b1 the B fragment of k 0-7 / 8-15
// (ldmatrix of the n-major B rows), c rows g and g + 8 (g = lane / 4),
// columns 2 (lane % 4) and + 1.
__device__ __forceinline__ void mma_bf16_16816(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                               unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Element offset of (r, c) in a bf16 tile of R rows stored as K-blocks of
// 64 columns ([c / 64][r][64]: 128 bytes a row), the 16-byte chunks of each
// row XOR-swizzled by the row (chunk (c % 64) / 8 sits at ((c % 64) / 8) ^
// (r % 8)): the layout TMA writes under CU_TENSOR_MAP_SWIZZLE_128B and
// wgmma reads through a 128-byte-swizzle descriptor.  Tiles start 1024-byte
// aligned (the swizzle repeats every 8 rows).
__device__ __forceinline__ int sw128_offset(int r, int c, int R) {
  return (c >> 6) * (R << 6) + (r << 6) + ((((c >> 3) & 7) ^ (r & 7)) << 3) + (c & 7);
}

// wgmma descriptor of a K-major bf16 operand in the sw128_offset layout,
// starting at `smem` (row 8 i of a K-block, plus 32 bytes per k16 step):
// 8-row groups 1024 bytes apart, 128-byte swizzle.
__device__ __forceinline__ uint64_t wgmma_desc_sw128(const void* smem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  return (uint64_t)((s & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

// mbarriers for the TMA copies: one arrival (the copying thread's, with the
// byte count) completes a phase once the bytes have landed.
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(bar);
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(s), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(bar);
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(s), "r"(bytes)
               : "memory");
}
// Waits for the phase of `parity` to complete; traps (a launch error, not a
// hang) if it has not after about 2^22 polls.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(bar);
  for (unsigned it = 0;; ++it) {
    unsigned done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(s), "r"(parity)
        : "memory");
    if (done) return;
    if (it > (1u << 22)) __trap();
  }
}
// TMA: the box at (x, y) (x the inner coordinate) of the 2-D tensor map
// `map` (a __grid_constant__ kernel parameter) into shared memory, counted
// on `bar`.
__device__ __forceinline__ void tma_load_2d(void* smem, const void* map, int x, int y,
                                            uint64_t* bar) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  const unsigned b = (unsigned)__cvta_generic_to_shared(bar);
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(s),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(b)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Orders shared-memory writes of the threads (generic proxy, cp.async
// included) before the reads of wgmma (async proxy); a barrier follows.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// Keeps the compiler from moving register reads or writes of an
// accumulator across an asynchronous wgmma.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= A B^T for one warpgroup: A 64 x 16 and B 64 x 16 (n rows, k
// contiguous), bf16, both K-major in shared memory (descriptors a, b); d the
// 64 x 64 fp32 tile, element i of thread t at row 16 (t / 32) + (t % 32) / 4
// + 8 ((i / 2) % 2), column 8 (i / 4) + 2 (t % 4) + i % 2.  scale_d == 0
// overwrites d.
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t a, uint64_t b,
                                                int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}
