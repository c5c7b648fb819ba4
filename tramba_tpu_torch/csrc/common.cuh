// Shared device helpers for the port's hand-written Hopper kernels.
//
// Every weight is read in torch.nn.Linear layout (out_features, in_features),
// row-major.  Activations and weights are fp32 or bf16 (`__nv_bfloat16`);
// arithmetic is always fp32, and a bf16 result is rounded once, to nearest
// even (`__float2bfloat16_rn`, as jnp's astype), where the TPU kernel rounds.
//
// Matrix products inside the kernels run from "staged tiles" (K1's
// projection, K2-K7, K9-K13): the weight streams through a ring of
//   shared-memory stages filled several stages ahead of use, and the product
//   runs from shared memory.  K2: 16-byte cp.async copies (zero-filled past
//   the edges) into padded rows; bf16 as mma.sync m16n8k16 fragments loaded
//   by ldmatrix, fp32 as 4x4 register micro-tiles of SIMT FMAs.  K6: TMA
//   boxes (zeros past the edges) completing on mbarriers, in the 128-byte
//   swizzled layout (sw128_offset) that warpgroup wgmma m64n64k16 reads
//   through shared-memory descriptors, the fp32 sums in registers; K5-K7
//   and K9-K12 share the LayerNorm of gathered rows into that layout
//   (ln_gather_sw128: K5's and K11's rows are their tiles' halo pixels), K7,
//   K9, K10 and K13 the front kernel (ln_fc_kernel below), K7 and K10 stage
//   their hidden maps' halos by 4-D TMA boxes, K9 / K10's (c) runs in thread
//   block clusters, and their weight gradients are mma.sync products of
//   transposed operands (ldmatrix_x4_trans) from a cp.async ring; K13's
//   attention runs mma.sync on ldmatrix fragments of cp.async-staged q, k,
//   v and its output projection wgmma on TMA boxes of wp; K12 (attn.cu)
//   runs every product on wgmma from one TMA ring, the scores and the
//   probabilities as register A operands.  K3 and
//   K4 (expand.cu): in bf16 x and the weight as TMA boxes, wgmma up to
//   m64n256k16 (wgmma_m64nk16) with the LayerNorm and the head computed from
//   the accumulators; in fp32 register micro-tiles of SIMT FMAs from a
//   cp.async ring, K3's column chunks of a group in a thread block cluster.
//   K1's projection (ss2d.cu) keeps its fp32 operands' accuracy on wgmma:
//   the weight comes by TMA as three bf16 terms split once a weight version,
//   an fp32 x as raw boxes that the threads split per slab.
// bf16 x bf16 products are exact in fp32, so only the summation order
// differs from the TPU's fp32-accumulating MXU.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <dlfcn.h>

#include <algorithm>
#include <cstdint>

using bf16 = __nv_bfloat16;

// Kernels the library has launched: every launch site adds one, through
// TRAMBA_CHECK_LAUNCH (or directly where a launcher returns a cudaError_t);
// tramba_native_launches() reads it, so a caller can count the launches of
// one call of a wrapper exactly.
inline long& native_launch_count() {
  static long n = 0;
  return n;
}

#define TRAMBA_CHECK_LAUNCH()                 \
  do {                                        \
    ++native_launch_count();                  \
    cudaError_t e__ = cudaGetLastError();     \
    if (e__ != cudaSuccess) return (int)e__;  \
  } while (0)

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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
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

// Sets the dynamic shared-memory limit of a kernel before its first launch.
template <typename Kern>
static inline cudaError_t allow_smem(Kern kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
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

// d (+)= A B for one warpgroup: A 64 x 16 (m rows, k contiguous) and B
// 16 x 64, bf16, in shared memory (descriptors a, b).  B is K-major (64 n
// rows of 16 k, descriptor start + 16 elements per k16 step of a box) or,
// with TRANS_B, N-major (16 k rows of 64 n, as a box of a row-major (k, n)
// matrix: start + 1024 elements per k16 step; the same descriptor, whose
// 1024-byte stride then steps 8 k rows).  d the 64 x 64 fp32 tile, element
// i of thread t at row 16 (t / 32) + (t % 32) / 4 + 8 ((i / 2) % 2), column
// 8 (i / 4) + 2 (t % 4) + i % 2.  scale_d == 0 overwrites d.
template <int TRANS_B = 0>
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t a, uint64_t b,
                                                int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, %35;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d), "n"(TRANS_B));
}

// d (+)= A B for one warpgroup at N = 32, 48, 64, 72, 80, 96, 128, 144, 192
// or 256 columns (the widths the kernels use; wgmma takes any multiple of 8
// up to 256): A 64 x 16
// and B N x 16 (K-major: N rows of 16 k), bf16, in the sw128_offset layout
// (descriptors a, b; B's N rows may span several 64-row boxes stacked in
// shared memory, 8-row groups 1024 bytes apart throughout).  d the 64 x N
// fp32 tile, N / 2 registers a thread laid out as wgmma_m64n64k16's: element
// i of thread t at row 16 (t / 32) + (t % 32) / 4 + 8 ((i / 2) % 2), column
// 8 (i / 4) + 2 (t % 4) + i % 2.  scale_d == 0 overwrites d.
template <int N>
__device__ __forceinline__ void wgmma_m64nk16(float (&d)[N / 2], uint64_t a, uint64_t b,
                                              int scale_d);
template <>
__device__ __forceinline__ void wgmma_m64nk16<64>(float (&d)[32], uint64_t a, uint64_t b,
                                                  int scale_d) {
  wgmma_m64n64k16(d, a, b, scale_d);
}
template <>
__device__ __forceinline__ void wgmma_m64nk16<128>(float (&d)[64], uint64_t a, uint64_t b,
                                                 int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}
template <>
__device__ __forceinline__ void wgmma_m64nk16<192>(float (&d)[96], uint64_t a, uint64_t b,
                                                 int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(a), "l"(b), "r"(scale_d));
}
template <>
__device__ __forceinline__ void wgmma_m64nk16<256>(float (&d)[128], uint64_t a, uint64_t b,
                                                 int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_m64nk16<32>(float (&d)[16], uint64_t a, uint64_t b,
                                                  int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(scale_d));
}
template <>
__device__ __forceinline__ void wgmma_m64nk16<48>(float (&d)[24], uint64_t a, uint64_t b,
                                                  int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23"
      "}, %24, %25, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "l"(a), "l"(b), "r"(scale_d));
}
template <>
__device__ __forceinline__ void wgmma_m64nk16<72>(float (&d)[36], uint64_t a, uint64_t b,
                                                  int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %38, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n72k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35"
      "}, %36, %37, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35])
      : "l"(a), "l"(b), "r"(scale_d));
}
template <>
__device__ __forceinline__ void wgmma_m64nk16<80>(float (&d)[40], uint64_t a, uint64_t b,
                                                  int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %42, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39"
      "}, %40, %41, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "l"(a), "l"(b), "r"(scale_d));
}
template <>
__device__ __forceinline__ void wgmma_m64nk16<96>(float (&d)[48], uint64_t a, uint64_t b,
                                                  int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
      "}, %48, %49, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(a), "l"(b), "r"(scale_d));
}
template <>
__device__ __forceinline__ void wgmma_m64nk16<144>(float (&d)[72], uint64_t a, uint64_t b,
                                                   int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %74, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n144k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71"
      "}, %72, %73, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71])
      : "l"(a), "l"(b), "r"(scale_d));
}

// Four 8x8 b16 matrices, each transposed on the way: lane l gives the
// address of stored row l % 8 of matrix l / 8, and r[i] is this lane's pair
// of matrix i at stored rows 2 (l % 4) and + 1, column l / 4.  It reads
// mma_bf16_16816's A (or B) fragment from a tile stored with the m (or n)
// index contiguous, as the weight gradients' operands are.
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const void* smem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// TMA: the box at (c0, c1, c2, c3) (c0 the inner coordinate) of the 4-D
// tensor map `map` into shared memory, counted on `bar`; coordinates may lie
// outside the tensor, whose elements then arrive as zeros.
__device__ __forceinline__ void tma_load_4d(void* smem, const void* map, int c0, int c1, int c2,
                                            int c3, uint64_t* bar) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  const unsigned b = (unsigned)__cvta_generic_to_shared(bar);
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(s),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(b)
      : "memory");
}

// cuTensorMapEncodeTiled from the driver library, found at run time (the
// kernels link only the CUDA runtime).
using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

static inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_LOCAL);
    return lib ? reinterpret_cast<EncodeTiledFn>(dlsym(lib, "cuTensorMapEncodeTiled")) : nullptr;
  }();
  return fn;
}

// Tensor map of a row-major (rows, cols) bf16 matrix in 64 x 64 boxes,
// 128-byte swizzle, zeros outside: weights, and the rows of activations.
static inline bool weight_map(CUtensorMap* map, const bf16* w, long rows, int cols) {
  const EncodeTiledFn encode = encode_tiled();
  if (!encode) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {64, 64}, elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<bf16*>(w), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

// Tensor map of a (B, H, W, C) fp32 map in boxes of 64 channels x side x
// side pixels of one image, unswizzled ([y][x][c] in shared memory), zeros
// outside the map: the SAME padding of a depthwise stencil's input.
static inline bool halo_map(CUtensorMap* map, const float* h, int B, int H, int W, int C,
                            int side) {
  const EncodeTiledFn encode = encode_tiled();
  if (!encode) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)C * 4, (cuuint64_t)W * C * 4,
                                 (cuuint64_t)H * W * C * 4};
  const cuuint32_t box[4] = {64, (cuuint32_t)side, (cuuint32_t)side, 1}, elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<float*>(h), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

constexpr int kTileRows = 64;     // rows of one wgmma M tile
constexpr int kBox = 64 * 64;     // elements of one 64 x 64 TMA box (8 KB in bf16)
constexpr size_t kSmemBlock = 227 * 1024;  // shared memory one block may use

// The first 1024-aligned address at least `reserve` bytes into the dynamic
// shared memory (the mbarriers sit before it).
__device__ __forceinline__ bf16* tiles_start(float4* smem4, int reserve) {
  return reinterpret_cast<bf16*>((reinterpret_cast<uintptr_t>(smem4) + reserve + 1023) &
                                 ~static_cast<uintptr_t>(1023));
}

// bf16(LN(x) ln_w + ln_b) (fp32 statistics in two passes, eps 1e-5 unless
// given) of `rows` gathered rows of x (., d) into As, a rows x dp tile in the
// sw128_offset layout (dp = d rounded up to 64; zeros past d): row r is row
// row_of(r) of x, or zeros where row_of(r) < 0; without ln_w, the rows of x
// as they are (y = x).  With xf set, the normalised rows also go to
// xf[row_of(r)].  One warp a row, `nwarps` warps; a lane holds KG 16-byte
// groups of a row (d <= 256 KG), and a warp keeps 8 rows' loads in flight
// (4 at KG = 4); d % 8 == 0, rows a multiple of 8.
template <int KG, typename RowOf>
__device__ __forceinline__ void ln_gather_sw128(const bf16* __restrict__ x,
                                                const float* __restrict__ ln_w,
                                                const float* __restrict__ ln_b, int d, int rows,
                                                const RowOf& row_of, int nwarps, bf16* As,
                                                bf16* __restrict__ xf, float eps = 1e-5f) {
  constexpr int kRows = KG == 1 ? 8 : 16 / KG;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, dp = (d + 63) & ~63;
  // this lane's columns of ln_w and ln_b, held in registers where a lane has
  // at most two groups
  constexpr int KP = KG <= 2 ? KG : 1;
  float pw[KP][8], pb[KP][8];
#pragma unroll
  for (int i = 0; i < KP; ++i)
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int c = 8 * (lane + 32 * i) + e;
      pw[i][e] = KG <= 2 && ln_w && c < d ? ln_w[c] : 0.f;
      pb[i][e] = KG <= 2 && ln_w && c < d ? ln_b[c] : 0.f;
    }
  for (int r0 = warp * kRows; r0 < rows; r0 += nwarps * kRows) {
    uint4 raw[kRows][KG];
    int src[kRows];  // a pixel or row index (< 2^31), or -1
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      src[k] = (int)row_of(r0 + k);
#pragma unroll
      for (int i = 0; i < KG; ++i) {
        const int g = lane + 32 * i;
        raw[k][i] = src[k] >= 0 && g < d / 8
                        ? __ldg(reinterpret_cast<const uint4*>(x + (long)src[k] * d) + g)
                        : make_uint4(0u, 0u, 0u, 0u);
      }
    }
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      const int r = r0 + k;
      float mean = 0.f, rstd = 0.f;
      if (ln_w) {
        float s = 0.f;
#pragma unroll
        for (int i = 0; i < KG; ++i) {
          const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw[k][i]);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 f = __bfloat1622float2(h[e]);
            s += f.x + f.y;
          }
        }
        mean = warp_sum(s) / d;
        float q = 0.f;
#pragma unroll
        for (int i = 0; i < KG; ++i) {
          if (lane + 32 * i >= d / 8) continue;
          const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw[k][i]);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 f = __bfloat1622float2(h[e]);
            q = fmaf(f.x - mean, f.x - mean, q);
            q = fmaf(f.y - mean, f.y - mean, q);
          }
        }
        rstd = rsqrtf(warp_sum(q) / d + eps);
      }
#pragma unroll
      for (int i = 0; i < KG; ++i) {
        const int g = lane + 32 * i;
        if (g >= dp / 8) continue;
        uint4 o = make_uint4(0u, 0u, 0u, 0u);
        if (src[k] >= 0 && g < d / 8) {
          if (ln_w) {
            const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw[k][i]);
            __nv_bfloat162* y = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float2 f = __bfloat1622float2(h[e]);
              const int c = 8 * g + 2 * e;
              const int ip = KG <= 2 ? i : 0;
              const float w0 = KG <= 2 ? pw[ip][2 * e] : ln_w[c];
              const float w1 = KG <= 2 ? pw[ip][2 * e + 1] : ln_w[c + 1];
              const float b0 = KG <= 2 ? pb[ip][2 * e] : ln_b[c];
              const float b1 = KG <= 2 ? pb[ip][2 * e + 1] : ln_b[c + 1];
              y[e] = __floats2bfloat162_rn((f.x - mean) * rstd * w0 + b0,
                                           (f.y - mean) * rstd * w1 + b1);
            }
          } else {
            o = raw[k][i];
          }
          if (xf) *reinterpret_cast<uint4*>(xf + (long)src[k] * d + 8 * g) = o;
        }
        *reinterpret_cast<uint4*>(As + sw128_offset(r, 8 * g, rows)) = o;
      }
    }
  }
}

// ln_gather_sw128 of rows [m0, m0 + 64) of x (M, d) (zeros past M) into a
// 64 x dp tile, and with xf set into the rows < M of xf (M, d); d <= 1024.
__device__ __forceinline__ void ln_rows_sw128(const bf16* __restrict__ x,
                                              const float* __restrict__ ln_w,
                                              const float* __restrict__ ln_b, long M, int d,
                                              long m0, int nwarps, bf16* As,
                                              bf16* __restrict__ xf, float eps = 1e-5f) {
  ln_gather_sw128<4>(x, ln_w, ln_b, d, kTileRows,
                     [=](int r) { return m0 + r < M ? m0 + r : -1L; }, nwarps, As, xf, eps);
}

__device__ __forceinline__ float gelu_grad(float z) {
  // Phi(z) + z phi(z), as fused_mlp._gelu_grad
  return 0.5f * (1.f + erff(z * 0.70710678118654752f)) +
         z * expf(-0.5f * z * z) * 0.3989422804014327f;
}

// gelu_exact(z) and gelu_grad(z) from one erff.
__device__ __forceinline__ void gelu_and_grad(float z, float* g, float* gp) {
  const float e = erff(z * 0.70710678118654752f);
  *g = 0.5f * z * (1.f + e);
  *gp = 0.5f * (1.f + e) + z * expf(-0.5f * z * z) * 0.3989422804014327f;
}

// K7's merged 7x7 taps, which its front launch writes for its stencil: per
// chunk of 64 hidden channels, [49][64] taps t = k7 + pad(k5) + pad(k3) +
// identity (fp32 sums of the bf16 taps), then [64] biases c3 + c5 + c7;
// zeros past hid.  K11's wide route passes k5, k7, c5, c7 null and no
// identity: t = pad(k3), biases c3.
struct MergedTaps {
  const bf16 *k3, *k5, *k7;
  const float *c3, *c5, *c7;
  float* out;
  bool identity = true;
};
constexpr int kTapChunk = 50 * 64;  // floats of one chunk's merged taps and biases

// Every block of the grid takes its share of the merged taps.
__device__ __forceinline__ void merge_taps(const MergedTaps& t, int hid) {
  const long n = (long)(hid + 63) / 64 * kTapChunk;
  const long stride = (long)gridDim.x * gridDim.y * blockDim.x;
  for (long e = ((long)blockIdx.y * gridDim.x + blockIdx.x) * blockDim.x + threadIdx.x; e < n;
       e += stride) {
    const int r = (int)(e % kTapChunk), i = r / 64;
    const long ch = e / kTapChunk * 64 + r % 64;
    float v = 0.f;
    if (ch < hid && i == 49) {
      v = t.c3[ch];
      if (t.c5) v = v + t.c5[ch] + t.c7[ch];
    } else if (ch < hid) {
      const int u = i / 7, w = i - u * 7;
      if (t.k7) v = to_f32(t.k7[ch * 49 + i]);
      if (t.k5 && u >= 1 && u <= 5 && w >= 1 && w <= 5)
        v += to_f32(t.k5[ch * 25 + (u - 1) * 5 + w - 1]);
      if (u >= 2 && u <= 4 && w >= 2 && w <= 4) v += to_f32(t.k3[ch * 9 + (u - 2) * 3 + w - 2]);
      if (t.identity && i == 24) v += 1.f;
    }
    t.out[e] = v;
  }
}

// ---------------------------------------------------------------------------
// The LN + fc front of K7, K9 and K10: one kernel, three epilogues
// ---------------------------------------------------------------------------
//
// One block per (64 rows, group of hidden chunks of kFrontHC columns): two
// warpgroups, each owning 64 of a chunk's columns.  The block normalises its
// rows once into As (ln_rows_sw128); the weights stream by TMA as one
// sequence of 64 x 64 tiles, `stages` ring slots with an mbarrier each, and
// the products run as wgmma m64n64k16 with the sums in registers (K6's
// scheme: after the block's barrier of tile t, thread 0 issues tile
// t + stages - 2 into the slot of tile t - 2, whose groups every warpgroup
// has waited for).
//   K7 (kFrontK7): dp / 64 tiles of w1 a chunk; h = LN(x) w1^T + b1 goes
//     to device memory once, fp32 (M, hid), unrounded, for K7's stencil;
//     the blocks also share out the merged taps (merge_taps).
//   K9 (kFrontK9): then dp / 64 tiles of g's rows and of w2 (d, hid) in
//     its own layout, the N-major B operand of gw = g w2[:, chunk] (k = d,
//     as for h); in registers z = h + b1, dh = gw GELU'(z),
//     hg = bf16(GELU(z)); hg and bf16(dh) are written (M, hid), and the
//     column sums of the unrounded dh over the tile's rows to
//     part_db1[row tile, :] (the warps' sums added in a fixed order).
//     The warps' sums pass through the ring slot just consumed (so that
//     two blocks fit an SM at d <= 128).
//   K10 (kFrontK10): K9's two products; h = LN(x) w1^T + b1 and gw = g w2
//     go to device memory once each, fp32 (M, hid), for K10's two stencil
//     launches (each pixel's h and dacc are read by the halos of up to 9
//     tiles), and the blocks share out the merged taps as K7's do.
//   K9 and K10: hidden group 0 also writes xf = bf16(LN(x)) for dW1.
//   K13 (kFrontQKV): the qkv projection of Swin's window attention: w1 is
//     wqkv (3 Cq, C) and b1 bqkv; bf16((LN(x) w1^T + b1) s) goes to qo.out
//     (M, 3 Cq), s = qo.scale on the q columns (those below qo.nscale),
//     else 1: the rounding points of q, k and v.
constexpr int kFrontHC = 128;

constexpr int kFrontK7 = 0, kFrontK9 = 1, kFrontK10 = 2, kFrontQKV = 3;

// K13's output of the front: see kFrontQKV.
struct QkvOut {
  bf16* out;
  int nscale;
  float scale;
};

template <int MODE>
__global__ void __launch_bounds__(256, 1)
    ln_fc_kernel(const __grid_constant__ CUtensorMap map_w1,
                 const __grid_constant__ CUtensorMap map_g,
                 const __grid_constant__ CUtensorMap map_w2, const bf16* __restrict__ x,
                 const float* __restrict__ ln_w, const float* __restrict__ ln_b,
                 const float* __restrict__ b1, float* __restrict__ h, float* __restrict__ gwo,
                 bf16* __restrict__ xf, bf16* __restrict__ hg, bf16* __restrict__ dh,
                 float* __restrict__ part_db1, long M, int d, int hid, int cps, int stages,
                 MergedTaps taps, QkvOut qo, float eps) {
  constexpr bool BWD = MODE == kFrontK9 || MODE == kFrontK10;  // the g w2 product too
  constexpr int NB = BWD ? 3 : 2;  // boxes a slot: a weight's per warpgroup, then g's
  extern __shared__ float4 smem4[];
  const int dp = (d + 63) & ~63, nkd = dp / 64, tpc = BWD ? 2 * nkd : nkd;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem4);  // one mbarrier a slot (8 at most)
  bf16* As = tiles_start(smem4, 64);
  bf16* ring = As + kTileRows * dp;
  const int wg = threadIdx.x >> 7, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long m0 = (long)blockIdx.x * kTileRows;
  const int nchunks = (hid + kFrontHC - 1) / kFrontHC;
  const int c_first = blockIdx.y * cps, c_last = min(nchunks, c_first + cps);
  const int T = (c_last - c_first) * tpc;
  auto issue = [&](int t) {
    const int slot = t % stages, c = c_first + t / tpc, u = t % tpc;
    bf16* dst = ring + (size_t)slot * NB * kBox;
    if (!BWD || u < nkd) {
      mbar_expect_tx(full + slot, 2 * kBox * 2);
#pragma unroll
      for (int w = 0; w < 2; ++w)
        tma_load_2d(dst + w * kBox, &map_w1, 64 * u, c * kFrontHC + 64 * w, full + slot);
    } else {
      const int k = u - nkd;
      mbar_expect_tx(full + slot, 3 * kBox * 2);
#pragma unroll
      for (int w = 0; w < 2; ++w)
        tma_load_2d(dst + w * kBox, &map_w2, c * kFrontHC + 64 * w, 64 * k, full + slot);
      tma_load_2d(dst + 2 * kBox, &map_g, 64 * k, (int)m0, full + slot);
    }
  };
  if (threadIdx.x == 0) {
    for (int i = 0; i < stages; ++i) mbar_init(full + i, 1);
    mbar_init_fence();
    for (int t = 0; t < min(T, stages - 2); ++t) issue(t);
  }
  if constexpr (MODE == kFrontK7 || MODE == kFrontK10) merge_taps(taps, hid);
  ln_rows_sw128(x, ln_w, ln_b, M, d, m0, 8, As, BWD && blockIdx.y == 0 ? xf : nullptr, eps);
  fence_proxy_async();

  float acc[32], gw[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = gw[i] = 0.f;
  const int wrow = 16 * (warp & 3) + (lane >> 2), wcol = 2 * (lane & 3);
  for (int t = 0; t < T; ++t) {
    __syncthreads();  // tile t - 2's reads are done, As is written
    if (threadIdx.x == 0 && t + stages - 2 < T) issue(t + stages - 2);
    mbar_wait(full + t % stages, (t / stages) & 1);
    const bf16* tile = ring + (size_t)(t % stages) * NB * kBox;
    const int c = c_first + t / tpc, u = t % tpc;
    if (!BWD || u < nkd) {  // h += LN(x)[:, 64 u + ...] w1[chunk rows of this warpgroup]^T
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < 4; ++s)
        wgmma_m64n64k16(acc, wgmma_desc_sw128(As + u * kBox + 16 * s),
                        wgmma_desc_sw128(tile + wg * kBox + 16 * s), u > 0 || s > 0);
    } else {  // gw += g[:, 64 k + ...] w2[64 k + ..., chunk columns of this warpgroup]
      const int k = u - nkd;
      fence_regs(gw);
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < 4; ++s)
        wgmma_m64n64k16<1>(gw, wgmma_desc_sw128(tile + 2 * kBox + 16 * s),
                           wgmma_desc_sw128(tile + wg * kBox + 1024 * s), k > 0 || s > 0);
    }
    wgmma_commit();
    if (u != tpc - 1) {
      wgmma_wait<1>();
      continue;
    }
    wgmma_wait<0>();
    fence_regs(acc);
    const int c0 = c * kFrontHC + 64 * wg;
    if constexpr (MODE == kFrontQKV) {
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const long row = m0 + wrow + 8 * ((i >> 1) & 1);
        const int col = c0 + 8 * (i >> 2) + wcol;
        if (row >= M || col >= hid) continue;
        const float s = col < qo.nscale ? qo.scale : 1.f;  // nscale is even
        *reinterpret_cast<__nv_bfloat162*>(qo.out + row * hid + col) =
            __floats2bfloat162_rn((acc[i] + b1[col]) * s, (acc[i + 1] + b1[col + 1]) * s);
      }
    } else if constexpr (MODE != kFrontK9) {
      if constexpr (MODE == kFrontK10) fence_regs(gw);
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const long row = m0 + wrow + 8 * ((i >> 1) & 1);
        const int col = c0 + 8 * (i >> 2) + wcol;
        if (row >= M || col >= hid) continue;
        *reinterpret_cast<float2*>(h + row * hid + col) =
            make_float2(acc[i] + b1[col], acc[i + 1] + b1[col + 1]);
        if constexpr (MODE == kFrontK10)
          *reinterpret_cast<float2*>(gwo + row * hid + col) = make_float2(gw[i], gw[i + 1]);
      }
    } else {
      fence_regs(gw);
      float s[16];  // this thread's columns summed over its two rows
#pragma unroll
      for (int i = 0; i < 16; ++i) s[i] = 0.f;
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const long row = m0 + wrow + 8 * ((i >> 1) & 1);
        const int col = c0 + 8 * (i >> 2) + wcol;
        if (row >= M || col >= hid) continue;
        float g0, g1, p0, p1;
        gelu_and_grad(acc[i] + b1[col], &g0, &p0);
        gelu_and_grad(acc[i + 1] + b1[col + 1], &g1, &p1);
        const float d0 = gw[i] * p0, d1 = gw[i + 1] * p1;
        *reinterpret_cast<__nv_bfloat162*>(hg + row * hid + col) = __floats2bfloat162_rn(g0, g1);
        *reinterpret_cast<__nv_bfloat162*>(dh + row * hid + col) = __floats2bfloat162_rn(d0, d1);
        s[(i >> 2) * 2] += d0;
        s[(i >> 2) * 2 + 1] += d1;
      }
#pragma unroll
      for (int i = 0; i < 16; ++i) {  // over the warp's 8 row lanes
        s[i] += __shfl_xor_sync(0xffffffffu, s[i], 4);
        s[i] += __shfl_xor_sync(0xffffffffu, s[i], 8);
        s[i] += __shfl_xor_sync(0xffffffffu, s[i], 16);
      }
      // [8 warps][64] sums in tile t's slot, whose products are done in
      // every warpgroup once all have passed this barrier
      float* red = reinterpret_cast<float*>(const_cast<bf16*>(tile));
      __syncthreads();
      if (lane < 4) {
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          red[warp * 64 + 8 * k + wcol] = s[2 * k];
          red[warp * 64 + 8 * k + wcol + 1] = s[2 * k + 1];
        }
      }
      __syncthreads();
      if (threadIdx.x < 128) {  // the four warps of each warpgroup, in order
        const int w = threadIdx.x >> 6, cl = threadIdx.x & 63, col = c * kFrontHC + 64 * w + cl;
        const float* r = red + 4 * w * 64 + cl;
        if (col < hid) part_db1[(long)blockIdx.x * hid + col] = ((r[0] + r[64]) + r[128]) + r[192];
      }
      fence_proxy_async();  // before TMA writes the slot again
    }
  }
}

// Tiling of one front launch (ln_fc_kernel).
struct FrontPlan {
  long rows;  // row tiles of 64
  int groups, cps, stages;
  size_t smem;
};

static inline bool plan_front(long M, int d, int hid, bool bwd, FrontPlan* p) {
  if (d % 8 || hid % 16 || d < 8 || d > 1024 || hid < 16 || M < 1) return false;
  const int dp = (d + 63) & ~63, nchunks = (hid + kFrontHC - 1) / kFrontHC;
  const size_t fixed = 1024 + (size_t)kTileRows * dp * 2;
  const size_t slot = (size_t)(bwd ? 3 : 2) * kBox * 2;
  // two blocks an SM (113 KB each) where four slots fit in that, else one
  const size_t budget = fixed + 4 * slot <= 113 * 1024 ? 113 * 1024 : kSmemBlock;
  p->stages = (int)std::min<size_t>(8, (budget - std::min(budget, fixed)) / slot);
  p->smem = fixed + (size_t)p->stages * slot;
  p->rows = (M + kTileRows - 1) / kTileRows;
  // hidden groups: enough blocks for two a SM, each group whole chunks
  const long want = std::max(1L, std::min((long)nchunks, (2L * 132 + p->rows - 1) / p->rows));
  p->cps = (int)((nchunks + want - 1) / want);
  p->groups = (nchunks + p->cps - 1) / p->cps;
  return p->stages >= 3;
}

template <int MODE>
static inline int front_launch(const FrontPlan& p, const CUtensorMap& map_w1,
                               const CUtensorMap& map_g, const CUtensorMap& map_w2,
                               const bf16* x, const float* ln_w, const float* ln_b,
                               const float* b1, float* h, float* gw, bf16* xf, bf16* hg,
                               bf16* dh, float* part_db1, long M, int d, int hid,
                               MergedTaps taps, cudaStream_t s, QkvOut qo = QkvOut{},
                               float eps = 1e-5f) {
  cudaError_t e = allow_smem(ln_fc_kernel<MODE>, p.smem);
  if (e != cudaSuccess) return (int)e;
  ln_fc_kernel<MODE><<<dim3((unsigned)p.rows, p.groups), 256, p.smem, s>>>(
      map_w1, map_g, map_w2, x, ln_w, ln_b, b1, h, gw, xf, hg, dh, part_db1, M, d, hid, p.cps,
      p.stages, taps, qo, eps);
  TRAMBA_CHECK_LAUNCH();
  return 0;
}
