// K6 ln_mlp, K7 ln_dwms_mlp and K11 ln_dwmlp: the block FFNs of the bf16
// inference path, and the bf16 LayerNorm launch that K5, K7 and K11-K13
// start with.
//
// K6 replaces _mlp_pallas (tramba_tpu/ops/fused_mlp.py:130, kernel :115):
//   y = bf16(LN(x)); h = bf16(GELU(y @ w1^T + b1)); out = bf16(h @ w2^T + b2).
// K7 replaces _dwms_pallas (:360, kernel :312):
//   h = y @ w1^T + b1 (fp32, zero outside the image: SAME padding pads h, b1
//   included); a = h + dw3(h) + dw5(h) + dw7(h) + c3 + c5 + c7 with bf16 taps
//   on the unrounded h; out = bf16(bf16(GELU(a)) @ w2^T + b2).
// K11 replaces _dwmlp_pallas (:844, kernel :806), PVTv2's FFN:
//   h = y @ w1^T + b1 (fp32, zero outside the image); a = dw3(h) + c3 with
//   bf16 taps (the conv replaces h: no identity term);
//   out = bf16(bf16(GELU(a)) @ w2^T + b2), y = bf16(LN(x)) with eps 1e-6.
// It is K7's chain with one 3x3 tap set and a 1-px halo, in a kernel of its
// own, so that K7 compiles as before.
// All three keep the wide hidden tensor on chip: the hidden dimension is walked
// in chunks, each chunk's fc2 product is added to an fp32 output tile, and
// only the bf16 output reaches device memory.  Where a map gives too few
// blocks to fill the card in whole waves (the 24 and 12 px maps), the
// chunks are split over S blocks per tile (grid z): each writes its fp32
// partial sum, and one more launch adds b2 to the S partials and rounds,
// the one rounding the TPU kernel makes there.  Where JAX on a TPU gives
// the 12 px d=1024 MLP to XLA (its VMEM weight budget), K6 runs it like
// every other shape.
//
// What bounds them on an H100.  K6 does 16 d^2 operations a pixel on 4 d
// bytes of x and out: about 4 d operations a byte, 512 at d 128 and above,
// over the card's bf16 ridge of ~295 (d 64, Tramba-P's 96 px guide, sits
// just under it), so it is bound by the operations, and only products fed
// to the tensor cores from staged shared-memory tiles come near the bound:
// it normalises its own rows into shared memory (no LayerNorm launch, no
// round trip of y), streams w1 and w2 by TMA into a ring of 128-byte
// swizzled tiles and runs both products as warpgroup wgmma with the output
// tile's fp32 sums in registers through the whole hidden loop (the
// kernel's note below).  Each weight tile serves the block's 64 rows only,
// so the weights stream from L2 at 64 operations a byte: that stream, not
// the tensor cores, is what holds it back now (PERF.md).  K7 and K11 run
// their products as bf16 wmma tiles with fp32 accumulation (common.cuh)
// reading the weights from L2, and pay 83 (K7) or 9 (K11) depthwise taps
// per hidden value in fp32 SIMT FMA and the fc1 of a 3-px (1-px) halo
// around each 8x8 tile (196 / 100 rows for 64 outputs); their blocks' tiles
// fit the 227 KB of shared memory of one block, and their LN runs once per
// pixel in its own launch, so halo pixels are not renormalised.
#include <cuda.h>
#include <dlfcn.h>

#include <algorithm>

#include "common.cuh"

namespace {

// y[m, :] = bf16(LN(x[m, :]) * ln_w + ln_b), fp32 statistics; one warp per
// row.
__global__ void ln_rows_kernel(const bf16* __restrict__ x, const float* __restrict__ ln_w,
                               const float* __restrict__ ln_b, bf16* __restrict__ y, long M,
                               int d, float eps) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long m = (long)blockIdx.x * (blockDim.x >> 5) + warp;
  if (m >= M) return;
  const bf16* xr = x + m * d;
  float s = 0.f;
  for (int i = lane; i < d; i += 32) s += to_f32(xr[i]);
  const float mean = warp_sum(s) / d;
  float q = 0.f;
  for (int i = lane; i < d; i += 32) {
    const float v = to_f32(xr[i]) - mean;
    q = fmaf(v, v, q);
  }
  const float rstd = rsqrtf(warp_sum(q) / d + eps);
  bf16* yr = y + m * d;
  for (int i = lane; i < d; i += 32)
    yr[i] = __float2bfloat16_rn((to_f32(xr[i]) - mean) * rstd * ln_w[i] + ln_b[i]);
}

constexpr int kThreads = 256;

// out[i] = bf16(b2[i % d] + sum over s < S of part[s * n + i]), n = rows * d.
__global__ void finish_split_kernel(const float* __restrict__ part, const float* __restrict__ b2,
                                    bf16* __restrict__ out, long n, int d, int S) {
  for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long)gridDim.x * blockDim.x) {
    float a = b2[i % d];
    for (int s = 0; s < S; ++s) a += part[s * n + i];
    out[i] = __float2bfloat16_rn(a);
  }
}

// Hidden chunks [c_first, c_last) of split blockIdx.z, cps chunks per split.
__device__ __forceinline__ void split_range(int hid, int HC, int cps, int* c_first, int* c_last) {
  *c_first = blockIdx.z * cps * HC;
  *c_last = min(hid, *c_first + cps * HC);
}

// ---- K6 -------------------------------------------------------------------
//
// One block per (64 rows, column group, hidden split): NW warpgroups (one at
// d <= 64, else two) share the rows and own NT output tiles of 64 columns
// each, so a block covers NB = 64 NT NW columns (d 320 pads to 384; d 1024
// takes two column groups, each recomputing fc1).  Shared memory, bf16,
// 1024-aligned, in the layouts TMA writes and wgmma reads:
//   As [64 x dp]   bf16(LN(x)) of the rows (dp = d rounded up to 64, zeros
//                  past d), 128-byte swizzle (sw128_offset): fc1's A;
//   Gs 1-2 x [64 x HC]  bf16(GELU(fc1 chunk + b1)), HC = 64 NW hidden
//                  columns (64 per warpgroup), 128-byte swizzle; double-
//                  buffered by chunk where NT > 1: fc2's A;
//   ring           `stages` slots of 8 KB per warpgroup, each with its
//                  mbarrier.
// The weights stream as one sequence of tiles of one 64 x 64 box (128-byte
// swizzle) per warpgroup w, per hidden chunk c: dp / 64 tiles of w1 (rows c
// HC + 64 w, a k-slab of 64), then NW NT tiles of w2 (hidden slab s of the
// chunk, output tile j: rows n_base + w 64 NT + 64 j).  A tile is 4
// dependent wgmma m64n64k16 per warpgroup (one accumulator: h, or acc[j]),
// and each warpgroup keeps W tiles' groups in flight (mlp_in_flight), so
// fc2's tiles of consecutive j overlap; thread 0 issues tile t + stages - W
// by TMA after the block's barrier of tile t, into the slot of tile t - W,
// whose reads every warpgroup has waited for.  fc1's chunk ends with
// wait_group 0, b1 and exact GELU in registers and the bf16 chunk written
// to its Gs buffer.
// fc2 accumulates into NT 64 x 64 fp32 tiles held in registers for the
// whole hidden loop (128 registers a thread at NT 4); b2 and the one
// rounding come at the end, or fp32 partial sums go to part[split] when the
// hidden chunks are split over blocks (finish_split_kernel adds them).
constexpr int kMlpRows = 64;         // rows per block: one wgmma M tile
constexpr int kMlpBox = 64 * 64;     // elements of one TMA box (8 KB)
// tiles whose wgmma groups a warpgroup keeps in flight: 3 where fc2 has
// several output tiles (separate accumulators) and Gs is double-buffered, 2
// where it has one
template <int NT>
__host__ __device__ constexpr int mlp_in_flight() { return NT > 1 ? 3 : 2; }
template <int NT>
__host__ __device__ constexpr int mlp_g_buffers() { return NT > 1 ? 2 : 1; }

// (two blocks an SM at NT = 1: the plan's shared memory allows it, and 128
// registers a thread do)
template <int NW, int NT>
__global__ void __launch_bounds__(128 * NW, NT == 1 ? 2 : 1)
    ln_mlp_kernel(const __grid_constant__ CUtensorMap map_w1,
                  const __grid_constant__ CUtensorMap map_w2, const bf16* __restrict__ x,
                  const float* __restrict__ ln_w, const float* __restrict__ ln_b,
                  const float* __restrict__ b1, const float* __restrict__ b2,
                  bf16* __restrict__ out, float* __restrict__ part, long M, int d, int hid,
                  int cps, int stages) {
  constexpr int HC = 64 * NW, NB = 64 * NT * NW, W = mlp_in_flight<NT>();
  extern __shared__ float4 smem4[];
  const int dp = (d + 63) & ~63, nkd = dp / 64, tpc = nkd + NW * NT;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem4);  // one mbarrier a slot (8 at most)
  bf16* As = reinterpret_cast<bf16*>(
      (reinterpret_cast<uintptr_t>(smem4) + 64 + 1023) & ~static_cast<uintptr_t>(1023));
  bf16* Gs = As + kMlpRows * dp;
  bf16* ring = Gs + mlp_g_buffers<NT>() * kMlpRows * HC;
  const int wg = threadIdx.x >> 7, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long m0 = (long)blockIdx.x * kMlpRows;
  const int n_base = blockIdx.y * NB;
  const int nchunks = (hid + HC - 1) / HC;
  const int c_first = blockIdx.z * cps, c_last = min(nchunks, c_first + cps);
  const int T = (c_last - c_first) * tpc;
  // tile t of the stream into its slot: NW boxes, counted on the slot's barrier
  auto issue = [&](int t) {
    const int slot = t % stages, c = c_first + t / tpc, u = t % tpc;
    bf16* dst = ring + slot * NW * kMlpBox;
    mbar_expect_tx(full + slot, NW * kMlpBox * 2);
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      if (u < nkd) {
        tma_load_2d(dst + w * kMlpBox, &map_w1, 64 * u, c * HC + 64 * w, full + slot);
      } else {
        const int v = u - nkd, s = v / NT, j = v - s * NT;
        tma_load_2d(dst + w * kMlpBox, &map_w2, c * HC + 64 * s, n_base + w * 64 * NT + 64 * j,
                    full + slot);
      }
    }
  };
  if (threadIdx.x == 0) {
    for (int i = 0; i < stages; ++i) mbar_init(full + i, 1);
    mbar_init_fence();
    for (int t = 0; t < min(T, stages - W); ++t) issue(t);
  }

  // LayerNorm of the rows into As, one warp per row (d <= 1024: up to four
  // 16-byte groups a lane), four rows' loads in flight at once, fp32
  // statistics in two passes, bf16 output
  constexpr int kRows = 4;
  for (int r0 = warp * kRows; r0 < kMlpRows; r0 += 4 * NW * kRows) {
    uint4 raw[kRows][4];
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      const long m = m0 + r0 + k;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int g = lane + 32 * i;
        raw[k][i] = m < M && g < d / 8 ? __ldg(reinterpret_cast<const uint4*>(x + m * d) + g)
                                       : make_uint4(0u, 0u, 0u, 0u);
      }
    }
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      const int r = r0 + k;
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw[k][i]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(h[e]);
          s += f.x + f.y;
        }
      }
      const float mean = warp_sum(s) / d;
      float q = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (lane + 32 * i >= d / 8) continue;
        const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw[k][i]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(h[e]);
          q = fmaf(f.x - mean, f.x - mean, q);
          q = fmaf(f.y - mean, f.y - mean, q);
        }
      }
      const float rstd = rsqrtf(warp_sum(q) / d + 1e-5f);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int g = lane + 32 * i;
        if (g >= dp / 8) continue;
        uint4 o = make_uint4(0u, 0u, 0u, 0u);
        if (m0 + r < M && g < d / 8) {
          const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw[k][i]);
          __nv_bfloat162* y = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 f = __bfloat1622float2(h[e]);
            const int c = 8 * g + 2 * e;
            y[e] = __floats2bfloat162_rn((f.x - mean) * rstd * ln_w[c] + ln_b[c],
                                         (f.y - mean) * rstd * ln_w[c + 1] + ln_b[c + 1]);
          }
        }
        *reinterpret_cast<uint4*>(As + sw128_offset(r, 8 * g, kMlpRows)) = o;
      }
    }
  }
  fence_proxy_async();

  float acc[NT][32], h[32];  // acc[j]: output tile j of this warpgroup
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    h[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) acc[j][i] = 0.f;
  }
  const int wrow = 16 * (warp & 3) + (lane >> 2), wcol = 2 * (lane & 3);
  for (int t = 0; t < T; ++t) {
    __syncthreads();  // tile t - W's reads are done, Gs and As are written
    if (threadIdx.x == 0 && t + stages - W < T) issue(t + stages - W);
    mbar_wait(full + t % stages, (t / stages) & 1);
    const bf16* tile = ring + (t % stages) * NW * kMlpBox + wg * kMlpBox;
    const int c = c_first + t / tpc, u = t % tpc;
    bf16* Gc = Gs + ((c - c_first) % mlp_g_buffers<NT>()) * kMlpRows * HC;  // this chunk's
    if (u < nkd) {  // fc1: h = LN(x)[:, 64 u + ...] w1[chunk rows of this warpgroup]^T
      fence_regs(h);
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < 4; ++s)
        wgmma_m64n64k16(h, wgmma_desc_sw128(As + u * kMlpBox + 16 * s),
                        wgmma_desc_sw128(tile + 16 * s), u > 0 || s > 0);
    } else {  // fc2: acc[j] += G[:, 64 s2 + ...] w2[columns of tile j]^T
      const int v = u - nkd, s2 = v / NT, j = v - s2 * NT;
#pragma unroll
      for (int jj = 0; jj < NT; ++jj) {
        if (jj != j) continue;
        fence_regs(acc[jj]);
        wgmma_fence();
#pragma unroll
        for (int s = 0; s < 4; ++s)
          wgmma_m64n64k16(acc[jj], wgmma_desc_sw128(Gc + s2 * kMlpBox + 16 * s),
                          wgmma_desc_sw128(tile + 16 * s), 1);
      }
    }
    wgmma_commit();
    if (u == nkd - 1) {
      // fc1 of chunk c is complete: b1, exact GELU, bf16 into Gc.  The
      // last fc2 groups to read Gc (chunk c - 2's with two buffers, c - 1's
      // with one) ended at least W tiles ago (nkd >= 2 when NW == 2):
      // every warpgroup has waited for them before the last barrier.
      wgmma_wait<0>();
      fence_regs(h);
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int row = wrow + 8 * ((i >> 1) & 1), col = 64 * wg + 8 * (i >> 2) + wcol;
        const int hc = c * HC + col;
        const float g0 = hc < hid ? gelu_exact(h[i] + b1[hc]) : 0.f;
        const float g1 = hc + 1 < hid ? gelu_exact(h[i + 1] + b1[hc + 1]) : 0.f;
        *reinterpret_cast<__nv_bfloat162*>(Gc + sw128_offset(row, col, kMlpRows)) =
            __floats2bfloat162_rn(g0, g1);
      }
      fence_proxy_async();
    } else {
      wgmma_wait<W - 1>();
    }
  }
  wgmma_wait<0>();
  float* part_s = part ? part + (long)blockIdx.z * M * d : nullptr;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    fence_regs(acc[j]);
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const long row = m0 + wrow + 8 * ((i >> 1) & 1);
      const int col = n_base + wg * 64 * NT + j * 64 + 8 * (i >> 2) + wcol;
      if (row >= M || col >= d) continue;
      if (part_s) {
        *reinterpret_cast<float2*>(part_s + row * d + col) = make_float2(acc[j][i], acc[j][i + 1]);
      } else {
        *reinterpret_cast<__nv_bfloat162*>(out + row * d + col) =
            __floats2bfloat162_rn(acc[j][i] + b2[col], acc[j][i + 1] + b2[col + 1]);
      }
    }
  }
}

// cuTensorMapEncodeTiled from the driver library, found at run time (the
// kernels link only the CUDA runtime).
using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_LOCAL);
    return lib ? reinterpret_cast<EncodeTiledFn>(dlsym(lib, "cuTensorMapEncodeTiled")) : nullptr;
  }();
  return fn;
}

// Tensor map of a row-major (rows, cols) bf16 matrix in 64 x 64 boxes,
// 128-byte swizzle, zeros outside.
bool weight_map(CUtensorMap* map, const bf16* w, int rows, int cols) {
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

// ---- K7 -------------------------------------------------------------------

constexpr int kT = 8;                   // output tile kT x kT pixels
constexpr int kE = kT + 6;              // with the 3-px halo: 14 x 14
constexpr int kEP = kE * kE;            // 196 halo pixels
constexpr int kMP = (kEP + 15) / 16 * 16;  // 208 rows, padded for 16-row tiles
constexpr int kTP = kT * kT;            // 64 output pixels

// One block per (8x8 output tile, image, split).  Shared: ys [208][KC+8] bf16
// (channels [k0, k0+KC) of the LN'd halo tile), h32 [208][HC+4] fp32 (fc1
// chunk of the halo tile), hs [64][HC+8] bf16 (GELU chunk), acc [64][d+4] fp32
// (output tile; b2 and the split partials as in K6).
__global__ void ln_dwms_kernel(const bf16* __restrict__ y, const bf16* __restrict__ w1,
                               const float* __restrict__ b1, const bf16* __restrict__ k3,
                               const float* __restrict__ c3, const bf16* __restrict__ k5,
                               const float* __restrict__ c5, const bf16* __restrict__ k7,
                               const float* __restrict__ c7, const bf16* __restrict__ w2,
                               const float* __restrict__ b2, bf16* __restrict__ out,
                               float* __restrict__ part, int H, int W, int d, int hid, int KC,
                               int HC, int cps) {
  extern __shared__ float4 smem4[];
  const int ldy = KC + 8, ld32 = HC + 4, ldhs = HC + 8, ldacc = d + 4;
  bf16* ys = reinterpret_cast<bf16*>(smem4);
  float* h32 = reinterpret_cast<float*>(ys + kMP * ldy);
  bf16* hs = reinterpret_cast<bf16*>(h32 + kMP * ld32);
  float* acc = reinterpret_cast<float*>(hs + kTP * ldhs);
  const int tiles_x = (W + kT - 1) / kT;
  const int ty0 = (blockIdx.x / tiles_x) * kT, tx0 = (blockIdx.x % tiles_x) * kT;
  const int b = blockIdx.y;
  for (int i = threadIdx.x; i < kTP * d; i += blockDim.x) {
    const int p = i / d, j = i - p * d;
    acc[p * ldacc + j] = part ? 0.f : b2[j];
  }
  int c_first, c_last;
  split_range(hid, HC, cps, &c_first, &c_last);
  for (int c0 = c_first; c0 < c_last; c0 += HC) {
    // fc1 of the halo tile, K-chunked when the whole LN'd tile does not fit
    for (int k0 = 0; k0 < d; k0 += KC) {
      if (KC < d || c0 == c_first) {
        __syncthreads();
        stage_halo(y, b, H, W, d, ty0 - 3, tx0 - 3, kE, kE, kMP, k0, KC, ys, ldy);
        __syncthreads();
      }
      mma_tiles(ys, ldy, w1 + (long)c0 * d + k0, d, h32, ld32, kMP / 16, HC / 16, KC, k0 > 0);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < kEP * HC; i += blockDim.x) {
      const int e = i / HC, j = i - e * HC;
      const int gy = ty0 - 3 + e / kE, gx = tx0 - 3 + e % kE;
      const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
      float* v = h32 + e * ld32 + j;
      *v = inside ? *v + b1[c0 + j] : 0.f;
    }
    __syncthreads();
    {
      // thread -> channel j of the chunk; the block's threads cover HC
      // channels times kThreads / HC pixel groups
      const int j = threadIdx.x % HC, g = threadIdx.x / HC, G = blockDim.x / HC;
      const int c = c0 + j;
      float t3[9], t5[25], t7[49];
#pragma unroll
      for (int i = 0; i < 9; ++i) t3[i] = to_f32(k3[(long)c * 9 + i]);
#pragma unroll
      for (int i = 0; i < 25; ++i) t5[i] = to_f32(k5[(long)c * 25 + i]);
#pragma unroll
      for (int i = 0; i < 49; ++i) t7[i] = to_f32(k7[(long)c * 49 + i]);
      const float cb3 = c3[c], cb5 = c5[c], cb7 = c7[c];
      const float* hj = h32 + j;
      for (int p = g; p < kTP; p += G) {
        const int py = p / kT, px = p % kT;
        float a = hj[((py + 3) * kE + px + 3) * ld32] + cb3;
        a += cb5;
        a += cb7;
#pragma unroll
        for (int u = 0; u < 3; ++u)
#pragma unroll
          for (int v = 0; v < 3; ++v)
            a = fmaf(t3[u * 3 + v], hj[((py + 2 + u) * kE + px + 2 + v) * ld32], a);
#pragma unroll
        for (int u = 0; u < 5; ++u)
#pragma unroll
          for (int v = 0; v < 5; ++v)
            a = fmaf(t5[u * 5 + v], hj[((py + 1 + u) * kE + px + 1 + v) * ld32], a);
#pragma unroll
        for (int u = 0; u < 7; ++u)
#pragma unroll
          for (int v = 0; v < 7; ++v)
            a = fmaf(t7[u * 7 + v], hj[((py + u) * kE + px + v) * ld32], a);
        hs[p * ldhs + j] = __float2bfloat16_rn(gelu_exact(a));
      }
    }
    __syncthreads();
    mma_tiles(hs, ldhs, w2 + c0, hid, acc, ldacc, kTP / 16, d / 16, HC, true);
    __syncthreads();
  }
  float* part_s = part ? part + blockIdx.z * (long)gridDim.y * H * W * d : nullptr;
  for (int i = threadIdx.x; i < kTP * d; i += blockDim.x) {
    const int p = i / d, j = i - p * d;
    const int gy = ty0 + p / kT, gx = tx0 + p % kT;
    if (gy >= H || gx >= W) continue;
    const long o = (((long)b * H + gy) * W + gx) * d + j;
    if (part_s) {
      part_s[o] = acc[p * ldacc + j];
    } else {
      out[o] = __float2bfloat16_rn(acc[p * ldacc + j]);
    }
  }
}

size_t dwms_smem(int d, int KC, int HC) {
  return (size_t)kMP * ((KC + 8) * 2 + (HC + 4) * 4) + (size_t)kTP * ((HC + 8) * 2 + (d + 4) * 4);
}

// ---- K11 ------------------------------------------------------------------

constexpr int kE1 = kT + 2;                 // with the 1-px halo: 10 x 10
constexpr int kEP1 = kE1 * kE1;             // 100 halo pixels
constexpr int kMP1 = (kEP1 + 15) / 16 * 16;  // 112 rows, padded for 16-row tiles

// One block per (8x8 output tile, image, split), as K7.  Shared: ys
// [112][KC+8] bf16 (channels [k0, k0+KC) of the LN'd halo tile), h32
// [112][HC+4] fp32 (fc1 chunk of the halo tile), hs [64][HC+8] bf16 (GELU
// chunk), acc [64][d+4] fp32 (output tile; b2 and the split partials as in
// K6).
__global__ void ln_dwmlp_kernel(const bf16* __restrict__ y, const bf16* __restrict__ w1,
                                const float* __restrict__ b1, const bf16* __restrict__ k3,
                                const float* __restrict__ c3, const bf16* __restrict__ w2,
                                const float* __restrict__ b2, bf16* __restrict__ out,
                                float* __restrict__ part, int H, int W, int d, int hid, int KC,
                                int HC, int cps) {
  extern __shared__ float4 smem4[];
  const int ldy = KC + 8, ld32 = HC + 4, ldhs = HC + 8, ldacc = d + 4;
  bf16* ys = reinterpret_cast<bf16*>(smem4);
  float* h32 = reinterpret_cast<float*>(ys + kMP1 * ldy);
  bf16* hs = reinterpret_cast<bf16*>(h32 + kMP1 * ld32);
  float* acc = reinterpret_cast<float*>(hs + kTP * ldhs);
  const int tiles_x = (W + kT - 1) / kT;
  const int ty0 = (blockIdx.x / tiles_x) * kT, tx0 = (blockIdx.x % tiles_x) * kT;
  const int b = blockIdx.y;
  for (int i = threadIdx.x; i < kTP * d; i += blockDim.x) {
    const int p = i / d, j = i - p * d;
    acc[p * ldacc + j] = part ? 0.f : b2[j];
  }
  int c_first, c_last;
  split_range(hid, HC, cps, &c_first, &c_last);
  for (int c0 = c_first; c0 < c_last; c0 += HC) {
    for (int k0 = 0; k0 < d; k0 += KC) {
      if (KC < d || c0 == c_first) {
        __syncthreads();
        stage_halo(y, b, H, W, d, ty0 - 1, tx0 - 1, kE1, kE1, kMP1, k0, KC, ys, ldy);
        __syncthreads();
      }
      mma_tiles(ys, ldy, w1 + (long)c0 * d + k0, d, h32, ld32, kMP1 / 16, HC / 16, KC, k0 > 0);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < kEP1 * HC; i += blockDim.x) {
      const int e = i / HC, j = i - e * HC;
      const int gy = ty0 - 1 + e / kE1, gx = tx0 - 1 + e % kE1;
      const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
      float* v = h32 + e * ld32 + j;
      *v = inside ? *v + b1[c0 + j] : 0.f;
    }
    __syncthreads();
    {
      // thread -> channel j of the chunk, as in K7
      const int j = threadIdx.x % HC, g = threadIdx.x / HC, G = blockDim.x / HC;
      const int c = c0 + j;
      float t3[9];
#pragma unroll
      for (int i = 0; i < 9; ++i) t3[i] = to_f32(k3[(long)c * 9 + i]);
      const float cb3 = c3[c];
      const float* hj = h32 + j;
      for (int p = g; p < kTP; p += G) {
        const int py = p / kT, px = p % kT;
        float a = cb3;
#pragma unroll
        for (int u = 0; u < 3; ++u)
#pragma unroll
          for (int v = 0; v < 3; ++v)
            a = fmaf(t3[u * 3 + v], hj[((py + u) * kE1 + px + v) * ld32], a);
        hs[p * ldhs + j] = __float2bfloat16_rn(gelu_exact(a));
      }
    }
    __syncthreads();
    mma_tiles(hs, ldhs, w2 + c0, hid, acc, ldacc, kTP / 16, d / 16, HC, true);
    __syncthreads();
  }
  float* part_s = part ? part + blockIdx.z * (long)gridDim.y * H * W * d : nullptr;
  for (int i = threadIdx.x; i < kTP * d; i += blockDim.x) {
    const int p = i / d, j = i - p * d;
    const int gy = ty0 + p / kT, gx = tx0 + p % kT;
    if (gy >= H || gx >= W) continue;
    const long o = (((long)b * H + gy) * W + gx) * d + j;
    if (part_s) {
      part_s[o] = acc[p * ldacc + j];
    } else {
      out[o] = __float2bfloat16_rn(acc[p * ldacc + j]);
    }
  }
}

size_t dwmlp_smem(int d, int KC, int HC) {
  return (size_t)kMP1 * ((KC + 8) * 2 + (HC + 4) * 4) + (size_t)kTP * ((HC + 8) * 2 + (d + 4) * 4);
}

constexpr size_t kSmemMax = 227 * 1024;

// The largest hidden chunk HC (then K chunk KC) whose tiles fit one block of
// K7 (smem = dwms_smem) or K11 (dwmlp_smem; d 320 stages its input in chunks
// of 64 channels).
bool pick_chunks(size_t (*smem)(int, int, int), int d, int hid, int* KC, int* HC) {
  for (int hc = 128; hc >= 16; hc /= 2) {
    if (hid % hc || kThreads % hc) continue;
    const int kcs[] = {d, 256, 128, 64, 32, 16};
    for (int kc : kcs) {
      if (kc > d || d % kc) continue;
      if (smem(d, kc, hc) <= kSmemMax) {
        *KC = kc;
        *HC = hc;
        return true;
      }
    }
  }
  return false;
}

// Splits of the hidden chunks for a grid of `blocks` blocks when the kernel
// holds `smem` bytes of shared memory per block: the wave-quantised time of
// s splits is ceil(blocks * s / slots) / s of one block's full work, slots
// being the blocks the card holds at once.  Returns the fewest splits that
// cut it by more than 10% each time, at most 8 and at most `nchunks`, after
// rounding to whole chunks per split.
template <typename Kern>
int pick_splits(Kern kernel, size_t smem, long blocks, int nchunks, int* splits) {
  cudaError_t e = allow_smem(kernel, smem);
  int per_sm = 0, dev = 0, sms = 0;
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const long slots = std::max(1L, (long)per_sm * sms);
  int best = 1;
  double best_cost = (double)((blocks + slots - 1) / slots);
  for (int s = 2; s <= std::min(8, nchunks); ++s) {
    const double cost = (double)((blocks * s + slots - 1) / slots) / s;
    if (cost < 0.9 * best_cost) {
      best = s;
      best_cost = cost;
    }
  }
  const int cps = (nchunks + best - 1) / best;
  *splits = (nchunks + cps - 1) / cps;
  return 0;
}

int finish_split(const float* part, const float* b2, bf16* out, long n, int d, int S,
                 cudaStream_t s) {
  const long blocks = std::min((n + kThreads - 1) / kThreads, 132L * 8);
  finish_split_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(part, b2, out, n, d, S);
  TRAMBA_CHECK_LAUNCH();
  return 0;
}

// Tiling of one K6 launch (see ln_mlp_kernel).
struct MlpPlan {
  int NW, NT, groups, stages, nchunks;
  size_t smem;
  long rows;  // row tiles of 64
};

bool plan_mlp(long M, int d, int hid, MlpPlan* p) {
  if (d % 8 || hid % 8 || d < 8 || d > 1024 || hid < 8 || M < 1) return false;
  p->NW = d <= 64 ? 1 : 2;
  const int per_block = std::min(d, 512);
  p->NT = (per_block / p->NW + 63) / 64;
  p->groups = (d + 64 * p->NT * p->NW - 1) / (64 * p->NT * p->NW);
  p->nchunks = (hid + 64 * p->NW - 1) / (64 * p->NW);
  p->rows = (M + kMlpRows - 1) / kMlpRows;
  const int dp = (d + 63) & ~63;
  const int in_flight = p->NT > 1 ? 3 : 2, g_buffers = p->NT > 1 ? 2 : 1;
  // the mbarriers (up to 8) and the 1024-byte alignment of the tiles, then
  // the LN rows, the GELU buffers, the ring
  const size_t fixed = 1024 + (size_t)kMlpRows * (dp + g_buffers * 64 * p->NW) * 2;
  const size_t tile = (size_t)kMlpBox * p->NW * 2;
  // two blocks an SM (113 KB each) where the accumulators leave the
  // registers for it and the ring keeps two tiles ahead
  size_t budget = p->NT <= 2 ? 113 * 1024 : kSmemMax;
  if (fixed + (in_flight + 2) * tile > budget) budget = kSmemMax;
  p->stages = (int)std::min<size_t>(8, (budget - std::min(budget, fixed)) / tile);
  p->smem = fixed + (size_t)p->stages * tile;
  return p->stages > in_flight;
}

#define TRAMBA_MLP_DISPATCH(p, ...)                                                     \
  switch ((p).NW * 8 + (p).NT) {                                                         \
    case 9: { constexpr int kNW = 1, kNT = 1; __VA_ARGS__; } break;                      \
    case 17: { constexpr int kNW = 2, kNT = 1; __VA_ARGS__; } break;                     \
    case 18: { constexpr int kNW = 2, kNT = 2; __VA_ARGS__; } break;                     \
    case 19: { constexpr int kNW = 2, kNT = 3; __VA_ARGS__; } break;                     \
    case 20: { constexpr int kNW = 2, kNT = 4; __VA_ARGS__; } break;                     \
    default: return (int)cudaErrorInvalidValue;                                          \
  }

// Splits of the hidden chunks over blocks for K6: s splits take
// ceil(blocks s / slots) waves of 1 / s of a block's products (taken at
// ~2.5 TFLOP/s an SM) and move 8 M d s bytes of fp32 partial sums (at ~2.5
// TB/s); the cheapest s up to 16 and `nchunks`, rounded to whole chunks
// per split.
int pick_mlp_splits(const MlpPlan& p, long M, int d, int hid, int* splits) {
  int per_sm = 0, dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  TRAMBA_MLP_DISPATCH(p, {
    auto kern = ln_mlp_kernel<kNW, kNT>;
    if (e == cudaSuccess) e = allow_smem(kern, p.smem);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, 128 * kNW, p.smem);
  });
  if (e != cudaSuccess) return (int)e;
  const long slots = std::max(1L, (long)per_sm * sms), blocks = p.rows * p.groups;
  const double block_s = 2.0 * kMlpRows * hid * (((d + 63) & ~63) + 64.0 * p.NT * p.NW) / 2.5e12;
  int best = 1;
  double best_cost = 0;
  for (int s = 1; s <= std::min(16, p.nchunks); ++s) {
    const double cost = (double)((blocks * s + slots - 1) / slots) * block_s / s +
                        (s > 1 ? 8.0 * M * d * s / 2.5e12 : 0.0);
    if (s == 1 || cost < best_cost) {
      best = s;
      best_cost = cost;
    }
  }
  const int cps = (p.nchunks + best - 1) / best;
  *splits = (p.nchunks + cps - 1) / cps;
  return 0;
}

}  // namespace

extern "C" {

// bf16 LayerNorm of the rows of x (M, d) into y (M, d); ln_w, ln_b (d) fp32.
int layer_norm_bf16_launch(const bf16* x, const float* ln_w, const float* ln_b, bf16* y, long M,
                           int d, float eps, void* stream) {
  const int rows = kThreads / 32;
  ln_rows_kernel<<<(unsigned)((M + rows - 1) / rows), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(x, ln_w, ln_b, y, M, d, eps);
  TRAMBA_CHECK_LAUNCH();
  return 0;
}

// Splits of the hidden dimension that ln_mlp_launch should use for these
// shapes (see pick_mlp_splits).
int ln_mlp_splits(long M, int d, int hid, int* splits) {
  MlpPlan p;
  if (!plan_mlp(M, d, hid, &p)) return (int)cudaErrorInvalidValue;
  return pick_mlp_splits(p, M, d, hid, splits);
}

// K6.  x (M, d) bf16; ln_w, ln_b (d) fp32 (LayerNorm eps 1e-5, folded in);
// w1 (hid, d) bf16; b1 (hid) fp32; w2 (d, hid) bf16; b2 (d) fp32; out (M, d)
// bf16; `splits` from ln_mlp_splits, with scratch part (splits, M, d) fp32
// when it is above 1.  d, hid multiples of 8, d <= 1024.
int ln_mlp_launch(const bf16* x, const float* ln_w, const float* ln_b, const bf16* w1,
                  const float* b1, const bf16* w2, const float* b2, bf16* out, float* part,
                  long M, int d, int hid, int splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  MlpPlan p;
  if (!plan_mlp(M, d, hid, &p) || splits < 1) return (int)cudaErrorInvalidValue;
  const int cps = (p.nchunks + splits - 1) / splits;
  const int S = (p.nchunks + cps - 1) / cps;
  CUtensorMap map_w1, map_w2;
  if (!weight_map(&map_w1, w1, hid, d) || !weight_map(&map_w2, w2, d, hid))
    return (int)cudaErrorInvalidValue;
  TRAMBA_MLP_DISPATCH(p, {
    auto kern = ln_mlp_kernel<kNW, kNT>;
    cudaError_t e = allow_smem(kern, p.smem);
    if (e != cudaSuccess) return (int)e;
    kern<<<dim3((unsigned)p.rows, p.groups, S), 128 * kNW, p.smem, s>>>(
        map_w1, map_w2, x, ln_w, ln_b, b1, b2, out, S > 1 ? part : nullptr, M, d, hid, cps,
        p.stages);
  });
  TRAMBA_CHECK_LAUNCH();
  return S > 1 ? finish_split(part, b2, out, M * d, d, S, s) : 0;
}

// Splits of the hidden dimension that ln_dwms_mlp_launch should use.
int ln_dwms_mlp_splits(int B, int H, int W, int d, int hid, int* splits) {
  int KC, HC;
  if (d % 16 || hid % 16 || !pick_chunks(dwms_smem, d, hid, &KC, &HC))
    return (int)cudaErrorInvalidValue;
  const long tiles = (long)((H + kT - 1) / kT) * ((W + kT - 1) / kT);
  return pick_splits(ln_dwms_kernel, dwms_smem(d, KC, HC), tiles * B, hid / HC, splits);
}

// K7.  y (B, H, W, d) bf16, already LN'd; w1 (hid, d) bf16; b1 (hid) fp32;
// k3 (hid, 3*3), k5 (hid, 5*5), k7 (hid, 7*7) bf16; c3, c5, c7 (hid) fp32;
// w2 (d, hid) bf16; b2 (d) fp32; out (B, H, W, d) bf16; `splits` from
// ln_dwms_mlp_splits, with scratch part (splits, B, H, W, d) fp32 when it is
// above 1.  d, hid multiples of 16.
int ln_dwms_mlp_launch(const bf16* y, const bf16* w1, const float* b1, const bf16* k3,
                       const float* c3, const bf16* k5, const float* c5, const bf16* k7,
                       const float* c7, const bf16* w2, const float* b2, bf16* out, float* part,
                       int B, int H, int W, int d, int hid, int splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int KC, HC;
  if (d % 16 || hid % 16 || splits < 1 || !pick_chunks(dwms_smem, d, hid, &KC, &HC))
    return (int)cudaErrorInvalidValue;
  const size_t smem = dwms_smem(d, KC, HC);
  cudaError_t e = allow_smem(ln_dwms_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const int tiles = ((H + kT - 1) / kT) * ((W + kT - 1) / kT);
  const int nchunks = hid / HC, cps = (nchunks + splits - 1) / splits;
  const int S = (nchunks + cps - 1) / cps;
  ln_dwms_kernel<<<dim3(tiles, B, S), kThreads, smem, s>>>(
      y, w1, b1, k3, c3, k5, c5, k7, c7, w2, b2, out, S > 1 ? part : nullptr, H, W, d, hid, KC,
      HC, cps);
  TRAMBA_CHECK_LAUNCH();
  return S > 1 ? finish_split(part, b2, out, (long)B * H * W * d, d, S, s) : 0;
}

// Splits of the hidden dimension that ln_dwmlp_launch should use.
int ln_dwmlp_splits(int B, int H, int W, int d, int hid, int* splits) {
  int KC, HC;
  if (d % 16 || hid % 16 || !pick_chunks(dwmlp_smem, d, hid, &KC, &HC))
    return (int)cudaErrorInvalidValue;
  const long tiles = (long)((H + kT - 1) / kT) * ((W + kT - 1) / kT);
  return pick_splits(ln_dwmlp_kernel, dwmlp_smem(d, KC, HC), tiles * B, hid / HC, splits);
}

// K11.  y (B, H, W, d) bf16, already LN'd (eps 1e-6); w1 (hid, d) bf16;
// b1 (hid) fp32; k3 (hid, 3*3) bf16; c3 (hid) fp32; w2 (d, hid) bf16; b2 (d)
// fp32; out (B, H, W, d) bf16; `splits` from ln_dwmlp_splits, with scratch
// part (splits, B, H, W, d) fp32 when it is above 1.  d, hid multiples of 16.
int ln_dwmlp_launch(const bf16* y, const bf16* w1, const float* b1, const bf16* k3,
                    const float* c3, const bf16* w2, const float* b2, bf16* out, float* part,
                    int B, int H, int W, int d, int hid, int splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int KC, HC;
  if (d % 16 || hid % 16 || splits < 1 || !pick_chunks(dwmlp_smem, d, hid, &KC, &HC))
    return (int)cudaErrorInvalidValue;
  const size_t smem = dwmlp_smem(d, KC, HC);
  cudaError_t e = allow_smem(ln_dwmlp_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const int tiles = ((H + kT - 1) / kT) * ((W + kT - 1) / kT);
  const int nchunks = hid / HC, cps = (nchunks + splits - 1) / splits;
  const int S = (nchunks + cps - 1) / cps;
  ln_dwmlp_kernel<<<dim3(tiles, B, S), kThreads, smem, s>>>(
      y, w1, b1, k3, c3, w2, b2, out, S > 1 ? part : nullptr, H, W, d, hid, KC, HC, cps);
  TRAMBA_CHECK_LAUNCH();
  return S > 1 ? finish_split(part, b2, out, (long)B * H * W * d, d, S, s) : 0;
}

}  // extern "C"
