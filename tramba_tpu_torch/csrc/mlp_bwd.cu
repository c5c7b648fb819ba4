// K9 ln_mlp_bwd and K10 ln_dwms_mlp_bwd: the adjoints of K6 and K7, bf16.
//
// K9 replaces _mlp_bwd_pallas (tramba_tpu/ops/fused_mlp.py:233, kernel
// :177-229), the VJP of every fused_ln_mlp; K10 replaces _dwms_bwd_pallas
// (:674, kernel :541-670), the VJP of fused_ln_dwmsmlp, and also the
// composed XLA VJP that JAX runs where that kernel's shape gate fails (d > 256,
// the 24 px decoder FFN).  The rounding points are the TPU kernels':
//   xf = bf16(LN(x)), h = xf w1^T + b1 (fp32), g rounded to bf16,
//   K9:  dh = (g w2) * GELU'(h),  hg = bf16(GELU(h));
//   K10: acc = h + c3 + c5 + c7 + sum_k dwk(h) (bf16 taps, fp32 h; h is 0
//        outside the image), dacc = (g w2) * GELU'(acc), hg = bf16(GELU(acc)),
//        dh = dacc + sum_k corr(flip(k), dacc) (zero padded);
//   dW2 = g^T hg, db2 = sum g, dW1 = bf16(dh)^T xf, db1 = sum dh (unrounded),
//   dxf = bf16(dh) w1, the LN adjoint in fp32 -> dx (bf16), dLN from dxf;
//   K10's tap gradients dk[i, j] = sum dacc(p) h(p + (i, j) - r), dc = sum dacc.
// Weights in torch layout: w1 (hid, d), w2 (d, hid), taps (hid, 1, k, k).
//
// Launches of one call.  K9 (four):
//  front  ln_fc_kernel<true> (common.cuh), one block per (64-row tile,
//         hidden group): LN into a swizzled tile, h = xf w1^T and
//         g w2[:, chunk] on wgmma (k = d) from TMA-fed tiles, then in
//         registers hg = bf16(GELU(h + b1)) and dh = (g w2) GELU'(h + b1),
//         written bf16 with the tile's db1 column sums; xf for dW1.
// K10 keeps its own front (five): (a) mlp_bwd_fc_kernel, row tiles x
//         hidden slices (wmma tiles): xf, h and g w2 as fp32 maps for
//         (b) mlp_bwd_dwms_act_kernel, mlp_bwd_dwms_dh_kernel and
//         mlp_bwd_dwms_tap_kernel (3/5/7 stencils, one thread per channel):
//         hg and bf16(dh), per-row partial sums of db1, the taps and dc, and
//         mlp_bwd_sum_taps_kernel.
// Both then run the same tail:
//  (c) mlp_bwd_dx_kernel: dxf = bf16(dh) w1 on wgmma in 64-row tiles, split
//      over column groups of d (a thread block cluster) where the row tiles
//      alone give less than a wave; the LN adjoint, whose row sums cross the
//      groups through distributed shared memory; per-tile partial sums of
//      dLN and db2;
//  (d) mlp_bwd_wgrad_kernel: dW2 and dW1 in one launch, 128 x 128 output
//      tiles over segments of rows (mma.sync from a cp.async ring);
//  (e) mlp_bwd_sum_kernel: every partial buffer added up in a fixed order in
//      one launch: no float atomics, so every result is the same from run to
//      run.
// What bounds them on an H100: the five products, 10 M d hid operations
// (dh, hg and the weights' tiles cross L2, about 64 operations a byte per
// 64-row tile), above the bytes of x, g, dx and the weights; K10 adds its
// fp32 maps and 3 x 83 stencil FMAs per hidden value in fp32 SIMT (its
// redesign is a later step).
#include <cooperative_groups.h>

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kChan = 128;  // channels per block of the elementwise and stencil launches
constexpr int kTaps = 9 + 25 + 49;

// C (+)= A * B over all 16x16 tiles of an (Mt*16) x (Nt*16) output, as
// common.cuh's mma_tiles but with the layouts of A and B as template
// parameters: LA row_major reads (m, k) at A[m * lda + k], col_major at
// A[k * lda + m]; LB row_major reads (k, n) at B[k * ldb + n], col_major at
// B[n * ldb + k].  A in shared memory; B in shared or global memory; C fp32
// in shared memory.  K % 16 == 0.
template <typename LA, typename LB>
__device__ __forceinline__ void mma_tiles_ab(const bf16* A, int lda, const bf16* B, long ldb,
                                             float* C, int ldc, int Mt, int Nt, int K,
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
      if (accumulate) {
        wm::load_matrix_sync(c[i], C + (m0 + i) * 16 * ldc + nt * 16, ldc, wm::mem_row_major);
      } else {
        wm::fill_fragment(c[i], 0.f);
      }
    }
    for (int k = 0; k < K; k += 16) {
      wm::fragment<wm::matrix_b, 16, 16, 16, bf16, LB> b;
      if constexpr (std::is_same<LB, wm::row_major>::value) {
        wm::load_matrix_sync(b, B + (long)k * ldb + nt * 16, (unsigned)ldb);
      } else {
        wm::load_matrix_sync(b, B + (long)nt * 16 * ldb + k, (unsigned)ldb);
      }
#pragma unroll
      for (int i = 0; i < kMmaGroup; ++i) {
        if (i >= mn) break;
        wm::fragment<wm::matrix_a, 16, 16, 16, bf16, LA> a;
        if constexpr (std::is_same<LA, wm::row_major>::value) {
          wm::load_matrix_sync(a, A + (m0 + i) * 16 * lda + k, lda);
        } else {
          wm::load_matrix_sync(a, A + k * lda + (m0 + i) * 16, lda);
        }
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

// Copy rows [m0, m0 + rows) x columns [k0, k0 + n) of a row-major bf16 (M, ld)
// matrix into shared memory (row stride lds), zero past M.  n, k0, ld
// multiples of 8.
__device__ __forceinline__ void stage_rows(const bf16* __restrict__ src, long M, long ld, long m0,
                                           int rows, long k0, int n, bf16* dst, int lds) {
  const int vn = n / 8;
  for (int i = threadIdx.x; i < rows * vn; i += blockDim.x) {
    const int p = i / vn, v = i - p * vn;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (m0 + p < M) val = __ldg(reinterpret_cast<const uint4*>(src + (m0 + p) * ld + k0) + v);
    *reinterpret_cast<uint4*>(dst + p * lds + v * 8) = val;
  }
}

// LayerNorm statistics of row m of x (M, d) bf16, one warp, two passes (the
// TPU kernel's mean of squared deviations).
__device__ __forceinline__ void row_stats(const bf16* __restrict__ xr, int d, float* mean,
                                          float* rstd) {
  float s = 0.f;
  for (int i = threadIdx.x & 31; i < d; i += 32) s += to_f32(xr[i]);
  const float mu = warp_sum(s) / d;
  float q = 0.f;
  for (int i = threadIdx.x & 31; i < d; i += 32) {
    const float v = to_f32(xr[i]) - mu;
    q = fmaf(v, v, q);
  }
  *mean = mu;
  *rstd = rsqrtf(warp_sum(q) / d + 1e-5f);
}

// ---- (a) ------------------------------------------------------------------

// One block per (BM rows, hidden slice).  Shared: xs, gs [BM][d+8] bf16 (the
// LN'd rows and the rows of g), cs [BM][HC+4] fp32 (one hidden chunk).
// Writes xf (M, d) bf16 (slice 0 only), h = xf w1^T + b1 and gw = g w2, both
// (M, hid) fp32.
__global__ void mlp_bwd_fc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ g,
                          const float* __restrict__ ln_w, const float* __restrict__ ln_b,
                          const bf16* __restrict__ w1, const float* __restrict__ b1,
                          const bf16* __restrict__ w2, bf16* __restrict__ xf,
                          float* __restrict__ h, float* __restrict__ gw, long M, int d, int hid,
                          int BM, int HC, int cps) {
  extern __shared__ float4 smem4[];
  const int ldx = d + 8, ldc = HC + 4;
  bf16* xs = reinterpret_cast<bf16*>(smem4);
  bf16* gs = xs + BM * ldx;
  float* cs = reinterpret_cast<float*>(gs + BM * ldx);
  const long m0 = (long)blockIdx.x * BM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nwarps = blockDim.x >> 5;
  for (int p = warp; p < BM; p += nwarps) {
    bf16* row = xs + p * ldx;
    if (m0 + p >= M) {
      for (int i = lane; i < d; i += 32) row[i] = __float2bfloat16_rn(0.f);
      continue;
    }
    const bf16* xr = x + (m0 + p) * d;
    float mean, rstd;
    row_stats(xr, d, &mean, &rstd);
    for (int i = lane; i < d; i += 32) {
      const bf16 v = __float2bfloat16_rn((to_f32(xr[i]) - mean) * rstd * ln_w[i] + ln_b[i]);
      row[i] = v;
      if (blockIdx.y == 0) xf[(m0 + p) * d + i] = v;
    }
  }
  stage_rows(g, M, d, m0, BM, 0, d, gs, ldx);
  __syncthreads();
  const int c_first = blockIdx.y * cps * HC, c_last = min(hid, c_first + cps * HC);
  for (int c0 = c_first; c0 < c_last; c0 += HC) {
    mma_tiles_ab<wm::row_major, wm::col_major>(xs, ldx, w1 + (long)c0 * d, d, cs, ldc, BM / 16,
                                               HC / 16, d, false);
    __syncthreads();
    for (int i = threadIdx.x; i < BM * HC; i += blockDim.x) {
      const int p = i / HC, j = i - p * HC;
      if (m0 + p < M) h[(m0 + p) * hid + c0 + j] = cs[p * ldc + j] + b1[c0 + j];
    }
    __syncthreads();
    mma_tiles_ab<wm::row_major, wm::row_major>(gs, ldx, w2 + c0, hid, cs, ldc, BM / 16, HC / 16,
                                               d, false);
    __syncthreads();
    for (int i = threadIdx.x; i < BM * HC; i += blockDim.x) {
      const int p = i / HC, j = i - p * HC;
      if (m0 + p < M) gw[(m0 + p) * hid + c0 + j] = cs[p * ldc + j];
    }
    __syncthreads();
  }
}

// ---- (b), K10 ---------------------------------------------------------------

struct Taps {
  float t3[9], t5[25], t7[49];
};

__device__ __forceinline__ void load_taps(const bf16* k3, const bf16* k5, const bf16* k7, int c,
                                          Taps& t) {
#pragma unroll
  for (int i = 0; i < 9; ++i) t.t3[i] = to_f32(k3[(long)c * 9 + i]);
#pragma unroll
  for (int i = 0; i < 25; ++i) t.t5[i] = to_f32(k5[(long)c * 25 + i]);
#pragma unroll
  for (int i = 0; i < 49; ++i) t.t7[i] = to_f32(k7[(long)c * 49 + i]);
}

// v[(b, y, x), c] of a (B, H, W, hid) map, 0 outside the image.
struct MapAt {
  const float* v;
  int H, W, hid, c;
  long base;  // (b * H) * W
  __device__ __forceinline__ float operator()(int y, int x) const {
    return (y >= 0 && y < H && x >= 0 && x < W) ? v[((base + (long)y * W) + x) * hid + c] : 0.f;
  }
};

// One block per (image row b*H + y, kChan channels), a thread per channel,
// walking the row: acc = h + c3 + c5 + c7 + sum_k dwk(h), then in place
// gw := dacc = gw * GELU'(acc), and hg = bf16(GELU(acc)).
__global__ void mlp_bwd_dwms_act_kernel(const float* __restrict__ h, float* __restrict__ gw,
                                bf16* __restrict__ hg, const bf16* __restrict__ k3,
                                const float* __restrict__ c3, const bf16* __restrict__ k5,
                                const float* __restrict__ c5, const bf16* __restrict__ k7,
                                const float* __restrict__ c7, int H, int W, int hid) {
  const int c = blockIdx.y * kChan + threadIdx.x;
  if (c >= hid) return;
  const int b = blockIdx.x / H, y = blockIdx.x % H;
  Taps t;
  load_taps(k3, k5, k7, c, t);
  const MapAt hv{h, H, W, hid, c, (long)b * H * W};
  const float cb3 = c3[c], cb5 = c5[c], cb7 = c7[c];
  for (int x = 0; x < W; ++x) {
    float a = hv(y, x) + cb3;
    a += cb5;
    a += cb7;
#pragma unroll
    for (int u = 0; u < 3; ++u)
#pragma unroll
      for (int v = 0; v < 3; ++v) a = fmaf(t.t3[u * 3 + v], hv(y + u - 1, x + v - 1), a);
#pragma unroll
    for (int u = 0; u < 5; ++u)
#pragma unroll
      for (int v = 0; v < 5; ++v) a = fmaf(t.t5[u * 5 + v], hv(y + u - 2, x + v - 2), a);
#pragma unroll
    for (int u = 0; u < 7; ++u)
#pragma unroll
      for (int v = 0; v < 7; ++v) a = fmaf(t.t7[u * 7 + v], hv(y + u - 3, x + v - 3), a);
    const long o = (((long)b * H + y) * W + x) * hid + c;
    gw[o] = gw[o] * gelu_grad(a);
    hg[o] = __float2bfloat16_rn(gelu_exact(a));
  }
}

// Same blocks: dh = dacc + sum_k sum_{i,j} k[i, j] dacc(y - i + r, x - j + r)
// (the taps' adjoint: a correlation with the flipped taps) -> bf16, and the
// row's sum of the unrounded dh per channel (part_db1[row, c]).
__global__ void mlp_bwd_dwms_dh_kernel(const float* __restrict__ dacc, bf16* __restrict__ dh,
                               const bf16* __restrict__ k3, const bf16* __restrict__ k5,
                               const bf16* __restrict__ k7, float* __restrict__ part_db1, int H,
                               int W, int hid) {
  const int c = blockIdx.y * kChan + threadIdx.x;
  if (c >= hid) return;
  const int b = blockIdx.x / H, y = blockIdx.x % H;
  Taps t;
  load_taps(k3, k5, k7, c, t);
  const MapAt dv{dacc, H, W, hid, c, (long)b * H * W};
  float s = 0.f;
  for (int x = 0; x < W; ++x) {
    float a = dv(y, x);
#pragma unroll
    for (int u = 0; u < 3; ++u)
#pragma unroll
      for (int v = 0; v < 3; ++v) a = fmaf(t.t3[u * 3 + v], dv(y - u + 1, x - v + 1), a);
#pragma unroll
    for (int u = 0; u < 5; ++u)
#pragma unroll
      for (int v = 0; v < 5; ++v) a = fmaf(t.t5[u * 5 + v], dv(y - u + 2, x - v + 2), a);
#pragma unroll
    for (int u = 0; u < 7; ++u)
#pragma unroll
      for (int v = 0; v < 7; ++v) a = fmaf(t.t7[u * 7 + v], dv(y - u + 3, x - v + 3), a);
    dh[(((long)b * H + y) * W + x) * hid + c] = __float2bfloat16_rn(a);
    s += a;
  }
  part_db1[(long)blockIdx.x * hid + c] = s;
}

// One block per (TR image rows, kChan channels): the rows' partial tap
// gradients sum dacc(p) h(p + (i, j) - r) of the 83 taps and sum dacc (the
// gradient of each conv bias), written to part[tile, tap, c] (tap 83: dc).
__global__ void mlp_bwd_dwms_tap_kernel(const float* __restrict__ dacc, const float* __restrict__ h,
                                float* __restrict__ part, int B, int H, int W, int hid, int TR) {
  const int c = blockIdx.y * kChan + threadIdx.x;
  if (c >= hid) return;
  float a3[9], a5[25], a7[49], sc = 0.f;
#pragma unroll
  for (int i = 0; i < 9; ++i) a3[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 25; ++i) a5[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 49; ++i) a7[i] = 0.f;
  const int r0 = blockIdx.x * TR, r1 = min(B * H, r0 + TR);
  for (int r = r0; r < r1; ++r) {
    const int b = r / H, y = r % H;
    const MapAt hv{h, H, W, hid, c, (long)b * H * W};
    for (int x = 0; x < W; ++x) {
      const float da = dacc[(((long)b * H + y) * W + x) * hid + c];
      sc += da;
#pragma unroll
      for (int u = 0; u < 3; ++u)
#pragma unroll
        for (int v = 0; v < 3; ++v) a3[u * 3 + v] = fmaf(da, hv(y + u - 1, x + v - 1), a3[u * 3 + v]);
#pragma unroll
      for (int u = 0; u < 5; ++u)
#pragma unroll
        for (int v = 0; v < 5; ++v) a5[u * 5 + v] = fmaf(da, hv(y + u - 2, x + v - 2), a5[u * 5 + v]);
#pragma unroll
      for (int u = 0; u < 7; ++u)
#pragma unroll
        for (int v = 0; v < 7; ++v) a7[u * 7 + v] = fmaf(da, hv(y + u - 3, x + v - 3), a7[u * 7 + v]);
    }
  }
  float* out = part + (long)blockIdx.x * (kTaps + 1) * hid + c;
#pragma unroll
  for (int i = 0; i < 9; ++i) out[(long)i * hid] = a3[i];
#pragma unroll
  for (int i = 0; i < 25; ++i) out[(long)(9 + i) * hid] = a5[i];
#pragma unroll
  for (int i = 0; i < 49; ++i) out[(long)(34 + i) * hid] = a7[i];
  out[(long)kTaps * hid] = sc;
}

// The tap partials summed over tiles in order, into dk3 (hid, 9), dk5
// (hid, 25), dk7 (hid, 49) and dc3 = dc5 = dc7 (hid); one thread per
// (tap, channel).
__global__ void mlp_bwd_sum_taps_kernel(const float* __restrict__ part, int tiles, int hid,
                                float* __restrict__ dk3, float* __restrict__ dk5,
                                float* __restrict__ dk7, float* __restrict__ dc3,
                                float* __restrict__ dc5, float* __restrict__ dc7) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  const long n = (long)(kTaps + 1) * hid;
  if (i >= n) return;
  const int tap = (int)(i / hid), c = (int)(i % hid);
  float s = 0.f;
  for (int t = 0; t < tiles; ++t) s += part[(long)t * n + i];
  if (tap < 9) {
    dk3[(long)c * 9 + tap] = s;
  } else if (tap < 34) {
    dk5[(long)c * 25 + tap - 9] = s;
  } else if (tap < kTaps) {
    dk7[(long)c * 49 + tap - 34] = s;
  } else {
    dc3[c] = s;
    dc5[c] = s;
    dc7[c] = s;
  }
}

// ---- (c) ------------------------------------------------------------------
//
// dxf = bf16(dh) w1 on wgmma: one block per (64-row tile, column group of
// 64 NW NT columns of d); the G column groups of a row tile form one thread
// block cluster (grid y = cluster y = G).  dh's 64 x 64 boxes (A) and those
// of w1 (hid, d) in its own layout (B, N-major) stream by TMA through
// `stages` slots of the ring, K6's scheme; the dxf tile stays in registers.
// Then the LN adjoint
//   dx = rstd (dxn - mean(dxn) - xn mean(dxn xn)),  dxn = dxf ln_w,
// whose two row means cross the column groups: each block adds up its
// columns' share of the row sums (its warps', then its warpgroups', in a
// fixed order), and every block of the cluster reads all G shares from
// their shared memory (distributed shared memory) in rank order, so every
// block gets the same sums and the result is the same from run to run.  Per
// column, the row tile's partial sums of dxf xn (dln_w), dxf (dln_b) and g
// (db2) go to part[0 / 1 / 2, row tile, column].
namespace cg = cooperative_groups;

template <int NW, int NT>
__global__ void __launch_bounds__(128 * NW, 1)
    mlp_bwd_dx_kernel(const __grid_constant__ CUtensorMap map_dh,
                      const __grid_constant__ CUtensorMap map_w1, const bf16* __restrict__ x,
                      const bf16* __restrict__ g, const float* __restrict__ ln_w,
                      bf16* __restrict__ dx, float* __restrict__ part, long M, int d, int hid,
                      int stages) {
  constexpr int NB = 1 + NW * NT;  // boxes a slot: dh's, then w1's
  extern __shared__ float4 smem4[];
  cg::cluster_group cluster = cg::this_cluster();
  uint64_t* full = reinterpret_cast<uint64_t*>(smem4);  // one mbarrier a slot (8 at most)
  bf16* ring = tiles_start(smem4, 64);
  float* st = reinterpret_cast<float*>(ring + (size_t)stages * NB * kBox);  // [64] mean, rstd
  float* rs = st + 2 * kTileRows;     // [NW][64][2] each warpgroup's row sums
  float* xs = rs + NW * 2 * kTileRows;  // [64][2] this block's share, read by the cluster
  float* tot = xs + 2 * kTileRows;    // [64][2] the two row means over all of d
  float* cs = tot + 2 * kTileRows;    // [NW][4 warps][3][64] column sums
  const int tid = threadIdx.x, wg = tid >> 7, warp = tid >> 5, lane = tid & 31;
  const long m0 = (long)blockIdx.x * kTileRows;
  const int n_base = blockIdx.y * 64 * NW * NT;
  const int T = (hid + 63) / 64;
  auto issue = [&](int t) {
    const int slot = t % stages, k = 64 * t;
    bf16* dst = ring + (size_t)slot * NB * kBox;
    mbar_expect_tx(full + slot, NB * kBox * 2);
    tma_load_2d(dst, &map_dh, k, (int)m0, full + slot);
#pragma unroll
    for (int n = 0; n < NW * NT; ++n)
      tma_load_2d(dst + (1 + n) * kBox, &map_w1, n_base + 64 * n, k, full + slot);
  };
  if (tid == 0) {
    for (int i = 0; i < stages; ++i) mbar_init(full + i, 1);
    mbar_init_fence();
    for (int t = 0; t < min(T, stages - 2); ++t) issue(t);
  }
  // the rows' LayerNorm statistics, as K9's front computed them
  for (int r = warp; r < kTileRows; r += 4 * NW) {
    float mean = 0.f, rstd = 0.f;
    if (m0 + r < M) row_stats(x + (m0 + r) * d, d, &mean, &rstd);
    if (lane == 0) {
      st[r] = mean;
      st[kTileRows + r] = rstd;
    }
  }
  float acc[NT][32];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[j][i] = 0.f;
  for (int t = 0; t < T; ++t) {
    __syncthreads();  // tile t - 2's reads are done
    if (tid == 0 && t + stages - 2 < T) issue(t + stages - 2);
    mbar_wait(full + t % stages, (t / stages) & 1);
    const bf16* tile = ring + (size_t)(t % stages) * NB * kBox;
#pragma unroll
    for (int j = 0; j < NT; ++j) fence_regs(acc[j]);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int s = 0; s < 4; ++s)
        wgmma_m64n64k16<1>(acc[j], wgmma_desc_sw128(tile + 16 * s),
                           wgmma_desc_sw128(tile + (1 + wg * NT + j) * kBox + 1024 * s),
                           t > 0 || s > 0);
    wgmma_commit();
    wgmma_wait<1>();
  }
  wgmma_wait<0>();
#pragma unroll
  for (int j = 0; j < NT; ++j) fence_regs(acc[j]);

  const int wrow = 16 * (warp & 3) + (lane >> 2), wcol = 2 * (lane & 3);
  float r1[2] = {0.f, 0.f}, r2[2] = {0.f, 0.f};  // this thread's two rows
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int e = (i >> 1) & 1, rl = wrow + 8 * e;
      const int col = n_base + 64 * (wg * NT + j) + 8 * (i >> 2) + wcol;
      if (m0 + rl >= M || col >= d) continue;
      const float2 xv =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(x + (m0 + rl) * d + col));
      const float mean = st[rl], rstd = st[kTileRows + rl];
      const float n0 = acc[j][i] * ln_w[col], n1 = acc[j][i + 1] * ln_w[col + 1];
      r1[e] += n0;
      r1[e] += n1;
      r2[e] = fmaf(n0, (xv.x - mean) * rstd, r2[e]);
      r2[e] = fmaf(n1, (xv.y - mean) * rstd, r2[e]);
    }
#pragma unroll
  for (int e = 0; e < 2; ++e) {  // over the four lanes of a row
    r1[e] += __shfl_xor_sync(0xffffffffu, r1[e], 1);
    r1[e] += __shfl_xor_sync(0xffffffffu, r1[e], 2);
    r2[e] += __shfl_xor_sync(0xffffffffu, r2[e], 1);
    r2[e] += __shfl_xor_sync(0xffffffffu, r2[e], 2);
    if ((lane & 3) == 0) {
      rs[(wg * kTileRows + wrow + 8 * e) * 2] = r1[e];
      rs[(wg * kTileRows + wrow + 8 * e) * 2 + 1] = r2[e];
    }
  }
  __syncthreads();
  if (tid < kTileRows) {
    float a = 0.f, b = 0.f;
    for (int w = 0; w < NW; ++w) {
      a += rs[(w * kTileRows + tid) * 2];
      b += rs[(w * kTileRows + tid) * 2 + 1];
    }
    xs[2 * tid] = a;
    xs[2 * tid + 1] = b;
  }
  cluster.sync();
  if (tid < kTileRows) {
    float a = 0.f, b = 0.f;
    for (unsigned r = 0; r < gridDim.y; ++r) {  // the cluster spans grid y
      const float* rx = cluster.map_shared_rank(xs, r);
      a += rx[2 * tid];
      b += rx[2 * tid + 1];
    }
    tot[2 * tid] = a / d;
    tot[2 * tid + 1] = b / d;
  }
  cluster.sync();  // the shares are read, tot is written

#pragma unroll
  for (int j = 0; j < NT; ++j) {
    float sw[16], sb[16], sg[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) sw[k] = sb[k] = sg[k] = 0.f;
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int rl = wrow + 8 * ((i >> 1) & 1), k = (i >> 2) * 2;
      const int col = n_base + 64 * (wg * NT + j) + 8 * (i >> 2) + wcol;
      if (m0 + rl >= M || col >= d) continue;
      const long o = (m0 + rl) * d + col;
      const float2 xv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(x + o));
      const float2 gv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(g + o));
      const float mean = st[rl], rstd = st[kTileRows + rl];
      const float s1 = tot[2 * rl], s2 = tot[2 * rl + 1];
      const float f0 = acc[j][i], f1 = acc[j][i + 1];
      const float xn0 = (xv.x - mean) * rstd, xn1 = (xv.y - mean) * rstd;
      *reinterpret_cast<__nv_bfloat162*>(dx + o) =
          __floats2bfloat162_rn(rstd * (f0 * ln_w[col] - s1 - xn0 * s2),
                                rstd * (f1 * ln_w[col + 1] - s1 - xn1 * s2));
      sw[k] = fmaf(f0, xn0, sw[k]);
      sw[k + 1] = fmaf(f1, xn1, sw[k + 1]);
      sb[k] += f0;
      sb[k + 1] += f1;
      sg[k] += gv.x;
      sg[k + 1] += gv.y;
    }
#pragma unroll
    for (int k = 0; k < 16; ++k) {  // over the warp's 8 row lanes
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        sw[k] += __shfl_xor_sync(0xffffffffu, sw[k], o);
        sb[k] += __shfl_xor_sync(0xffffffffu, sb[k], o);
        sg[k] += __shfl_xor_sync(0xffffffffu, sg[k], o);
      }
    }
    if (lane < 4) {
      float* c = cs + (wg * 4 + (warp & 3)) * 3 * 64;
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        const int cl = 8 * (k >> 1) + wcol + (k & 1);
        c[cl] = sw[k];
        c[64 + cl] = sb[k];
        c[128 + cl] = sg[k];
      }
    }
    __syncthreads();
    for (int it = tid; it < NW * 3 * 64; it += 128 * NW) {  // each warpgroup's four warps in order
      const int w = it / 192, which = (it / 64) % 3, cl = it % 64;
      const int col = n_base + 64 * (w * NT + j) + cl;
      const float* c = cs + (w * 4 * 3 + which) * 64 + cl;
      if (col < d)
        part[((long)which * gridDim.x + blockIdx.x) * d + col] = ((c[0] + c[192]) + c[384]) + c[576];
    }
    __syncthreads();
  }
}

// ---- (d) ------------------------------------------------------------------
//
// dW2 = g^T hg (d, hid) and dW1 = bf16(dh)^T xf (hid, d) in one launch: a
// block computes one 128 x 128 tile of one of them over one segment of
// rows, sum over rows m of A[m, i] B[m, j] with A (M, I) and B (M, J)
// row-major bf16.  32-row slabs of the tile's columns of A and B stream
// through a kWgStages-deep cp.async ring (zeros past the segment and the
// edges); each of the 8 warps owns a 64 x 32 sub-tile as 4 x 4 mma.sync
// m16n8k16 tiles, both fragments read by ldmatrix .trans (the operands are
// stored with the tile's i or j contiguous).  The segment's partial goes to
// part[segment] (fp32, the output's layout); (e) adds the segments in order.
constexpr int kWgT = 128, kWgK = 32, kWgStages = 4, kWgLd = kWgT + 8;
constexpr size_t kWgSmem = (size_t)kWgStages * 2 * kWgK * kWgLd * 2;

struct WgradJob {
  const bf16* A;
  const bf16* B;
  float* part;  // [S][I][J]
  int I, J, tiles_j, tiles;
};

__global__ void __launch_bounds__(256) mlp_bwd_wgrad_kernel(WgradJob j0, WgradJob j1, long M,
                                                            long seg) {
  extern __shared__ float4 smem4[];
  bf16* sm = reinterpret_cast<bf16*>(smem4);
  const bool second = blockIdx.x >= (unsigned)j0.tiles;
  const WgradJob jb = second ? j1 : j0;
  const int tile = blockIdx.x - (second ? j0.tiles : 0);
  const int i0 = (tile / jb.tiles_j) * kWgT, jj0 = (tile % jb.tiles_j) * kWgT;
  const long q0 = (long)blockIdx.z * seg, q1 = min(M, q0 + seg);
  const int nk = (int)((q1 - q0 + kWgK - 1) / kWgK);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wi = warp & 1, wj = warp >> 1;  // sub-tile rows 64 wi, columns 32 wj
  auto load = [&](int ks) {
    bf16* sa = sm + (ks % kWgStages) * 2 * kWgK * kWgLd;
    bf16* sb = sa + kWgK * kWgLd;
    const long q = q0 + (long)ks * kWgK;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int e = tid + 256 * r, row = e >> 4, ch = e & 15;  // 32 rows x 16 chunks of 8
      const bool vr = q + row < q1;
      const int ci = i0 + 8 * ch, cj = jj0 + 8 * ch;
      const bool va = vr && ci < jb.I, vb = vr && cj < jb.J;
      cp_async16(sa + row * kWgLd + 8 * ch, va ? jb.A + (q + row) * jb.I + ci : jb.A, va);
      cp_async16(sb + row * kWgLd + 8 * ch, vb ? jb.B + (q + row) * jb.J + cj : jb.B, vb);
    }
  };
  float acc[4][4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[a][b][c] = 0.f;
#pragma unroll
  for (int s = 0; s < kWgStages - 1; ++s) {
    if (s < nk) load(s);
    cp_async_commit();
  }
  const int lq = lane >> 3, lr = lane & 7;
  for (int ks = 0; ks < nk; ++ks) {
    cp_async_wait<kWgStages - 2>();
    __syncthreads();  // slab ks has landed; slab ks - 1's slot is free
    if (ks + kWgStages - 1 < nk) load(ks + kWgStages - 1);
    cp_async_commit();
    const bf16* sa = sm + (ks % kWgStages) * 2 * kWgK * kWgLd;
    const bf16* sb = sa + kWgK * kWgLd;
#pragma unroll
    for (int kk = 0; kk < kWgK; kk += 16) {
      unsigned a[4][4], b[2][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
        ldmatrix_x4_trans(a[mt], sa + (kk + lr + 8 * (lq >> 1)) * kWgLd + 64 * wi + 16 * mt +
                                     8 * (lq & 1));
#pragma unroll
      for (int p = 0; p < 2; ++p)
        ldmatrix_x4_trans(b[p], sb + (kk + lr + 8 * (lq & 1)) * kWgLd + 32 * wj + 16 * p +
                                    8 * (lq >> 1));
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma_bf16_16816(acc[mt][nt], a[mt], b[nt >> 1][2 * (nt & 1)],
                         b[nt >> 1][2 * (nt & 1) + 1]);
    }
  }
  cp_async_wait<0>();
  float* out = jb.part + (long)blockIdx.z * jb.I * jb.J;
  const int g8 = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = i0 + 64 * wi + 16 * mt + g8 + 8 * h, j = jj0 + 32 * wj + 8 * nt + 2 * t4;
        if (i < jb.I && j < jb.J)
          *reinterpret_cast<float2*>(out + (long)i * jb.J + j) =
              make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
      }
}

// ---- (e) ------------------------------------------------------------------
//
// Every partial buffer of one call added up in one launch: job blockIdx.y,
// out[i] = sum over s < n of part[s N + i], s in order (no float atomics,
// so every result is the same from run to run).
struct SumJob {
  const float* part;
  float* out;
  long N;
  int n;
};
constexpr int kSumJobs = 6;
struct SumJobs {
  SumJob job[kSumJobs];
};

__global__ void mlp_bwd_sum_kernel(SumJobs jobs) {
  const SumJob jb = jobs.job[blockIdx.y];
  for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x; i < jb.N;
       i += (long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < jb.n; ++k) s += jb.part[(long)k * jb.N + i];
    jb.out[i] = s;
  }
}

// ---- plan -------------------------------------------------------------------

// Tiling and scratch of one call.  dwms: K10 over a (B, H, W) map, else K9
// over M = B rows (H = W = 1).
struct Plan {
  long M, R;  // rows, 64-row tiles
  int d, hid;
  FrontPlan front;        // K9's front
  int BMa, HCa, cps, Sa;  // K10's (a): rows per block, hidden chunk, chunks per slice, slices
  long act_tiles;         // K10's (b): image rows, the db1 partials' count
  int TR, tap_tiles;      // K10's image rows per tap block, tap blocks
  int G, NW, NT, stages_c;  // (c): column groups (cluster size), warpgroups, tiles, ring slots
  size_t smem_c;
  int S;     // (d): row segments
  long seg;  // rows per segment
  size_t off[10], total;  // scratch: xf h gw hg dh pdb1 pln pw2 pw1 ptap
};

size_t fc_smem(int BM, int d, int HC) { return (size_t)BM * (2 * (d + 8) * 2 + (HC + 4) * 4); }

// (c): the fewest column groups G (a divisor of d's 64-column tiles, at most
// 8, a cluster) of 1, 2, 4 or 8 tiles each that give the row tiles a wave
// of 132 blocks, else the most; one warpgroup at one tile a block, else two.
bool plan_dx(Plan* p) {
  const int nt = (p->d + 63) / 64;
  int G = 0;
  for (int g = 1; g <= 8; ++g) {
    const int ct = nt % g ? 0 : nt / g;
    if (ct != 1 && ct != 2 && ct != 4 && ct != 8) continue;
    G = g;
    if (p->R * g >= 132) break;
  }
  if (!G) return false;
  p->G = G;
  p->NW = nt / G == 1 ? 1 : 2;
  p->NT = nt / G / p->NW;
  const size_t fixed = 1024 + (size_t)(2 + 2 * p->NW + 2 + 2) * kTileRows * 4 +
                       (size_t)p->NW * 4 * 3 * 64 * 4;
  const size_t slot = (size_t)(1 + p->NW * p->NT) * kBox * 2;
  const size_t budget = fixed + 4 * slot <= 113 * 1024 ? 113 * 1024 : kSmemBlock;
  p->stages_c = (int)std::min<size_t>(8, (budget - std::min(budget, fixed)) / slot);
  p->smem_c = fixed + (size_t)p->stages_c * slot;
  return p->stages_c >= 3;
}

bool make_plan(int dwms, int B, int H, int W, int d, int hid, Plan* p) {
  if (d % 16 || hid % 16 || d < 16 || d > 1024 || hid < 16 || B < 1 || H < 1 || W < 1)
    return false;
  const long M = (long)B * H * W;
  p->M = M;
  p->R = (M + kTileRows - 1) / kTileRows;
  p->d = d;
  p->hid = hid;
  if (!plan_dx(p)) return false;
  if (dwms) {
    p->HCa = 128;
    while (hid % p->HCa) p->HCa /= 2;
    p->BMa = 32;
    while (p->BMa > 16 && fc_smem(p->BMa, d, p->HCa) > kSmemBlock) p->BMa /= 2;
    if (fc_smem(p->BMa, d, p->HCa) > kSmemBlock) return false;
    const long row_blocks = (M + p->BMa - 1) / p->BMa;
    const int nchunks = hid / p->HCa;
    const int want =
        (int)std::max(1L, std::min((long)nchunks, (2L * 132 + row_blocks - 1) / row_blocks));
    p->cps = (nchunks + want - 1) / want;
    p->Sa = (nchunks + p->cps - 1) / p->cps;
    p->act_tiles = (long)B * H;
    p->TR = std::max(1, (int)((long)B * H * ((hid + kChan - 1) / kChan) / (4 * 132)));
    p->tap_tiles = (B * H + p->TR - 1) / p->TR;
  } else {
    if (!plan_front(M, d, hid, true, &p->front)) return false;
    p->act_tiles = p->R;
    p->TR = p->tap_tiles = 0;
  }
  // (d): segments of whole 32-row slabs, about two blocks an SM in all
  const long tiles = 2L * ((d + kWgT - 1) / kWgT) * ((hid + kWgT - 1) / kWgT);
  long S = std::max(1L, std::min((2L * 132 + tiles - 1) / tiles, M / 256));
  p->seg = ((M + S - 1) / S + kWgK - 1) / kWgK * kWgK;
  p->S = (int)((M + p->seg - 1) / p->seg);
  const size_t mh = (size_t)M * hid;
  const size_t sizes[10] = {(size_t)M * d * 2,
                            dwms ? mh * 4 : 0,
                            dwms ? mh * 4 : 0,
                            mh * 2,
                            mh * 2,
                            (size_t)p->act_tiles * hid * 4,
                            (size_t)3 * p->R * d * 4,
                            (size_t)p->S * d * hid * 4,
                            (size_t)p->S * hid * d * 4,
                            (size_t)p->tap_tiles * (kTaps + 1) * hid * 4};
  size_t o = 0;
  for (int i = 0; i < 10; ++i) {
    p->off[i] = o;
    o += (sizes[i] + 255) / 256 * 256;
  }
  p->total = o;
  return true;
}

template <typename T>
T* at(void* scratch, const Plan& p, int i) {
  return reinterpret_cast<T*>(static_cast<char*>(scratch) + p.off[i]);
}

#define TRAMBA_DX_DISPATCH(p, ...)                                     \
  switch ((p).NW * 8 + (p).NT) {                                       \
    case 9: { constexpr int kNW = 1, kNT = 1; __VA_ARGS__; } break;    \
    case 17: { constexpr int kNW = 2, kNT = 1; __VA_ARGS__; } break;   \
    case 18: { constexpr int kNW = 2, kNT = 2; __VA_ARGS__; } break;   \
    case 20: { constexpr int kNW = 2, kNT = 4; __VA_ARGS__; } break;   \
    default: return (int)cudaErrorInvalidValue;                        \
  }

// K10's (a): the LN'd rows, h and g w2 as fp32 maps for its stencils.
int run_fc(const Plan& p, void* scratch, const bf16* x, const bf16* g, const float* ln_w,
           const float* ln_b, const bf16* w1, const float* b1, const bf16* w2, cudaStream_t s) {
  const size_t smem = fc_smem(p.BMa, p.d, p.HCa);
  cudaError_t e = allow_smem(mlp_bwd_fc_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  mlp_bwd_fc_kernel<<<dim3((unsigned)((p.M + p.BMa - 1) / p.BMa), p.Sa), kThreads, smem, s>>>(
      x, g, ln_w, ln_b, w1, b1, w2, at<bf16>(scratch, p, 0), at<float>(scratch, p, 1),
      at<float>(scratch, p, 2), p.M, p.d, p.hid, p.BMa, p.HCa, p.cps);
  TRAMBA_CHECK_LAUNCH();
  return 0;
}

// (c) - (e), which both adjoints share, after xf, hg, bf16(dh) and the db1
// partials are in the scratch.
int run_tail(const Plan& p, void* scratch, const bf16* x, const bf16* g, const float* ln_w,
             const bf16* w1, bf16* dx, float* dw1, float* db1, float* dw2, float* db2,
             float* dln_w, float* dln_b, cudaStream_t s) {
  const bf16* xf = at<bf16>(scratch, p, 0);
  const bf16* hg = at<bf16>(scratch, p, 3);
  const bf16* dh = at<bf16>(scratch, p, 4);
  float* pln = at<float>(scratch, p, 6);
  CUtensorMap map_dh, map_w1;
  if (!weight_map(&map_dh, dh, p.M, p.hid) || !weight_map(&map_w1, w1, p.hid, p.d))
    return (int)cudaErrorInvalidValue;
  TRAMBA_DX_DISPATCH(p, {
    auto kern = mlp_bwd_dx_kernel<kNW, kNT>;
    cudaError_t e = allow_smem(kern, p.smem_c);
    if (e != cudaSuccess) return (int)e;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)p.R, p.G, 1);
    cfg.blockDim = dim3(128 * kNW, 1, 1);
    cfg.dynamicSmemBytes = p.smem_c;
    cfg.stream = s;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 1;
    attr[0].val.clusterDim.y = p.G;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    e = cudaLaunchKernelEx(&cfg, kern, map_dh, map_w1, x, g, ln_w, dx, pln, p.M, p.d, p.hid,
                           p.stages_c);
    if (e != cudaSuccess) return (int)e;
  });
  TRAMBA_CHECK_LAUNCH();
  float* pw2 = at<float>(scratch, p, 7);
  float* pw1 = at<float>(scratch, p, 8);
  const int ti = (p.d + kWgT - 1) / kWgT, tj = (p.hid + kWgT - 1) / kWgT;
  const WgradJob j2{g, hg, pw2, p.d, p.hid, tj, ti * tj};   // dW2 = g^T hg
  const WgradJob j1{dh, xf, pw1, p.hid, p.d, ti, tj * ti};  // dW1 = bf16(dh)^T xf
  cudaError_t e = allow_smem(mlp_bwd_wgrad_kernel, kWgSmem);
  if (e != cudaSuccess) return (int)e;
  mlp_bwd_wgrad_kernel<<<dim3(j2.tiles + j1.tiles, 1, p.S), 256, kWgSmem, s>>>(j2, j1, p.M,
                                                                         p.seg);
  TRAMBA_CHECK_LAUNCH();
  const long plane = p.R * p.d;
  const SumJobs jobs{{{pw2, dw2, (long)p.d * p.hid, p.S},
                      {pw1, dw1, (long)p.hid * p.d, p.S},
                      {at<float>(scratch, p, 5), db1, p.hid, (int)p.act_tiles},
                      {pln, dln_w, p.d, (int)p.R},
                      {pln + plane, dln_b, p.d, (int)p.R},
                      {pln + 2 * plane, db2, p.d, (int)p.R}}};
  const long blocks = std::min(((long)p.d * p.hid + 255) / 256, 264L);
  mlp_bwd_sum_kernel<<<dim3((unsigned)blocks, kSumJobs), 256, 0, s>>>(jobs);
  TRAMBA_CHECK_LAUNCH();
  return 0;
}

}  // namespace

extern "C" {

// Bytes of scratch ln_mlp_bwd_launch (dwms = 0; B = M rows, H = W = 1) or
// ln_dwms_mlp_bwd_launch (dwms = 1) needs at these shapes.
int mlp_bwd_scratch(int dwms, int B, int H, int W, int d, int hid, long* bytes) {
  Plan p;
  if (!make_plan(dwms, B, H, W, d, hid, &p)) return (int)cudaErrorInvalidValue;
  *bytes = (long)p.total;
  return 0;
}

// Column groups G of stage (c) (plan_dx) for M rows of width d, hidden hid
// (K10's M = B H W plans the same); 0 for shapes the kernels do not take.
int mlp_bwd_column_groups(int M, int d, int hid) {
  Plan p;
  return make_plan(0, M, 1, 1, d, hid, &p) ? p.G : 0;
}

// K9.  x, g (M, d) bf16; ln_w, ln_b (d), b1 (hid) fp32; w1 (hid, d) and w2
// (d, hid) bf16.  Outputs: dx (M, d) bf16; dw1 (hid, d), db1 (hid), dw2
// (d, hid), db2 (d), dln_w, dln_b (d) fp32.  scratch: mlp_bwd_scratch(0, M,
// 1, 1, d, hid) bytes, 256-byte aligned.  d, hid multiples of 16, d <= 1024.
// Four launches: the front, (c), (d), (e).
int ln_mlp_bwd_launch(const bf16* x, const bf16* g, const float* ln_w, const float* ln_b,
                      const bf16* w1, const float* b1, const bf16* w2, bf16* dx, float* dw1,
                      float* db1, float* dw2, float* db2, float* dln_w, float* dln_b,
                      void* scratch, int M, int d, int hid, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Plan p;
  if (!make_plan(0, M, 1, 1, d, hid, &p)) return (int)cudaErrorInvalidValue;
  CUtensorMap map_w1, map_g, map_w2;
  if (!weight_map(&map_w1, w1, hid, d) || !weight_map(&map_g, g, M, d) ||
      !weight_map(&map_w2, w2, d, hid))
    return (int)cudaErrorInvalidValue;
  const int rc = front_launch<true>(p.front, map_w1, map_g, map_w2, x, ln_w, ln_b, b1, nullptr,
                                    at<bf16>(scratch, p, 0), at<bf16>(scratch, p, 3),
                                    at<bf16>(scratch, p, 4), at<float>(scratch, p, 5), M, d,
                                    hid, MergedTaps{}, s);
  if (rc) return rc;
  return run_tail(p, scratch, x, g, ln_w, w1, dx, dw1, db1, dw2, db2, dln_w, dln_b, s);
}

// K10.  x, g (B, H, W, d) bf16; ln_w, ln_b (d), b1 (hid), c3, c5, c7 (hid)
// fp32; w1 (hid, d), k3 (hid, 3*3), k5 (hid, 5*5), k7 (hid, 7*7), w2
// (d, hid) bf16.  Outputs: dx (B, H, W, d) bf16; dw1 (hid, d), db1, dk3,
// dk5, dk7 (as the taps), dc3, dc5, dc7 (hid), dw2 (d, hid), db2, dln_w,
// dln_b (d) fp32.  scratch: mlp_bwd_scratch(1, B, H, W, d, hid) bytes.
int ln_dwms_mlp_bwd_launch(const bf16* x, const bf16* g, const float* ln_w, const float* ln_b,
                           const bf16* w1, const float* b1, const bf16* k3, const float* c3,
                           const bf16* k5, const float* c5, const bf16* k7, const float* c7,
                           const bf16* w2, bf16* dx, float* dw1, float* db1, float* dk3,
                           float* dc3, float* dk5, float* dc5, float* dk7, float* dc7,
                           float* dw2, float* db2, float* dln_w, float* dln_b,
                           void* scratch, int B, int H, int W, int d, int hid, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Plan p;
  if (!make_plan(1, B, H, W, d, hid, &p)) return (int)cudaErrorInvalidValue;
  int rc = run_fc(p, scratch, x, g, ln_w, ln_b, w1, b1, w2, s);
  if (rc) return rc;
  float* h = at<float>(scratch, p, 1);
  float* dacc = at<float>(scratch, p, 2);  // g w2, then dacc in place
  const dim3 rows_grid((unsigned)(B * H), (hid + kChan - 1) / kChan);
  mlp_bwd_dwms_act_kernel<<<rows_grid, kChan, 0, s>>>(h, dacc, at<bf16>(scratch, p, 3), k3, c3,
                                                      k5, c5, k7, c7, H, W, hid);
  TRAMBA_CHECK_LAUNCH();
  mlp_bwd_dwms_dh_kernel<<<rows_grid, kChan, 0, s>>>(dacc, at<bf16>(scratch, p, 4), k3, k5, k7,
                                                     at<float>(scratch, p, 5), H, W, hid);
  TRAMBA_CHECK_LAUNCH();
  float* ptap = at<float>(scratch, p, 9);
  mlp_bwd_dwms_tap_kernel<<<dim3(p.tap_tiles, (hid + kChan - 1) / kChan), kChan, 0, s>>>(
      dacc, h, ptap, B, H, W, hid, p.TR);
  TRAMBA_CHECK_LAUNCH();
  const long nt = (long)(kTaps + 1) * hid;
  mlp_bwd_sum_taps_kernel<<<(unsigned)((nt + 255) / 256), 256, 0, s>>>(ptap, p.tap_tiles, hid,
                                                                       dk3, dk5, dk7, dc3, dc5,
                                                                       dc7);
  TRAMBA_CHECK_LAUNCH();
  return run_tail(p, scratch, x, g, ln_w, w1, dx, dw1, db1, dw2, db2, dln_w, dln_b, s);
}

}  // extern "C"
