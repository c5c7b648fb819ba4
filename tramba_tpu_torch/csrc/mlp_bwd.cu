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
// Launches of one call, sharing their parts between K9 and K10:
//  (a) mlp_bwd_fc_kernel, row tiles x hidden slices: LN, xf (kept for dW1),
//      h and g w2, both fp32 in device memory (the TPU kernel keeps them in VMEM;
//      here a block holds too little shared memory for a hidden row);
//  (b) K9 mlp_bwd_act_kernel (elementwise) or K10 mlp_bwd_dwms_act_kernel,
//      mlp_bwd_dwms_dh_kernel and mlp_bwd_dwms_tap_kernel (3/5/7 stencils, one
//      thread per channel): hg and bf16(dh), and per-tile partial sums of
//      db1, the taps and dc;
//  (c) mlp_bwd_ln_kernel, row tiles: dxf = bf16(dh) w1, the LN adjoint,
//      per-tile partial sums of dLN and db2;
//  (d) mlp_bwd_wgrad_kernel: dW2 and dW1 as (M-reduction) products A^T B
//      over segments of rows, one output tile per block;
//  (e) the partial sums added in a fixed order: no float atomics, so every
//      result is the same from run to run.
// What bounds them on an H100: the five products (10 M d hid flops, bf16
// wmma tiles with fp32 accumulation as K6/K7) and, at d = 128, the fp32
// h / g w2 maps' round trips through device memory; K10 adds 3 x 83 stencil
// FMAs per hidden value in fp32 SIMT.  Simple and right first: no wgmma, no
// TMA, and the stages are separate launches.
#include <algorithm>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kChan = 128;  // channels per block of the elementwise and stencil launches
constexpr int kTaps = 9 + 25 + 49;
constexpr size_t kSmemMax = 227 * 1024;

__device__ __forceinline__ float gelu_grad(float z) {
  // Phi(z) + z phi(z), as fused_mlp._gelu_grad
  return 0.5f * (1.f + erff(z * 0.70710678118654752f)) +
         z * expf(-0.5f * z * z) * 0.3989422804014327f;
}

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

// ---- (b), K9 ----------------------------------------------------------------

// Rows [R * blockIdx.x, + R) x channels [kChan * blockIdx.y, + kChan):
// dh = gw * GELU'(h) -> bf16, hg = bf16(GELU(h)), and the tile's sum of the
// unrounded dh per channel (part_db1[blockIdx.x, c]).
__global__ void mlp_bwd_act_kernel(const float* __restrict__ h, const float* __restrict__ gw,
                           bf16* __restrict__ hg, bf16* __restrict__ dh,
                           float* __restrict__ part_db1, long M, int hid, int R) {
  const int c = blockIdx.y * kChan + threadIdx.x;
  if (c >= hid) return;
  const long m0 = (long)blockIdx.x * R, m1 = min(M, m0 + R);
  float s = 0.f;
  for (long m = m0; m < m1; ++m) {
    const long o = m * hid + c;
    const float z = h[o];
    const float v = gw[o] * gelu_grad(z);
    hg[o] = __float2bfloat16_rn(gelu_exact(z));
    dh[o] = __float2bfloat16_rn(v);
    s += v;
  }
  part_db1[(long)blockIdx.x * hid + c] = s;
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

// One block per BM rows.  Shared: dhs [BM][HC+8] bf16 (one hidden chunk of
// bf16(dh)), dxf [BM][d+4] fp32, the rows' LN mean and rstd.  dxf = dh w1
// over all chunks, then per row (one warp) the LN adjoint
//   dx = rstd (dxn - mean(dxn) - xn mean(dxn xn)),  dxn = dxf ln_w,
// and per column the block's partial sums of dxf xn (dln_w), dxf (dln_b) and
// g (db2): part[0 / 1 / 2, block, j].
__global__ void mlp_bwd_ln_kernel(const bf16* __restrict__ x, const bf16* __restrict__ g,
                              const float* __restrict__ ln_w, const bf16* __restrict__ w1,
                              const bf16* __restrict__ dh, bf16* __restrict__ dx,
                              float* __restrict__ part, long M, int d, int hid, int BM, int HC) {
  extern __shared__ float4 smem4[];
  const int ldh = HC + 8, ldf = d + 4;
  float* dxf = reinterpret_cast<float*>(smem4);
  float* st = dxf + BM * ldf;  // [BM] mean, [BM] rstd
  bf16* dhs = reinterpret_cast<bf16*>(st + 2 * BM);
  const long m0 = (long)blockIdx.x * BM;
  for (int c0 = 0; c0 < hid; c0 += HC) {
    stage_rows(dh, M, hid, m0, BM, c0, HC, dhs, ldh);
    __syncthreads();
    mma_tiles_ab<wm::row_major, wm::row_major>(dhs, ldh, w1 + (long)c0 * d, d, dxf, ldf, BM / 16,
                                               d / 16, HC, c0 > 0);
    __syncthreads();
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nwarps = blockDim.x >> 5;
  for (int p = warp; p < BM; p += nwarps) {
    if (m0 + p >= M) continue;
    const bf16* xr = x + (m0 + p) * d;
    float mean, rstd;
    row_stats(xr, d, &mean, &rstd);
    const float* fr = dxf + p * ldf;
    float s1 = 0.f, s2 = 0.f;
    for (int i = lane; i < d; i += 32) {
      const float dxn = fr[i] * ln_w[i];
      s1 += dxn;
      s2 = fmaf(dxn, (to_f32(xr[i]) - mean) * rstd, s2);
    }
    s1 = warp_sum(s1) / d;
    s2 = warp_sum(s2) / d;
    for (int i = lane; i < d; i += 32) {
      const float xn = (to_f32(xr[i]) - mean) * rstd;
      dx[(m0 + p) * d + i] = __float2bfloat16_rn(rstd * (fr[i] * ln_w[i] - s1 - xn * s2));
    }
    if (lane == 0) {
      st[p] = mean;
      st[BM + p] = rstd;
    }
  }
  __syncthreads();
  const int rows = (int)min((long)BM, M - m0);
  const long plane = (long)gridDim.x * d;
  for (int j = threadIdx.x; j < d; j += blockDim.x) {
    float sw = 0.f, sb = 0.f, sg = 0.f;
    for (int p = 0; p < rows; ++p) {
      const float f = dxf[p * ldf + j];
      const float xn = (to_f32(x[(m0 + p) * d + j]) - st[p]) * st[BM + p];
      sw = fmaf(f, xn, sw);
      sb += f;
      sg += to_f32(g[(m0 + p) * d + j]);
    }
    part[(long)blockIdx.x * d + j] = sw;
    part[plane + (long)blockIdx.x * d + j] = sb;
    part[2 * plane + (long)blockIdx.x * d + j] = sg;
  }
}

// ---- (d) ------------------------------------------------------------------

constexpr int kWT = 64;   // output tile kWT x kWT
constexpr int kWK = 32;   // rows of M staged per step

// C (I, J) = A^T B over rows [seg * blockIdx.z, + seg) of A (M, I) and
// B (M, J), both bf16 row-major; block (blockIdx.x, blockIdx.y) owns output
// tile (kWT rows of I, kWT columns of J) and keeps it in its warps'
// accumulators (8 warps, 2 of the 16 tiles each); it writes the segment's
// partial to C + blockIdx.z * I * J.  I, J multiples of 16.
__global__ void mlp_bwd_wgrad_kernel(const bf16* __restrict__ A, const bf16* __restrict__ Bm,
                             float* __restrict__ C, long M, int I, int J, long seg) {
  __shared__ __align__(32) bf16 as[kWK * (kWT + 16)];
  __shared__ __align__(32) bf16 bs[kWK * (kWT + 16)];
  constexpr int ld = kWT + 16;
  const int i0 = blockIdx.x * kWT, j0 = blockIdx.y * kWT;
  const int ni = min(kWT, I - i0), nj = min(kWT, J - j0);
  const long q0 = (long)blockIdx.z * seg, q1 = min(M, q0 + seg);
  const int warp = threadIdx.x >> 5;
  wm::fragment<wm::accumulator, 16, 16, 16, float> acc[2];
  wm::fill_fragment(acc[0], 0.f);
  wm::fill_fragment(acc[1], 0.f);
  const int ti0 = (warp * 2) / 4, tj0 = (warp * 2) % 4;  // tiles (ti0, tj0), (ti0, tj0 + 1)
  for (long q = q0; q < q1; q += kWK) {
    for (int e = threadIdx.x; e < kWK * (kWT / 8); e += blockDim.x) {
      const int r = e / (kWT / 8), v = e % (kWT / 8);
      uint4 va = make_uint4(0u, 0u, 0u, 0u), vb = va;
      if (q + r < q1) {
        if (v * 8 < ni) va = __ldg(reinterpret_cast<const uint4*>(A + (q + r) * I + i0) + v);
        if (v * 8 < nj) vb = __ldg(reinterpret_cast<const uint4*>(Bm + (q + r) * J + j0) + v);
      }
      *reinterpret_cast<uint4*>(as + r * ld + v * 8) = va;
      *reinterpret_cast<uint4*>(bs + r * ld + v * 8) = vb;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kWK; k += 16) {
      wm::fragment<wm::matrix_a, 16, 16, 16, bf16, wm::col_major> a;
      wm::load_matrix_sync(a, as + k * ld + ti0 * 16, ld);
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        wm::fragment<wm::matrix_b, 16, 16, 16, bf16, wm::row_major> b;
        wm::load_matrix_sync(b, bs + k * ld + (tj0 + s) * 16, ld);
        wm::mma_sync(acc[s], a, b, acc[s]);
      }
    }
    __syncthreads();
  }
  float* Cz = C + (long)blockIdx.z * I * J;
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int ti = i0 + ti0 * 16, tj = j0 + (tj0 + s) * 16;
    if (ti < I && tj < J)
      wm::store_matrix_sync(Cz + (long)ti * J + tj, acc[s], J, wm::mem_row_major);
  }
}

// out[i] = sum_{s < n} part[s * N + i], s in order.
__global__ void mlp_bwd_sum_parts_kernel(const float* __restrict__ part, int n, long N,
                                 float* __restrict__ out) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  float s = 0.f;
  for (int j = 0; j < n; ++j) s += part[(long)j * N + i];
  out[i] = s;
}

int sum_parts(const float* part, int n, long N, float* out, cudaStream_t s) {
  mlp_bwd_sum_parts_kernel<<<(unsigned)((N + 255) / 256), 256, 0, s>>>(part, n, N, out);
  TRAMBA_CHECK_LAUNCH();
  return 0;
}

// ---- plan -------------------------------------------------------------------

struct Wgrad {
  int S;
  long seg;
};

Wgrad plan_wgrad(long M, int I, int J) {
  const long tiles = (long)((I + kWT - 1) / kWT) * ((J + kWT - 1) / kWT);
  long S = std::max(1L, (2L * 132 + tiles - 1) / tiles);
  S = std::min(S, std::max(1L, M / 512));
  long seg = (M + S - 1) / S;
  seg = (seg + kWK - 1) / kWK * kWK;
  return {(int)((M + seg - 1) / seg), seg};
}

// Tiling and scratch of one call.  dwms: K10 over a (B, H, W) map, else K9
// over M = B rows (H = W = 1).
struct Plan {
  long M;
  int d, hid;
  int BMa, HCa, cps, Sa;  // (a): rows per block, hidden chunk, chunks per slice, slices
  long act_tiles;         // (b): blocks along M of the act / dh launches
  int R, TR, tap_tiles;   // K9 rows per act block; K10 image rows per tap block, tap blocks
  int BMc, HCc;           // (c)
  long c_blocks;
  Wgrad w2, w1;           // (d): dW2 = g^T hg (d, hid), dW1 = dh^T xf (hid, d)
  size_t off[10], total;  // scratch: xf h gw hg dh pdb1 pln pw2 pw1 ptap
};

size_t fc_smem(int BM, int d, int HC) { return (size_t)BM * (2 * (d + 8) * 2 + (HC + 4) * 4); }
size_t ln_bwd_smem(int BM, int d, int HC) {
  return (size_t)BM * ((d + 4) * 4 + 2 * 4 + (HC + 8) * 2);
}

bool make_plan(int dwms, int B, int H, int W, int d, int hid, Plan* p) {
  if (d % 16 || hid % 16 || B < 1 || H < 1 || W < 1) return false;
  const long M = (long)B * H * W;
  p->M = M;
  p->d = d;
  p->hid = hid;
  p->HCa = 128;
  while (hid % p->HCa) p->HCa /= 2;
  p->BMa = 32;
  while (p->BMa > 16 && fc_smem(p->BMa, d, p->HCa) > kSmemMax) p->BMa /= 2;
  if (fc_smem(p->BMa, d, p->HCa) > kSmemMax) return false;
  const long row_blocks = (M + p->BMa - 1) / p->BMa;
  const int nchunks = hid / p->HCa;
  const int want = (int)std::max(1L, std::min((long)nchunks, (2L * 132 + row_blocks - 1) / row_blocks));
  p->cps = (nchunks + want - 1) / want;
  p->Sa = (nchunks + p->cps - 1) / p->cps;
  const int groups = (hid + kChan - 1) / kChan;
  if (dwms) {
    p->R = W;
    p->act_tiles = (long)B * H;
    p->TR = std::max(1, (int)((long)B * H * groups / (4 * 132)));
    p->tap_tiles = (B * H + p->TR - 1) / p->TR;
  } else {
    p->R = 64;
    p->act_tiles = (M + p->R - 1) / p->R;
    p->TR = p->tap_tiles = 0;
  }
  p->HCc = 64;
  while (hid % p->HCc) p->HCc /= 2;
  p->BMc = (M >= 132L * 32 && ln_bwd_smem(32, d, p->HCc) <= kSmemMax) ? 32 : 16;
  if (ln_bwd_smem(p->BMc, d, p->HCc) > kSmemMax) return false;
  p->c_blocks = (M + p->BMc - 1) / p->BMc;
  p->w2 = plan_wgrad(M, d, hid);
  p->w1 = plan_wgrad(M, hid, d);
  const size_t sizes[10] = {
      (size_t)M * d * 2, (size_t)M * hid * 4, (size_t)M * hid * 4, (size_t)M * hid * 2,
      (size_t)M * hid * 2, (size_t)p->act_tiles * hid * 4, (size_t)3 * p->c_blocks * d * 4,
      p->w2.S > 1 ? (size_t)p->w2.S * d * hid * 4 : 0,
      p->w1.S > 1 ? (size_t)p->w1.S * hid * d * 4 : 0,
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

int wgrad(const bf16* A, const bf16* Bm, float* out, float* part, long M, int I, int J, Wgrad w,
          cudaStream_t s) {
  const dim3 grid((I + kWT - 1) / kWT, (J + kWT - 1) / kWT, w.S);
  mlp_bwd_wgrad_kernel<<<grid, kThreads, 0, s>>>(A, Bm, w.S > 1 ? part : out, M, I, J, w.seg);
  TRAMBA_CHECK_LAUNCH();
  return w.S > 1 ? sum_parts(part, w.S, (long)I * J, out, s) : 0;
}

// The launches both adjoints share: (a) before, (c) - (e) after the caller's (b).
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

int run_tail(const Plan& p, void* scratch, const bf16* x, const bf16* g, const float* ln_w,
             const bf16* w1, bf16* dx, float* dw1, float* db1, float* dw2, float* db2,
             float* dln_w, float* dln_b, cudaStream_t s) {
  const bf16* xf = at<bf16>(scratch, p, 0);
  const bf16* hg = at<bf16>(scratch, p, 3);
  const bf16* dh = at<bf16>(scratch, p, 4);
  float* pln = at<float>(scratch, p, 6);
  const size_t smem = ln_bwd_smem(p.BMc, p.d, p.HCc);
  cudaError_t e = allow_smem(mlp_bwd_ln_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  mlp_bwd_ln_kernel<<<(unsigned)p.c_blocks, kThreads, smem, s>>>(x, g, ln_w, w1, dh, dx, pln,
                                                                p.M, p.d, p.hid, p.BMc, p.HCc);
  TRAMBA_CHECK_LAUNCH();
  int rc = wgrad(g, hg, dw2, at<float>(scratch, p, 7), p.M, p.d, p.hid, p.w2, s);
  if (!rc) rc = wgrad(dh, xf, dw1, at<float>(scratch, p, 8), p.M, p.hid, p.d, p.w1, s);
  if (!rc) rc = sum_parts(at<float>(scratch, p, 5), (int)p.act_tiles, p.hid, db1, s);
  const long plane = p.c_blocks * p.d;
  if (!rc) rc = sum_parts(pln, (int)p.c_blocks, p.d, dln_w, s);
  if (!rc) rc = sum_parts(pln + plane, (int)p.c_blocks, p.d, dln_b, s);
  if (!rc) rc = sum_parts(pln + 2 * plane, (int)p.c_blocks, p.d, db2, s);
  return rc;
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

// K9.  x, g (M, d) bf16; ln_w, ln_b (d), b1 (hid) fp32; w1 (hid, d), w2
// (d, hid) bf16.  Outputs: dx (M, d) bf16; dw1 (hid, d), db1 (hid), dw2
// (d, hid), db2 (d), dln_w, dln_b (d) fp32.  scratch: mlp_bwd_scratch(0, M,
// 1, 1, d, hid) bytes, 256-byte aligned.  d, hid multiples of 16.
int ln_mlp_bwd_launch(const bf16* x, const bf16* g, const float* ln_w, const float* ln_b,
                      const bf16* w1, const float* b1, const bf16* w2, bf16* dx, float* dw1,
                      float* db1, float* dw2, float* db2, float* dln_w, float* dln_b,
                      void* scratch, int M, int d, int hid, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Plan p;
  if (!make_plan(0, M, 1, 1, d, hid, &p)) return (int)cudaErrorInvalidValue;
  int rc = run_fc(p, scratch, x, g, ln_w, ln_b, w1, b1, w2, s);
  if (rc) return rc;
  const dim3 act_grid((unsigned)p.act_tiles, (hid + kChan - 1) / kChan);
  mlp_bwd_act_kernel<<<act_grid, kChan, 0, s>>>(
      at<float>(scratch, p, 1), at<float>(scratch, p, 2), at<bf16>(scratch, p, 3),
      at<bf16>(scratch, p, 4), at<float>(scratch, p, 5), p.M, hid, p.R);
  TRAMBA_CHECK_LAUNCH();
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
                           float* dw2, float* db2, float* dln_w, float* dln_b, void* scratch,
                           int B, int H, int W, int d, int hid, void* stream) {
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
