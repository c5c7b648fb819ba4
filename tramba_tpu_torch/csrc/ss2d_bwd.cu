// K8 ss2d_scan_bwd: the adjoint of K1 for every scan order, fp32 or bf16.
//
// Replaces the backward Pallas kernels of tramba_tpu/ops/fused_ss2d.py:
// _dirs_bwd_call (:638, via _rows_bwd_pallas :689 and _cols_bwd_pallas :698,
// also for the window/dilation families through _seq_rows_bwd :1167) and
// _seq_bwd_pallas (:747, the line directions).  Their shared body is
// _bwd_chunk_math (:520-583).  On the TPU each direction is its own call and
// a forward-scanning direction walks its chunks in the other order from a
// reversed one; here every direction is a gather table idx[k, t] (as in K1),
// so the adjoint of every direction walks its chunks from last to first.
//
// Forward (K1), per (b, k, d), t = 0..L-1, p_t = idx[k, t]:
//   u = x[b, p_t],  [dt_r, B, C] = dbc[b, p_t, k],  v = bias + dt . wdt[k, d]
//   delta = softplus(v),  a = exp(delta A),  h_t = a h_{t-1} + delta B u,
//   y_t = C h_t + Ds u,   summed into pixel p_t by K2.
// Adjoint, with g_t = g_y[b, p_t] (the merge summed every occurrence of a
// pixel, so its adjoint is a gather):
//   lam_t = g_t C_t + a_{t+1} lam_{t+1}
//   ddt   = (lam h_{t-1} a A + lam u B) sigmoid(v)
//   du    = lam delta B + g Ds + sum_c d_dbc[c] wx[k, c, d]
//   d_dbc = (sum_d ddt wdt[k, d, :], sum_d lam delta u, sum_d g h)
//   dwx[k] = sum_{b,t} d_dbc (x) u,  dwdt[k] = sum_{b,t} ddt (x) dt_r,
//   dbias = sum ddt,  dA = sum lam h_{t-1} a delta,  dDs = sum g u.
//
// Six launches in one call (ss2d_scan_bwd_launch):
//  (a) adjoint scan, one warp per (32 channels, k, b), as K1: a chunk of
//      kScanChunk steps (K1's chunk) is staged one ahead with cp.async, its states h are
//      recomputed in shared memory from the carry K1 emitted, then lam runs
//      backwards.  Writes du's direct part and ddt per (b, k, t, d), the
//      32-channel partial sums of the dB and dC terms per (b, k, t), and the
//      per-(b, k, d) sums of dbias, dA and dDs (one warp owns each).
//  (b) d_dbc per (b, k, t): one warp per row reduces ddt . wdt over D and the
//      dB / dC partials.
//  (c) dx per pixel: a gather through K2's multi-slot inverse table of
//      du + d_dbc . wx[k] over every k and slot, so no scatter and no float
//      atomics.
//  (d) dwx and dwdt partials over blocks of 64 (b, t) rows per k, each block
//      one slice of 128 channels;
//  (e) the partials summed in a fixed order (one launch per weight).
//
// bf16 (the backward of #13's emit_train route, fused_ss2d_small.py:393-469,
// and of _full_bwd / _freq_bwd in bf16): x (K5's post-SiLU u) and g_y (the
// LN adjoint's cotangent, in y_sum's dtype) are bf16, staged two channels a
// lane as K1 stages a bf16 x, and dx is written in bf16; everything else is
// fp32 as in the fp32 variant.  The bf16 launches are instantiations of
// their own (T = bf16) beside the fp32 ones.
//
// What bounds it on an H100: (a) is the same chain of L dependent steps per
// channel as K1 and is latency-bound on few blocks; (b)-(d) are small SIMT
// reductions and products.  Plain SIMT, no tensor cores: correct first.
#include <cuda_pipeline.h>

#include "common.cuh"

namespace {

constexpr int kT = kScanChunk;  // steps per chunk: K1's, the carries' stride

// Asynchronous copies of chunk [t0, t0 + n) of direction k into one stage
// buffer: u[t][lane] = x[b, pix_t, d0 + lane], g[t][lane] = g_y[b, pix_t,
// d0 + lane], dbc[t][:] = dbc[b, pix_t, k, :]; pix_t = idx[k, t0 + t] is held
// in registers, t = lane (pix0) and t = lane + 32 (pix1).
__device__ __forceinline__ void stage_bwd(float* u_s, float* g_s, float* dbc_s, const float* x_b,
                                          const float* g_b, const float* dbc_b, int pix0,
                                          int pix1, int n, int D, int d0, int K, int k, int C) {
  const int lane = threadIdx.x;
#pragma unroll 4
  for (int t = 0; t < kT; ++t) {
    const int pix = __shfl_sync(0xffffffffu, t < 32 ? pix0 : pix1, t & 31);
    if (t < n) {
      const long off = (long)pix * D + d0 + lane;
      __pipeline_memcpy_async(u_s + t * 32 + lane, x_b + off, 4);
      __pipeline_memcpy_async(g_s + t * 32 + lane, g_b + off, 4);
    }
  }
  for (int i = lane; i < kT * C; i += 32) {
    const int t = i / C, c = i - t * C;
    const int p0 = __shfl_sync(0xffffffffu, pix0, t & 31);
    const int p1 = __shfl_sync(0xffffffffu, pix1, t & 31);
    if (t < n) __pipeline_memcpy_async(dbc_s + i, dbc_b + ((long)(t < 32 ? p0 : p1) * K + k) * C + c, 4);
  }
  __pipeline_commit();
}

// The same for bf16 u and g: a pair of channels per lane, two steps per
// copy (lanes 0-15 and 16-31), as K1's bf16 stage_u.
__device__ __forceinline__ void stage_bwd(bf16* u_s, bf16* g_s, float* dbc_s, const bf16* x_b,
                                          const bf16* g_b, const float* dbc_b, int pix0,
                                          int pix1, int n, int D, int d0, int K, int k, int C) {
  const int lane = threadIdx.x, half = lane >> 4, c2 = 2 * (lane & 15);
#pragma unroll 4
  for (int t2 = 0; t2 < kT; t2 += 2) {
    const int t = t2 + half;  // t2 even: t and t2 lie on one side of 32
    const int pix = __shfl_sync(0xffffffffu, t2 < 32 ? pix0 : pix1, t & 31);
    if (t < n) {
      const long off = (long)pix * D + d0 + c2;
      __pipeline_memcpy_async(u_s + t * 32 + c2, x_b + off, 4);
      __pipeline_memcpy_async(g_s + t * 32 + c2, g_b + off, 4);
    }
  }
  for (int i = lane; i < kT * C; i += 32) {
    const int t = i / C, c = i - t * C;
    const int p0 = __shfl_sync(0xffffffffu, pix0, t & 31);
    const int p1 = __shfl_sync(0xffffffffu, pix1, t & 31);
    if (t < n) __pipeline_memcpy_async(dbc_s + i, dbc_b + ((long)(t < 32 ? p0 : p1) * K + k) * C + c, 4);
  }
  __pipeline_commit();
}

// (a) One warp per (32 channels, direction k, batch b).
template <int RMAX, typename T>
__global__ void bwd_scan_kernel(const T* __restrict__ x, const int* __restrict__ idx,
                                const T* __restrict__ gy, const float* __restrict__ dbc,
                                const float* __restrict__ carries, const float* __restrict__ wdt,
                                const float* __restrict__ dt_bias,
                                const float* __restrict__ A_logs, const float* __restrict__ Ds,
                                float* __restrict__ dxs, float* __restrict__ ddt_out,
                                float* __restrict__ dBp, float* __restrict__ dCp,
                                float* __restrict__ sums, int B, int L, int D, int K, int R) {
  extern __shared__ float4 smem4[];
  const int C = R + 2;
  T* u_s = reinterpret_cast<T*>(smem4);                  // [2][T][32]
  T* g_s = u_s + 2 * kT * 32;                            // [2][T][32]
  float* h_s = reinterpret_cast<float*>(g_s + 2 * kT * 32);  // [T][32] recomputed h_t
  float* v_s = h_s + kT * 32;                    // [T][32] dt before the softplus
  float* dbc_s = v_s + kT * 32;                  // [2][T][C]
  const int lane = threadIdx.x;
  const int grp = blockIdx.x, G = D / 32;
  const int d0 = grp * 32;
  const int d = d0 + lane;
  const int k = blockIdx.y;
  const int b = blockIdx.z;
  float w[RMAX];
#pragma unroll
  for (int r = 0; r < RMAX; ++r) w[r] = r < R ? wdt[((long)k * D + d) * R + r] : 0.f;
  const float bias = dt_bias[k * D + d];
  const float A = -expf(A_logs[k * D + d]);
  const float Dd = Ds[k * D + d];
  const int* idx_k = idx + (long)k * L;
  const T* x_b = x + (long)b * L * D;
  const T* g_b = gy + (long)b * L * D;
  const float* dbc_b = dbc + (long)b * L * K * C;
  const long bk = (long)b * K + k;
  const int n_chunks = (L + kT - 1) / kT;
  const float* carry_bk = carries + bk * n_chunks * D;
  float* dxs_bk = dxs + bk * L * D;
  float* ddt_bk = ddt_out + bk * L * D;
  float* dB_bk = dBp + bk * L * G;
  float* dC_bk = dCp + bk * L * G;
  auto pix_at = [&](int t) { return t < L ? idx_k[t] : 0; };
  int c = n_chunks - 1;
  stage_bwd(u_s, g_s, dbc_s, x_b, g_b, dbc_b, pix_at(c * kT + lane), pix_at(c * kT + 32 + lane),
            L - c * kT, D, d0, K, k, C);
  float lam = 0.f, a_next = 0.f;  // lam_{t+1} and a_{t+1}: 0 past the last step
  float s_bias = 0.f, s_A = 0.f, s_D = 0.f;
  for (int buf = 0; c >= 0; --c, buf ^= 1) {
    const int t0 = c * kT;
    const int n = min(kT, L - t0);
    if (c > 0) {
      const int tp = t0 - kT;
      stage_bwd(u_s + (buf ^ 1) * kT * 32, g_s + (buf ^ 1) * kT * 32, dbc_s + (buf ^ 1) * kT * C,
                x_b, g_b, dbc_b, pix_at(tp + lane), pix_at(tp + 32 + lane), kT, D, d0, K, k, C);
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    __syncwarp();
    const T* us = u_s + buf * kT * 32;
    const T* gs = g_s + buf * kT * 32;
    const float* ds = dbc_s + buf * kT * C;
    // recompute the chunk's states from the carry K1 emitted
    const float h_in = carry_bk[(long)c * D + d];
    float h = h_in;
    for (int t = 0; t < n; ++t) {
      const float* db = ds + t * C;
      float v = bias;
#pragma unroll
      for (int r = 0; r < RMAX; ++r)
        if (r < R) v = fmaf(db[r], w[r], v);
      const float delta = softplus(v);
      h = fmaf(expf(delta * A), h, delta * db[R] * to_f32(us[t * 32 + lane]));
      h_s[t * 32 + lane] = h;
      v_s[t * 32 + lane] = v;
    }
    // the adjoint, last step first
    for (int t = n - 1; t >= 0; --t) {
      const float* db = ds + t * C;
      const float v = v_s[t * 32 + lane];
      const float delta = softplus(v);
      const float a = expf(delta * A);
      const float sig = 1.f / (1.f + expf(-v));
      const float u = to_f32(us[t * 32 + lane]);
      const float g = to_f32(gs[t * 32 + lane]);
      const float h_prev = t > 0 ? h_s[(t - 1) * 32 + lane] : h_in;
      lam = fmaf(a_next, lam, g * db[R + 1]);
      a_next = a;
      const float daA = lam * h_prev * a;
      const float ddt = fmaf(daA, A, lam * u * db[R]) * sig;
      const long o = (long)(t0 + t) * D + d;
      dxs_bk[o] = fmaf(lam * delta, db[R], g * Dd);
      ddt_bk[o] = ddt;
      const float dB = warp_sum(lam * delta * u);
      const float dC = warp_sum(g * h_s[t * 32 + lane]);
      if (lane == 0) {
        dB_bk[(long)(t0 + t) * G + grp] = dB;
        dC_bk[(long)(t0 + t) * G + grp] = dC;
      }
      s_bias += ddt;
      s_A = fmaf(daA, delta, s_A);
      s_D = fmaf(g, u, s_D);
    }
    __syncwarp();  // this buffer is refilled by the next iteration's stage
  }
  const long plane = (long)B * K * D;
  sums[bk * D + d] = s_bias;
  sums[plane + bk * D + d] = s_A;
  sums[2 * plane + bk * D + d] = s_D;
}

// (b) d_dbc[row, :R] = ddt[row, :] . wdt[k], d_dbc[row, R] = sum of the dB
// partials, d_dbc[row, R+1] = sum of the dC partials; row = (b, k, t), one
// warp per row.
template <int RMAX>
__global__ void bwd_dbc_kernel(const float* __restrict__ ddt, const float* __restrict__ dBp,
                               const float* __restrict__ dCp, const float* __restrict__ wdt,
                               float* __restrict__ d_dbc, long rows, int L, int D, int K, int R) {
  const int lane = threadIdx.x & 31;
  const long row = (long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int k = (int)((row / L) % K);
  const float* src = ddt + row * D;
  const float* wk = wdt + (long)k * D * R;
  float acc[RMAX];
#pragma unroll
  for (int r = 0; r < RMAX; ++r) acc[r] = 0.f;
  for (int d = lane; d < D; d += 32) {
    const float v = src[d];
    const float* wr = wk + (long)d * R;
#pragma unroll
    for (int r = 0; r < RMAX; ++r)
      if (r < R) acc[r] = fmaf(v, wr[r], acc[r]);
  }
  const int G = D / 32;
  float sB = 0.f, sC = 0.f;
  for (int g = lane; g < G; g += 32) {
    sB += dBp[row * G + g];
    sC += dCp[row * G + g];
  }
  const int C = R + 2;
  float* out = d_dbc + row * C;
#pragma unroll
  for (int r = 0; r < RMAX; ++r) {
    if (r >= R) break;
    const float s = warp_sum(acc[r]);
    if (lane == 0) out[r] = s;
  }
  sB = warp_sum(sB);
  sC = warp_sum(sC);
  if (lane == 0) {
    out[R] = sB;
    out[R + 1] = sC;
  }
}

// (c) dx[b, l, :] = sum over k and slots m of
//   dxs[b, k, t, :] + sum_c d_dbc[b, k, t, c] * wx[k, c, :],  t = inv[k, m, l]
// (slot value L = none); one warp per pixel; dx in T.
template <typename T>
__global__ void bwd_dx_kernel(const float* __restrict__ dxs, const float* __restrict__ d_dbc,
                              const int* __restrict__ inv, const float* __restrict__ wx,
                              T* __restrict__ dx, long pixels, int K, int Mslots, int L,
                              int D, int C) {
  const int lane = threadIdx.x & 31;
  const long pixel = (long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (pixel >= pixels) return;
  const long b = pixel / L;
  const int l = (int)(pixel - b * L);
  for (int d = lane; d < D; d += 32) {
    float acc = 0.f;
    for (int k = 0; k < K; ++k) {
      const int* inv_kl = inv + (long)k * Mslots * L + l;
      const float* wk = wx + (long)k * C * D + d;
      for (int m = 0; m < Mslots; ++m) {
        const int t = inv_kl[(long)m * L];
        if (t >= L) break;  // a pixel's positions fill its first slots
        const long row = (b * K + k) * L + t;
        acc += dxs[row * D + d];
        const float* dd = d_dbc + row * C;
        for (int c = 0; c < C; ++c) acc = fmaf(dd[c], wk[(long)c * D], acc);
      }
    }
    dx[pixel * D + d] = from_f32<T>(acc);
  }
}

constexpr int kWRows = 64;      // (b, t) rows per weight-gradient block
constexpr int kWThreads = 128;  // channels per weight-gradient block

// (d) Partial weight gradients of rows [q0, q0 + kWRows) (q = b * L + t) of
// direction k, for channels d of this block:
//   pwx[chunk, k, c, d]  = sum_q d_dbc[b, k, t, c] * x[b, idx[k, t], d]
//   pwdt[chunk, k, d, r] = sum_q ddt[b, k, t, d] * dbc[b, idx[k, t], k, r]
template <int RMAX, typename T>
__global__ void bwd_wgrad_kernel(const T* __restrict__ x, const int* __restrict__ idx,
                                 const float* __restrict__ dbc, const float* __restrict__ ddt,
                                 const float* __restrict__ d_dbc, float* __restrict__ pwx,
                                 float* __restrict__ pwdt, int B, int L, int D, int K, int R) {
  __shared__ float sd[kWRows * (RMAX + 2)];  // d_dbc rows
  __shared__ float st[kWRows * RMAX];        // dt rows of dbc
  __shared__ int sp[kWRows];                 // (b * L + pixel) of each row
  const int chunk = blockIdx.x, k = blockIdx.y;
  const int d = blockIdx.z * kWThreads + threadIdx.x;
  const int C = R + 2;
  const long q0 = (long)chunk * kWRows;
  const long rest = (long)B * L - q0;
  const int n = rest < kWRows ? (int)rest : kWRows;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const long q = q0 + i;
    const long b = q / L;
    const int t = (int)(q - b * L);
    sp[i] = (int)(b * L + idx[(long)k * L + t]);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n * C; i += blockDim.x) {
    const int j = i / C, c = i - j * C;
    const long q = q0 + j;
    const long b = q / L;
    sd[i] = d_dbc[((b * K + k) * L + (q - b * L)) * C + c];
  }
  for (int i = threadIdx.x; i < n * R; i += blockDim.x) {
    const int j = i / R, r = i - j * R;
    st[i] = dbc[((long)sp[j] * K + k) * C + r];
  }
  __syncthreads();
  if (d >= D) return;
  float ax[RMAX + 2], at[RMAX];
#pragma unroll
  for (int c = 0; c < RMAX + 2; ++c) ax[c] = 0.f;
#pragma unroll
  for (int r = 0; r < RMAX; ++r) at[r] = 0.f;
  for (int j = 0; j < n; ++j) {
    const long q = q0 + j;
    const long b = q / L;
    const float u = to_f32(x[(long)sp[j] * D + d]);
    const float g = ddt[((b * K + k) * L + (q - b * L)) * D + d];
#pragma unroll
    for (int c = 0; c < RMAX + 2; ++c)
      if (c < C) ax[c] = fmaf(sd[j * C + c], u, ax[c]);
#pragma unroll
    for (int r = 0; r < RMAX; ++r)
      if (r < R) at[r] = fmaf(g, st[j * R + r], at[r]);
  }
  float* px = pwx + ((long)chunk * K + k) * C * D;
#pragma unroll
  for (int c = 0; c < RMAX + 2; ++c)
    if (c < C) px[(long)c * D + d] = ax[c];
  float* pt = pwdt + (((long)chunk * K + k) * D + d) * R;
#pragma unroll
  for (int r = 0; r < RMAX; ++r)
    if (r < R) pt[r] = at[r];
}

// (e) out[i] = sum_{j < n} part[j * M + i], j in order.
__global__ void sum_parts_kernel(const float* __restrict__ part, int n, long M,
                                 float* __restrict__ out) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M) return;
  float s = 0.f;
  for (int j = 0; j < n; ++j) s += part[(long)j * M + i];
  out[i] = s;
}

template <int RMAX, typename T>
int bwd_launch(const T* x, const int* idx, const int* inv, const T* gy,
               const float* carries, const float* dbc, const float* wx, const float* wdt,
               const float* dt_bias, const float* A_logs, const float* Ds, T* dx, float* dwx,
               float* dwdt, float* sums, float* dxs, float* ddt, float* dBp, float* dCp,
               float* d_dbc, float* pwx, float* pwdt, int B, int L, int D, int K, int R,
               int Mslots, cudaStream_t s) {
  const int C = R + 2;
  const size_t smem = (size_t)4 * kT * 32 * sizeof(T) + (size_t)(2 * kT * 32 + 2 * kT * C) * 4;
  cudaError_t e = allow_smem(bwd_scan_kernel<RMAX, T>, smem);
  if (e != cudaSuccess) return (int)e;
  bwd_scan_kernel<RMAX, T><<<dim3(D / 32, K, B), 32, smem, s>>>(
      x, idx, gy, dbc, carries, wdt, dt_bias, A_logs, Ds, dxs, ddt, dBp, dCp, sums, B, L, D, K, R);
  TRAMBA_CHECK_LAUNCH();
  const long rows = (long)B * K * L;
  bwd_dbc_kernel<RMAX><<<(unsigned)((rows + 7) / 8), 256, 0, s>>>(ddt, dBp, dCp, wdt, d_dbc, rows,
                                                                 L, D, K, R);
  TRAMBA_CHECK_LAUNCH();
  const long pixels = (long)B * L;
  bwd_dx_kernel<T><<<(unsigned)((pixels + 7) / 8), 256, 0, s>>>(dxs, d_dbc, inv, wx, dx, pixels,
                                                                K, Mslots, L, D, C);
  TRAMBA_CHECK_LAUNCH();
  const int chunks = (int)((pixels + kWRows - 1) / kWRows);
  bwd_wgrad_kernel<RMAX, T><<<dim3(chunks, K, (D + kWThreads - 1) / kWThreads), kWThreads, 0, s>>>(
      x, idx, dbc, ddt, d_dbc, pwx, pwdt, B, L, D, K, R);
  TRAMBA_CHECK_LAUNCH();
  const long mx = (long)K * C * D, mt = (long)K * D * R;
  sum_parts_kernel<<<(unsigned)((mx + 255) / 256), 256, 0, s>>>(pwx, chunks, mx, dwx);
  TRAMBA_CHECK_LAUNCH();
  sum_parts_kernel<<<(unsigned)((mt + 255) / 256), 256, 0, s>>>(pwdt, chunks, mt, dwdt);
  TRAMBA_CHECK_LAUNCH();
  return 0;
}

}  // namespace

extern "C" {

// Rows of (b, t) per weight-gradient block: the scratch pwx / pwdt hold
// ceil(B * L / rows) partials.
int ss2d_scan_bwd_rows() { return kWRows; }

// K8.  x (B, L, D), gy (B, L, D) the cotangent of K2's pre-LN sum, and the
// output dx (B, L, D) all fp32 (bf16 = 0) or all bf16 (bf16 = 1); the rest
// fp32.  Inputs: idx (K, L) and inv (K, Mslots, L) int32; carries
// (B, K, ceil(L / ss2d_scan_chunk()), D) and dbc (B, L, K, R+2) from K1's
// train variant;
// wx (K, R+2, D); wdt (K, D, R); dt_bias, A_logs, Ds (K, D).
// Outputs: dx; dwx (K, R+2, D); dwdt (K, D, R); sums (3, B, K, D),
// the per-image sums of dbias, dA and dDs.
// Scratch: dxs, ddt (B, K, L, D); dBp, dCp (B, K, L, D/32); d_dbc
// (B, K, L, R+2); pwx (chunks, K, R+2, D); pwdt (chunks, K, D, R) with
// chunks = ceil(B * L / ss2d_scan_bwd_rows()).  D % 32 == 0, R <= 64.
int ss2d_scan_bwd_launch(const void* x, const int* idx, const int* inv, const void* gy,
                         const float* carries, const float* dbc, const float* wx,
                         const float* wdt, const float* dt_bias, const float* A_logs,
                         const float* Ds, void* dx, float* dwx, float* dwdt, float* sums,
                         float* dxs, float* ddt, float* dBp, float* dCp, float* d_dbc, float* pwx,
                         float* pwdt, int B, int L, int D, int K, int R, int Mslots, int bf16_x,
                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TRAMBA_BWD(RM, T)                                                                   \
  bwd_launch<RM, T>(static_cast<const T*>(x), idx, inv, static_cast<const T*>(gy), carries,  \
                    dbc, wx, wdt, dt_bias, A_logs, Ds, static_cast<T*>(dx), dwx, dwdt, sums, \
                    dxs, ddt, dBp, dCp, d_dbc, pwx, pwdt, B, L, D, K, R, Mslots, s)
#define TRAMBA_BWD_R(T)                     \
  if (R <= 8) return TRAMBA_BWD(8, T);      \
  if (R <= 16) return TRAMBA_BWD(16, T);    \
  if (R <= 32) return TRAMBA_BWD(32, T);    \
  if (R <= 64) return TRAMBA_BWD(64, T);
  if (bf16_x) {
    TRAMBA_BWD_R(bf16)
  } else {
    TRAMBA_BWD_R(float)
  }
#undef TRAMBA_BWD_R
#undef TRAMBA_BWD
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
