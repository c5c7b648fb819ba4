// K1 ss2d_scan and K2 ss2d_merge: the SS2D core of the inference path, fp32
// and bf16.
//
// K1 replaces the scan halves of the TPU kernels in tramba_tpu/ops/fused_ss2d.py:
// _fused_pallas (:101), _line_pair_pallas (:873), _pair_phase1 (:1505),
// _pair_carries (:1402), _pair_phase2_cols (:1533), _pair_phase2_rows_merge
// (:1561, scan half) and _pair_phase2_rows_plain (:1612).  Those split each
// direction into VMEM chunks with carries because a TPU grid runs in order on
// one core.  Here every direction is one gather table idx[k, t] (the scan
// order), and a direction's recurrence runs start to end inside one block.
//
// K2 replaces the merge tails of _pair_phase2_rows_merge (:1561) and
// _freq_merge_pallas (:1732) and the XLA _ln_gelu_proj (:478): gather the
// direction outputs back to pixels through the multi-slot inverse table,
// LayerNorm, exact GELU, out projection.
//
// What bounds them on an H100: K1's scan is a chain of L dependent steps per
// channel, so it is latency-bound and has only B*K*D/32 blocks of one warp;
// it stages T steps of inputs in shared memory so that a chunk's loads are in
// flight together.  K1's projection and K2 are small SIMT matrix products
// (see common.cuh); K2 keeps the LayerNorm'd row in shared memory, so the
// wide pre-projection tensor never reaches device memory.
//
// bf16 (the rounding points of _small_pallas, fused_ss2d_small.py:150-228):
// K1 reads a bf16 x and still projects (dt, B, C) in fp32 against the fp32
// x_proj_weight, runs the fp32 state and writes fp32 ys.  K2 reads fp32 ys,
// normalises in fp32, rounds the GELU output to bf16, multiplies it by a bf16
// w_out with fp32 accumulation and writes bf16.
#include <cuda_pipeline.h>

#include "common.cuh"

namespace {

constexpr int kScanT = 64;  // scan steps per staged chunk (2 per lane)

// dbc[m, n] = sum_d x[m, d] * wx[n, d]: the per-pixel (dt, B, C) projections
// of all K directions at once (m = b*L + l, n = k*(R+2) + c).
template <int P, typename T>
__global__ void ss2d_proj_kernel(const T* __restrict__ x, const float* __restrict__ wx,
                                 float* __restrict__ dbc, long M, int D, int N) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);
  const long m0 = (long)blockIdx.x * P;
  load_rows<P>(x, M, D, m0, xs);
  __syncthreads();
  for (int j = threadIdx.x; j < N; j += blockDim.x) {
    float acc[P];
    rows_dot<P>(xs, D, wx + (long)j * D, D, acc);
#pragma unroll
    for (int p = 0; p < P; ++p)
      if (m0 + p < M) dbc[(m0 + p) * N + j] = acc[p];
  }
}

__device__ __forceinline__ float softplus(float v) {
  // log(1 + e^v) = max(v, 0) + log1p(e^-|v|), as jax.nn.softplus computes it
  return fmaxf(v, 0.f) + log1pf(expf(-fabsf(v)));
}

// Asynchronous copies of chunk [t0, t0 + n) of direction k into one stage
// buffer: u[t][lane] = x[b, pix_t, d] and dbc[t][:] = dbc[b, pix_t, k, :],
// where pix_t = idx[k, t0 + t] is held in registers, t = lane (pix0) and
// t = lane + 32 (pix1).  A copy moves 4, 8 or 16 bytes, so an fp32 u is one
// channel per lane and a bf16 u a pair of channels per lane, two pixels per
// step (lanes 0-15 and 16-31).
__device__ __forceinline__ void stage_u(float* u_s, const float* x_b, int pix0, int pix1, int n,
                                        int D, int d0) {
  const int lane = threadIdx.x;
#pragma unroll
  for (int t = 0; t < kScanT; ++t) {
    const int pix = __shfl_sync(0xffffffffu, t < 32 ? pix0 : pix1, t & 31);
    if (t < n) __pipeline_memcpy_async(u_s + t * 32 + lane, x_b + (long)pix * D + d0 + lane, 4);
  }
}

__device__ __forceinline__ void stage_u(bf16* u_s, const bf16* x_b, int pix0, int pix1, int n,
                                        int D, int d0) {
  const int lane = threadIdx.x, half = lane >> 4, c2 = 2 * (lane & 15);
#pragma unroll
  for (int t2 = 0; t2 < kScanT; t2 += 2) {
    const int t = t2 + half;  // t2 even: t and t2 lie on one side of 32
    const int pix = __shfl_sync(0xffffffffu, t2 < 32 ? pix0 : pix1, t & 31);
    if (t < n) __pipeline_memcpy_async(u_s + t * 32 + c2, x_b + (long)pix * D + d0 + c2, 4);
  }
}

template <typename T>
__device__ __forceinline__ void stage_chunk(T* u_s, float* dbc_s, const T* x_b,
                                            const float* dbc_b, int pix0, int pix1, int n,
                                            int D, int d0, int K, int k, int C) {
  const int lane = threadIdx.x;
  stage_u(u_s, x_b, pix0, pix1, n, D, d0);
  for (int i = lane; i < kScanT * C; i += 32) {
    const int t = i / C, c = i - t * C;
    const int p0 = __shfl_sync(0xffffffffu, pix0, t & 31);
    const int p1 = __shfl_sync(0xffffffffu, pix1, t & 31);
    if (t < n) __pipeline_memcpy_async(dbc_s + i, dbc_b + ((long)(t < 32 ? p0 : p1) * K + k) * C + c, 4);
  }
  __pipeline_commit();
}

// One warp per (32 channels, direction k, batch b).  For t = 0..L-1:
//   u = x[b, idx[k, t]],  delta = softplus(dbc[:R] . wdt[k, d] + bias),
//   h = exp(delta * A) * h + delta * B * u,  ys[b, k, t, d] = C * h + Ds * u.
// The inputs of each chunk of T steps arrive in shared memory by
// asynchronous copies issued one chunk ahead (two stage buffers), so the
// gathers overlap the previous chunk's recurrence.  A thread keeps its row of
// wdt in registers (R <= RMAX), and the step loop is unrolled so that the
// work that does not depend on h (dt, softplus, exp) of several steps
// overlaps: only the one FMA on h is a chain from step to step.
template <int RMAX, typename T>
__global__ void ss2d_scan_kernel(const T* __restrict__ x, const int* __restrict__ idx,
                                 const float* __restrict__ dbc, const float* __restrict__ wdt,
                                 const float* __restrict__ dt_bias,
                                 const float* __restrict__ A_logs, const float* __restrict__ Ds,
                                 float* __restrict__ ys, int L, int D, int K, int R) {
  extern __shared__ float4 smem4[];
  const int C = R + 2;
  T* u_s = reinterpret_cast<T*>(smem4);                          // [2][T][32]
  float* dbc_s = reinterpret_cast<float*>(u_s + 2 * kScanT * 32);  // [2][T][C]
  const int lane = threadIdx.x;
  const int d0 = blockIdx.x * 32;
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
  const float* dbc_b = dbc + (long)b * L * K * C;
  float* y_bk = ys + ((long)b * K + k) * L * D;
  auto pix_at = [&](int t) { return t < L ? idx_k[t] : 0; };
  stage_chunk(u_s, dbc_s, x_b, dbc_b, pix_at(lane), pix_at(32 + lane), min(kScanT, L), D, d0,
              K, k, C);
  int next0 = pix_at(kScanT + lane), next1 = pix_at(kScanT + 32 + lane);
  float h = 0.f;
  for (int t0 = 0, buf = 0; t0 < L; t0 += kScanT, buf ^= 1) {
    const int n = min(kScanT, L - t0);
    const int tn = t0 + kScanT;
    if (tn < L) {
      stage_chunk(u_s + (buf ^ 1) * kScanT * 32, dbc_s + (buf ^ 1) * kScanT * C, x_b, dbc_b,
                  next0, next1, min(kScanT, L - tn), D, d0, K, k, C);
      next0 = pix_at(tn + kScanT + lane);
      next1 = pix_at(tn + kScanT + 32 + lane);
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    __syncwarp();
    const T* us = u_s + buf * kScanT * 32;
    const float* ds = dbc_s + buf * kScanT * C;
#pragma unroll 4
    for (int t = 0; t < n; ++t) {
      const float* db = ds + t * C;
      float dt = bias;
#pragma unroll
      for (int r = 0; r < RMAX; ++r)
        if (r < R) dt = fmaf(db[r], w[r], dt);
      const float delta = softplus(dt);
      const float u = to_f32(us[t * 32 + lane]);
      h = fmaf(expf(delta * A), h, delta * db[R] * u);
      y_bk[(long)(t0 + t) * D + d] = fmaf(h, db[R + 1], u * Dd);
    }
    __syncwarp();  // this buffer is refilled by the next iteration's stage
  }
}

template <int RMAX, typename T>
cudaError_t launch_scan(const T* x, const int* idx, const float* dbc, const float* wdt,
                        const float* dt_bias, const float* A_logs, const float* Ds, float* ys,
                        int B, int L, int D, int K, int R, cudaStream_t s) {
  const size_t smem = (size_t)2 * kScanT * (32 * sizeof(T) + (R + 2) * 4);
  cudaError_t e = allow_smem(ss2d_scan_kernel<RMAX, T>, smem);
  if (e != cudaSuccess) return e;
  ss2d_scan_kernel<RMAX, T><<<dim3(D / 32, K, B), 32, smem, s>>>(x, idx, dbc, wdt, dt_bias,
                                                                   A_logs, Ds, ys, L, D, K, R);
  return cudaGetLastError();
}

template <typename T>
int scan_launch(const T* x, const int* idx, const float* wx, const float* wdt,
                const float* dt_bias, const float* A_logs, const float* Ds, float* dbc,
                float* ys, int B, int L, int D, int K, int R, cudaStream_t s) {
  const long M = (long)B * L;
  const int C = R + 2, N = K * C;
  const int P = rows_per_block(M, D, kRowBudget);
  const size_t proj_smem = (size_t)P * D * 4;
  const int proj_threads = N >= 256 ? 256 : ((N + 31) / 32) * 32;
  const unsigned proj_blocks = (unsigned)((M + P - 1) / P);
  TRAMBA_DISPATCH_P(P, {
    cudaError_t e = allow_smem(ss2d_proj_kernel<kP, T>, proj_smem);
    if (e != cudaSuccess) return (int)e;
    ss2d_proj_kernel<kP, T><<<proj_blocks, proj_threads, proj_smem, s>>>(x, wx, dbc, M, D, N);
  });
  TRAMBA_CHECK_LAUNCH();
  cudaError_t e;
  if (R <= 8) e = launch_scan<8>(x, idx, dbc, wdt, dt_bias, A_logs, Ds, ys, B, L, D, K, R, s);
  else if (R <= 16) e = launch_scan<16>(x, idx, dbc, wdt, dt_bias, A_logs, Ds, ys, B, L, D, K, R, s);
  else if (R <= 32) e = launch_scan<32>(x, idx, dbc, wdt, dt_bias, A_logs, Ds, ys, B, L, D, K, R, s);
  else if (R <= 64) e = launch_scan<64>(x, idx, dbc, wdt, dt_bias, A_logs, Ds, ys, B, L, D, K, R, s);
  else e = cudaErrorInvalidValue;
  return (int)e;
}

// Per pixel l of batch b: y = sum over k, m of ys[b, k, inv[k, m, l]] (slot
// value L means none), then LayerNorm (eps 1e-5), exact GELU, rounding to TW,
// and out[b, l, :] = y @ w_out^T with w_out (dm, D) of TW; out is TW.
template <int P, typename TW>
__global__ void ss2d_merge_kernel(const float* __restrict__ ys, const int* __restrict__ inv,
                                  const float* __restrict__ ln_w, const float* __restrict__ ln_b,
                                  const TW* __restrict__ w_out, TW* __restrict__ out,
                                  int K, int Mslots, int L, int D, int dm) {
  extern __shared__ float4 smem4[];
  float* rows = reinterpret_cast<float*>(smem4);  // [P][D]
  const int b = blockIdx.y;
  const int l0 = blockIdx.x * P;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nwarps = blockDim.x >> 5;
  const float* ys_b = ys + (long)b * K * L * D;
  for (int p = warp; p < P; p += nwarps) {
    float* row = rows + p * D;
    const int l = l0 + p;
    for (int i = lane; i < D; i += 32) row[i] = 0.f;
    if (l >= L) continue;
    for (int k = 0; k < K; ++k) {
      const int* inv_kl = inv + (long)k * Mslots * L + l;
      const float* ys_k = ys_b + (long)k * L * D;
      for (int m = 0; m < Mslots; ++m) {
        const int t = inv_kl[(long)m * L];
        if (t >= L) break;  // a pixel's positions fill its first slots, padding follows
        const float* src = ys_k + (long)t * D;
#pragma unroll 4
        for (int i = lane; i < D; i += 32) row[i] += src[i];
      }
    }
    __syncwarp();
    float mean, rstd;
    warp_row_stats(row, D, 1e-5f, &mean, &rstd);
    for (int i = lane; i < D; i += 32)
      row[i] = round_to<TW>(gelu_exact((row[i] - mean) * rstd * ln_w[i] + ln_b[i]));
  }
  __syncthreads();
  TW* out_b = out + (long)b * L * dm;
  for (int j = threadIdx.x; j < dm; j += blockDim.x) {
    float acc[P];
    rows_dot<P>(rows, D, w_out + (long)j * D, D, acc);
#pragma unroll
    for (int p = 0; p < P; ++p)
      if (l0 + p < L) out_b[(long)(l0 + p) * dm + j] = from_f32<TW>(acc[p]);
  }
}

template <typename TW>
int merge_launch(const float* ys, const int* inv, const float* ln_w, const float* ln_b,
                 const TW* w_out, TW* out, int B, int K, int Mslots, int L, int D, int dm,
                 cudaStream_t s) {
  const int P = rows_per_block((long)B * L, D, kRowBudget);
  const size_t smem = (size_t)P * D * 4;
  const dim3 grid((L + P - 1) / P, B);
  TRAMBA_DISPATCH_P(P, {
    cudaError_t e = allow_smem(ss2d_merge_kernel<kP, TW>, smem);
    if (e != cudaSuccess) return (int)e;
    ss2d_merge_kernel<kP, TW><<<grid, 256, smem, s>>>(ys, inv, ln_w, ln_b, w_out, out, K, Mslots,
                                                       L, D, dm);
  });
  TRAMBA_CHECK_LAUNCH();
  return 0;
}

}  // namespace

extern "C" {

const char* tramba_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// K1.  x (B, L, D) fp32 (bf16 = 0) or bf16 (bf16 = 1); idx (K, L) int32;
// wx (K, R+2, D); wdt (K, D, R); dt_bias (K, D); A_logs (K, D); Ds (K, D);
// scratch dbc (B, L, K, R+2); ys (B, K, L, D); all fp32 but x.
// D % 32 == 0, R <= 64.
int ss2d_scan_launch(const void* x, const int* idx, const float* wx, const float* wdt,
                     const float* dt_bias, const float* A_logs, const float* Ds, float* dbc,
                     float* ys, int B, int L, int D, int K, int R, int bf16_x, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16_x)
    return scan_launch(static_cast<const bf16*>(x), idx, wx, wdt, dt_bias, A_logs, Ds, dbc, ys,
                       B, L, D, K, R, s);
  return scan_launch(static_cast<const float*>(x), idx, wx, wdt, dt_bias, A_logs, Ds, dbc, ys, B,
                     L, D, K, R, s);
}

// K2.  ys (B, K, L, D) fp32; inv (K, Mslots, L) int32; ln_w, ln_b (D) fp32;
// w_out (dm, D) and out (B, L, dm) both fp32 (bf16 = 0) or both bf16
// (bf16 = 1).  D % 4 == 0 (fp32) or D % 8 == 0 (bf16).
int ss2d_merge_launch(const float* ys, const int* inv, const float* ln_w, const float* ln_b,
                      const void* w_out, void* out, int B, int K, int Mslots, int L, int D,
                      int dm, int bf16_out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16_out)
    return merge_launch(ys, inv, ln_w, ln_b, static_cast<const bf16*>(w_out),
                        static_cast<bf16*>(out), B, K, Mslots, L, D, dm, s);
  return merge_launch(ys, inv, ln_w, ln_b, static_cast<const float*>(w_out),
                      static_cast<float*>(out), B, K, Mslots, L, D, dm, s);
}

}  // extern "C"
