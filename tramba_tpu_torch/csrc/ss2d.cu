// K1 ss2d_scan and K2 ss2d_merge: the SS2D core of the forward, fp32 and
// bf16, each with a train variant that emits what the backward needs.
//
// K1 replaces the scan halves of the TPU kernels in tramba_tpu/ops/fused_ss2d.py:
// _fused_pallas (:101), _line_pair_pallas (:873), _pair_phase1 (:1505),
// _pair_carries (:1402), _pair_phase2_cols (:1533), _pair_phase2_rows_merge
// (:1561, scan half) and _pair_phase2_rows_plain (:1612).  Those split each
// direction into VMEM chunks with carries because a TPU grid runs in order on
// one core.  Here every direction is one gather table idx[k, t] (the scan
// order).
//
// K2 replaces the merge tails of _pair_phase2_rows_merge (:1561) and
// _freq_merge_pallas (:1732) and the XLA _ln_gelu_proj (:478): gather the
// direction outputs back to pixels through the multi-slot inverse table,
// LayerNorm, exact GELU, out projection.
//
// Train variants: K1 also writes the chunk-entry carries of _fused_pallas
// (:101, emit_carries=True) and the pair kernels' carries (#8) as training
// uses them; K2 also writes the pre-LN sum (#10 emit_ysum=True), in the
// compute dtype as the TPU routes save it (fused_ss2d_small.py:269, #13's
// emit_train; fused_ss2d.py:464).  Training never needs ys once K2 has read
// it.  In bf16 the train variants are K1<bf16, carries> and K2<bf16, y_sum>,
// instantiations of their own beside the inference ones.
//
// What bounds them on an H100.  K1's scan is a first-order linear recurrence
// h_t = a_t h_{t-1} + b_t per channel: L dependent steps (9,216 at 96 px).
// One warp per (32 channels, k, b) walking them in order would run the
// Tramba-V 96 px raster scan at B1 on 32 warps of 132 SMs, each step
// waiting on the last.  So each direction is cut into S segments of whole
// chunks (common.cuh; ~4,096 warps a launch, 4,608 at that shape) that run
// at once in three steps:
//   1. summary kernel: each segment but the last runs from h = 0 and writes
//      its end state and its decay, the sum of delta * A (exp of it is the
//      product of its a's);
//   2. carry pass: each segment's block walks the summaries of the segments
//      before it, one FMA each, in the output kernel's prologue: no third
//      launch and no look-back between blocks;
//   3. output kernel: the segment again from its true entry state, writing
//      ys (and the train variant's chunk carries).
// Running a segment twice doubles the softplus/exp work, a few microseconds
// at these sizes.  A block holds up to 256 channels of one (b, k, segment),
// so the chunk's (dt, B, C) rows and table entries are staged once for all
// of them, and each thread holds its u kScanAhead steps ahead in registers.
// What bounds it now is the bytes: x is read twice per direction and ys
// written once (bound: chip_smoke.py's `bound`).  K1's projection and K2
// are small SIMT matrix products (see common.cuh); K2 keeps the
// LayerNorm'd row in shared memory, so the wide pre-projection tensor never
// reaches device memory.
//
// bf16 (the rounding points of _small_pallas, fused_ss2d_small.py:150-228):
// K1 reads a bf16 x and still projects (dt, B, C) in fp32 against the fp32
// x_proj_weight, runs the fp32 state and writes fp32 ys.  K2 reads fp32 ys,
// normalises in fp32, rounds the GELU output to bf16, multiplies it by a bf16
// w_out with fp32 accumulation and writes bf16.
#include "common.cuh"

namespace {

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

// The segmented scan, one thread per channel d of a block of NC channels of
// direction k of image b, over the steps of segment s (blockIdx.x = s *
// D / NC + channel block).  Step t of direction k (p = idx[k, t]):
//   u = x[b, p, d],  delta = softplus(dbc[b, p, k, :R] . wdt[k, d] + bias),
//   h = exp(delta * A) * h + delta * B * u,  ys[b, k, t, d] = C * h + Ds * u.
// The block stages each chunk's table entries and (dt, B, C) rows in shared
// memory one chunk ahead (cp.async, two buffers), so the rows are read once
// for all NC channels; each thread reads its own u (NC neighbouring channels
// of one pixel: one coalesced row), kScanAhead steps ahead into registers.
// Only the FMA on h chains one step to the next.
//   kMode 0 (summary): from h = 0, writes the segment's end state and
//     sum of delta * A, summ[0 / 1][b, k, s, d]; launched for s < S - 1.
//   kMode 1 (output): the carry pass first: the state entering segment s,
//     h = sum over j < s of exp(summ[1][j]) * h + summ[0][j] in order, one
//     FMA per segment; then the segment again from h, writing ys.
//   kMode 2 (output, train variant): also writes the state entering each
//     chunk, carries[b, k, chunk, d] (0 entering the first), from which the
//     backward (K8, ss2d_bwd.cu) recomputes a chunk's states.
template <int RMAX, typename T, int kMode>
__global__ void __launch_bounds__(256)
    ss2d_seg_kernel(const T* __restrict__ x, const int* __restrict__ idx,
                    const float* __restrict__ dbc, const float* __restrict__ wdt,
                    const float* __restrict__ dt_bias, const float* __restrict__ A_logs,
                    const float* __restrict__ Ds, float* __restrict__ summ,
                    float* __restrict__ ys, float* __restrict__ carries, int B, int L, int D,
                    int K, int R, int S, int seg_chunks) {
  extern __shared__ float4 smem4[];
  const int C = R + 2, Cs = row_stride(C);
  float* dbc_s = reinterpret_cast<float*>(smem4);        // [2][kScanChunk][Cs]
  int* pix_s = reinterpret_cast<int*>(dbc_s + 2 * kScanChunk * Cs);  // [2][kScanChunk]
  const int NC = blockDim.x, nblk = D / NC;
  const int s = blockIdx.x / nblk;
  const int d = (blockIdx.x - s * nblk) * NC + threadIdx.x;
  const int k = blockIdx.y, b = blockIdx.z;
  const ScanChannel<RMAX> ch(wdt, dt_bias, A_logs, Ds, k, D, d, R);
  const int* idx_k = idx + (long)k * L;
  const T* x_b = x + (long)b * L * D;
  const float* dbc_b = dbc + (long)b * L * K * C;
  const long bk = (long)b * K + k;
  const long plane = (long)B * K * S * D;  // one of the two summary maps
  const int n_chunks = (L + kScanChunk - 1) / kScanChunk;
  const int c0 = s * seg_chunks, c1 = min(n_chunks, c0 + seg_chunks);
  float h = 0.f, sdA = 0.f;
  if (kMode != 0) {
    const float* hl = summ + bk * S * D + d;
    const float* la = hl + plane;
#pragma unroll 4
    for (int j = 0; j < s; ++j) h = fmaf(expf(la[(long)j * D]), h, hl[(long)j * D]);
  }
  float* y_bk = ys + bk * L * D;
  stage_scan_rows(pix_s, dbc_s, idx_k, dbc_b, c0 * kScanChunk,
                  min(kScanChunk, L - c0 * kScanChunk), K, k, C);
  for (int c = c0, buf = 0; c < c1; ++c, buf ^= 1) {
    const int t0 = c * kScanChunk, n = min(kScanChunk, L - t0);
    if (c + 1 < c1) {
      const int tn = t0 + kScanChunk;
      stage_scan_rows(pix_s + (buf ^ 1) * kScanChunk, dbc_s + (buf ^ 1) * kScanChunk * Cs, idx_k,
                      dbc_b, tn, min(kScanChunk, L - tn), K, k, C);
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();
    if (kMode == 2) carries[(bk * n_chunks + c) * D + d] = h;
    const float* ds = dbc_s + buf * kScanChunk * Cs;
    const int* ps = pix_s + buf * kScanChunk;
    float u[kScanAhead], un[kScanAhead];
    load_steps(u, x_b, ps, 0, n, D, d);
    for (int tb = 0; tb < n; tb += kScanAhead) {
      load_steps(un, x_b, ps, tb + kScanAhead, n, D, d);
#pragma unroll
      for (int i = 0; i < kScanAhead; ++i) {
        const int t = tb + i;
        if (t < n) {
          const float* db = ds + t * Cs;
          const float delta = softplus(ch.v(db, R));
          const float dA = delta * ch.A;
          h = fmaf(expf(dA), h, delta * db[R] * u[i]);
          if (kMode == 0) {
            sdA += dA;
          } else {
            y_bk[(long)(t0 + t) * D + d] = fmaf(h, db[R + 1], u[i] * ch.Dd);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kScanAhead; ++i) u[i] = un[i];
    }
    __syncthreads();  // this buffer is refilled by the next iteration's stage
  }
  if (kMode == 0) {
    summ[(bk * S + s) * D + d] = h;
    summ[plane + (bk * S + s) * D + d] = sdA;
  }
}

template <int RMAX, typename T>
cudaError_t launch_scan(const T* x, const int* idx, const float* dbc, const float* wdt,
                        const float* dt_bias, const float* A_logs, const float* Ds, float* summ,
                        float* ys, float* carries, int B, int L, int D, int K, int R,
                        cudaStream_t s) {
  const size_t smem = scan_rows_smem(R + 2);
  const int per = scan_seg_chunks(B, L, D, K, kScanWarps), S = scan_segments(L, per);
  const int nc = scan_block_channels(D, 256), nblk = D / nc;
  if (S > 1) {
    auto sum_kern = ss2d_seg_kernel<RMAX, T, 0>;
    cudaError_t e = allow_smem(sum_kern, smem);
    if (e != cudaSuccess) return e;
    sum_kern<<<dim3((S - 1) * nblk, K, B), nc, smem, s>>>(
        x, idx, dbc, wdt, dt_bias, A_logs, Ds, summ, ys, carries, B, L, D, K, R, S, per);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  auto kern = carries ? ss2d_seg_kernel<RMAX, T, 2> : ss2d_seg_kernel<RMAX, T, 1>;
  cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return e;
  kern<<<dim3(S * nblk, K, B), nc, smem, s>>>(x, idx, dbc, wdt, dt_bias, A_logs, Ds, summ, ys,
                                             carries, B, L, D, K, R, S, per);
  return cudaGetLastError();
}

template <typename T>
int scan_launch(const T* x, const int* idx, const float* wx, const float* wdt,
                const float* dt_bias, const float* A_logs, const float* Ds, float* dbc,
                float* summ, float* ys, float* carries, int B, int L, int D, int K, int R,
                cudaStream_t s) {
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
#define TRAMBA_SCAN(RM) \
  launch_scan<RM>(x, idx, dbc, wdt, dt_bias, A_logs, Ds, summ, ys, carries, B, L, D, K, R, s)
  cudaError_t e;
  if (R <= 8) e = TRAMBA_SCAN(8);
  else if (R <= 16) e = TRAMBA_SCAN(16);
  else if (R <= 32) e = TRAMBA_SCAN(32);
  else if (R <= 64) e = TRAMBA_SCAN(64);
  else e = cudaErrorInvalidValue;
#undef TRAMBA_SCAN
  return (int)e;
}

// Per pixel l of batch b: y = sum over k, m of ys[b, k, inv[k, m, l]] (slot
// value L means none), then LayerNorm (eps 1e-5), exact GELU, rounding to TW,
// and out[b, l, :] = y @ w_out^T with w_out (dm, D) of TW; out is TW.
// Train variant (kYsum, #10's emit_ysum; a separate instantiation, as K1's):
// also writes the pre-LN sum y (B, L, D) in TW (rounded to bf16 in bf16; the
// LayerNorm still reads the fp32 sum), over which the backward
// differentiates the LayerNorm, GELU and out projection.
template <int P, typename TW, bool kYsum>
__global__ void ss2d_merge_kernel(const float* __restrict__ ys, const int* __restrict__ inv,
                                  const float* __restrict__ ln_w, const float* __restrict__ ln_b,
                                  const TW* __restrict__ w_out, TW* __restrict__ out,
                                  TW* __restrict__ y_sum, int K, int Mslots, int L, int D,
                                  int dm) {
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
    if (kYsum) {
      TW* dst = y_sum + ((long)b * L + l) * D;
      for (int i = lane; i < D; i += 32) dst[i] = from_f32<TW>(row[i]);
    }
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
                 const TW* w_out, TW* out, TW* y_sum, int B, int K, int Mslots, int L, int D,
                 int dm, cudaStream_t s) {
  const int P = rows_per_block((long)B * L, D, kRowBudget);
  const size_t smem = (size_t)P * D * 4;
  const dim3 grid((L + P - 1) / P, B);
  TRAMBA_DISPATCH_P(P, {
    auto kern = y_sum ? ss2d_merge_kernel<kP, TW, true> : ss2d_merge_kernel<kP, TW, false>;
    cudaError_t e = allow_smem(kern, smem);
    if (e != cudaSuccess) return (int)e;
    kern<<<grid, 256, smem, s>>>(ys, inv, ln_w, ln_b, w_out, out, y_sum, K, Mslots, L, D, dm);
  });
  TRAMBA_CHECK_LAUNCH();
  return 0;
}

}  // namespace

extern "C" {

const char* tramba_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// Steps per chunk of K1 and K8 (kScanChunk): the carries' stride.
int ss2d_scan_chunk() { return kScanChunk; }

// Steps per segment of K1's scan (bwd = 0) or K8's (bwd = 1) at these sizes
// (the last segment may be shorter): the wrappers size the summaries and
// K8's partial sums by the segments per direction, S = ceil(L / steps).
int ss2d_scan_segment_steps(int B, int L, int D, int K, int bwd) {
  return scan_seg_chunks(B, L, D, K, bwd ? kScanBwdWarps : kScanWarps) * kScanChunk;
}

// K1.  x (B, L, D) fp32 (bf16 = 0) or bf16 (bf16 = 1); idx (K, L) int32;
// wx (K, R+2, D); wdt (K, D, R); dt_bias (K, D); A_logs (K, D); Ds (K, D);
// dbc (B, L, K, R+2) (the projections, kept by training); summ (2, B, K, S,
// D) scratch, S = ceil(L / ss2d_scan_segment_steps(B, L, D, K, 0)); ys
// (B, K, L, D); carries (B, K, ceil(L / ss2d_scan_chunk()), D) or null
// (inference); all fp32 but x.  D % 32 == 0, R <= 64.
int ss2d_scan_launch(const void* x, const int* idx, const float* wx, const float* wdt,
                     const float* dt_bias, const float* A_logs, const float* Ds, float* dbc,
                     float* summ, float* ys, float* carries, int B, int L, int D, int K, int R,
                     int bf16_x, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16_x)
    return scan_launch(static_cast<const bf16*>(x), idx, wx, wdt, dt_bias, A_logs, Ds, dbc, summ,
                       ys, carries, B, L, D, K, R, s);
  return scan_launch(static_cast<const float*>(x), idx, wx, wdt, dt_bias, A_logs, Ds, dbc, summ,
                     ys, carries, B, L, D, K, R, s);
}

// K2.  ys (B, K, L, D) fp32; inv (K, Mslots, L) int32; ln_w, ln_b (D) fp32;
// w_out (dm, D), out (B, L, dm) and y_sum (B, L, D) all fp32 (bf16 = 0) or
// all bf16 (bf16 = 1); y_sum null for inference.  D % 4 == 0 (fp32) or
// D % 8 == 0 (bf16).
int ss2d_merge_launch(const float* ys, const int* inv, const float* ln_w, const float* ln_b,
                      const void* w_out, void* out, void* y_sum, int B, int K, int Mslots, int L,
                      int D, int dm, int bf16_out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16_out)
    return merge_launch(ys, inv, ln_w, ln_b, static_cast<const bf16*>(w_out),
                        static_cast<bf16*>(out), static_cast<bf16*>(y_sum), B, K, Mslots, L, D,
                        dm, s);
  return merge_launch(ys, inv, ln_w, ln_b, static_cast<const float*>(w_out),
                      static_cast<float*>(out), static_cast<float*>(y_sum), B, K, Mslots, L, D,
                      dm, s);
}

}  // extern "C"
