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
// Seven launches in one call (ss2d_scan_bwd_launch; six when S = 1):
//  (a1) segment summaries: each direction's L steps are cut into the S
//      segments of K1 (common.cuh); each segment but the first runs lam
//      back from 0 over its steps and writes what flows into the segment
//      before it (a lam at its first step) and its decay;
//  (a2) the adjoint scan, one thread per channel of a block of up to 128
//      channels of one (b, k, segment): a reverse carry pass over the later
//      segments' summaries (one FMA each) gives the lam entering the
//      segment; then, chunk by chunk from the last, the chunk's states h
//      are recomputed into shared memory from the carry K1 emitted, and lam
//      runs backwards.  Writes du's direct part and ddt per (b, k, t, d),
//      the 32-channel partial sums of the dB and dC terms per (b, k, t)
//      (products staged in a per-warp tile, one reduction per 32 steps),
//      and per-(b, segment, k, d) sums of dbias, dA and dDs, which the
//      wrapper sums over (b, segment) in a fixed order.
//  (b) d_dbc per (b, k, t): ddt . wdt[k] over D as a product tiled in shared
//      memory (32 steps x 32 channels x R), and the dB / dC partials summed.
//  (c) dx per pixel: a gather through K2's multi-slot inverse table of
//      du + d_dbc . wx[k] over every k and slot, so no scatter and no float
//      atomics; a block of 8 pixels keeps each wx[k] column in registers.
//  (d) dwx and dwdt partials over blocks of 64 (b, t) rows per k, each block
//      one slice of 128 channels;
//  (e) the partials summed in a fixed order (one launch per weight).
// Every sum runs in a fixed order, so two launches give the same bits.
//
// bf16 (the backward of #13's emit_train route, fused_ss2d_small.py:393-469,
// and of _full_bwd / _freq_bwd in bf16): x (K5's post-SiLU u) and g_y (the
// LN adjoint's cotangent, in y_sum's dtype) are bf16, read as K1 reads a
// bf16 x (rounded values, fp32 arithmetic), and dx is written in bf16; everything else is
// fp32 as in the fp32 variant.  The bf16 launches are instantiations of
// their own (T = bf16) beside the fp32 ones.
//
// What bounds it on an H100.  The adjoint is a first-order linear recurrence
// run backwards, lam_t = g_t C_t + a_{t+1} lam_{t+1}: L dependent steps per
// channel (9,216 at 96 px).  One warp per (32 channels, k, b) walking them
// in order leaves most of the 132 SMs idle (128 warps at the 96 px line
// shape at B2) and puts two warp_sums per step on the warp's only stream.
// Cut into segments joined by the carry pass, (a2) runs ~8,192 warps
// whatever the batch (several waves of blocks), holds each step's gathers
// kScanAhead steps ahead in registers, and reduces the dB / dC products
// once per 32 steps.  What is left is bytes and SIMT work: the scratch maps
// dxs and ddt, (B, K, L, D) fp32 each (302 MB each at the 96 px line shape
// at B4), written by (a2) and read by (b)-(d); dBp / dCp are 1/32 of one,
// d_dbc (B, K, L, R+2 padded to 4).  Plain SIMT, no tensor cores.
#include "common.cuh"

namespace {

constexpr int kT = kScanChunk;  // steps per chunk: K1's, the carries' stride
constexpr int kBwdChannels = 128;  // channels per block of (a1) / (a2) at most

// The steps of segment s of direction k, last chunk first: stages chunk c's
// table entries and (dt, B, C) rows one chunk ahead (stage_scan_rows, two
// buffers) and calls body(c, t0, n, dbc_s, pix_s) between two block barriers.
template <typename Body>
__device__ __forceinline__ void walk_chunks_back(int* pix_s, float* dbc_s, const int* idx_k,
                                                 const float* dbc_b, int c0, int c1, int L,
                                                 int K, int k, int C, Body body) {
  const int Cs = row_stride(C);
  int c = c1 - 1;
  stage_scan_rows(pix_s, dbc_s, idx_k, dbc_b, c * kT, min(kT, L - c * kT), K, k, C);
  for (int buf = 0; c >= c0; --c, buf ^= 1) {
    if (c > c0) {
      stage_scan_rows(pix_s + (buf ^ 1) * kT, dbc_s + (buf ^ 1) * kT * Cs, idx_k, dbc_b,
                      (c - 1) * kT, kT, K, k, C);
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();
    body(c, c * kT, min(kT, L - c * kT), dbc_s + buf * kT * Cs, pix_s + buf * kT);
    __syncthreads();  // this buffer is refilled by the next iteration's stage
  }
}

// (a1) Segment summaries of the adjoint, one thread per channel d of a block
// of NC channels of segment s (blockIdx.x = (s - 1) * D / NC + block, s >=
// 1), direction k, image b.  From lam = 0 past the segment's last step,
//   lam_t = g_t C_t + a_{t+1} lam_{t+1}  (a_{t+1} of the segment's steps),
// down to its first step t_s; writes summ[0][b, k, s, d] = a_{t_s} lam_{t_s}
// (what flows into segment s - 1's last step) and summ[1][...] = the sum of
// delta * A over the segment (exp of it: the product of its a's).
template <int RMAX, typename T>
__global__ void __launch_bounds__(kBwdChannels)
    bwd_summary_kernel(const int* __restrict__ idx, const T* __restrict__ gy,
                       const float* __restrict__ dbc, const float* __restrict__ wdt,
                       const float* __restrict__ dt_bias, const float* __restrict__ A_logs,
                       const float* __restrict__ Ds, float* __restrict__ summ, int B, int L,
                       int D, int K, int R, int S, int seg_chunks) {
  extern __shared__ float4 smem4[];
  const int C = R + 2, Cs = row_stride(C);
  float* dbc_s = reinterpret_cast<float*>(smem4);                   // [2][kT][Cs]
  int* pix_s = reinterpret_cast<int*>(dbc_s + 2 * kT * Cs);         // [2][kT]
  const int NC = blockDim.x, nblk = D / NC;
  const int s = 1 + blockIdx.x / nblk;
  const int d = (blockIdx.x - (s - 1) * nblk) * NC + threadIdx.x;
  const int k = blockIdx.y, b = blockIdx.z;
  const ScanChannel<RMAX> ch(wdt, dt_bias, A_logs, Ds, k, D, d, R);
  const T* g_b = gy + (long)b * L * D;
  const int n_chunks = (L + kT - 1) / kT;
  const int c0 = s * seg_chunks, c1 = min(n_chunks, c0 + seg_chunks);
  float lam = 0.f, a_next = 0.f, sdA = 0.f;
  walk_chunks_back(pix_s, dbc_s, idx + (long)k * L, dbc + (long)b * L * K * C, c0, c1, L, K, k,
                   C, [&](int, int, int n, const float* ds, const int* ps) {
                     float g[kScanAhead], gn[kScanAhead];
                     load_steps_back(g, g_b, ps, n - 1, D, d);
                     for (int tb = n - 1; tb >= 0; tb -= kScanAhead) {
                       load_steps_back(gn, g_b, ps, tb - kScanAhead, D, d);
#pragma unroll
                       for (int i = 0; i < kScanAhead; ++i) {
                         const int t = tb - i;
                         if (t >= 0) {
                           const float* db = ds + t * Cs;
                           const float dA = softplus(ch.v(db, R)) * ch.A;
                           lam = fmaf(a_next, lam, g[i] * db[R + 1]);
                           a_next = expf(dA);
                           sdA += dA;
                         }
                       }
#pragma unroll
                       for (int i = 0; i < kScanAhead; ++i) g[i] = gn[i];
                     }
                   });
  const long o = (((long)b * K + k) * S + s) * D + d;
  summ[o] = a_next * lam;
  summ[(long)B * K * S * D + o] = sdA;
}

// (a2) The adjoint of segment s, one thread per channel d of a block of NC
// channels (blockIdx.x = s * D / NC + block), direction k, image b.  The
// reverse carry pass first: the lam that flows into the segment's last step
// from the segments after it, E = a lam at the next segment's first step,
// is E_{S-1} = 0, E_{j-1} = exp(summ[1][j]) E_j + summ[0][j], one FMA per
// later segment.  Then the segment's chunks, last first: each chunk's states
// h are recomputed from the carry K1 emitted into shared memory (h_s), and
// lam runs back through it.  Per step it writes du's direct part (dxs) and
// ddt per (b, k, t, d); the dB and dC products (lam delta u, g h) go to a
// per-warp shared tile, which a lane reduces a row at a time every 32 steps
// (one pass over 32 values instead of ten shuffles per step): their
// 32-channel partial sums per (b, k, t).  The partial sums of dbias, dA and
// dDs over the segment go to sums[3][b, s, k, d].
template <int RMAX, typename T>
__global__ void __launch_bounds__(kBwdChannels)
    bwd_scan_kernel(const T* __restrict__ x, const int* __restrict__ idx,
                    const T* __restrict__ gy, const float* __restrict__ dbc,
                    const float* __restrict__ carries, const float* __restrict__ wdt,
                    const float* __restrict__ dt_bias, const float* __restrict__ A_logs,
                    const float* __restrict__ Ds, const float* __restrict__ summ,
                    float* __restrict__ dxs, float* __restrict__ ddt_out,
                    float* __restrict__ dBp, float* __restrict__ dCp, float* __restrict__ sums,
                    int B, int L, int D, int K, int R, int S, int seg_chunks) {
  extern __shared__ float4 smem4[];
  const int C = R + 2, Cs = row_stride(C);
  const int NC = blockDim.x, nblk = D / NC;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* h_s = reinterpret_cast<float*>(smem4);           // [kT][NC] recomputed h_t
  float* prod_s = h_s + kT * NC;                           // [NC / 32][2][32][33] dB, dC products
  float* dbc_s = prod_s + (NC / 32) * 2 * 32 * 33;         // [2][kT][Cs]
  int* pix_s = reinterpret_cast<int*>(dbc_s + 2 * kT * Cs);  // [2][kT]
  float* pB = prod_s + warp * 2 * 32 * 33;
  float* pC = pB + 32 * 33;
  const int s = blockIdx.x / nblk;
  const int d = (blockIdx.x - s * nblk) * NC + threadIdx.x;
  const int grp = d >> 5, G = D / 32;
  const int k = blockIdx.y, b = blockIdx.z;
  const ScanChannel<RMAX> ch(wdt, dt_bias, A_logs, Ds, k, D, d, R);
  const T* x_b = x + (long)b * L * D;
  const T* g_b = gy + (long)b * L * D;
  const long bk = (long)b * K + k;
  const int n_chunks = (L + kT - 1) / kT;
  const int c0 = s * seg_chunks, c1 = min(n_chunks, c0 + seg_chunks);
  const float* carry_bk = carries + bk * n_chunks * D;
  float* dxs_bk = dxs + bk * L * D;
  float* ddt_bk = ddt_out + bk * L * D;
  float* dB_bk = dBp + bk * L * G;
  float* dC_bk = dCp + bk * L * G;
  // lam_{t+1} and a_{t+1} past the segment's last step: a_{t+1} lam_{t+1} = E
  float lam = 0.f, a_next = 1.f;
  {
    const long plane = (long)B * K * S * D;
    const float* ql = summ + bk * S * D + d;
#pragma unroll 4
    for (int j = S - 1; j > s; --j) lam = fmaf(expf(ql[plane + (long)j * D]), lam, ql[(long)j * D]);
  }
  float s_bias = 0.f, s_A = 0.f, s_D = 0.f;
  walk_chunks_back(
      pix_s, dbc_s, idx + (long)k * L, dbc + (long)b * L * K * C, c0, c1, L, K, k, C,
      [&](int c, int t0, int n, const float* ds, const int* ps) {
        const float h_in = carry_bk[(long)c * D + d];
        float h = h_in;
        float u[kScanAhead], un[kScanAhead], g[kScanAhead], gn[kScanAhead];
        load_steps(u, x_b, ps, 0, n, D, d);
        for (int tb = 0; tb < n; tb += kScanAhead) {
          load_steps(un, x_b, ps, tb + kScanAhead, n, D, d);
#pragma unroll
          for (int i = 0; i < kScanAhead; ++i) {
            const int t = tb + i;
            if (t < n) {
              const float* db = ds + t * Cs;
              const float delta = softplus(ch.v(db, R));
              h = fmaf(expf(delta * ch.A), h, delta * db[R] * u[i]);
              h_s[t * NC + threadIdx.x] = h;
            }
          }
#pragma unroll
          for (int i = 0; i < kScanAhead; ++i) u[i] = un[i];
        }
        load_steps_back(u, x_b, ps, n - 1, D, d);
        load_steps_back(g, g_b, ps, n - 1, D, d);
        for (int tb = n - 1; tb >= 0; tb -= kScanAhead) {
          load_steps_back(un, x_b, ps, tb - kScanAhead, D, d);
          load_steps_back(gn, g_b, ps, tb - kScanAhead, D, d);
#pragma unroll
          for (int i = 0; i < kScanAhead; ++i) {
            const int t = tb - i;
            if (t < 0) break;
            const float* db = ds + t * Cs;
            const float v = ch.v(db, R);
            const float delta = softplus(v);
            const float a = expf(delta * ch.A);
            const float sig = 1.f / (1.f + expf(-v));
            const float h_t = h_s[t * NC + threadIdx.x];
            const float h_prev = t > 0 ? h_s[(t - 1) * NC + threadIdx.x] : h_in;
            lam = fmaf(a_next, lam, g[i] * db[R + 1]);
            a_next = a;
            const float daA = lam * h_prev * a;
            const float ddt = fmaf(daA, ch.A, lam * u[i] * db[R]) * sig;
            const long o = (long)(t0 + t) * D + d;
            dxs_bk[o] = fmaf(lam * delta, db[R], g[i] * ch.Dd);
            ddt_bk[o] = ddt;
            pB[(t & 31) * 33 + lane] = lam * delta * u[i];
            pC[(t & 31) * 33 + lane] = g[i] * h_t;
            s_bias += ddt;
            s_A = fmaf(daA, delta, s_A);
            s_D = fmaf(g[i], u[i], s_D);
            if ((t & 31) == 0) {  // steps t .. t + 31 of this chunk are in the tile
              __syncwarp();
              if (lane < n - t) {
                float sb = 0.f, sc = 0.f;
#pragma unroll 8
                for (int j = 0; j < 32; ++j) {
                  sb += pB[lane * 33 + j];
                  sc += pC[lane * 33 + j];
                }
                const long row = (long)(t0 + t + lane) * G + grp;
                dB_bk[row] = sb;
                dC_bk[row] = sc;
              }
              __syncwarp();
            }
          }
#pragma unroll
          for (int i = 0; i < kScanAhead; ++i) {
            u[i] = un[i];
            g[i] = gn[i];
          }
        }
      });
  const long plane = (long)B * S * K * D;
  const long o = (((long)b * S + s) * K + k) * D + d;
  sums[o] = s_bias;
  sums[plane + o] = s_A;
  sums[2 * plane + o] = s_D;
}

constexpr int kDbcRows = 32;  // steps per block of (b)

// (b) d_dbc[row, :R] = ddt[row, :] . wdt[k], d_dbc[row, R] = sum of the dB
// partials, d_dbc[row, R+1] = sum of the dC partials, 0 up to the row
// stride row_stride(R + 2); row = (b, k, t).  A
// block holds kDbcRows steps of one (b, k) (blockIdx.y = b * K + k) and
// takes the product over D in tiles of 32 channels: the tile of ddt
// (kDbcRows x 32) and of wdt[k] (32 x R) in shared memory, thread (lane,
// warp w) summing row `lane` for r = w, w + 8, ... in order.
template <int RMAX>
__global__ void __launch_bounds__(256)
    bwd_dbc_kernel(const float* __restrict__ ddt, const float* __restrict__ dBp,
                   const float* __restrict__ dCp, const float* __restrict__ wdt,
                   float* __restrict__ d_dbc, int L, int D, int K, int R) {
  constexpr int J = (RMAX + 7) / 8;
  __shared__ float a_s[kDbcRows][33];
  __shared__ float w_s[32][RMAX];
  const long bk = blockIdx.y;
  const int k = (int)(bk % K);
  const int t0 = blockIdx.x * kDbcRows, n = min(kDbcRows, L - t0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* src = ddt + (bk * L + t0) * D;
  const float* wk = wdt + (long)k * D * R;
  float acc[J];
#pragma unroll
  for (int j = 0; j < J; ++j) acc[j] = 0.f;
  for (int d0 = 0; d0 < D; d0 += 32) {
    for (int i = threadIdx.x; i < kDbcRows * 32; i += blockDim.x) {
      const int rr = i >> 5, dd = i & 31;
      a_s[rr][dd] = rr < n ? src[(long)rr * D + d0 + dd] : 0.f;
    }
    for (int i = threadIdx.x; i < 32 * R; i += blockDim.x) w_s[i / R][i % R] = wk[(long)d0 * R + i];
    __syncthreads();
#pragma unroll 8
    for (int dd = 0; dd < 32; ++dd) {
      const float a = a_s[lane][dd];
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int r = warp + 8 * j;
        if (r < R) acc[j] = fmaf(a, w_s[dd][r], acc[j]);
      }
    }
    __syncthreads();
  }
  const int C = R + 2, Cp = row_stride(C), G = D / 32;
  float* out = d_dbc + (bk * L + t0) * Cp;
  if (lane < n) {
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int r = warp + 8 * j;
      if (r < R) out[lane * Cp + r] = acc[j];
    }
    if (warp < 2) {  // warp 0 the dB partials, warp 1 the dC ones
      const float* part = (warp == 0 ? dBp : dCp) + (bk * L + t0 + lane) * G;
      float sum = 0.f;
      for (int g = 0; g < G; ++g) sum += part[g];
      out[lane * Cp + R + warp] = sum;
    } else if (warp == 2) {  // the row's padding: 0, as (c) reads it
      for (int c = C; c < Cp; ++c) out[lane * Cp + c] = 0.f;
    }
  }
}

constexpr int kDxPix = 8;  // pixels per block of (c)

// (c) dx[b, l, d] = sum over k and slots m (t = inv[k, m, l]; slot value L =
// none) of dxs[b, k, t, d] + sum_c d_dbc[b, k, t, c] * wx[k, c, d]; dx in T.
// A block holds kDxPix pixels of (b * L + l) and NC channels, one thread
// per channel: for each k the thread keeps its column wx[k, :, d] in
// registers for all the block's pixels, and the d_dbc rows it reads are the
// same for the whole block (one broadcast load each).
template <int RMAX, typename T>
__global__ void __launch_bounds__(256)
    bwd_dx_kernel(const float* __restrict__ dxs, const float* __restrict__ d_dbc,
                  const int* __restrict__ inv, const float* __restrict__ wx, T* __restrict__ dx,
                  long pixels, int K, int Mslots, int L, int D, int C) {
  const int d = blockIdx.y * blockDim.x + threadIdx.x;
  const long q0 = (long)blockIdx.x * kDxPix;
  const int n = (int)min((long)kDxPix, pixels - q0);
  constexpr int CMAX = (RMAX + 2 + 3) & ~3;
  const int Cp = row_stride(C);
  float acc[kDxPix];
#pragma unroll
  for (int p = 0; p < kDxPix; ++p) acc[p] = 0.f;
  for (int k = 0; k < K; ++k) {
    float w[CMAX];
#pragma unroll
    for (int c = 0; c < CMAX; ++c) w[c] = c < C ? wx[((long)k * C + c) * D + d] : 0.f;
    const int* inv_k = inv + (long)k * Mslots * L;
#pragma unroll
    for (int p = 0; p < kDxPix; ++p) {
      if (p >= n) break;
      const long q = q0 + p, b = q / L;
      const int l = (int)(q - b * L);
      for (int m = 0; m < Mslots; ++m) {
        const int t = __ldg(inv_k + (long)m * L + l);
        if (t >= L) break;  // a pixel's positions fill its first slots
        const long row = (b * K + k) * L + t;
        const float4* dd = reinterpret_cast<const float4*>(d_dbc + row * Cp);
        float v = dxs[row * D + d];
#pragma unroll
        for (int c = 0; c < CMAX; c += 4) {
          if (c < C) {  // the padding past C is 0, and so is w there
            const float4 q = __ldg(dd + c / 4);
            v = fmaf(q.x, w[c], v);
            v = fmaf(q.y, w[c + 1], v);
            v = fmaf(q.z, w[c + 2], v);
            v = fmaf(q.w, w[c + 3], v);
          }
        }
        acc[p] += v;
      }
    }
  }
#pragma unroll
  for (int p = 0; p < kDxPix; ++p)
    if (p < n) dx[(q0 + p) * D + d] = from_f32<T>(acc[p]);
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
    sd[i] = d_dbc[((b * K + k) * L + (q - b * L)) * row_stride(C) + c];
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
               float* dwdt, float* sums, float* summ, float* dxs, float* ddt, float* dBp,
               float* dCp, float* d_dbc, float* pwx, float* pwdt, int B, int L, int D, int K,
               int R, int Mslots, cudaStream_t s) {
  const int C = R + 2;
  const int per = scan_seg_chunks(B, L, D, K, kScanBwdWarps), S = scan_segments(L, per);
  const int nc = scan_block_channels(D, kBwdChannels), nblk = D / nc;
  const size_t rows_smem = scan_rows_smem(C);
  if (S > 1) {
    cudaError_t e = allow_smem(bwd_summary_kernel<RMAX, T>, rows_smem);
    if (e != cudaSuccess) return (int)e;
    bwd_summary_kernel<RMAX, T><<<dim3((S - 1) * nblk, K, B), nc, rows_smem, s>>>(
        idx, gy, dbc, wdt, dt_bias, A_logs, Ds, summ, B, L, D, K, R, S, per);
    TRAMBA_CHECK_LAUNCH();
  }
  const size_t smem = (size_t)(kT * nc + (nc / 32) * 2 * 32 * 33) * 4 + rows_smem;
  cudaError_t e = allow_smem(bwd_scan_kernel<RMAX, T>, smem);
  if (e != cudaSuccess) return (int)e;
  bwd_scan_kernel<RMAX, T><<<dim3(S * nblk, K, B), nc, smem, s>>>(
      x, idx, gy, dbc, carries, wdt, dt_bias, A_logs, Ds, summ, dxs, ddt, dBp, dCp, sums, B, L,
      D, K, R, S, per);
  TRAMBA_CHECK_LAUNCH();
  bwd_dbc_kernel<RMAX><<<dim3((L + kDbcRows - 1) / kDbcRows, B * K), 256, 0, s>>>(
      ddt, dBp, dCp, wdt, d_dbc, L, D, K, R);
  TRAMBA_CHECK_LAUNCH();
  const long pixels = (long)B * L;
  const int dx_nc = scan_block_channels(D, 256);
  bwd_dx_kernel<RMAX, T><<<dim3((unsigned)((pixels + kDxPix - 1) / kDxPix), D / dx_nc), dx_nc, 0,
                           s>>>(dxs, d_dbc, inv, wx, dx, pixels, K, Mslots, L, D, C);
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
// Outputs: dx; dwx (K, R+2, D); dwdt (K, D, R); sums (3, B, S, K, D),
// the per-image, per-segment sums of dbias, dA and dDs, with S =
// ceil(L / ss2d_scan_segment_steps(B, L, D, K, 1)).
// Scratch: summ (2, B, K, S, D); dxs, ddt (B, K, L, D); dBp, dCp (B, K, L,
// D/32); d_dbc (B, K, L, row_stride(R+2)) (R+2 rounded up to a multiple
// of 4); pwx (chunks, K, R+2, D); pwdt (chunks, K, D, R) with
// chunks = ceil(B * L / ss2d_scan_bwd_rows()).  D % 32 == 0, R <= 64.
int ss2d_scan_bwd_launch(const void* x, const int* idx, const int* inv, const void* gy,
                         const float* carries, const float* dbc, const float* wx,
                         const float* wdt, const float* dt_bias, const float* A_logs,
                         const float* Ds, void* dx, float* dwx, float* dwdt, float* sums,
                         float* summ, float* dxs, float* ddt, float* dBp, float* dCp,
                         float* d_dbc, float* pwx, float* pwdt, int B, int L, int D, int K,
                         int R, int Mslots, int bf16_x, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TRAMBA_BWD(RM, T)                                                                   \
  bwd_launch<RM, T>(static_cast<const T*>(x), idx, inv, static_cast<const T*>(gy), carries,  \
                    dbc, wx, wdt, dt_bias, A_logs, Ds, static_cast<T*>(dx), dwx, dwdt, sums, \
                    summ, dxs, ddt, dBp, dCp, d_dbc, pwx, pwdt, B, L, D, K, R, Mslots, s)
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
