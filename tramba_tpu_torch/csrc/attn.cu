// K12 sra and K13 window_attn: the attention blocks of the bf16 Tramba-P
// (PVTv2-b4) and Tramba-S (Swin-B) encoders.
//
// K12 replaces _sra_pallas (tramba_tpu/ops/fused_attn.py:96, kernel :58),
// PVTv2's spatial-reduction attention: per query row
//   y = bf16(LN(x)) (eps 1e-6); q = bf16((y @ wq^T + bq) * hd^-1/2);
//   per head h: p = bf16(softmax(q_h k_h^T)); o_h = p @ v_h;
//   out = bf16(bf16(concat_h o_h) @ wp^T + bp),
// with k, v (B, nh, Lk, hd) from the composed sr-conv path outside.
// K13 replaces _wattn_pallas (:254, kernel :204), Swin's window attention,
// per 12x12 window of the (already rolled) map:
//   y = bf16(LN(x)) (eps 1e-5); qkv = y @ wqkv^T + bqkv (fp32);
//   q = bf16(q * hd^-1/2), k = bf16(k), v = bf16(v);
//   p = bf16(softmax(q_h k_h^T + bias[h] (+ mask[window])));
//   out = bf16(bf16(concat_h p v_h) @ wp^T + bp),
// window partition and reverse by index arithmetic; the cyclic shift, the
// gather of the relative-position bias and the residual stay outside.
//
// Both are the same two launches after the bf16 LayerNorm launch of
// csrc/mlp.cu:
//   (1) proj_in_kernel: the input projection of the LN'd rows, with the bias
//       and the q scale in fp32 and one rounding to bf16: q (B*N, C) for K12,
//       qkv (B, H, W, 3C) for K13.  Every rounding point of the TPU kernels
//       comes after a bf16 cast of q, k and v, so writing them in bf16 to
//       device memory changes no number.
//   (2) attn_kernel: one block per (group of keys, chunk of QM query rows):
//       for each head it stages q_h, k_h and v_h in shared memory, computes
//       the fp32 scores (bf16 wmma tiles, fp32 accumulation), adds bias and
//       mask, takes the softmax in fp32 with one warp per row, rounds p,
//       multiplies by v_h and rounds the head's output into the merged bf16
//       row tile; then the output projection (wp from L2), bp, one rounding.
//       A group is a batch image (K12: all Lk = 144 reduced keys of the image)
//       or a window (K13: its N = 144 tokens).
//
// K13's working set at stage 3 (C = 512, 16 heads: y 147 KB, fp32 qkv, the
// 144 x 144 scores) does not fit one SM's 227 KB, so the design is the split
// above: launch (1) writes bf16 q, k, v, and launch (2) tiles by head (only
// one head's q, k, v, scores and probabilities are resident) and by query
// rows (QM of the 144); only the merged (QM, C) bf16 head outputs and the
// (QM, C) fp32 projection stay across heads.
//
// What bounds them on an H100: the products (2*C*C per row for each of the
// q/k/v and output projections, 4*Lk*C per row for scores and p v) on the
// bf16 tensor cores, against the bytes of x, out and (K13) the bf16 qkv round
// trip.  At these widths both are far below the card's rates; the kernels are
// latency-bound by their many small tiles (Lk = 144, hd = 32 or 64) and the
// syncs between the per-head phases.  The query-row chunk QM is chosen per
// shape so that at least two blocks per SM are in flight where the map
// allows it (K12 at stage 1 has 9216 rows per image, stage 4 only 144).
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr size_t kSmemMax = 227 * 1024;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// C = A * B over all 16x16 tiles of an (Mt*16) x (Nt*16) output, with B
// row-major (B[k * ldb + n]): p v, where v's rows are the keys.  A, B in
// shared memory (32-byte aligned tiles, lda, ldb % 8 == 0), C fp32 in shared
// memory (ldc % 4 == 0).  The caller synchronises around the call.
__device__ __forceinline__ void mma_tiles_rowb(const bf16* A, int lda, const bf16* B, int ldb,
                                               float* C, int ldc, int Mt, int Nt, int K) {
  const int warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  for (int t = warp; t < Mt * Nt; t += nwarps) {
    const int mt = t / Nt, nt = t % Nt;
    wm::fragment<wm::accumulator, 16, 16, 16, float> c;
    wm::fill_fragment(c, 0.f);
    for (int k = 0; k < K; k += 16) {
      wm::fragment<wm::matrix_a, 16, 16, 16, bf16, wm::row_major> a;
      wm::fragment<wm::matrix_b, 16, 16, 16, bf16, wm::row_major> b;
      wm::load_matrix_sync(a, A + mt * 16 * lda + k, lda);
      wm::load_matrix_sync(b, B + k * ldb + nt * 16, ldb);
      wm::mma_sync(c, a, b, c);
    }
    wm::store_matrix_sync(C + mt * 16 * ldc + nt * 16, c, ldc, wm::mem_row_major);
  }
}

// ---- (1) input projection ---------------------------------------------------

// One block per (BM rows, NC output columns).  Shared: ys [BM][K+8] bf16,
// acc [BM][NC+4] fp32.  out[m, j] = bf16((y[m] . w[j] + b[j]) * s_j), s_j =
// scale for j < nscale, else 1.
__global__ void proj_in_kernel(const bf16* __restrict__ y, const bf16* __restrict__ w,
                               const float* __restrict__ b, bf16* __restrict__ out, long M, int K,
                               int Nout, int nscale, float scale, int BM, int NC) {
  extern __shared__ float4 smem4[];
  const int ldy = K + 8, ldacc = NC + 4;
  bf16* ys = reinterpret_cast<bf16*>(smem4);
  float* acc = reinterpret_cast<float*>(ys + BM * ldy);
  const long m0 = (long)blockIdx.x * BM;
  const int n0 = blockIdx.y * NC;
  const int vn = K / 8;
  for (int i = threadIdx.x; i < BM * vn; i += blockDim.x) {
    const int p = i / vn, v = i - p * vn;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (m0 + p < M) val = __ldg(reinterpret_cast<const uint4*>(y + (m0 + p) * K) + v);
    *reinterpret_cast<uint4*>(ys + p * ldy + v * 8) = val;
  }
  __syncthreads();
  mma_tiles(ys, ldy, w + (long)n0 * K, K, acc, ldacc, BM / 16, NC / 16, K, false);
  __syncthreads();
  for (int i = threadIdx.x; i < BM * NC; i += blockDim.x) {
    const int p = i / NC, j = i - p * NC;
    if (m0 + p >= M) continue;
    float v = acc[p * ldacc + j] + b[n0 + j];
    if (n0 + j < nscale) v *= scale;
    out[(m0 + p) * Nout + n0 + j] = __float2bfloat16_rn(v);
  }
}

size_t proj_smem(int BM, int K, int NC) { return (size_t)BM * ((K + 8) * 2 + (NC + 4) * 4); }

// ---- (2) attention + output projection --------------------------------------

struct AttnArgs {
  const bf16* q;   // K12: q (B*N, C); K13: qkv (B*H*W, 3C), q at column 0
  const bf16* k;   // K12: k (B, nh, Lk, hd); K13: qkv again, k at column C
  const bf16* v;   // K12: v (B, nh, Lk, hd); K13: qkv again, v at column 2C
  const float* bias;  // K13: (nh, N, N) fp32
  const float* mask;  // K13: (nW, N, N) fp32, or null
  const bf16* wp;     // (C, C)
  const float* bp;    // (C)
  bf16* out;          // K12: (B*N, C); K13: (B*H*W, C)
  int C, nh, hd, Nq, Lk, QM;
  int H, W, w, nWh, nWw;  // K13 geometry
};

// Byte offsets of the shared buffers of attn_kernel, each 128-byte aligned:
// os [QM][C+8] bf16 (merged head outputs), then either the per-head tiles
// qs [QM][hd+8], ks and vs [Lk][hd+8] bf16, S [QM][Lk+4] fp32, P [QM][Lk+8]
// bf16, Oh [QM][hd+4] fp32, or, after the heads, out32 [QM][C+4] fp32.
struct AttnSmem {
  size_t qs, ks, vs, S, P, Oh, out32, total;
};

__host__ __device__ inline size_t al128(size_t n) { return (n + 127) / 128 * 128; }

__host__ __device__ inline AttnSmem attn_layout(int QM, int C, int hd, int Lk) {
  AttnSmem s;
  const size_t os = al128((size_t)QM * (C + 8) * 2);
  s.qs = os;
  s.ks = s.qs + al128((size_t)QM * (hd + 8) * 2);
  s.vs = s.ks + al128((size_t)Lk * (hd + 8) * 2);
  s.S = s.vs + al128((size_t)Lk * (hd + 8) * 2);
  s.P = s.S + al128((size_t)QM * (Lk + 4) * 4);
  s.Oh = s.P + al128((size_t)QM * (Lk + 8) * 2);
  const size_t heads_end = s.Oh + al128((size_t)QM * (hd + 4) * 4);
  s.out32 = os;
  const size_t out_end = os + al128((size_t)QM * (C + 4) * 4);
  s.total = heads_end > out_end ? heads_end : out_end;
  return s;
}

template <bool kWindow>
__global__ void attn_kernel(AttnArgs a) {
  extern __shared__ float4 smem4[];
  char* base = reinterpret_cast<char*>(smem4);
  const AttnSmem L = attn_layout(a.QM, a.C, a.hd, a.Lk);
  const int C = a.C, hd = a.hd, Lk = a.Lk, QM = a.QM, Nq = a.Nq;
  const int ldo = C + 8, ldh = hd + 8, ldS = Lk + 4, ldP = Lk + 8, ldOh = hd + 4, ldout = C + 4;
  bf16* os = reinterpret_cast<bf16*>(base);
  bf16* qs = reinterpret_cast<bf16*>(base + L.qs);
  bf16* ks = reinterpret_cast<bf16*>(base + L.ks);
  bf16* vs = reinterpret_cast<bf16*>(base + L.vs);
  float* S = reinterpret_cast<float*>(base + L.S);
  bf16* P = reinterpret_cast<bf16*>(base + L.P);
  float* Oh = reinterpret_cast<float*>(base + L.Oh);
  float* out32 = reinterpret_cast<float*>(base + L.out32);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nwarps = blockDim.x >> 5;

  const int g = blockIdx.y, q0 = blockIdx.x * QM;
  // K12: g is the image; K13: g is (image, window row, window column)
  const int nW = a.nWh * a.nWw;
  const int b = kWindow ? g / nW : g;
  const int widx = kWindow ? g % nW : 0;
  const int wy = widx / (a.nWw > 0 ? a.nWw : 1), wx = widx % (a.nWw > 0 ? a.nWw : 1);
  // device-memory row of token t of this group (query row for K12)
  auto row_of = [&](int t) -> long {
    if (kWindow)
      return ((long)b * a.H + wy * a.w + t / a.w) * a.W + wx * a.w + t % a.w;
    return (long)b * Nq + t;
  };
  const long q_ld = kWindow ? 3L * C : (long)C;
  const int vpr = hd / 8;  // 16-byte vectors per head row

  for (int h = 0; h < a.nh; ++h) {
    for (int i = threadIdx.x; i < QM * vpr; i += blockDim.x) {
      const int p = i / vpr, c = i - p * vpr, t = q0 + p;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (t < Nq)
        val = __ldg(reinterpret_cast<const uint4*>(a.q + row_of(t) * q_ld + h * hd) + c);
      *reinterpret_cast<uint4*>(qs + p * ldh + c * 8) = val;
    }
    for (int i = threadIdx.x; i < Lk * vpr; i += blockDim.x) {
      const int j = i / vpr, c = i - j * vpr;
      const bf16 *kp, *vp;
      if (kWindow) {
        const long r = row_of(j) * q_ld + h * hd;
        kp = a.k + r + C;
        vp = a.v + r + 2 * C;
      } else {
        const long r = (((long)b * a.nh + h) * Lk + j) * hd;
        kp = a.k + r;
        vp = a.v + r;
      }
      *reinterpret_cast<uint4*>(ks + j * ldh + c * 8) =
          __ldg(reinterpret_cast<const uint4*>(kp) + c);
      *reinterpret_cast<uint4*>(vs + j * ldh + c * 8) =
          __ldg(reinterpret_cast<const uint4*>(vp) + c);
    }
    __syncthreads();
    // scores: S = q_h k_h^T (ks rows are B's "weight rows")
    mma_tiles(qs, ldh, ks, ldh, S, ldS, QM / 16, Lk / 16, hd, false);
    __syncthreads();
    // (+ bias (+ mask)), softmax in fp32, p rounded to bf16
    for (int p = warp; p < QM; p += nwarps) {
      float* srow = S + p * ldS;
      bf16* prow = P + p * ldP;
      const int t = q0 + p;
      if (t >= Nq) {
        for (int j = lane; j < Lk; j += 32) prow[j] = __float2bfloat16_rn(0.f);
        continue;
      }
      float mx = -INFINITY;
      for (int j = lane; j < Lk; j += 32) {
        float s = srow[j];
        if (kWindow) {
          s = s + a.bias[((long)h * Nq + t) * Lk + j];
          if (a.mask) s = s + a.mask[((long)widx * Nq + t) * Lk + j];
          srow[j] = s;
        }
        mx = fmaxf(mx, s);
      }
      mx = warp_max(mx);
      float sum = 0.f;
      for (int j = lane; j < Lk; j += 32) {
        const float e = expf(srow[j] - mx);
        srow[j] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      for (int j = lane; j < Lk; j += 32) prow[j] = __float2bfloat16_rn(srow[j] / sum);
    }
    __syncthreads();
    mma_tiles_rowb(P, ldP, vs, ldh, Oh, ldOh, QM / 16, hd / 16, Lk);
    __syncthreads();
    for (int i = threadIdx.x; i < QM * hd; i += blockDim.x) {
      const int p = i / hd, d = i - p * hd;
      os[p * ldo + h * hd + d] = __float2bfloat16_rn(Oh[p * ldOh + d]);
    }
    __syncthreads();
  }
  // output projection of the merged heads
  mma_tiles(os, ldo, a.wp, C, out32, ldout, QM / 16, C / 16, C, false);
  __syncthreads();
  for (int i = threadIdx.x; i < QM * C; i += blockDim.x) {
    const int p = i / C, j = i - p * C, t = q0 + p;
    if (t >= Nq) continue;
    a.out[row_of(t) * C + j] = __float2bfloat16_rn(out32[p * ldout + j] + a.bp[j]);
  }
}

// Query rows per block: the largest of 64, 48, 32, 16 whose tiles fit one
// block and, except for 16, divide Nq, that still gives two blocks per SM;
// else 16.  0 when not even 16 rows fit.
int pick_qm(long groups, int Nq, int C, int hd, int Lk) {
  const int cands[] = {64, 48, 32, 16};
  for (int qm : cands) {
    if (attn_layout(qm, C, hd, Lk).total > kSmemMax) continue;
    if (qm != 16 && Nq % qm) continue;
    if (qm == 16 || groups * ((Nq + qm - 1) / qm) >= 2L * 132) return qm;
  }
  return 0;
}

template <bool kWindow>
int launch_attn(AttnArgs a, long groups, cudaStream_t s) {
  if (a.C % 16 || a.hd % 16 || a.Lk % 16 || a.nh * a.hd != a.C) return (int)cudaErrorInvalidValue;
  a.QM = pick_qm(groups, a.Nq, a.C, a.hd, a.Lk);
  if (a.QM == 0) return (int)cudaErrorInvalidValue;
  const size_t smem = attn_layout(a.QM, a.C, a.hd, a.Lk).total;
  cudaError_t e = allow_smem(attn_kernel<kWindow>, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)((a.Nq + a.QM - 1) / a.QM), (unsigned)groups);
  attn_kernel<kWindow><<<grid, kThreads, smem, s>>>(a);
  TRAMBA_CHECK_LAUNCH();
  return 0;
}

}  // namespace

extern "C" {

// (1) out (M, Nout) bf16 = the projection of y (M, K) bf16 (already LN'd) by
// w (Nout, K) bf16 and b (Nout) fp32, columns below nscale times scale.
// K, Nout multiples of 16.
int attn_proj_in_launch(const bf16* y, const bf16* w, const float* b, bf16* out, long M, int K,
                        int Nout, int nscale, float scale, void* stream) {
  if (K % 16 || Nout % 16) return (int)cudaErrorInvalidValue;
  int NC = 128;
  while (Nout % NC) NC /= 2;
  const int ncols = Nout / NC;
  int BM = 64;
  while (BM > 16 && ((M + BM - 1) / BM) * ncols < 2L * 132) BM /= 2;
  while (BM > 16 && proj_smem(BM, K, NC) > kSmemMax) BM /= 2;
  const size_t smem = proj_smem(BM, K, NC);
  if (smem > kSmemMax) return (int)cudaErrorInvalidValue;
  cudaError_t e = allow_smem(proj_in_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)ncols);
  proj_in_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      y, w, b, out, M, K, Nout, nscale, scale, BM, NC);
  TRAMBA_CHECK_LAUNCH();
  return 0;
}

// K12 (2).  q (B, N, C) bf16 from (1); k, v (B, nh, Lk, hd) bf16; wp (C, C)
// bf16; bp (C) fp32; out (B, N, C) bf16.  C, hd, Lk multiples of 16.
int sra_attn_launch(const bf16* q, const bf16* k, const bf16* v, const bf16* wp,
                    const float* bp, bf16* out, int B, int N, int C, int nh, int Lk,
                    void* stream) {
  AttnArgs a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.wp = wp;
  a.bp = bp;
  a.out = out;
  a.C = C;
  a.nh = nh;
  a.hd = nh > 0 ? C / nh : 0;
  a.Nq = N;
  a.Lk = Lk;
  return launch_attn<false>(a, B, static_cast<cudaStream_t>(stream));
}

// K13 (2).  qkv (B, H, W, 3C) bf16 from (1), q pre-scaled; bias (nh, w*w,
// w*w) fp32; mask (nW, w*w, w*w) fp32 or null; wp (C, C) bf16; bp (C) fp32;
// out (B, H, W, C) bf16.  H, W multiples of w; C, hd, w*w multiples of 16.
int window_attn_launch(const bf16* qkv, const float* bias, const float* mask, const bf16* wp,
                       const float* bp, bf16* out, int B, int H, int W, int C, int nh, int w,
                       void* stream) {
  if (w <= 0 || H % w || W % w) return (int)cudaErrorInvalidValue;
  AttnArgs a{};
  a.q = qkv;
  a.k = qkv;
  a.v = qkv;
  a.bias = bias;
  a.mask = mask;
  a.wp = wp;
  a.bp = bp;
  a.out = out;
  a.C = C;
  a.nh = nh;
  a.hd = nh > 0 ? C / nh : 0;
  a.Nq = a.Lk = w * w;
  a.H = H;
  a.W = W;
  a.w = w;
  a.nWh = H / w;
  a.nWw = W / w;
  return launch_attn<true>(a, (long)B * a.nWh * a.nWw, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
