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
// K12 runs two launches after the bf16 LayerNorm launch of csrc/mlp.cu:
//   (1) proj_in_kernel: the input projection of the LN'd rows, with the bias
//       and the q scale in fp32 and one rounding to bf16: q (B*N, C).  Every
//       rounding point of the TPU kernel comes after a bf16 cast of q, so
//       writing it in bf16 to device memory changes no number.
//   (2) attn_kernel: one block per (image, chunk of QM query rows):
//       for each head it stages q_h, k_h and v_h in shared memory, computes
//       the fp32 scores (bf16 wmma tiles, fp32 accumulation), takes the
//       softmax in fp32 with one warp per row, rounds p, multiplies by v_h
//       and rounds the head's output into the merged bf16 row tile; then the
//       output projection (wp from L2), bp, one rounding.
// What bounds K12 on an H100: the products (2*C*C per row for each of the q
// and output projections, 4*Lk*C per row for scores and p v) on the bf16
// tensor cores, against the bytes of x and out; at these widths both are far
// below the card's rates, and the kernel is latency-bound by its many small
// tiles and the syncs between the per-head phases.
//
// K13 is two launches, and no LayerNorm launch:
//   (i) ln_fc_kernel<kFrontQKV> (common.cuh, the front K7, K9 and K10 use):
//       each block normalises its 64 rows itself into a swizzled tile and
//       runs the qkv projection as wgmma with wqkv streamed by TMA; bias, the
//       q scale and one rounding in the epilogue: bf16 q, k, v written once
//       (changing no number, as for K12's q).
//   (ii) window_attn_kernel (below): attention and the output projection.
// A window's working set at stage 3 (C 512, 16 heads: its 144 LN'd rows take
// 147 KB, the merged head outputs 147 KB more) does not fit one block's 227
// KB, hence the split: (i) holds no attention state, (ii) holds only its
// query rows' merged outputs across heads.  What bounds K13: its products
// (8 C^2 + 4 N C operations a row, far over the bf16 ridge) on the tensor
// cores; the qkv round trip (12 C bytes a row) is the bytes it adds.  What
// holds it back: (i)'s weight stream (each 64-row tile reads all of wqkv
// from L2) and (ii)'s per-head chain (each pair of warps walks all the heads
// of its 16 query rows); the design below keeps (ii)'s scores,
// probabilities and outputs in registers, stages every operand of a head
// (q, k, v and the bias rows) by cp.async a head ahead, and reads the mask
// once per window.
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
  const bf16* q;   // (B*N, C)
  const bf16* k;   // (B, nh, Lk, hd)
  const bf16* v;   // (B, nh, Lk, hd)
  const bf16* wp;  // (C, C)
  const float* bp; // (C)
  bf16* out;       // (B*N, C)
  int C, nh, hd, Nq, Lk, QM;
  int Lkv;  // keys that take part: those from Lkv on are padding (-inf)
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

  const int b = blockIdx.y, q0 = blockIdx.x * QM;  // image, first query row
  auto row_of = [&](int t) -> long { return (long)b * Nq + t; };
  const long q_ld = C;
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
      const long r = (((long)b * a.nh + h) * Lk + j) * hd;
      const bf16 *kp = a.k + r, *vp = a.v + r;
      *reinterpret_cast<uint4*>(ks + j * ldh + c * 8) =
          __ldg(reinterpret_cast<const uint4*>(kp) + c);
      *reinterpret_cast<uint4*>(vs + j * ldh + c * 8) =
          __ldg(reinterpret_cast<const uint4*>(vp) + c);
    }
    __syncthreads();
    // scores: S = q_h k_h^T (ks rows are B's "weight rows")
    mma_tiles(qs, ldh, ks, ldh, S, ldS, QM / 16, Lk / 16, hd, false);
    __syncthreads();
    // softmax in fp32, p rounded to bf16
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
        if (j >= a.Lkv) s = -INFINITY;
        srow[j] = s;
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

int launch_attn(AttnArgs a, long groups, cudaStream_t s) {
  if (a.C % 16 || a.hd % 16 || a.Lk % 16 || a.nh * a.hd != a.C) return (int)cudaErrorInvalidValue;
  a.QM = pick_qm(groups, a.Nq, a.C, a.hd, a.Lk);
  if (a.QM == 0) return (int)cudaErrorInvalidValue;
  const size_t smem = attn_layout(a.QM, a.C, a.hd, a.Lk).total;
  cudaError_t e = allow_smem(attn_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)((a.Nq + a.QM - 1) / a.QM), (unsigned)groups);
  attn_kernel<<<grid, kThreads, smem, s>>>(a);
  TRAMBA_CHECK_LAUNCH();
  return 0;
}

// ---- K13 (ii): window attention + output projection --------------------------
//
// One block of two warpgroups per (window, group of kWinRows query rows):
// 144 tokens make three groups (grid x), so the 24 px map gives 12 blocks
// an image.  Shared, from a 1024-aligned base:
//   os    [Cq / 64][kWinRows][64] bf16, 128-byte swizzle: the merged head
//         outputs, the output projection's A; the product's 64-row M tile
//         reads 16 rows past each K block (into the next, or the slack after
//         the last, which holds the tokens' map rows), rows it drops;
//   X     two staging buffers, filled by cp.async a head ahead: q_h of the
//         block's rows and k_h, v_h of the window's N tokens (rows of hd + 8
//         bf16: ldmatrix conflict-free), then bias[h] on the block's rows
//         (fp32 rows of N + 4); the mask on the block's rows, staged once per
//         window; the halves' row maxima and sums; half 1's p v partials.
//         The projection's ring of wp boxes (kWinRing slots of two 64 x 64
//         boxes) reuses the first staging buffer.
// Warp w owns query rows [16 (w % 4), + 16) of the group (w % 4 < 3) and
// half w / 4 of the keys (16-key pairs [0, ceil(P / 2)) or the rest, P = N /
// 16).  Per head: the scores q_h k_h^T as mma.sync m16n8k16 into registers
// (at most 40 fp32 a thread); + bias[h] (+ mask); the row max over both
// halves (exchanged through shared memory), e = exp(s - max), the row sum
// over both halves: the softmax of the whole row, taken exactly, with no
// online rescaling; p = bf16(e / sum) packed straight into p v's A
// fragments (the score tiles' accumulator layout is the A layout), v_h's B
// fragments by ldmatrix.trans; half 0 adds half 1's fp32 partial and rounds
// the head's output to bf16 into os.  Then the output projection out = os
// wp^T + bp on wgmma m64n64k16 (a warpgroup a 64-column half of each
// 128-column chunk), wp by TMA, one rounding, rows scattered back to the
// map (the window reverse).
constexpr int kWinRows = 48;
constexpr int kWinRing = 3;
constexpr int kWinKeys = 144;                         // most keys a window
constexpr int kWinPairs = (kWinKeys / 16 + 1) / 2;    // 16-key pairs a half: 5

// Shared-memory layout of window_attn_kernel: byte offsets of region X from
// the 1024-aligned base, and within X of the second staging buffer (stage),
// the mask rows, the exchanged maxima and sums, the p v partials; bytes in
// all (with the base's 1024).
struct WinLayout {
  size_t x, stage, mask, red, ob, total;
};

__host__ __device__ inline WinLayout win_layout(int Cq, int hd, int N) {
  WinLayout l;
  l.x = (size_t)((Cq + 63) / 64) * kWinRows * 128 + 16 * 128;
  l.stage = (size_t)(kWinRows + 2 * N) * (hd + 8) * 2 + (size_t)kWinRows * (N + 4) * 4;
  l.mask = 2 * l.stage;
  l.red = l.mask + (size_t)kWinRows * (N + 4) * 4;
  l.ob = l.red + 2 * 4 * 2 * 16 * 4;
  const size_t heads = l.ob + (size_t)3 * 16 * (hd + 8) * 4;
  const size_t ring = (size_t)kWinRing * 2 * kBox * 2;
  l.total = 1024 + l.x + (heads > ring ? heads : ring);
  return l;
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

template <int HD>
__global__ void __launch_bounds__(256, 1)
    window_attn_kernel(const __grid_constant__ CUtensorMap map_wp, const bf16* __restrict__ qkv,
                       const float* __restrict__ bias, const float* __restrict__ mask,
                       const float* __restrict__ bp, bf16* __restrict__ out, int H, int W, int w,
                       int Cq, int nh) {
  constexpr int LD = HD + 8;  // elements a staged row (bf16) and a p v partial row (fp32)
  extern __shared__ float4 smem4[];
  const int N = w * w, nkb = (Cq + 63) / 64, LB = N + 4;
  const WinLayout L = win_layout(Cq, HD, N);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem4);  // the ring's mbarriers
  bf16* os = tiles_start(smem4, 64);
  char* X = reinterpret_cast<char*>(os) + L.x;
  float* ms = mask ? reinterpret_cast<float*>(X + L.mask) : nullptr;
  float* red = reinterpret_cast<float*>(X + L.red);  // [max, sum][slab][half][16 rows]
  float* ob = reinterpret_cast<float*>(X + L.ob);    // [slab][16 rows][LD]
  const int tid = threadIdx.x, wg = tid >> 7, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3, slab = warp & 3, half = warp >> 2;
  const int nWw = W / w, nW = (H / w) * nWw;
  const int widx = blockIdx.y % nW, b = blockIdx.y / nW;
  const int wy = widx / nWw, wx = widx % nWw;
  const int r0 = blockIdx.x * kWinRows, nrow = min(kWinRows, N - r0);
  const long ld3 = 3L * Cq;
  // the map row of each token of the window, in the slack after os
  int* tok_row = reinterpret_cast<int*>(os + (size_t)nkb * kWinRows * 64);
  for (int t = tid; t < N; t += 256) tok_row[t] = (b * H + wy * w + t / w) * W + wx * w + t % w;
  auto qs_of = [&](int buf) { return reinterpret_cast<bf16*>(X + buf * L.stage); };
  auto bias_of = [&](int buf) {
    return reinterpret_cast<float*>(X + buf * L.stage + (size_t)(kWinRows + 2 * N) * LD * 2);
  };
  // rows [0, nrow) of an (., N) fp32 matrix from row `row0` into rows of LB
  auto stage_rows = [&](float* dst, const float* src) {
    for (int r = warp; r < nrow; r += 8)
      for (int c = 4 * lane; c < N; c += 128) cp_async16(dst + r * LB + c, src + (long)r * N + c, true);
  };
  auto stage = [&](int h, int buf) {  // head h's operands into buffer buf; one group
    bf16* qs = qs_of(buf);
    constexpr int vpr = HD / 8;
    stage_rows(bias_of(buf), bias + ((long)h * N + r0) * N);
    for (int i = tid; i < nrow * vpr; i += 256) {
      const int r = i / vpr, c = 8 * (i - r * vpr);
      cp_async16(qs + r * LD + c, qkv + tok_row[r0 + r] * ld3 + h * HD + c, true);
    }
    for (int i = tid; i < 2 * N * vpr; i += 256) {  // k rows, then v rows
      const int r = i / vpr, c = 8 * (i - r * vpr), kv = r >= N, t = r - kv * N;
      cp_async16(qs + (kWinRows + r) * LD + c, qkv + tok_row[t] * ld3 + (1 + kv) * Cq + h * HD + c,
                 true);
    }
    cp_async_commit();
  };
  // the output projection's ring: tile t = (128-column chunk t / nkb, k-slab
  // t % nkb), a 64 x 64 box of wp for each warpgroup
  bf16* ring = qs_of(0);
  const int nch = (Cq + 127) / 128, T = nch * nkb;
  auto issue = [&](int t) {
    const int slot = t % kWinRing, ch = t / nkb, kb = t % nkb;
    bf16* dst = ring + (size_t)slot * 2 * kBox;
    mbar_expect_tx(full + slot, 2 * kBox * 2);
    tma_load_2d(dst, &map_wp, 64 * kb, 128 * ch, full + slot);
    tma_load_2d(dst + kBox, &map_wp, 64 * kb, 128 * ch + 64, full + slot);
  };
  // the ring's first tiles land during the last head where it runs from the
  // second buffer and the ring fits the first
  const bool early = nh % 2 == 0 && (size_t)kWinRing * 2 * kBox * 2 <= L.stage;
  if (tid == 0) {
    for (int i = 0; i < kWinRing; ++i) mbar_init(full + i, 1);
    mbar_init_fence();
  }
  __syncthreads();  // tok_row is written
  if (ms) stage_rows(ms, mask + ((long)widx * N + r0) * N);  // once per window, in head 0's group
  stage(0, 0);

  // this warp's query rows and 16-key pairs [p0, p0 + np)
  const bool rows_ok = slab < 3 && 16 * slab < nrow;
  const int P = N / 16, p0 = half ? (P + 1) / 2 : 0, np = half ? P / 2 : (P + 1) / 2;
  float* red_max = red + (slab * 2) * 16;  // + half * 16 + row
  float* red_sum = red + 128 + (slab * 2) * 16;
  for (int h = 0; h < nh; ++h) {
    if (h + 1 < nh) {
      stage(h + 1, (h + 1) & 1);  // its buffer's last reads ended before the last barrier
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
      if (early) fence_proxy_async();  // the first buffer's reads before the ring's TMA writes
    }
    __syncthreads();  // head h's operands have landed
    if (early && h == nh - 1 && tid == 0)
      for (int t = 0; t < min(T, kWinRing); ++t) issue(t);
    const bf16* qs = qs_of(h & 1);
    const bf16* ks = qs + kWinRows * LD;
    const bf16* vs = ks + N * LD;
    float s[2 * kWinPairs][4];
    float mx0 = -INFINITY, mx1 = -INFINITY;
    if (rows_ok) {
      unsigned qa[HD / 16][4];
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        ldmatrix_x4(qa[kk], qs + (16 * slab + (lane & 15)) * LD + 16 * kk + 8 * (lane >> 4));
#pragma unroll
      for (int jp = 0; jp < kWinPairs; ++jp) {  // keys 16 (p0 + jp) + [0, 16)
        s[2 * jp][0] = s[2 * jp][1] = s[2 * jp][2] = s[2 * jp][3] = 0.f;
        s[2 * jp + 1][0] = s[2 * jp + 1][1] = s[2 * jp + 1][2] = s[2 * jp + 1][3] = 0.f;
        if (jp >= np) continue;
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          unsigned kb[4];
          ldmatrix_x4(kb, ks + (16 * (p0 + jp) + (lane & 7) + 8 * (lane >> 4)) * LD + 16 * kk +
                              8 * ((lane >> 3) & 1));
          mma_bf16_16816(s[2 * jp], qa[kk], kb[0], kb[1]);
          mma_bf16_16816(s[2 * jp + 1], qa[kk], kb[2], kb[3]);
        }
      }
      // + bias[h] (+ mask), both staged; this half's row maxima
      const int off = (16 * slab + g) * LB + 16 * p0 + 2 * t4;
      const float* bs = bias_of(h & 1) + off;
#pragma unroll
      for (int j = 0; j < 2 * kWinPairs; ++j) {
        if (j >= 2 * np) continue;
        const float2 b0 = *reinterpret_cast<const float2*>(bs + 8 * j);
        const float2 b1 = *reinterpret_cast<const float2*>(bs + 8 * LB + 8 * j);
        s[j][0] += b0.x;
        s[j][1] += b0.y;
        s[j][2] += b1.x;
        s[j][3] += b1.y;
        if (ms) {
          const float2 m0 = *reinterpret_cast<const float2*>(ms + off + 8 * j);
          const float2 m1 = *reinterpret_cast<const float2*>(ms + off + 8 * LB + 8 * j);
          s[j][0] += m0.x;
          s[j][1] += m0.y;
          s[j][2] += m1.x;
          s[j][3] += m1.y;
        }
        mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
        mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
      }
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o));
      }
      if (t4 == 0) {
        red_max[half * 16 + g] = mx0;
        red_max[half * 16 + g + 8] = mx1;
      }
    }
    __syncthreads();  // both halves' maxima
    float sum0 = 0.f, sum1 = 0.f;
    if (rows_ok) {
      mx0 = fmaxf(red_max[g], red_max[16 + g]);
      mx1 = fmaxf(red_max[g + 8], red_max[16 + g + 8]);
#pragma unroll
      for (int j = 0; j < 2 * kWinPairs; ++j) {
        if (j >= 2 * np) continue;
        s[j][0] = expf(s[j][0] - mx0);
        s[j][1] = expf(s[j][1] - mx0);
        s[j][2] = expf(s[j][2] - mx1);
        s[j][3] = expf(s[j][3] - mx1);
        sum0 += s[j][0] + s[j][1];
        sum1 += s[j][2] + s[j][3];
      }
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1) {
        sum0 += __shfl_xor_sync(0xffffffffu, sum0, o);
        sum1 += __shfl_xor_sync(0xffffffffu, sum1, o);
      }
      if (t4 == 0) {
        red_sum[half * 16 + g] = sum0;
        red_sum[half * 16 + g + 8] = sum1;
      }
    }
    __syncthreads();  // both halves' sums
    float o[HD / 8][4];
    if (rows_ok) {
      // p = e (1 / sum), the sum of the whole row (half 0's part first)
      const float inv0 = 1.f / (red_sum[g] + red_sum[16 + g]);
      const float inv1 = 1.f / (red_sum[g + 8] + red_sum[16 + g + 8]);
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
      // o = bf16(p) v over this half's keys: score tiles 2 jp, 2 jp + 1 are
      // the A fragment of keys 16 (p0 + jp) + [0, 16)
#pragma unroll
      for (int jp = 0; jp < kWinPairs; ++jp) {
        if (jp >= np) continue;
        const unsigned pa[4] = {pack_bf16(s[2 * jp][0] * inv0, s[2 * jp][1] * inv0),
                                pack_bf16(s[2 * jp][2] * inv1, s[2 * jp][3] * inv1),
                                pack_bf16(s[2 * jp + 1][0] * inv0, s[2 * jp + 1][1] * inv0),
                                pack_bf16(s[2 * jp + 1][2] * inv1, s[2 * jp + 1][3] * inv1)};
#pragma unroll
        for (int nq = 0; nq < HD / 16; ++nq) {
          unsigned vb[4];
          ldmatrix_x4_trans(vb, vs + (16 * (p0 + jp) + (lane & 7) + 8 * ((lane >> 3) & 1)) * LD +
                                    16 * nq + 8 * (lane >> 4));
          mma_bf16_16816(o[2 * nq], pa, vb[0], vb[1]);
          mma_bf16_16816(o[2 * nq + 1], pa, vb[2], vb[3]);
        }
      }
      if (half) {
        float* po = ob + (slab * 16 + g) * LD + 2 * t4;
#pragma unroll
        for (int n = 0; n < HD / 8; ++n) {
          *reinterpret_cast<float2*>(po + 8 * n) = make_float2(o[n][0], o[n][1]);
          *reinterpret_cast<float2*>(po + 8 * LD + 8 * n) = make_float2(o[n][2], o[n][3]);
        }
      }
    }
    __syncthreads();  // half 1's partials; head h's buffer is free for head h + 2
    if (rows_ok && !half) {
      const float* po = ob + (slab * 16 + g) * LD + 2 * t4;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        const float2 a = *reinterpret_cast<const float2*>(po + 8 * n);
        const float2 c = *reinterpret_cast<const float2*>(po + 8 * LD + 8 * n);
        const int col = h * HD + 8 * n + 2 * t4, row = 16 * slab + g;
        *reinterpret_cast<__nv_bfloat162*>(os + sw128_offset(row, col, kWinRows)) =
            __floats2bfloat162_rn(o[n][0] + a.x, o[n][1] + a.y);
        *reinterpret_cast<__nv_bfloat162*>(os + sw128_offset(row + 8, col, kWinRows)) =
            __floats2bfloat162_rn(o[n][2] + c.x, o[n][3] + c.y);
      }
    }
  }
  // zero os past Cq (the last K block's padding), then os is wgmma's A
  for (int i = tid; i < kWinRows * (nkb * 64 - Cq); i += 256) {
    const int r = i % kWinRows, c = Cq + i / kWinRows;
    os[sw128_offset(r, c, kWinRows)] = __float2bfloat16_rn(0.f);
  }
  fence_proxy_async();  // os's writes (and the staging's reads) before wgmma and TMA
  __syncthreads();
  if (!early && tid == 0)
    for (int t = 0; t < min(T, kWinRing); ++t) issue(t);

  // out = os wp^T + bp: warpgroup wg takes columns [64 wg, 64 wg + 64) of
  // each 128-column chunk, a k-slab of 64 a ring slot
  float acc[32];
  const int wrow = 16 * (warp & 3) + g, wcol = 2 * t4;
  for (int t = 0; t < T; ++t) {
    const int ch = t / nkb, kb = t % nkb, slot = t % kWinRing;
    mbar_wait(full + slot, (t / kWinRing) & 1);
    const bf16* tile = ring + (size_t)slot * 2 * kBox + wg * kBox;
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < 4; ++s)
      wgmma_m64n64k16(acc, wgmma_desc_sw128(os + (size_t)kb * kWinRows * 64 + 16 * s),
                      wgmma_desc_sw128(tile + 16 * s), kb > 0 || s > 0);
    wgmma_commit();
    wgmma_wait<0>();
    __syncthreads();  // the slot's reads are done in both warpgroups
    if (tid == 0 && t + kWinRing < T) issue(t + kWinRing);
    if (kb != nkb - 1) continue;
    fence_regs(acc);
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int p = wrow + 8 * ((i >> 1) & 1), col = 128 * ch + 64 * wg + 8 * (i >> 2) + wcol;
      if (p >= nrow || col >= Cq) continue;
      *reinterpret_cast<__nv_bfloat162*>(out + (long)tok_row[r0 + p] * Cq + col) =
          __floats2bfloat162_rn(acc[i] + bp[col], acc[i + 1] + bp[col + 1]);
    }
  }
}

#define TRAMBA_HD_DISPATCH(hd, ...)                                  \
  switch (hd) {                                                     \
    case 16: { constexpr int kHD = 16; __VA_ARGS__; } break;        \
    case 32: { constexpr int kHD = 32; __VA_ARGS__; } break;        \
    case 48: { constexpr int kHD = 48; __VA_ARGS__; } break;        \
    case 64: { constexpr int kHD = 64; __VA_ARGS__; } break;        \
    default: return (int)cudaErrorInvalidValue;                     \
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
// bf16; bp (C) fp32; out (B, N, C) bf16.  C, hd, Lk multiples of 16; the keys
// from Lk_valid on are padding and take no part (-inf scores).
int sra_attn_launch(const bf16* q, const bf16* k, const bf16* v, const bf16* wp,
                    const float* bp, bf16* out, int B, int N, int C, int nh, int Lk,
                    int Lk_valid, void* stream) {
  if (Lk_valid < 1 || Lk_valid > Lk) return (int)cudaErrorInvalidValue;
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
  a.Lkv = Lk_valid;
  return launch_attn(a, B, static_cast<cudaStream_t>(stream));
}

// The plan of a K13 call: plan[0..6] = the front's row tiles, hidden groups,
// chunks a group, ring stages and shared bytes (plan_front); the attention
// launch's blocks a window and shared bytes.
int window_attn_plan(int B, int H, int W, int C, int Cq, int nh, int w, int* plan) {
  FrontPlan fp;
  if (B < 1 || w < 1 || nh < 1 || Cq % nh || !plan_front((long)B * H * W, C, 3 * Cq, false, &fp))
    return (int)cudaErrorInvalidValue;
  const int N = w * w;
  const WinLayout L = win_layout(Cq, Cq / nh, N);
  const int v[7] = {(int)fp.rows, fp.groups, fp.cps, fp.stages, (int)fp.smem,
                    (N + kWinRows - 1) / kWinRows, (int)L.total};
  std::copy(v, v + 7, plan);
  return 0;
}

// K13: two launches.  (i) ln_fc_kernel<kFrontQKV> (common.cuh): qkv (B*H*W,
// 3Cq) bf16 = bf16((LN(x) wqkv^T + bqkv) s), s = scale on q; (ii)
// window_attn_kernel.  x (B, H, W, C) bf16; ln_w, ln_b (C) fp32 (LayerNorm
// with eps); wqkv (3Cq, C) bf16 and bqkv (3Cq) fp32, each head's rows padded
// to Cq / nh; bias (nh, w*w, w*w) fp32; mask (nW, w*w, w*w) fp32 or null; wp
// (Cq, Cq) bf16; bp (Cq) fp32; scratch qkv; out (B, H, W, Cq) bf16.  H, W
// multiples of w; w*w a multiple of 16 up to 144; Cq / nh 16, 32, 48 or 64; C a
// multiple of 8.
int window_attn_launch(const bf16* x, const float* ln_w, const float* ln_b, const bf16* wqkv,
                       const float* bqkv, const float* bias, const float* mask, const bf16* wp,
                       const float* bp, bf16* qkv, bf16* out, int B, int H, int W, int C, int Cq,
                       int nh, int w, float scale, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int N = w * w;
  if (B < 1 || w < 1 || H % w || W % w || N % 16 || N > kWinKeys || nh < 1 || Cq % nh ||
      Cq % 16 || C > Cq)
    return (int)cudaErrorInvalidValue;
  const long M = (long)B * H * W;
  FrontPlan fp;
  CUtensorMap map_wqkv, map_wp;
  if (!plan_front(M, C, 3 * Cq, false, &fp) || !weight_map(&map_wqkv, wqkv, 3 * Cq, C) ||
      !weight_map(&map_wp, wp, Cq, Cq))
    return (int)cudaErrorInvalidValue;
  const int hd = Cq / nh;
  const WinLayout L = win_layout(Cq, hd, N);
  if (L.total > kSmemMax) return (int)cudaErrorInvalidValue;
  int rc = front_launch<kFrontQKV>(fp, map_wqkv, map_wqkv, map_wqkv, x, ln_w, ln_b, bqkv, nullptr,
                                   nullptr, nullptr, nullptr, nullptr, nullptr, M, C, 3 * Cq,
                                   MergedTaps{}, s, QkvOut{qkv, Cq, scale}, eps);
  if (rc) return rc;
  const dim3 grid((N + kWinRows - 1) / kWinRows, (unsigned)(B * (H / w) * (W / w)));
  TRAMBA_HD_DISPATCH(hd, {
    auto kern = window_attn_kernel<kHD>;
    cudaError_t e = allow_smem(kern, L.total);
    if (e != cudaSuccess) return (int)e;
    kern<<<grid, 256, L.total, s>>>(map_wp, qkv, bias, mask, bp, out, H, W, w, Cq, nh);
  });
  TRAMBA_CHECK_LAUNCH();
  return 0;
}

}  // extern "C"
