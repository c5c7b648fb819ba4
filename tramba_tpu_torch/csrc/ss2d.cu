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
// _freq_merge_pallas (:1732), _merge_pallas (:426), _lgp_pallas
// (fused_ss2d_small.py:303), the merge half of _small_pallas (:233) and the
// XLA _ln_gelu_proj (:478): gather the direction outputs back to pixels
// through the multi-slot inverse table, LayerNorm, exact GELU, out
// projection.
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
// written once (bound: chip_smoke.py's `bound`).  K1's projection is a
// small SIMT product ("row blocks", common.cuh).
//
// K2 reads the fp32 ys once (K D 4 bytes a pixel) and does 2 D dm product
// operations a pixel: dm / (2 K) operations a byte, at most 128 on the main
// path, under the card's bf16 ridge of ~295, so in bf16 it is bound by the
// bytes and its product only has to hide under the gather; in fp32 (67
// TFLOP/s without the tensor cores) the 24, 12 and 48 px calls are bound by
// the operations.  So the gather keeps many 16-byte loads in flight per
// lane and sums in registers, the LayerNorm'd, GELU'd rows stay in shared
// memory (the wide pre-projection tensor never reaches device memory), and
// the product runs from staged tiles: on the tensor cores in bf16, as
// register micro-tiles in fp32 (the kernel's own note, below).
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
    ++native_launch_count();
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  auto kern = carries ? ss2d_seg_kernel<RMAX, T, 2> : ss2d_seg_kernel<RMAX, T, 1>;
  cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return e;
  kern<<<dim3(S * nblk, K, B), nc, smem, s>>>(x, idx, dbc, wdt, dt_bias, A_logs, Ds, summ, ys,
                                             carries, B, L, D, K, R, S, per);
  ++native_launch_count();
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

// ---- K2 ---------------------------------------------------------------------
//
// Per pixel l of batch b: y = sum over k, m of ys[b, k, inv[k, m, l]] (slot
// value L means none), then LayerNorm (eps 1e-5), exact GELU, rounding to TW,
// and out[b, l, :] = y @ w_out^T with w_out (dm, D) of TW; out is TW.
// Train variant (kYsum, #10's emit_ysum; a separate instantiation, as K1's):
// also writes the pre-LN sum y (B, L, D) in TW (rounded to bf16 in bf16; the
// LayerNorm still reads the fp32 sum), over which the backward
// differentiates the LayerNorm, GELU and out projection.
//
// A block owns BM pixels of one image and `cpb` tiles of kMergeBN output
// columns (grid x = row tile * column groups + column group, so where a row
// tile's columns are split over blocks those run side by side and their
// repeated gathers come from L2).
//   1. w_out's first k-slabs start streaming into the stage ring (cp.async).
//   2. Gather, one warp per pixel: lane j holds the table entry of direction
//      j / (32 / K), slot m0 + j % (32 / K); a ballot lists the valid ones,
//      and the warp walks the list G at a time, each lane issuing the
//      16-byte loads of its channels 4 (lane + 32 i) of every listed ys row
//      before adding any: the sum stays in registers (NV float4 a lane, D <=
//      128 NV).  A line table has up to 48 slots (98 KB of entries for a
//      64-pixel tile), so the entries are read slot group by slot group and
//      the walk stops at the first group whose last slot is empty for every
//      direction (a pixel's positions fill its first slots).
//   3. LayerNorm statistics by warp reduction from the registers (two
//      passes), exact GELU, rounding to TW, written to the A tile in shared
//      memory (row stride padded by 16 bytes; columns past D zeroed).
//   4. For each of its column tiles, the product over k-slabs of 128 bytes
//      (the ring runs on from one tile to the next): bf16 on the tensor
//      cores (mma.sync m16n8k16, ldmatrix; warp tile 16 x BM), fp32 as 4 x 4
//      micro-tiles of SIMT FMAs (rows tm + TM i, columns tn + 32 j) in k
//      order, as rows_dot summed.
// The launch takes BM and cpb from the grid it would make (merge_launch):
// large maps take the large tile and all columns per block, so ys is
// gathered once and each w_out slab serves 32-64 pixels; small ones split
// the columns and take 16-pixel tiles until the card has a wave of blocks.
template <typename TW>
struct MergeSlab {
  static constexpr bool kBf16 = sizeof(TW) == 2;
  static constexpr int KC = 128 / (int)sizeof(TW);        // k per stage: 128 bytes a row
  static constexpr int LDB = KC + 16 / (int)sizeof(TW);   // stage row stride
};
// the large row tile: the A tile (BM x D of TW) stays within 132 KB
template <typename TW, int NV>
constexpr int merge_big_rows() {
  return sizeof(TW) == 2 ? (NV <= 8 ? 64 : 32) : (NV <= 8 ? 32 : 16);
}
constexpr int kMergeSmallRows = 16;
constexpr int kMergeBN = 128;      // output columns per column tile
constexpr int kMergeStages = 3;    // w_out k-slabs in the ring
constexpr int kMergeThreads = 256;

template <typename TW>
__host__ __device__ __forceinline__ int merge_lda(int D) {
  using T = MergeSlab<TW>;
  return (D + T::KC - 1) / T::KC * T::KC + 16 / (int)sizeof(TW);
}

template <typename TW>
static size_t merge_smem(int BM, int D) {
  return ((size_t)BM * merge_lda<TW>(D) + (size_t)kMergeStages * kMergeBN * MergeSlab<TW>::LDB) *
         sizeof(TW);
}

// Copies k-slab [k0, k0 + KC) of w_out rows [n0, n0 + kMergeBN) into one
// stage (rows past dm and columns past D zero-filled).
template <typename TW>
__device__ __forceinline__ void merge_stage(TW* Bs, const TW* __restrict__ w_out, int n0, int k0,
                                            int dm, int D) {
  using T = MergeSlab<TW>;
  constexpr int V = 16 / (int)sizeof(TW);  // elements per 16-byte copy
  for (int i = threadIdx.x; i < kMergeBN * (T::KC / V); i += blockDim.x) {
    const int r = i / (T::KC / V), c = (i - r * (T::KC / V)) * V;
    const bool ok = n0 + r < dm && k0 + c < D;
    cp_async16(Bs + r * T::LDB + c, ok ? w_out + (long)(n0 + r) * D + k0 + c : w_out, ok);
  }
}

__device__ __forceinline__ void add4(float4& a, const float4& b) {
  a.x += b.x; a.y += b.y; a.z += b.z; a.w += b.w;
}

template <typename TW, int NV, int BM, bool kYsum>
__global__ void __launch_bounds__(kMergeThreads)
    ss2d_merge_kernel(const float* __restrict__ ys, const int* __restrict__ inv,
                      const float* __restrict__ ln_w, const float* __restrict__ ln_b,
                      const TW* __restrict__ w_out, TW* __restrict__ out, TW* __restrict__ y_sum,
                      int K, int Mslots, int L, int D, int dm, int ctiles, int cpb) {
  using T = MergeSlab<TW>;
  constexpr int KC = T::KC, LDB = T::LDB, G = NV <= 16 ? 16 / NV : 1;  // ys rows in flight
  extern __shared__ float4 smem4[];
  const int lda = merge_lda<TW>(D), nk = (lda - 16 / (int)sizeof(TW)) / KC;
  TW* As = reinterpret_cast<TW*>(smem4);  // [BM][lda]
  TW* Bs = As + BM * lda;                 // [kMergeStages][kMergeBN][LDB]
  const int groups = (ctiles + cpb - 1) / cpb, cg = blockIdx.x % groups;
  const int l0 = (blockIdx.x / groups) * BM, b = blockIdx.y;
  const int ct0 = cg * cpb, nq = min(ctiles - ct0, cpb) * nk;  // this block's slabs
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  auto stage = [&](int q) {  // slab q: k-slab q % nk of column tile ct0 + q / nk
    merge_stage<TW>(Bs + (q % kMergeStages) * kMergeBN * LDB, w_out, (ct0 + q / nk) * kMergeBN,
                    (q % nk) * KC, dm, D);
  };

  for (int q = 0; q < kMergeStages - 1; ++q) {
    if (q < nq) stage(q);
    cp_async_commit();
  }

  // ---- gather, LayerNorm, GELU: one warp per pixel ----
  const int MB = 32 / K;  // slots per direction in one pass
  const int kl = lane / MB, ml = lane - kl * MB;
  const float* ys_b = ys + (long)b * K * L * D;
  const int D4 = D >> 2;
  for (int p = warp; p < BM; p += kMergeThreads / 32) {
    const int l = l0 + p;
    TW* arow = As + p * lda;
    if (l >= L) {
      for (int c = lane; c < lda; c += 32) arow[c] = from_f32<TW>(0.f);
      continue;
    }
    float4 acc[NV];
#pragma unroll
    for (int j = 0; j < NV; ++j) acc[j] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int m0 = 0; m0 < Mslots; m0 += MB) {
      const int m = m0 + ml;
      const int t = m < Mslots ? __ldg(inv + ((long)kl * Mslots + m) * L + l) : L;
      const bool valid = t < L;
      const int e = valid ? kl * L + t : 0;  // ys row of the entry within image b
      unsigned mask = __ballot_sync(0xffffffffu, valid);
      const bool more = __ballot_sync(0xffffffffu, valid && ml == MB - 1) != 0u;
      while (mask) {
        int rows[G];
        bool ok[G];
#pragma unroll
        for (int g = 0; g < G; ++g) {
          ok[g] = mask != 0u;
          rows[g] = __shfl_sync(0xffffffffu, e, ok[g] ? __ffs(mask) - 1 : 0);
          mask &= mask - 1u;
        }
        float4 v[G][NV];
#pragma unroll
        for (int g = 0; g < G; ++g)
#pragma unroll
          for (int j = 0; j < NV; ++j) {
            const int c4 = lane + 32 * j;
            v[g][j] = ok[g] && c4 < D4
                          ? __ldg(reinterpret_cast<const float4*>(ys_b + (long)rows[g] * D) + c4)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
          }
#pragma unroll
        for (int g = 0; g < G; ++g)
#pragma unroll
          for (int j = 0; j < NV; ++j) add4(acc[j], v[g][j]);
      }
      if (!more) break;
    }
    if (kYsum && cg == 0) {
      TW* dst = y_sum + ((long)b * L + l) * D;
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const int c4 = lane + 32 * j;
        if (c4 >= D4) continue;
        if constexpr (T::kBf16) {
          __nv_bfloat162 h[2] = {__floats2bfloat162_rn(acc[j].x, acc[j].y),
                                 __floats2bfloat162_rn(acc[j].z, acc[j].w)};
          *reinterpret_cast<uint2*>(dst + 4 * c4) = *reinterpret_cast<const uint2*>(h);
        } else {
          *reinterpret_cast<float4*>(dst + 4 * c4) = acc[j];
        }
      }
    }
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j) s += (acc[j].x + acc[j].y) + (acc[j].z + acc[j].w);
    const float mean = warp_sum(s) / D;
    float q = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      if (lane + 32 * j >= D4) continue;
      const float a0 = acc[j].x - mean, a1 = acc[j].y - mean, a2 = acc[j].z - mean,
                  a3 = acc[j].w - mean;
      q = fmaf(a0, a0, q); q = fmaf(a1, a1, q); q = fmaf(a2, a2, q); q = fmaf(a3, a3, q);
    }
    const float rstd = rsqrtf(warp_sum(q) / D + 1e-5f);
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int c4 = lane + 32 * j;
      if (c4 >= D4) continue;
      const float4 w4 = __ldg(reinterpret_cast<const float4*>(ln_w) + c4);
      const float4 b4 = __ldg(reinterpret_cast<const float4*>(ln_b) + c4);
      const float g0 = gelu_exact((acc[j].x - mean) * rstd * w4.x + b4.x);
      const float g1 = gelu_exact((acc[j].y - mean) * rstd * w4.y + b4.y);
      const float g2 = gelu_exact((acc[j].z - mean) * rstd * w4.z + b4.z);
      const float g3 = gelu_exact((acc[j].w - mean) * rstd * w4.w + b4.w);
      if constexpr (T::kBf16) {
        __nv_bfloat162 h[2] = {__floats2bfloat162_rn(g0, g1), __floats2bfloat162_rn(g2, g3)};
        *reinterpret_cast<uint2*>(arow + 4 * c4) = *reinterpret_cast<const uint2*>(h);
      } else {
        *reinterpret_cast<float4*>(arow + 4 * c4) = make_float4(g0, g1, g2, g3);
      }
    }
    for (int c = D + lane; c < lda; c += 32) arow[c] = from_f32<TW>(0.f);
  }

  // ---- out projection: each column tile over the k-slabs of the ring ----
  TW* out_b = out + (long)b * L * dm;
  if constexpr (T::kBf16) {
    constexpr int WMr = BM / 16, WN = kMergeBN / (8 / WMr), NT8 = WN / 8;
    const int wm = warp % WMr, wn = warp / WMr;
    const int g = lane >> 2, q2 = (lane & 3) * 2;
    float acc[NT8][4];
    for (int q = 0; q < nq; ++q) {
      const int kc = q % nk;
      if (kc == 0) {
#pragma unroll
        for (int i = 0; i < NT8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
      }
      cp_async_wait<kMergeStages - 2>();
      __syncthreads();
      if (q + kMergeStages - 1 < nq) stage(q + kMergeStages - 1);
      cp_async_commit();
      const TW* Bsl = Bs + (q % kMergeStages) * kMergeBN * LDB;
#pragma unroll
      for (int ks = 0; ks < KC / 16; ++ks) {
        unsigned a[4];
        ldmatrix_x4(a, As + (wm * 16 + (lane & 15)) * lda + kc * KC + ks * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int np = 0; np < NT8 / 2; ++np) {
          unsigned bq[4];
          ldmatrix_x4(bq, Bsl + (wn * WN + np * 16 + (lane >> 4) * 8 + (lane & 7)) * LDB + ks * 16 +
                              ((lane >> 3) & 1) * 8);
          mma_bf16_16816(acc[2 * np], a, bq[0], bq[1]);
          mma_bf16_16816(acc[2 * np + 1], a, bq[2], bq[3]);
        }
      }
      if (kc != nk - 1) continue;
      const int n0 = (ct0 + q / nk) * kMergeBN;
#pragma unroll
      for (int i = 0; i < NT8; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = l0 + wm * 16 + g + 8 * h, col = n0 + wn * WN + i * 8 + q2;
          if (row >= L) continue;
          TW* o = out_b + (long)row * dm + col;
          if (col + 1 < dm && (dm & 1) == 0) {
            *reinterpret_cast<__nv_bfloat162*>(o) =
                __floats2bfloat162_rn(acc[i][2 * h], acc[i][2 * h + 1]);
          } else {
            if (col < dm) o[0] = from_f32<TW>(acc[i][2 * h]);
            if (col + 1 < dm) o[1] = from_f32<TW>(acc[i][2 * h + 1]);
          }
        }
    }
  } else {
    constexpr int TM = BM / 4;  // warps down the rows; 32 lanes across the columns
    const int tm = warp, tn = lane;
    float acc[4][4];
    for (int q = 0; q < nq; ++q) {
      const int kc = q % nk;
      if (kc == 0) {
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
      }
      cp_async_wait<kMergeStages - 2>();
      __syncthreads();
      if (q + kMergeStages - 1 < nq) stage(q + kMergeStages - 1);
      cp_async_commit();
      if (tm >= TM) continue;
      const float* Bsl = reinterpret_cast<const float*>(Bs) + (q % kMergeStages) * kMergeBN * LDB;
      const float* Ak = reinterpret_cast<const float*>(As) + kc * KC;
#pragma unroll 2
      for (int kk = 0; kk < KC; kk += 4) {
        float4 a[4], w[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          a[i] = *reinterpret_cast<const float4*>(Ak + (tm + TM * i) * lda + kk);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          w[j] = *reinterpret_cast<const float4*>(Bsl + (tn + 32 * j) * LDB + kk);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            acc[i][j] = fmaf(a[i].x, w[j].x, acc[i][j]);
            acc[i][j] = fmaf(a[i].y, w[j].y, acc[i][j]);
            acc[i][j] = fmaf(a[i].z, w[j].z, acc[i][j]);
            acc[i][j] = fmaf(a[i].w, w[j].w, acc[i][j]);
          }
      }
      if (kc != nk - 1) continue;
      const int n0 = (ct0 + q / nk) * kMergeBN;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = l0 + tm + TM * i;
        if (row >= L) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = n0 + tn + 32 * j;
          if (col < dm) out_b[(long)row * dm + col] = from_f32<TW>(acc[i][j]);
        }
      }
    }
  }
}

template <typename TW, int NV, int BM>
int merge_launch_tile(const float* ys, const int* inv, const float* ln_w, const float* ln_b,
                      const TW* w_out, TW* out, TW* y_sum, int B, int K, int Mslots, int L,
                      int D, int dm, int ctiles, int cpb, cudaStream_t s) {
  const size_t smem = merge_smem<TW>(BM, D);
  const dim3 grid((unsigned)((L + BM - 1) / BM * ((ctiles + cpb - 1) / cpb)), B);
  auto kern = y_sum ? ss2d_merge_kernel<TW, NV, BM, true> : ss2d_merge_kernel<TW, NV, BM, false>;
  cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<grid, kMergeThreads, smem, s>>>(ys, inv, ln_w, ln_b, w_out, out, y_sum, K, Mslots, L, D,
                                         dm, ctiles, cpb);
  TRAMBA_CHECK_LAUNCH();
  return 0;
}

// The row tile and the column tiles per block: the large tile with every
// column tile in one block where that makes a wave (132 blocks), else the
// fewest column tiles per block that make one, else 16-pixel tiles, the
// columns split the same way.
template <typename TW, int NV>
int merge_launch_nv(const float* ys, const int* inv, const float* ln_w, const float* ln_b,
                    const TW* w_out, TW* out, TW* y_sum, int B, int K, int Mslots, int L, int D,
                    int dm, cudaStream_t s) {
  constexpr int BIG = merge_big_rows<TW, NV>();
  const int ctiles = (dm + kMergeBN - 1) / kMergeBN;
  const long wave = 132;
  const long big = (long)B * ((L + BIG - 1) / BIG);
  const bool use_big = big * ctiles >= wave || BIG == kMergeSmallRows;
  const long rows = use_big ? big : (long)B * ((L + kMergeSmallRows - 1) / kMergeSmallRows);
  int cpb = ctiles;
  while (cpb > 1 && rows * ((ctiles + cpb - 1) / cpb) < wave) cpb = (cpb + 1) / 2;
  if (use_big)
    return merge_launch_tile<TW, NV, BIG>(ys, inv, ln_w, ln_b, w_out, out, y_sum, B, K, Mslots, L,
                                          D, dm, ctiles, cpb, s);
  return merge_launch_tile<TW, NV, kMergeSmallRows>(ys, inv, ln_w, ln_b, w_out, out, y_sum, B, K,
                                                    Mslots, L, D, dm, ctiles, cpb, s);
}

template <typename TW>
int merge_launch(const float* ys, const int* inv, const float* ln_w, const float* ln_b,
                 const TW* w_out, TW* out, TW* y_sum, int B, int K, int Mslots, int L, int D,
                 int dm, cudaStream_t s) {
  if (K < 1 || K > 32 || 32 % K || D % (16 / (int)sizeof(TW)) || D > 2048 || dm < 1)
    return (int)cudaErrorInvalidValue;
#define TRAMBA_MERGE(NV) \
  merge_launch_nv<TW, NV>(ys, inv, ln_w, ln_b, w_out, out, y_sum, B, K, Mslots, L, D, dm, s)
  if (D <= 128) return TRAMBA_MERGE(1);
  if (D <= 256) return TRAMBA_MERGE(2);
  if (D <= 512) return TRAMBA_MERGE(4);
  if (D <= 1024) return TRAMBA_MERGE(8);
  return TRAMBA_MERGE(16);
#undef TRAMBA_MERGE
}

}  // namespace

extern "C" {

const char* tramba_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// Kernels the library has launched since it was loaded (native_launch_count).
long tramba_native_launches() { return native_launch_count(); }

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
// all bf16 (bf16 = 1); y_sum null for inference.  K divides 32; D % 4 == 0
// (fp32) or D % 8 == 0 (bf16), D <= 2048.
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
