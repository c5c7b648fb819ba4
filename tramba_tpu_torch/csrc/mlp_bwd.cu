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
//  front  ln_fc_kernel<kFrontK9> (common.cuh), one block per (64-row tile,
//         hidden group): LN into a swizzled tile, h = xf w1^T and
//         g w2[:, chunk] on wgmma (k = d) from TMA-fed tiles, then in
//         registers hg = bf16(GELU(h + b1)) and dh = (g w2) GELU'(h + b1),
//         written bf16 with the tile's db1 column sums; xf for dW1.
// K10 (six): the same front as ln_fc_kernel<kFrontK10>, which writes h and
//         g w2 once each as fp32 maps and the merged 7x7 taps
//         t = k7 + pad(k5) + pad(k3) + identity (bias c3 + c5 + c7), then
//  (b1)   mlp_bwd_dwms_acc_kernel: acc = the merged stencil of h on a 4-D
//         TMA halo box, dacc = (g w2) GELU'(acc) written over g w2 in
//         place, hg = bf16(GELU(acc));
//  (b2)   mlp_bwd_dwms_adj_kernel: on TMA halo boxes of dacc and h,
//         dh = corr(flip(t), dacc) (the identity included) written bf16
//         with per-block db1 partials, and the tap-gradient partials at the
//         49 offsets sum dacc(p) h(p + o), one correlation for the three tap
//         sets (dk5 and dk3 are its central 5x5 and 3x3), and sum dacc.
// Both then run the same tail:
//  (c) mlp_bwd_dx_kernel: dxf = bf16(dh) w1 on wgmma in 64-row tiles, split
//      over column groups of d (a thread block cluster) where the row tiles
//      alone give less than a wave; the LN adjoint, whose row sums cross the
//      groups through distributed shared memory; per-tile partial sums of
//      dLN and db2;
//  (d) mlp_bwd_wgrad_kernel: dW2 and dW1 in one launch, 128 x 128 output
//      tiles over segments of rows (mma.sync from a cp.async ring);
//  (e) mlp_bwd_sum_kernel: every partial buffer added up in a fixed order in
//      one launch (K10's tap partials too): no float atomics, so every
//      result is the same from run to run.
// What bounds them on an H100: the five products, 10 M d hid operations
// (dh, hg and the weights' tiles cross L2, about 64 operations a byte per
// 64-row tile), above the bytes of x, g, dx and the weights.  K10 adds
// 3 x 49 fp32 FMAs a hidden value (the forward stencil, dh, the tap
// gradients; ~0.044 ms of the card's fp32 rate at 96 px d128 B2, as much as
// its products) and its fp32 h and dacc maps (16 hid bytes a pixel written,
// read back through halos of 196 of every 64 pixels, mostly from L2).  Its
// design against that: each stencil runs once on a TMA halo in shared memory
// (zeros outside the image: the SAME padding), a thread owns one channel
// and two output rows and slides a 7-wide window along the 8 halo rows it
// reads (one shared-memory load feeds up to 14 FMAs, the taps and the
// partial sums in registers), and the adjoint launch walks several tiles a
// block so that its tap partials stay few.
#include <cooperative_groups.h>

#include "common.cuh"

namespace {

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

// ---- (b), K10 ---------------------------------------------------------------
//
// Both stencil launches run blocks of 256 threads on 8 x 8 output tiles and
// chunks of 64 hidden channels: thread t owns channel t % 64 of the chunk
// and output rows 2 (t / 64) and + 1 of the tile, whose 14 x 14 halo (3 px
// a side) arrives as one 4-D TMA box of 64 channels (50 KB of fp32).
constexpr int kT = 8;                  // output tile kT x kT pixels
constexpr int kE7 = kT + 6;            // halo side: 14
constexpr int kHalo = kE7 * kE7 * 64;  // fp32 elements of one chunk's halo box
constexpr int kTapRows = 50;           // the 49 tap offsets, then the bias / dc row

// Copies one chunk's merged taps and bias ([50][64] fp32, MergedTaps) into
// shared memory by cp.async, every thread taking part.
__device__ __forceinline__ void stage_taps(const float* __restrict__ mtaps, int q, float* ts) {
  const float* src = mtaps + (long)q * kTapChunk;
  for (int e = threadIdx.x; e < kTapChunk / 4; e += blockDim.x)
    cp_async16(ts + 4 * e, src + 4 * e, true);
  cp_async_commit();
}

// s0[px] (output row 2 rp) and s1[px] (row 2 rp + 1) += the 7x7 stencil of
// channel cl of a halo box, the taps read through tap(i) for offset
// i = 7 di + dj (di, dj in [0, 7): the halo pixel (row + di, col + dj)).
template <typename Tap>
__device__ __forceinline__ void stencil_rows(const float* hb, int rp, const Tap& tap,
                                             float (&s0)[kT], float (&s1)[kT]) {
#pragma unroll
  for (int r = 0; r < 8; ++r) {  // halo row 2 rp + r feeds output rows 2 rp and 2 rp + 1
    const float* row = hb + (2 * rp + r) * kE7 * 64;
    float v[kE7];
#pragma unroll
    for (int xx = 0; xx < kE7; ++xx) v[xx] = row[xx * 64];
#pragma unroll
    for (int kx = 0; kx < 7; ++kx) {
      if (r < 7) {
        const float t = tap(r * 7 + kx);
#pragma unroll
        for (int px = 0; px < kT; ++px) s0[px] = fmaf(t, v[px + kx], s0[px]);
      }
      if (r > 0) {
        const float t = tap((r - 1) * 7 + kx);
#pragma unroll
        for (int px = 0; px < kT; ++px) s1[px] = fmaf(t, v[px + kx], s1[px]);
      }
    }
  }
}

// (b1) One block per (8x8 tile, image, chunk): acc = bias + the merged
// stencil of h; in place dacc := gw GELU'(acc) (gw = g w2 from the front),
// and hg = bf16(GELU(acc)).
__global__ void __launch_bounds__(256, 2)
    mlp_bwd_dwms_acc_kernel(const __grid_constant__ CUtensorMap map_h,
                            const float* __restrict__ mtaps, float* __restrict__ dacc,
                            bf16* __restrict__ hg, int H, int W, int hid) {
  extern __shared__ float4 smem4[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem4);
  float* halo = reinterpret_cast<float*>(tiles_start(smem4, 64));  // [14][14][64]
  float* ts = halo + kHalo;                                         // [50][64]
  const int tid = threadIdx.x, cl = tid & 63, rp = tid >> 6;
  const int tiles_x = (W + kT - 1) / kT;
  const int ty0 = (blockIdx.x / tiles_x) * kT, tx0 = (blockIdx.x % tiles_x) * kT;
  const int b = blockIdx.y, q = blockIdx.z;
  if (tid == 0) {
    mbar_init(bar, 1);
    mbar_init_fence();
    mbar_expect_tx(bar, kHalo * 4);
    tma_load_4d(halo, &map_h, 64 * q, tx0 - 3, ty0 - 3, b, bar);
  }
  stage_taps(mtaps, q, ts);
  cp_async_wait<0>();
  __syncthreads();  // the taps, and the barrier's initialisation
  float tap[49], a0[kT], a1[kT];
  const float bias = ts[49 * 64 + cl];
#pragma unroll
  for (int i = 0; i < 49; ++i) tap[i] = ts[i * 64 + cl];
#pragma unroll
  for (int px = 0; px < kT; ++px) a0[px] = a1[px] = bias;
  mbar_wait(bar, 0);
  stencil_rows(halo + cl, rp, [&](int i) { return tap[i]; }, a0, a1);
  const int c = 64 * q + cl;
  if (c >= hid) return;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int gy = ty0 + 2 * rp + e;
    if (gy >= H) continue;
#pragma unroll
    for (int px = 0; px < kT; ++px) {
      const int gx = tx0 + px;
      if (gx >= W) continue;
      const long o = (((long)b * H + gy) * W + gx) * hid + c;
      float gv, gp;
      gelu_and_grad(e ? a1[px] : a0[px], &gv, &gp);
      dacc[o] *= gp;
      hg[o] = __float2bfloat16_rn(gv);
    }
  }
}

// (b2) One block per (run of `tpb` consecutive tiles of the flattened
// (image, tile) index, chunk).  Per tile, the halo boxes of dacc and h
// arrive by TMA on one mbarrier (zeros outside the image); then
//   dh = sum_o t[o] dacc(p - o), the taps flipped (tap 48 - i), the
//   identity in the centre tap: written bf16, its unrounded sum kept for
//   db1;
//   g[o] += sum_p dacc(p) h(p + o) at the 49 offsets o, and sum_p dacc(p),
//   over the tile's 64 pixels (dacc of pixels outside the image is 0).
// At the end the four row pairs' sums of each channel are added in order in
// shared memory (the halo buffers) and written as the block's partials:
// part_tap[block, 0..48 | 49, c], part_db1[block, c].
__global__ void __launch_bounds__(256, 2)
    mlp_bwd_dwms_adj_kernel(const __grid_constant__ CUtensorMap map_dacc,
                            const __grid_constant__ CUtensorMap map_h,
                            const float* __restrict__ mtaps, bf16* __restrict__ dh,
                            float* __restrict__ part_db1, float* __restrict__ part_tap, int B,
                            int H, int W, int hid, int tpb) {
  extern __shared__ float4 smem4[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem4);
  float* hd = reinterpret_cast<float*>(tiles_start(smem4, 64));  // [14][14][64] of dacc
  float* hh = hd + kHalo;                                         // [14][14][64] of h
  float* ts = hh + kHalo;                                         // [50][64]
  const int tid = threadIdx.x, cl = tid & 63, rp = tid >> 6, q = blockIdx.y;
  const int tiles_x = (W + kT - 1) / kT, ntiles = tiles_x * ((H + kT - 1) / kT);
  const int t_first = blockIdx.x * tpb, n = min(B * ntiles, t_first + tpb) - t_first;
  if (tid == 0) {
    mbar_init(bar, 1);
    mbar_init_fence();
  }
  stage_taps(mtaps, q, ts);
  cp_async_wait<0>();
  __syncthreads();
  // dh's taps are read from shared memory (one load feeds 8 FMAs), leaving
  // the registers to the 50 partial sums
  const float* tq = ts + cl;
  float g[kTapRows], sdh = 0.f;
#pragma unroll
  for (int i = 0; i < kTapRows; ++i) g[i] = 0.f;
  const int c = 64 * q + cl;
  for (int k = 0; k < n; ++k) {
    const int tt = t_first + k, b = tt / ntiles, tile = tt - b * ntiles;
    const int ty0 = (tile / tiles_x) * kT, tx0 = (tile % tiles_x) * kT;
    if (tid == 0) {  // the previous tile's reads ended before the last barrier
      mbar_expect_tx(bar, 2 * kHalo * 4);
      tma_load_4d(hd, &map_dacc, 64 * q, tx0 - 3, ty0 - 3, b, bar);
      tma_load_4d(hh, &map_h, 64 * q, tx0 - 3, ty0 - 3, b, bar);
    }
    mbar_wait(bar, k & 1);
    {
      float a0[kT], a1[kT];
#pragma unroll
      for (int px = 0; px < kT; ++px) a0[px] = a1[px] = 0.f;
      stencil_rows(hd + cl, rp, [&](int i) { return tq[(48 - i) * 64]; }, a0, a1);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int gy = ty0 + 2 * rp + e;
#pragma unroll
        for (int px = 0; px < kT; ++px) {
          const int gx = tx0 + px;
          if (gy >= H || gx >= W || c >= hid) continue;
          const float v = e ? a1[px] : a0[px];
          dh[(((long)b * H + gy) * W + gx) * hid + c] = __float2bfloat16_rn(v);
          sdh += v;
        }
      }
    }
    {
      // this thread's dacc: the halo's centre rows 2 rp + 3 and + 4
      float d0[kT], d1[kT];
#pragma unroll
      for (int px = 0; px < kT; ++px) {
        d0[px] = hd[((2 * rp + 3) * kE7 + px + 3) * 64 + cl];
        d1[px] = hd[((2 * rp + 4) * kE7 + px + 3) * 64 + cl];
        g[49] += d0[px];
        g[49] += d1[px];
      }
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const float* row = hh + (2 * rp + r) * kE7 * 64 + cl;
        float v[kE7];
#pragma unroll
        for (int xx = 0; xx < kE7; ++xx) v[xx] = row[xx * 64];
#pragma unroll
        for (int kx = 0; kx < 7; ++kx) {
          if (r < 7) {
#pragma unroll
            for (int px = 0; px < kT; ++px) g[r * 7 + kx] = fmaf(d0[px], v[px + kx], g[r * 7 + kx]);
          }
          if (r > 0) {
#pragma unroll
            for (int px = 0; px < kT; ++px)
              g[(r - 1) * 7 + kx] = fmaf(d1[px], v[px + kx], g[(r - 1) * 7 + kx]);
          }
        }
      }
    }
    __syncthreads();  // every read of this tile's halos is done
  }
  // the four row pairs' sums in order: red [4][51][64] over the halo buffers
  float* red = hd;
#pragma unroll
  for (int i = 0; i < kTapRows; ++i) red[(rp * (kTapRows + 1) + i) * 64 + cl] = g[i];
  red[(rp * (kTapRows + 1) + kTapRows) * 64 + cl] = sdh;
  __syncthreads();
  for (int i = tid; i < (kTapRows + 1) * 64; i += 256) {
    const int o = i / 64, ch = 64 * q + i % 64;
    const float v = ((red[i] + red[(kTapRows + 1) * 64 + i]) + red[2 * (kTapRows + 1) * 64 + i]) +
                    red[3 * (kTapRows + 1) * 64 + i];
    if (ch >= hid) continue;
    if (o < kTapRows) {
      part_tap[((long)blockIdx.x * kTapRows + o) * hid + ch] = v;
    } else {
      part_db1[(long)blockIdx.x * hid + ch] = v;
    }
  }
}

constexpr size_t kAccSmem = 1024 + (size_t)(kHalo + kTapChunk) * 4;
constexpr size_t kAdjSmem = 1024 + (size_t)(2 * kHalo + kTapChunk) * 4;
static_assert(4 * (kTapRows + 1) * 64 <= 2 * kHalo, "the adjoint's reduction fits its halos");

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
// so every result is the same from run to run).  K10 adds one more job
// (blockIdx.y == kSumJobs): its tap partials [block][50][hid], the sum at
// offset o < 49 going to dk7 and, in the central 5x5 / 3x3 offsets, to dk5
// / dk3 (the same sum: dk5[i, j] = dk7[i + 1, j + 1]), row 49 to dc3 = dc5 =
// dc7.
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
struct TapJob {
  const float* part;
  int n, hid;
  float *dk3, *dk5, *dk7, *dc3, *dc5, *dc7;
};

__global__ void mlp_bwd_sum_kernel(SumJobs jobs, TapJob taps) {
  const bool tap_job = blockIdx.y == kSumJobs;
  const SumJob jb = tap_job ? SumJob{taps.part, nullptr, (long)kTapRows * taps.hid, taps.n}
                            : jobs.job[blockIdx.y];
  for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x; i < jb.N;
       i += (long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < jb.n; ++k) s += jb.part[(long)k * jb.N + i];
    if (!tap_job) {
      jb.out[i] = s;
      continue;
    }
    const int o = (int)(i / taps.hid), c = (int)(i % taps.hid);
    if (o == 49) {
      taps.dc3[c] = s;
      taps.dc5[c] = s;
      taps.dc7[c] = s;
      continue;
    }
    const int u = o / 7, v = o % 7;
    taps.dk7[(long)c * 49 + o] = s;
    if (u >= 1 && u <= 5 && v >= 1 && v <= 5) taps.dk5[(long)c * 25 + (u - 1) * 5 + v - 1] = s;
    if (u >= 2 && u <= 4 && v >= 2 && v <= 4) taps.dk3[(long)c * 9 + (u - 2) * 3 + v - 2] = s;
  }
}

// ---- plan -------------------------------------------------------------------

// Tiling and scratch of one call.  dwms: K10 over a (B, H, W) map, else K9
// over M = B rows (H = W = 1).
struct Plan {
  long M, R;  // rows, 64-row tiles
  int d, hid;
  FrontPlan front;
  int tiles, chunks;      // K10's (b): 8x8 tiles of an image, 64-channel chunks
  int tpb, adj_blocks;    // (b2): tiles a block walks, blocks along the tiles
  long db1_parts;         // db1 partials: the front's row tiles (K9) or (b2)'s blocks
  int G, NW, NT, stages_c;  // (c): column groups (cluster size), warpgroups, tiles, ring slots
  size_t smem_c;
  int S;     // (d): row segments
  long seg;  // rows per segment
  size_t off[10], total;  // scratch: xf h gw hg dh pdb1 pln pw2 pw1 ptap (+ the merged taps)
};

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
  if (!plan_dx(p) || !plan_front(M, d, hid, true, &p->front)) return false;
  p->chunks = (hid + 63) / 64;
  if (dwms) {
    p->tiles = ((H + kT - 1) / kT) * ((W + kT - 1) / kT);
    // (b2): about two waves of two blocks an SM, each walking tpb tiles
    const long all = (long)B * p->tiles;
    p->tpb = (int)std::max(1L, all * p->chunks / (2L * 2 * 132));
    p->adj_blocks = (int)((all + p->tpb - 1) / p->tpb);
    p->db1_parts = p->adj_blocks;
  } else {
    p->tiles = p->tpb = p->adj_blocks = 0;
    p->db1_parts = p->R;
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
                            (size_t)p->db1_parts * hid * 4,
                            (size_t)3 * p->R * d * 4,
                            (size_t)p->S * d * hid * 4,
                            (size_t)p->S * hid * d * 4,
                            dwms ? ((size_t)p->adj_blocks * kTapRows * hid +
                                    (size_t)p->chunks * kTapChunk) * 4
                                 : 0};
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

// (c) - (e), which both adjoints share, after xf, hg, bf16(dh) and the db1
// partials are in the scratch.
int run_tail(const Plan& p, void* scratch, const bf16* x, const bf16* g, const float* ln_w,
             const bf16* w1, bf16* dx, float* dw1, float* db1, float* dw2, float* db2,
             float* dln_w, float* dln_b, TapJob taps, cudaStream_t s) {
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
                      {at<float>(scratch, p, 5), db1, p.hid, (int)p.db1_parts},
                      {pln, dln_w, p.d, (int)p.R},
                      {pln + plane, dln_b, p.d, (int)p.R},
                      {pln + 2 * plane, db2, p.d, (int)p.R}}};
  const long blocks = std::min(((long)p.d * p.hid + 255) / 256, 264L);
  mlp_bwd_sum_kernel<<<dim3((unsigned)blocks, kSumJobs + (taps.part ? 1 : 0)), 256, 0, s>>>(
      jobs, taps);
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
  const int rc = front_launch<kFrontK9>(p.front, map_w1, map_g, map_w2, x, ln_w, ln_b, b1,
                                        nullptr, nullptr, at<bf16>(scratch, p, 0),
                                        at<bf16>(scratch, p, 3), at<bf16>(scratch, p, 4),
                                        at<float>(scratch, p, 5), M, d, hid, MergedTaps{}, s);
  if (rc) return rc;
  return run_tail(p, scratch, x, g, ln_w, w1, dx, dw1, db1, dw2, db2, dln_w, dln_b, TapJob{},
                  s);
}

// K10.  x, g (B, H, W, d) bf16; ln_w, ln_b (d), b1 (hid), c3, c5, c7 (hid)
// fp32; w1 (hid, d), k3 (hid, 3*3), k5 (hid, 5*5), k7 (hid, 7*7), w2
// (d, hid) bf16.  Outputs: dx (B, H, W, d) bf16; dw1 (hid, d), db1, dk3,
// dk5, dk7 (as the taps), dc3, dc5, dc7 (hid), dw2 (d, hid), db2, dln_w,
// dln_b (d) fp32.  scratch: mlp_bwd_scratch(1, B, H, W, d, hid) bytes.
// Six launches: the front, (b1), (b2), (c), (d), (e).
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
  float* h = at<float>(scratch, p, 1);
  float* dacc = at<float>(scratch, p, 2);  // g w2, then dacc in place
  float* ptap = at<float>(scratch, p, 9);
  float* mtaps = ptap + (size_t)p.adj_blocks * kTapRows * hid;
  CUtensorMap map_w1, map_g, map_w2, map_h, map_dacc;
  if (!weight_map(&map_w1, w1, hid, d) || !weight_map(&map_g, g, p.M, d) ||
      !weight_map(&map_w2, w2, d, hid) || !halo_map(&map_h, h, B, H, W, hid, kE7) ||
      !halo_map(&map_dacc, dacc, B, H, W, hid, kE7))
    return (int)cudaErrorInvalidValue;
  int rc = front_launch<kFrontK10>(p.front, map_w1, map_g, map_w2, x, ln_w, ln_b, b1, h, dacc,
                                   at<bf16>(scratch, p, 0), nullptr, nullptr, nullptr, p.M, d,
                                   hid, MergedTaps{k3, k5, k7, c3, c5, c7, mtaps}, s);
  if (rc) return rc;
  cudaError_t e = allow_smem(mlp_bwd_dwms_acc_kernel, kAccSmem);
  if (e != cudaSuccess) return (int)e;
  mlp_bwd_dwms_acc_kernel<<<dim3(p.tiles, B, p.chunks), 256, kAccSmem, s>>>(
      map_h, mtaps, dacc, at<bf16>(scratch, p, 3), H, W, hid);
  TRAMBA_CHECK_LAUNCH();
  e = allow_smem(mlp_bwd_dwms_adj_kernel, kAdjSmem);
  if (e != cudaSuccess) return (int)e;
  mlp_bwd_dwms_adj_kernel<<<dim3(p.adj_blocks, p.chunks), 256, kAdjSmem, s>>>(
      map_dacc, map_h, mtaps, at<bf16>(scratch, p, 4), at<float>(scratch, p, 5), ptap, B, H, W,
      hid, p.tpb);
  TRAMBA_CHECK_LAUNCH();
  return run_tail(p, scratch, x, g, ln_w, w1, dx, dw1, db1, dw2, db2, dln_w, dln_b,
                  TapJob{ptap, p.adj_blocks, hid, dk3, dk5, dk7, dc3, dc5, dc7}, s);
}

}  // extern "C"
