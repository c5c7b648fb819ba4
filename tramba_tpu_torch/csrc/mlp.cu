// K6 ln_mlp, K7 ln_dwms_mlp and K11 ln_dwmlp: the block FFNs of the bf16
// inference path, and the bf16 LayerNorm launch that K11-K13 start with.
//
// K6 replaces _mlp_pallas (tramba_tpu/ops/fused_mlp.py:130, kernel :115):
//   y = bf16(LN(x)); h = bf16(GELU(y @ w1^T + b1)); out = bf16(h @ w2^T + b2).
// K7 replaces _dwms_pallas (:360, kernel :312):
//   h = y @ w1^T + b1 (fp32, zero outside the image: SAME padding pads h, b1
//   included); a = h + dw3(h) + dw5(h) + dw7(h) + c3 + c5 + c7 with bf16 taps
//   on the unrounded h; out = bf16(bf16(GELU(a)) @ w2^T + b2).
// K11 replaces _dwmlp_pallas (:844, kernel :806), PVTv2's FFN:
//   h = y @ w1^T + b1 (fp32, zero outside the image); a = dw3(h) + c3 with
//   bf16 taps (the conv replaces h: no identity term);
//   out = bf16(bf16(GELU(a)) @ w2^T + b2), y = bf16(LN(x)) with eps 1e-6.
// It is K7's old chain with one 3x3 tap set and a 1-px halo (its redesign
// is a later step).
// K6 and K11 keep the wide hidden tensor on chip: the hidden dimension is
// walked in chunks, each chunk's fc2 product is added to an fp32 output
// tile, and only the bf16 output reaches device memory; K7 writes h once as
// fp32 (its stencil needs each pixel's h in up to 49 output tiles' halos)
// and keeps the rest on chip.  Where a map gives too few
// blocks to fill the card in whole waves (the 24 and 12 px maps), the
// chunks are split over S blocks per tile (grid z): each writes its fp32
// partial sum, and one more launch adds b2 to the S partials and rounds,
// the one rounding the TPU kernel makes there.  Where JAX on a TPU gives
// the 12 px d=1024 MLP to XLA (its VMEM weight budget), K6 runs it like
// every other shape.
//
// What bounds them on an H100.  K6 does 16 d^2 operations a pixel on 4 d
// bytes of x and out: about 4 d operations a byte, 512 at d 128 and above,
// over the card's bf16 ridge of ~295 (d 64, Tramba-P's 96 px guide, sits
// just under it), so it is bound by the operations, and only products fed
// to the tensor cores from staged shared-memory tiles come near the bound:
// it normalises its own rows into shared memory (no LayerNorm launch, no
// round trip of y), streams w1 and w2 by TMA into a ring of 128-byte
// swizzled tiles and runs both products as warpgroup wgmma with the output
// tile's fp32 sums in registers through the whole hidden loop (the
// kernel's note below).  Each weight tile serves the block's 64 rows only,
// so the weights stream from L2 at 64 operations a byte: that stream, not
// the tensor cores, is what holds it back now (PERF.md).  K7 does 4 d hid
// operations a pixel on the tensor cores and 49 FMAs a hidden value in fp32
// (the merged stencil; its bound in chip_smoke.py still counts the 83 taps
// of the three convs), on 4 d bytes of x and out and 8 hid bytes of h
// written and read once: the stencil's fp32 FMAs, and its halo reads of h
// from L2 (196 of every 64 pixels), are what bound it (its design: the K7
// section below).  K11 runs its products as bf16 wmma tiles with fp32
// accumulation (common.cuh) reading the weights from L2, and pays 9
// depthwise taps per hidden value in fp32 SIMT FMA and the fc1 of a 1-px
// halo around each 8x8 tile (100 rows for 64 outputs); its LN runs once
// per pixel in its own launch.
#include "common.cuh"

namespace {

// y[m, :] = bf16(LN(x[m, :]) * ln_w + ln_b), fp32 statistics; one warp per
// row.
__global__ void ln_rows_kernel(const bf16* __restrict__ x, const float* __restrict__ ln_w,
                               const float* __restrict__ ln_b, bf16* __restrict__ y, long M,
                               int d, float eps) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long m = (long)blockIdx.x * (blockDim.x >> 5) + warp;
  if (m >= M) return;
  const bf16* xr = x + m * d;
  float s = 0.f;
  for (int i = lane; i < d; i += 32) s += to_f32(xr[i]);
  const float mean = warp_sum(s) / d;
  float q = 0.f;
  for (int i = lane; i < d; i += 32) {
    const float v = to_f32(xr[i]) - mean;
    q = fmaf(v, v, q);
  }
  const float rstd = rsqrtf(warp_sum(q) / d + eps);
  bf16* yr = y + m * d;
  for (int i = lane; i < d; i += 32)
    yr[i] = __float2bfloat16_rn((to_f32(xr[i]) - mean) * rstd * ln_w[i] + ln_b[i]);
}

constexpr int kThreads = 256;

// out[i] = bf16(b2[i % d] + sum over s < S of part[s * n + i]), n = rows * d.
__global__ void finish_split_kernel(const float* __restrict__ part, const float* __restrict__ b2,
                                    bf16* __restrict__ out, long n, int d, int S) {
  for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long)gridDim.x * blockDim.x) {
    float a = b2[i % d];
    for (int s = 0; s < S; ++s) a += part[s * n + i];
    out[i] = __float2bfloat16_rn(a);
  }
}

// Hidden chunks [c_first, c_last) of split blockIdx.z, cps chunks per split.
__device__ __forceinline__ void split_range(int hid, int HC, int cps, int* c_first, int* c_last) {
  *c_first = blockIdx.z * cps * HC;
  *c_last = min(hid, *c_first + cps * HC);
}

// ---- K6 -------------------------------------------------------------------
//
// One block per (64 rows, column group, hidden split): NW warpgroups (one at
// d <= 64, else two) share the rows and own NT output tiles of 64 columns
// each, so a block covers NB = 64 NT NW columns (d 320 pads to 384; d 1024
// takes two column groups, each recomputing fc1).  Shared memory, bf16,
// 1024-aligned, in the layouts TMA writes and wgmma reads:
//   As [64 x dp]   bf16(LN(x)) of the rows (dp = d rounded up to 64, zeros
//                  past d), 128-byte swizzle (sw128_offset): fc1's A;
//   Gs 1-2 x [64 x HC]  bf16(GELU(fc1 chunk + b1)), HC = 64 NW hidden
//                  columns (64 per warpgroup), 128-byte swizzle; double-
//                  buffered by chunk where NT > 1: fc2's A;
//   ring           `stages` slots of 8 KB per warpgroup, each with its
//                  mbarrier.
// The weights stream as one sequence of tiles of one 64 x 64 box (128-byte
// swizzle) per warpgroup w, per hidden chunk c: dp / 64 tiles of w1 (rows c
// HC + 64 w, a k-slab of 64), then NW NT tiles of w2 (hidden slab s of the
// chunk, output tile j: rows n_base + w 64 NT + 64 j).  A tile is 4
// dependent wgmma m64n64k16 per warpgroup (one accumulator: h, or acc[j]),
// and each warpgroup keeps W tiles' groups in flight (mlp_in_flight), so
// fc2's tiles of consecutive j overlap; thread 0 issues tile t + stages - W
// by TMA after the block's barrier of tile t, into the slot of tile t - W,
// whose reads every warpgroup has waited for.  fc1's chunk ends with
// wait_group 0, b1 and exact GELU in registers and the bf16 chunk written
// to its Gs buffer.
// fc2 accumulates into NT 64 x 64 fp32 tiles held in registers for the
// whole hidden loop (128 registers a thread at NT 4); b2 and the one
// rounding come at the end, or fp32 partial sums go to part[split] when the
// hidden chunks are split over blocks (finish_split_kernel adds them).
// tiles whose wgmma groups a warpgroup keeps in flight: 3 where fc2 has
// several output tiles (separate accumulators) and Gs is double-buffered, 2
// where it has one
template <int NT>
__host__ __device__ constexpr int mlp_in_flight() { return NT > 1 ? 3 : 2; }
template <int NT>
__host__ __device__ constexpr int mlp_g_buffers() { return NT > 1 ? 2 : 1; }

// (two blocks an SM at NT = 1: the plan's shared memory allows it, and 128
// registers a thread do)
template <int NW, int NT>
__global__ void __launch_bounds__(128 * NW, NT == 1 ? 2 : 1)
    ln_mlp_kernel(const __grid_constant__ CUtensorMap map_w1,
                  const __grid_constant__ CUtensorMap map_w2, const bf16* __restrict__ x,
                  const float* __restrict__ ln_w, const float* __restrict__ ln_b,
                  const float* __restrict__ b1, const float* __restrict__ b2,
                  bf16* __restrict__ out, float* __restrict__ part, long M, int d, int hid,
                  int cps, int stages) {
  constexpr int HC = 64 * NW, NB = 64 * NT * NW, W = mlp_in_flight<NT>();
  extern __shared__ float4 smem4[];
  const int dp = (d + 63) & ~63, nkd = dp / 64, tpc = nkd + NW * NT;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem4);  // one mbarrier a slot (8 at most)
  bf16* As = tiles_start(smem4, 64);
  bf16* Gs = As + kTileRows * dp;
  bf16* ring = Gs + mlp_g_buffers<NT>() * kTileRows * HC;
  const int wg = threadIdx.x >> 7, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long m0 = (long)blockIdx.x * kTileRows;
  const int n_base = blockIdx.y * NB;
  const int nchunks = (hid + HC - 1) / HC;
  const int c_first = blockIdx.z * cps, c_last = min(nchunks, c_first + cps);
  const int T = (c_last - c_first) * tpc;
  // tile t of the stream into its slot: NW boxes, counted on the slot's barrier
  auto issue = [&](int t) {
    const int slot = t % stages, c = c_first + t / tpc, u = t % tpc;
    bf16* dst = ring + slot * NW * kBox;
    mbar_expect_tx(full + slot, NW * kBox * 2);
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      if (u < nkd) {
        tma_load_2d(dst + w * kBox, &map_w1, 64 * u, c * HC + 64 * w, full + slot);
      } else {
        const int v = u - nkd, s = v / NT, j = v - s * NT;
        tma_load_2d(dst + w * kBox, &map_w2, c * HC + 64 * s, n_base + w * 64 * NT + 64 * j,
                    full + slot);
      }
    }
  };
  if (threadIdx.x == 0) {
    for (int i = 0; i < stages; ++i) mbar_init(full + i, 1);
    mbar_init_fence();
    for (int t = 0; t < min(T, stages - W); ++t) issue(t);
  }

  ln_rows_sw128(x, ln_w, ln_b, M, d, m0, 4 * NW, As, nullptr);
  fence_proxy_async();

  float acc[NT][32], h[32];  // acc[j]: output tile j of this warpgroup
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    h[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) acc[j][i] = 0.f;
  }
  const int wrow = 16 * (warp & 3) + (lane >> 2), wcol = 2 * (lane & 3);
  for (int t = 0; t < T; ++t) {
    __syncthreads();  // tile t - W's reads are done, Gs and As are written
    if (threadIdx.x == 0 && t + stages - W < T) issue(t + stages - W);
    mbar_wait(full + t % stages, (t / stages) & 1);
    const bf16* tile = ring + (t % stages) * NW * kBox + wg * kBox;
    const int c = c_first + t / tpc, u = t % tpc;
    bf16* Gc = Gs + ((c - c_first) % mlp_g_buffers<NT>()) * kTileRows * HC;  // this chunk's
    if (u < nkd) {  // fc1: h = LN(x)[:, 64 u + ...] w1[chunk rows of this warpgroup]^T
      fence_regs(h);
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < 4; ++s)
        wgmma_m64n64k16(h, wgmma_desc_sw128(As + u * kBox + 16 * s),
                        wgmma_desc_sw128(tile + 16 * s), u > 0 || s > 0);
    } else {  // fc2: acc[j] += G[:, 64 s2 + ...] w2[columns of tile j]^T
      const int v = u - nkd, s2 = v / NT, j = v - s2 * NT;
#pragma unroll
      for (int jj = 0; jj < NT; ++jj) {
        if (jj != j) continue;
        fence_regs(acc[jj]);
        wgmma_fence();
#pragma unroll
        for (int s = 0; s < 4; ++s)
          wgmma_m64n64k16(acc[jj], wgmma_desc_sw128(Gc + s2 * kBox + 16 * s),
                          wgmma_desc_sw128(tile + 16 * s), 1);
      }
    }
    wgmma_commit();
    if (u == nkd - 1) {
      // fc1 of chunk c is complete: b1, exact GELU, bf16 into Gc.  The
      // last fc2 groups to read Gc (chunk c - 2's with two buffers, c - 1's
      // with one) ended at least W tiles ago (nkd >= 2 when NW == 2):
      // every warpgroup has waited for them before the last barrier.
      wgmma_wait<0>();
      fence_regs(h);
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int row = wrow + 8 * ((i >> 1) & 1), col = 64 * wg + 8 * (i >> 2) + wcol;
        const int hc = c * HC + col;
        const float g0 = hc < hid ? gelu_exact(h[i] + b1[hc]) : 0.f;
        const float g1 = hc + 1 < hid ? gelu_exact(h[i + 1] + b1[hc + 1]) : 0.f;
        *reinterpret_cast<__nv_bfloat162*>(Gc + sw128_offset(row, col, kTileRows)) =
            __floats2bfloat162_rn(g0, g1);
      }
      fence_proxy_async();
    } else {
      wgmma_wait<W - 1>();
    }
  }
  wgmma_wait<0>();
  float* part_s = part ? part + (long)blockIdx.z * M * d : nullptr;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    fence_regs(acc[j]);
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const long row = m0 + wrow + 8 * ((i >> 1) & 1);
      const int col = n_base + wg * 64 * NT + j * 64 + 8 * (i >> 2) + wcol;
      if (row >= M || col >= d) continue;
      if (part_s) {
        *reinterpret_cast<float2*>(part_s + row * d + col) = make_float2(acc[j][i], acc[j][i + 1]);
      } else {
        *reinterpret_cast<__nv_bfloat162*>(out + row * d + col) =
            __floats2bfloat162_rn(acc[j][i] + b2[col], acc[j][i + 1] + b2[col + 1]);
      }
    }
  }
}

// ---- K7 -------------------------------------------------------------------
//
// Two launches, and the split finish where one is needed:
//  (i) ln_fc_kernel<kFrontK7> (common.cuh): LN, fc1 and b1 of every pixel once;
//      h fp32 (B, H, W, hid), unrounded, to device memory.
//  (ii) dwms_tile_kernel: one block of 256 threads per (8x8 output tile,
//      image, split).  Per chunk of 64 hidden channels:
//      * the tile's 14 x 14 halo of h arrives by one 4-D TMA box (zeros
//        outside the image: exactly SAME padding of h, b1 inside), double-
//        buffered, the next chunk's box in flight while this one is used;
//      * the chunk's merged taps t = k7 + pad(k5) + pad(k3) + identity
//        (fp32 sums of the bf16 taps) and bias c3 + c5 + c7, which launch
//        (i) wrote beside h, arrive by cp.async a chunk ahead: one 7x7
//        stencil, 49 FMAs a hidden value where the three convs and the
//        identity take 83 + 4 (the same function, reassociated in fp32);
//      * a thread owns one channel and two output rows and slides the
//        7-wide window along each of the 8 halo rows it reads, so one
//        shared-memory load of h feeds up to 14 FMAs (the taps in registers,
//        or at NT = 4 read from shared memory, to leave the registers to
//        the output tile);
//      * bf16(GELU(a)) goes to a 128-byte-swizzled 64 x 64 A tile (double-
//        buffered), and fc2 runs as wgmma m64n64k16 on w2 tiles streamed by
//        TMA, the 64 x d fp32 output tile in registers (NT tiles of 64
//        columns a warpgroup) through the hidden loop; a chunk's fc2 runs
//        under the next chunk's stencil.
constexpr int kT = 8;               // output tile kT x kT pixels (K7 and K11)
constexpr int kTP = kT * kT;        // 64 output pixels
constexpr int kE7 = kT + 6;         // K7's halo side: 14
constexpr int kHalo = kE7 * kE7 * 64;  // fp32 elements of one chunk's halo box (50 KB)

// w2 ring slots: two chunks' tiles where shared memory holds them, else 10
// boxes (D = 2 NT - slots of a chunk's tiles are issued once the previous
// chunk's first D products are done)
template <int NW, int NT>
__host__ __device__ constexpr int dwms_stages() { return 2 * NT < 10 / NW ? 2 * NT : 10 / NW; }

template <int NW, int NT>
__host__ __device__ constexpr size_t dwms_smem() {
  return 1024 + 2 * kTP * 64 * 2 + (size_t)dwms_stages<NW, NT>() * NW * kBox * 2 +
         2 * kHalo * 4 + 2 * kTapChunk * 4;
}

template <int NW, int NT>
__global__ void __launch_bounds__(256, 1)
    dwms_tile_kernel(const __grid_constant__ CUtensorMap map_h,
                     const __grid_constant__ CUtensorMap map_w2,
                     const float* __restrict__ mtaps, const float* __restrict__ b2,
                     bf16* __restrict__ out, float* __restrict__ part, int H, int W, int d,
                     int hid, int cps) {
  constexpr int S = dwms_stages<NW, NT>(), D = 2 * NT - S;
  constexpr bool kTapRegs = NT < 4;
  extern __shared__ float4 smem4[];
  uint64_t* hbar = reinterpret_cast<uint64_t*>(smem4);  // the two halo buffers' barriers
  uint64_t* full = hbar + 2;                            // the ring slots'
  bf16* Gs = tiles_start(smem4, 64);                    // [2][64 x 64] GELU tiles
  bf16* ring = Gs + 2 * kTP * 64;
  float* halo = reinterpret_cast<float*>(ring + S * NW * kBox);  // [2][14][14][64]
  float* ts = halo + 2 * kHalo;  // [2][50][64] merged taps and biases (MergedTaps)
  const int tid = threadIdx.x, wg = tid >> 7, warp = tid >> 5, lane = tid & 31;
  const int tiles_x = (W + kT - 1) / kT;
  const int ty0 = (blockIdx.x / tiles_x) * kT, tx0 = (blockIdx.x % tiles_x) * kT;
  const int b = blockIdx.y;
  const int nchunks = (hid + 63) / 64;
  const int c_first = blockIdx.z * cps, nq = min(nchunks, c_first + cps) - c_first;
  const int T = nq * NT;  // w2 tiles: chunk t / NT, output tile t % NT of each warpgroup
  auto issue_w2 = [&](int t) {
    const int slot = t % S, c = c_first + t / NT, j = t % NT;
    mbar_expect_tx(full + slot, NW * kBox * 2);
#pragma unroll
    for (int w = 0; w < NW; ++w)
      tma_load_2d(ring + (slot * NW + w) * kBox, &map_w2, 64 * c, 64 * (w * NT + j), full + slot);
  };
  auto issue_halo = [&](int q) {
    mbar_expect_tx(hbar + (q & 1), kHalo * 4);
    tma_load_4d(halo + (q & 1) * kHalo, &map_h, 64 * (c_first + q), tx0 - 3, ty0 - 3, b,
                hbar + (q & 1));
  };
  auto issue_taps = [&](int q) {  // by every thread
    const float* src = mtaps + (long)(c_first + q) * kTapChunk;
    float* dst = ts + (q & 1) * kTapChunk;
    for (int e = tid; e < kTapChunk / 4; e += 256) cp_async16(dst + 4 * e, src + 4 * e, true);
    cp_async_commit();
  };
  int issued = 0;  // w2 tiles issued (thread 0)
  if (tid == 0) {
    mbar_init(hbar, 1);
    mbar_init(hbar + 1, 1);
    for (int i = 0; i < S; ++i) mbar_init(full + i, 1);
    mbar_init_fence();
    issue_halo(0);
    for (; issued < min(T, S); ++issued) issue_w2(issued);
  }
  issue_taps(0);
  __syncthreads();

  float acc[NT][32];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[j][i] = 0.f;
  const int cl = tid & 63, rp = tid >> 6;  // stencil: channel, pair of output rows
  for (int q = 0; q < nq; ++q) {
    cp_async_wait<0>();  // this chunk's taps (all threads' pieces: after the barrier)
    if constexpr (D > 0) {
      if (q > 0 && wg < NW) wgmma_wait<NT - D>();  // the previous chunk's first D tiles
    }
    __syncthreads();
    if (q + 1 < nq) issue_taps(q + 1);  // its buffer was last read before the last barrier
    if (tid == 0) {
      if (D > 0 && q > 0)
        for (; issued < min(T, (q - 1) * NT + D + S); ++issued) issue_w2(issued);
      if (q + 1 < nq) issue_halo(q + 1);  // its buffer's last reads ended before the last barrier
    }
    mbar_wait(hbar + (q & 1), (q >> 1) & 1);
    bf16* G = Gs + (q & 1) * kTP * 64;
    {
      const float* hb = halo + (q & 1) * kHalo + cl;
      const float* tq = ts + (q & 1) * kTapChunk + cl;
      float a0[kT], a1[kT], tap[kTapRegs ? 49 : 1];
      const float bias = tq[49 * 64];
#pragma unroll
      for (int px = 0; px < kT; ++px) a0[px] = a1[px] = bias;
      if constexpr (kTapRegs) {
#pragma unroll
        for (int i = 0; i < 49; ++i) tap[i] = tq[i * 64];
      }
      auto tap_at = [&](int i) {
        if constexpr (kTapRegs) {
          return tap[i];
        } else {
          return tq[i * 64];
        }
      };
#pragma unroll
      for (int r = 0; r < 8; ++r) {  // halo row 2 rp + r feeds output rows 2 rp and 2 rp + 1
        const float* row = hb + (2 * rp + r) * kE7 * 64;
        float v[kE7];
#pragma unroll
        for (int xx = 0; xx < kE7; ++xx) v[xx] = row[xx * 64];
#pragma unroll
        for (int kx = 0; kx < 7; ++kx) {
          if (r < 7) {
            const float t = tap_at(r * 7 + kx);
#pragma unroll
            for (int px = 0; px < kT; ++px) a0[px] = fmaf(t, v[px + kx], a0[px]);
          }
          if (r > 0) {
            const float t = tap_at((r - 1) * 7 + kx);
#pragma unroll
            for (int px = 0; px < kT; ++px) a1[px] = fmaf(t, v[px + kx], a1[px]);
          }
        }
      }
      // the GELU tile's buffer was last read by the fc2 of chunk q - 2,
      // which every warpgroup waited for before the previous chunk's barrier
#pragma unroll
      for (int px = 0; px < kT; ++px) {
        G[sw128_offset(16 * rp + px, cl, kTP)] = __float2bfloat16_rn(gelu_exact(a0[px]));
        G[sw128_offset(16 * rp + 8 + px, cl, kTP)] = __float2bfloat16_rn(gelu_exact(a1[px]));
      }
    }
    if (wg < NW) wgmma_wait<0>();  // the previous chunk's fc2, run under this stencil
    fence_proxy_async();
    __syncthreads();
    if (tid == 0)
      for (; issued < min(T, q * NT + S); ++issued) issue_w2(issued);
    if (wg < NW) {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int t = q * NT + j;
        mbar_wait(full + t % S, (t / S) & 1);
        const bf16* tile = ring + ((t % S) * NW + wg) * kBox;
        fence_regs(acc[j]);
        wgmma_fence();
#pragma unroll
        for (int s = 0; s < 4; ++s)
          wgmma_m64n64k16(acc[j], wgmma_desc_sw128(G + 16 * s), wgmma_desc_sw128(tile + 16 * s),
                          1);
        wgmma_commit();
      }
    }
  }
  if (wg >= NW) return;
  wgmma_wait<0>();
  const int wrow = 16 * (warp & 3) + (lane >> 2), wcol = 2 * (lane & 3);
  float* part_s = part ? part + (long)blockIdx.z * gridDim.y * H * W * d : nullptr;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    fence_regs(acc[j]);
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int p = wrow + 8 * ((i >> 1) & 1);
      const int gy = ty0 + p / kT, gx = tx0 + p % kT;
      const int col = 64 * (wg * NT + j) + 8 * (i >> 2) + wcol;
      if (gy >= H || gx >= W || col >= d) continue;
      const long o = (((long)b * H + gy) * W + gx) * d + col;
      if (part_s) {
        *reinterpret_cast<float2*>(part_s + o) = make_float2(acc[j][i], acc[j][i + 1]);
      } else {
        *reinterpret_cast<__nv_bfloat162*>(out + o) =
            __floats2bfloat162_rn(acc[j][i] + b2[col], acc[j][i + 1] + b2[col + 1]);
      }
    }
  }
}

// fc2's warpgroups NW and output tiles NT a warpgroup of K7 at width d: d up
// to 512 (the tile's registers), one warpgroup at d <= 64.
bool plan_dwms(int d, int hid, int* NW, int* NT) {
  if (d % 16 || hid % 16 || d < 16 || d > 512 || hid < 16) return false;
  const int tiles = (d + 63) / 64;
  *NW = tiles == 1 ? 1 : 2;
  *NT = (tiles + *NW - 1) / *NW;
  return true;
}

#define TRAMBA_DWMS_DISPATCH(NW, NT, ...)                               \
  switch ((NW) * 8 + (NT)) {                                            \
    case 9: { constexpr int kNW = 1, kNT = 1; __VA_ARGS__; } break;     \
    case 17: { constexpr int kNW = 2, kNT = 1; __VA_ARGS__; } break;    \
    case 18: { constexpr int kNW = 2, kNT = 2; __VA_ARGS__; } break;    \
    case 19: { constexpr int kNW = 2, kNT = 3; __VA_ARGS__; } break;    \
    case 20: { constexpr int kNW = 2, kNT = 4; __VA_ARGS__; } break;    \
    default: return (int)cudaErrorInvalidValue;                         \
  }

// ---- K11 ------------------------------------------------------------------

constexpr int kE1 = kT + 2;                 // with the 1-px halo: 10 x 10
constexpr int kEP1 = kE1 * kE1;             // 100 halo pixels
constexpr int kMP1 = (kEP1 + 15) / 16 * 16;  // 112 rows, padded for 16-row tiles

// One block per (8x8 output tile, image, split), as K7.  Shared: ys
// [112][KC+8] bf16 (channels [k0, k0+KC) of the LN'd halo tile), h32
// [112][HC+4] fp32 (fc1 chunk of the halo tile), hs [64][HC+8] bf16 (GELU
// chunk), acc [64][d+4] fp32 (output tile; b2 and the split partials as in
// K6).
__global__ void ln_dwmlp_kernel(const bf16* __restrict__ y, const bf16* __restrict__ w1,
                                const float* __restrict__ b1, const bf16* __restrict__ k3,
                                const float* __restrict__ c3, const bf16* __restrict__ w2,
                                const float* __restrict__ b2, bf16* __restrict__ out,
                                float* __restrict__ part, int H, int W, int d, int hid, int KC,
                                int HC, int cps) {
  extern __shared__ float4 smem4[];
  const int ldy = KC + 8, ld32 = HC + 4, ldhs = HC + 8, ldacc = d + 4;
  bf16* ys = reinterpret_cast<bf16*>(smem4);
  float* h32 = reinterpret_cast<float*>(ys + kMP1 * ldy);
  bf16* hs = reinterpret_cast<bf16*>(h32 + kMP1 * ld32);
  float* acc = reinterpret_cast<float*>(hs + kTP * ldhs);
  const int tiles_x = (W + kT - 1) / kT;
  const int ty0 = (blockIdx.x / tiles_x) * kT, tx0 = (blockIdx.x % tiles_x) * kT;
  const int b = blockIdx.y;
  for (int i = threadIdx.x; i < kTP * d; i += blockDim.x) {
    const int p = i / d, j = i - p * d;
    acc[p * ldacc + j] = part ? 0.f : b2[j];
  }
  int c_first, c_last;
  split_range(hid, HC, cps, &c_first, &c_last);
  for (int c0 = c_first; c0 < c_last; c0 += HC) {
    for (int k0 = 0; k0 < d; k0 += KC) {
      if (KC < d || c0 == c_first) {
        __syncthreads();
        stage_halo(y, b, H, W, d, ty0 - 1, tx0 - 1, kE1, kE1, kMP1, k0, KC, ys, ldy);
        __syncthreads();
      }
      mma_tiles(ys, ldy, w1 + (long)c0 * d + k0, d, h32, ld32, kMP1 / 16, HC / 16, KC, k0 > 0);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < kEP1 * HC; i += blockDim.x) {
      const int e = i / HC, j = i - e * HC;
      const int gy = ty0 - 1 + e / kE1, gx = tx0 - 1 + e % kE1;
      const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
      float* v = h32 + e * ld32 + j;
      *v = inside ? *v + b1[c0 + j] : 0.f;
    }
    __syncthreads();
    {
      // thread -> channel j of the chunk, as in K7
      const int j = threadIdx.x % HC, g = threadIdx.x / HC, G = blockDim.x / HC;
      const int c = c0 + j;
      float t3[9];
#pragma unroll
      for (int i = 0; i < 9; ++i) t3[i] = to_f32(k3[(long)c * 9 + i]);
      const float cb3 = c3[c];
      const float* hj = h32 + j;
      for (int p = g; p < kTP; p += G) {
        const int py = p / kT, px = p % kT;
        float a = cb3;
#pragma unroll
        for (int u = 0; u < 3; ++u)
#pragma unroll
          for (int v = 0; v < 3; ++v)
            a = fmaf(t3[u * 3 + v], hj[((py + u) * kE1 + px + v) * ld32], a);
        hs[p * ldhs + j] = __float2bfloat16_rn(gelu_exact(a));
      }
    }
    __syncthreads();
    mma_tiles(hs, ldhs, w2 + c0, hid, acc, ldacc, kTP / 16, d / 16, HC, true);
    __syncthreads();
  }
  float* part_s = part ? part + blockIdx.z * (long)gridDim.y * H * W * d : nullptr;
  for (int i = threadIdx.x; i < kTP * d; i += blockDim.x) {
    const int p = i / d, j = i - p * d;
    const int gy = ty0 + p / kT, gx = tx0 + p % kT;
    if (gy >= H || gx >= W) continue;
    const long o = (((long)b * H + gy) * W + gx) * d + j;
    if (part_s) {
      part_s[o] = acc[p * ldacc + j];
    } else {
      out[o] = __float2bfloat16_rn(acc[p * ldacc + j]);
    }
  }
}

size_t dwmlp_smem(int d, int KC, int HC) {
  return (size_t)kMP1 * ((KC + 8) * 2 + (HC + 4) * 4) + (size_t)kTP * ((HC + 8) * 2 + (d + 4) * 4);
}


// The largest hidden chunk HC (then K chunk KC) whose tiles fit one block of
// K11 (smem = dwmlp_smem; d 320 stages its input in chunks of 64 channels).
bool pick_chunks(size_t (*smem)(int, int, int), int d, int hid, int* KC, int* HC) {
  for (int hc = 128; hc >= 16; hc /= 2) {
    if (hid % hc || kThreads % hc) continue;
    const int kcs[] = {d, 256, 128, 64, 32, 16};
    for (int kc : kcs) {
      if (kc > d || d % kc) continue;
      if (smem(d, kc, hc) <= kSmemBlock) {
        *KC = kc;
        *HC = hc;
        return true;
      }
    }
  }
  return false;
}

// Splits of the hidden chunks for a grid of `blocks` blocks when the kernel
// holds `smem` bytes of shared memory per block: the wave-quantised time of
// s splits is ceil(blocks * s / slots) / s of one block's full work, slots
// being the blocks the card holds at once.  Returns the fewest splits that
// cut it by more than 10% each time, at most 8 and at most `nchunks`, after
// rounding to whole chunks per split; with below_a_wave, none unless the
// grid fills less than one wave.
template <typename Kern>
int pick_splits(Kern kernel, size_t smem, long blocks, int nchunks, int* splits,
                bool below_a_wave = false) {
  cudaError_t e = allow_smem(kernel, smem);
  int per_sm = 0, dev = 0, sms = 0;
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const long slots = std::max(1L, (long)per_sm * sms);
  int best = 1;
  double best_cost = (double)((blocks + slots - 1) / slots);
  for (int s = 2; s <= std::min(8, nchunks) && !(below_a_wave && blocks >= slots); ++s) {
    const double cost = (double)((blocks * s + slots - 1) / slots) / s;
    if (cost < 0.9 * best_cost) {
      best = s;
      best_cost = cost;
    }
  }
  const int cps = (nchunks + best - 1) / best;
  *splits = (nchunks + cps - 1) / cps;
  return 0;
}

int finish_split(const float* part, const float* b2, bf16* out, long n, int d, int S,
                 cudaStream_t s) {
  const long blocks = std::min((n + kThreads - 1) / kThreads, 132L * 8);
  finish_split_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(part, b2, out, n, d, S);
  TRAMBA_CHECK_LAUNCH();
  return 0;
}

// Tiling of one K6 launch (see ln_mlp_kernel).
struct MlpPlan {
  int NW, NT, groups, stages, nchunks;
  size_t smem;
  long rows;  // row tiles of 64
};

bool plan_mlp(long M, int d, int hid, MlpPlan* p) {
  if (d % 8 || hid % 8 || d < 8 || d > 1024 || hid < 8 || M < 1) return false;
  p->NW = d <= 64 ? 1 : 2;
  const int per_block = std::min(d, 512);
  p->NT = (per_block / p->NW + 63) / 64;
  p->groups = (d + 64 * p->NT * p->NW - 1) / (64 * p->NT * p->NW);
  p->nchunks = (hid + 64 * p->NW - 1) / (64 * p->NW);
  p->rows = (M + kTileRows - 1) / kTileRows;
  const int dp = (d + 63) & ~63;
  const int in_flight = p->NT > 1 ? 3 : 2, g_buffers = p->NT > 1 ? 2 : 1;
  // the mbarriers (up to 8) and the 1024-byte alignment of the tiles, then
  // the LN rows, the GELU buffers, the ring
  const size_t fixed = 1024 + (size_t)kTileRows * (dp + g_buffers * 64 * p->NW) * 2;
  const size_t tile = (size_t)kBox * p->NW * 2;
  // two blocks an SM (113 KB each) where the accumulators leave the
  // registers for it and the ring keeps two tiles ahead
  size_t budget = p->NT <= 2 ? 113 * 1024 : kSmemBlock;
  if (fixed + (in_flight + 2) * tile > budget) budget = kSmemBlock;
  p->stages = (int)std::min<size_t>(8, (budget - std::min(budget, fixed)) / tile);
  p->smem = fixed + (size_t)p->stages * tile;
  return p->stages > in_flight;
}

#define TRAMBA_MLP_DISPATCH(p, ...)                                                     \
  switch ((p).NW * 8 + (p).NT) {                                                         \
    case 9: { constexpr int kNW = 1, kNT = 1; __VA_ARGS__; } break;                      \
    case 17: { constexpr int kNW = 2, kNT = 1; __VA_ARGS__; } break;                     \
    case 18: { constexpr int kNW = 2, kNT = 2; __VA_ARGS__; } break;                     \
    case 19: { constexpr int kNW = 2, kNT = 3; __VA_ARGS__; } break;                     \
    case 20: { constexpr int kNW = 2, kNT = 4; __VA_ARGS__; } break;                     \
    default: return (int)cudaErrorInvalidValue;                                          \
  }

// Splits of the hidden chunks over blocks for K6: s splits take
// ceil(blocks s / slots) waves of 1 / s of a block's products (taken at
// ~2.5 TFLOP/s an SM) and move 8 M d s bytes of fp32 partial sums (at ~2.5
// TB/s); the cheapest s up to 16 and `nchunks`, rounded to whole chunks
// per split.
int pick_mlp_splits(const MlpPlan& p, long M, int d, int hid, int* splits) {
  int per_sm = 0, dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  TRAMBA_MLP_DISPATCH(p, {
    auto kern = ln_mlp_kernel<kNW, kNT>;
    if (e == cudaSuccess) e = allow_smem(kern, p.smem);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, 128 * kNW, p.smem);
  });
  if (e != cudaSuccess) return (int)e;
  const long slots = std::max(1L, (long)per_sm * sms), blocks = p.rows * p.groups;
  const double block_s = 2.0 * kTileRows * hid * (((d + 63) & ~63) + 64.0 * p.NT * p.NW) / 2.5e12;
  int best = 1;
  double best_cost = 0;
  for (int s = 1; s <= std::min(16, p.nchunks); ++s) {
    const double cost = (double)((blocks * s + slots - 1) / slots) * block_s / s +
                        (s > 1 ? 8.0 * M * d * s / 2.5e12 : 0.0);
    if (s == 1 || cost < best_cost) {
      best = s;
      best_cost = cost;
    }
  }
  const int cps = (p.nchunks + best - 1) / best;
  *splits = (p.nchunks + cps - 1) / cps;
  return 0;
}

}  // namespace

extern "C" {

// bf16 LayerNorm of the rows of x (M, d) into y (M, d); ln_w, ln_b (d) fp32.
int layer_norm_bf16_launch(const bf16* x, const float* ln_w, const float* ln_b, bf16* y, long M,
                           int d, float eps, void* stream) {
  const int rows = kThreads / 32;
  ln_rows_kernel<<<(unsigned)((M + rows - 1) / rows), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(x, ln_w, ln_b, y, M, d, eps);
  TRAMBA_CHECK_LAUNCH();
  return 0;
}

// Splits of the hidden dimension that ln_mlp_launch should use for these
// shapes (see pick_mlp_splits).
int ln_mlp_splits(long M, int d, int hid, int* splits) {
  MlpPlan p;
  if (!plan_mlp(M, d, hid, &p)) return (int)cudaErrorInvalidValue;
  return pick_mlp_splits(p, M, d, hid, splits);
}

// K6.  x (M, d) bf16; ln_w, ln_b (d) fp32 (LayerNorm eps 1e-5, folded in);
// w1 (hid, d) bf16; b1 (hid) fp32; w2 (d, hid) bf16; b2 (d) fp32; out (M, d)
// bf16; `splits` from ln_mlp_splits, with scratch part (splits, M, d) fp32
// when it is above 1.  d, hid multiples of 8, d <= 1024.
int ln_mlp_launch(const bf16* x, const float* ln_w, const float* ln_b, const bf16* w1,
                  const float* b1, const bf16* w2, const float* b2, bf16* out, float* part,
                  long M, int d, int hid, int splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  MlpPlan p;
  if (!plan_mlp(M, d, hid, &p) || splits < 1) return (int)cudaErrorInvalidValue;
  const int cps = (p.nchunks + splits - 1) / splits;
  const int S = (p.nchunks + cps - 1) / cps;
  CUtensorMap map_w1, map_w2;
  if (!weight_map(&map_w1, w1, hid, d) || !weight_map(&map_w2, w2, d, hid))
    return (int)cudaErrorInvalidValue;
  TRAMBA_MLP_DISPATCH(p, {
    auto kern = ln_mlp_kernel<kNW, kNT>;
    cudaError_t e = allow_smem(kern, p.smem);
    if (e != cudaSuccess) return (int)e;
    kern<<<dim3((unsigned)p.rows, p.groups, S), 128 * kNW, p.smem, s>>>(
        map_w1, map_w2, x, ln_w, ln_b, b1, b2, out, S > 1 ? part : nullptr, M, d, hid, cps,
        p.stages);
  });
  TRAMBA_CHECK_LAUNCH();
  return S > 1 ? finish_split(part, b2, out, M * d, d, S, s) : 0;
}

// Splits of the hidden chunks that ln_dwms_mlp_launch should use: only
// where the tiles of the map fill less than one wave (24 px at B1-B2).
int ln_dwms_mlp_splits(int B, int H, int W, int d, int hid, int* splits) {
  int NW, NT;
  if (!plan_dwms(d, hid, &NW, &NT)) return (int)cudaErrorInvalidValue;
  const long tiles = (long)((H + kT - 1) / kT) * ((W + kT - 1) / kT);
  TRAMBA_DWMS_DISPATCH(NW, NT, {
    return pick_splits(dwms_tile_kernel<kNW, kNT>, dwms_smem<kNW, kNT>(), tiles * B,
                       (hid + 63) / 64, splits, true);
  });
  return 0;
}

// K7.  x (B, H, W, d) bf16; ln_w, ln_b (d) fp32 (LayerNorm eps 1e-5, folded
// into the fc1 launch); w1 (hid, d) bf16; b1 (hid) fp32; k3 (hid, 3*3), k5
// (hid, 5*5), k7 (hid, 7*7) bf16; c3, c5, c7 (hid) fp32; w2 (d, hid) bf16;
// b2 (d) fp32; out (B, H, W, d) bf16; scratch h: B H W hid + 50 * 64 *
// ceil(hid / 64) fp32 (the fc1 map, then the merged taps), and part
// (splits, B, H, W, d) fp32 when `splits` (from ln_dwms_mlp_splits) is above
// 1.  d, hid multiples of 16, d <= 512.
int ln_dwms_mlp_launch(const bf16* x, const float* ln_w, const float* ln_b, const bf16* w1,
                       const float* b1, const bf16* k3, const float* c3, const bf16* k5,
                       const float* c5, const bf16* k7, const float* c7, const bf16* w2,
                       const float* b2, bf16* out, float* h, float* part, int B, int H, int W,
                       int d, int hid, int splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long M = (long)B * H * W;
  int NW, NT;
  FrontPlan fp;
  if (splits < 1 || !plan_dwms(d, hid, &NW, &NT) || !plan_front(M, d, hid, false, &fp))
    return (int)cudaErrorInvalidValue;
  CUtensorMap map_w1, map_h, map_w2;
  if (!weight_map(&map_w1, w1, hid, d) || !weight_map(&map_w2, w2, d, hid) ||
      !halo_map(&map_h, h, B, H, W, hid, kE7))
    return (int)cudaErrorInvalidValue;
  float* mtaps = h + M * hid;
  int rc = front_launch<kFrontK7>(fp, map_w1, map_w1, map_w1, x, ln_w, ln_b, b1, h, nullptr,
                                  nullptr, nullptr, nullptr, nullptr, M, d, hid,
                               MergedTaps{k3, k5, k7, c3, c5, c7, mtaps}, s);
  if (rc) return rc;
  const int tiles = ((H + kT - 1) / kT) * ((W + kT - 1) / kT);
  const int nchunks = (hid + 63) / 64, cps = (nchunks + splits - 1) / splits;
  const int S = (nchunks + cps - 1) / cps;
  TRAMBA_DWMS_DISPATCH(NW, NT, {
    auto kern = dwms_tile_kernel<kNW, kNT>;
    cudaError_t e = allow_smem(kern, dwms_smem<kNW, kNT>());
    if (e != cudaSuccess) return (int)e;
    kern<<<dim3(tiles, B, S), 256, dwms_smem<kNW, kNT>(), s>>>(
        map_h, map_w2, mtaps, b2, out, S > 1 ? part : nullptr, H, W, d, hid, cps);
  });
  TRAMBA_CHECK_LAUNCH();
  return S > 1 ? finish_split(part, b2, out, M * d, d, S, s) : 0;
}

// Splits of the hidden dimension that ln_dwmlp_launch should use.
int ln_dwmlp_splits(int B, int H, int W, int d, int hid, int* splits) {
  int KC, HC;
  if (d % 16 || hid % 16 || !pick_chunks(dwmlp_smem, d, hid, &KC, &HC))
    return (int)cudaErrorInvalidValue;
  const long tiles = (long)((H + kT - 1) / kT) * ((W + kT - 1) / kT);
  return pick_splits(ln_dwmlp_kernel, dwmlp_smem(d, KC, HC), tiles * B, hid / HC, splits);
}

// K11.  y (B, H, W, d) bf16, already LN'd (eps 1e-6); w1 (hid, d) bf16;
// b1 (hid) fp32; k3 (hid, 3*3) bf16; c3 (hid) fp32; w2 (d, hid) bf16; b2 (d)
// fp32; out (B, H, W, d) bf16; `splits` from ln_dwmlp_splits, with scratch
// part (splits, B, H, W, d) fp32 when it is above 1.  d, hid multiples of 16.
int ln_dwmlp_launch(const bf16* y, const bf16* w1, const float* b1, const bf16* k3,
                    const float* c3, const bf16* w2, const float* b2, bf16* out, float* part,
                    int B, int H, int W, int d, int hid, int splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int KC, HC;
  if (d % 16 || hid % 16 || splits < 1 || !pick_chunks(dwmlp_smem, d, hid, &KC, &HC))
    return (int)cudaErrorInvalidValue;
  const size_t smem = dwmlp_smem(d, KC, HC);
  cudaError_t e = allow_smem(ln_dwmlp_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const int tiles = ((H + kT - 1) / kT) * ((W + kT - 1) / kT);
  const int nchunks = hid / HC, cps = (nchunks + splits - 1) / splits;
  const int S = (nchunks + cps - 1) / cps;
  ln_dwmlp_kernel<<<dim3(tiles, B, S), kThreads, smem, s>>>(
      y, w1, b1, k3, c3, w2, b2, out, S > 1 ? part : nullptr, H, W, d, hid, KC, HC, cps);
  TRAMBA_CHECK_LAUNCH();
  return S > 1 ? finish_split(part, b2, out, (long)B * H * W * d, d, S, s) : 0;
}

}  // extern "C"
