// K5 prologue: the SS2D prologue of the bf16 inference path,
//   y = bf16(LN(x)) (fp32 two-pass statistics, eps 1e-5) or, for the DFVSS
//   guides, y = x;
//   u = y @ w_in^T (fp32), zero outside the image;
//   out = bf16(SiLU(dw3x3(u))) with bf16 taps applied in fp32.
//
// It replaces _prologue_pallas (tramba_tpu/ops/fused_prologue.py:94, kernel
// :57) and the front of _small_pallas (fused_ss2d_small.py:103-131).  The
// conv pads u, not x: a pixel outside the image contributes 0, not the
// in-projection of a zero (or LN-bias) row.
//
// What bounds it on an H100.  A pixel reads 2 dm bytes of x and writes 2 D
// bytes of out (D = 2 dm) for 2 dm D = 4 dm^2 operations: ~85 operations a
// byte at dm 128, far under the card's bf16 ridge of ~295, so at 96 and
// 48 px it is bound by its bytes; at 24 px dm 512 (~341 a byte) and 12 px
// dm 1024 by the products.  So the design keeps everything but x and out
// on chip, and feeds the products to the tensor cores:
//  * one launch, the LayerNorm folded in: a block normalises the x rows of
//    its output tile's 1-px halo itself (ln_gather_sw128) into a 128-byte-
//    swizzled bf16 tile, halo pixels outside the image as zero rows (so
//    their u is 0: the SAME padding of u);
//  * in_proj runs as warpgroup wgmma m64n64k16 on that tile (M tiles of 64
//    halo rows, one per warpgroup of four) with w_in (D, dm) read
//    in place as the K-major B operand, 64 x 64 boxes streamed by TMA
//    through a ring of mbarrier'd slots (K6's scheme);
//  * u stays fp32 on chip: a chunk of 64 output channels goes from the
//    registers to a shared fp32 tile, where each thread applies the 3x3
//    taps of one channel to 8 outputs of a row from registers, and SiLU;
//    that stencil runs under the next chunk's first products, and the bf16
//    result is written once.  The gather and the stencil are bound by
//    latency, so the block runs sixteen warps;
//  * the output tile is as large as the A tile's shared memory allows: the
//    plan (plan_prologue) picks the tile TH x TW and M tiles MT <= 4 whose
//    halo rows, rounded up to 64, cover the map in the fewest products (14
//    x 16 at 96 px dm 128: 1.33x the outputs' rows, where 8 x 8 tiles took
//    1.75x), and splits the channels over groups of blocks (grid z) where
//    the tiles alone give less than a wave of 132 blocks, up to one wave.
#include "common.cuh"

namespace {

constexpr int kLdu = 66;  // fp32 row stride of the u tile: 64 channels + 2

// Shared memory of one block: the mbarriers and alignment, the A tile of
// 64 MT halo rows x dp, `stages` w_in boxes, the u tile.
size_t prologue_smem(int MT, int dp, int stages) {
  return 1024 + (size_t)64 * MT * dp * 2 + (size_t)stages * kBox * 2 + (size_t)64 * MT * kLdu * 4;
}

struct ProloguePlan {
  int TH, TW, MT;            // output tile; M tiles of 64 halo rows
  int tiles;                 // tiles an image
  int cpg, groups, stages;   // 64-channel chunks of D a group, groups (grid z), ring slots
  size_t smem;
};

// The tile that covers an H x W map in the fewest 64-row M tiles (then the
// fewest tiles), among those whose A tile fits a block with three ring
// slots; then the channel groups: where B x tiles is under a wave of 132
// blocks, the most that keep B x tiles x groups inside that wave (a second,
// partial wave would cost a whole block's gather and chunks again).
bool plan_prologue(int B, int H, int W, int dm, int D, ProloguePlan* p) {
  if (dm % 16 || D % 16 || dm < 16 || dm > 1024 || D < 16 || B < 1 || H < 1 || W < 1)
    return false;
  const int dp = (dm + 63) & ~63;
  long best = -1, best_tiles = 0;
  for (int mt = 1; mt <= 4 && prologue_smem(mt, dp, 3) <= kSmemBlock; ++mt) {
    for (int th = 1; th <= H && th + 2 <= 64 * mt / 3; ++th) {
      const int tw = std::min(W, 64 * mt / (th + 2) - 2);
      if (tw < 1) continue;
      const long tiles = (long)((H + th - 1) / th) * ((W + tw - 1) / tw);
      if (best < 0 || tiles * mt < best || (tiles * mt == best && tiles < best_tiles)) {
        best = tiles * mt;
        best_tiles = tiles;
        p->TH = th;
        p->TW = tw;
        p->MT = mt;
      }
    }
  }
  if (best < 0) return false;
  p->tiles = (int)best_tiles;
  // one block an SM (sixteen warps' registers): where the tiles fill less
  // than a wave, as many channel groups as keep the grid inside one wave
  const int chunks = (D + 63) / 64;
  const long blocks = (long)B * p->tiles;
  const int want = (int)std::max(1L, std::min<long>(chunks, 132 / blocks));
  p->cpg = (chunks + want - 1) / want;
  p->groups = (chunks + p->cpg - 1) / p->cpg;
  // two blocks an SM (113 KB each) where four slots fit in that, else one
  const size_t fixed = prologue_smem(p->MT, dp, 0);
  const size_t budget = fixed + 4 * kBox * 2 <= 113 * 1024 ? 113 * 1024 : kSmemBlock;
  p->stages = (int)std::min<size_t>(8, (budget - fixed) / (kBox * 2));
  p->smem = prologue_smem(p->MT, dp, p->stages);
  return p->stages >= 3;
}

constexpr int kThreads = 512;  // four warpgroups: one M tile each

// Units [u0, u1) of the stencil of one chunk: a unit is 8 outputs of one
// row of the tile for one channel; thread t takes the units t / 64 + 8 i of
// channel c = (chunk) + t % 64, reads the 3 x 10 halo values of its u column
// once and applies the 3x3 taps k9 from registers, then SiLU, bf16.
__device__ __forceinline__ void stencil_units(const float* us, const float (&k9)[9],
                                              bf16* __restrict__ out, int c, int D, int b, int H,
                                              int W, int ty0, int tx0, int TW, int segs, int u0,
                                              int u1) {
  const int EW = TW + 2, cl = threadIdx.x & 63;
  if (c >= D) return;
  for (int w = u0 + (threadIdx.x >> 6); w < u1; w += kThreads / 64) {
    const int py = w / segs, px0 = (w - py * segs) * 8, gy = ty0 + py;
    const float* base = us + (py * EW) * kLdu + cl;
    float o[8];
#pragma unroll
    for (int px = 0; px < 8; ++px) o[px] = 0.f;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      float v[10];
#pragma unroll
      for (int xx = 0; xx < 10; ++xx)  // past the halo row's end: a value no output uses
        v[xx] = base[(dy * EW + min(px0 + xx, EW - 1)) * kLdu];
#pragma unroll
      for (int px = 0; px < 8; ++px)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) o[px] = fmaf(k9[dy * 3 + dx], v[px + dx], o[px]);
    }
    if (gy >= H) continue;
    bf16* orow = out + (((long)b * H + gy) * W + tx0 + px0) * D + c;
#pragma unroll
    for (int px = 0; px < 8; ++px) {
      if (px0 + px >= TW || tx0 + px0 + px >= W) break;
      orow[(long)px * D] = __float2bfloat16_rn(o[px] * __frcp_rn(1.f + __expf(-o[px])));
    }
  }
}

// One block of four warpgroups per (output tile, image, channel group).
// Halo row r < R = (TH + 2)(TW + 2) is pixel (ty0 - 1 + r / (TW + 2),
// tx0 - 1 + r % (TW + 2)); rows [R, 64 MT) and pixels outside the image are
// zero rows of A.  Warpgroup w < MT runs M tile w.  The w_in boxes stream as
// one sequence over (chunk, k-block); after the block's barrier of tile t,
// thread 0 issues tile t + stages - 2 into the slot of tile t - 2, whose
// groups every warpgroup has waited for.  At a chunk's last k-block the u
// tile goes to shared memory; the stencil of that chunk then runs once the
// next chunk's first k-block of wgmma is issued, so the CUDA cores work
// while the tensor cores do (the last chunk's stencil runs alone at the
// end).
template <int MT, int KG>
__global__ void __launch_bounds__(kThreads, 1)
    prologue_kernel(const __grid_constant__ CUtensorMap map_w, const bf16* __restrict__ x,
                    const float* __restrict__ ln_w, const float* __restrict__ ln_b,
                    const bf16* __restrict__ taps, bf16* __restrict__ out, int H, int W, int dm,
                    int D, int TH, int TW, int cpg, int stages) {
  constexpr int RP = 64 * MT;  // halo rows padded to whole M tiles
  extern __shared__ float4 smem4[];
  const int dp = (dm + 63) & ~63, nkd = dp / 64;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem4);  // one mbarrier a slot (8 at most)
  bf16* As = tiles_start(smem4, 64);                     // [dp / 64][RP][64], swizzled
  bf16* ring = As + (size_t)RP * dp;
  float* us = reinterpret_cast<float*>(ring + (size_t)stages * kBox);  // [RP][kLdu]
  const int tid = threadIdx.x, wg = tid >> 7, warp = tid >> 5, lane = tid & 31, cl = tid & 63;
  const int EW = TW + 2, R = (TH + 2) * EW;
  const int tiles_x = (W + TW - 1) / TW;
  const int ty0 = (blockIdx.x / tiles_x) * TH, tx0 = (blockIdx.x % tiles_x) * TW;
  const int b = blockIdx.y;
  const int nchunks = (D + 63) / 64;
  const int c_first = blockIdx.z * cpg, nq = min(nchunks, c_first + cpg) - c_first;
  const int T = nq * nkd;
  const int segs = (TW + 7) / 8, units = TH * segs;  // stencil units of a chunk
  auto issue = [&](int t) {
    const int slot = t % stages;
    mbar_expect_tx(full + slot, kBox * 2);
    tma_load_2d(ring + (size_t)slot * kBox, &map_w, 64 * (t % nkd), 64 * (c_first + t / nkd),
                full + slot);
  };
  if (tid == 0) {
    for (int i = 0; i < stages; ++i) mbar_init(full + i, 1);
    mbar_init_fence();
    for (int t = 0; t < min(T, stages - 2); ++t) issue(t);
  }
  ln_gather_sw128<KG>(x, ln_w, ln_b, dm, RP,
                      [=](int r) {
                        const int gy = ty0 - 1 + r / EW, gx = tx0 - 1 + r % EW;
                        return r < R && gy >= 0 && gy < H && gx >= 0 && gx < W
                                   ? ((long)b * H + gy) * W + gx
                                   : -1L;
                      },
                      kThreads / 32, As, nullptr);
  fence_proxy_async();

  float acc[32], k9[9];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  const int wrow = 16 * (warp & 3) + (lane >> 2), wcol = 2 * (lane & 3);
  const bf16* a_tile = As + (size_t)wg * kBox;  // this warpgroup's M tile, k-block 0
  for (int t = 0; t < T; ++t) {
    __syncthreads();  // tile t - 2's reads are done, As and the u tile are written
    if (tid == 0 && t + stages - 2 < T) issue(t + stages - 2);
    mbar_wait(full + t % stages, (t / stages) & 1);
    const bf16* tile = ring + (size_t)(t % stages) * kBox;
    const int q = t / nkd, u = t % nkd;
    fence_regs(acc);
    wgmma_fence();
    if (wg < MT) {
#pragma unroll
      for (int s = 0; s < 4; ++s)
        wgmma_m64n64k16(acc, wgmma_desc_sw128(a_tile + (size_t)u * RP * 64 + 16 * s),
                        wgmma_desc_sw128(tile + 16 * s), u > 0 || s > 0);
    }
    wgmma_commit();
    if (q > 0 && u == 0)  // the previous chunk's stencil, under this chunk's first products
      stencil_units(us, k9, out, 64 * (c_first + q - 1) + cl, D, b, H, W, ty0, tx0, TW, segs, 0,
                    units);
    if (u != nkd - 1) {
      wgmma_wait<1>();
      continue;
    }
    wgmma_wait<0>();
    fence_regs(acc);
    __syncthreads();  // every piece of the previous chunk's stencil has read the u tile
    if (wg < MT) {
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int row = 64 * wg + wrow + 8 * ((i >> 1) & 1);
        *reinterpret_cast<float2*>(us + row * kLdu + 8 * (i >> 2) + wcol) =
            make_float2(acc[i], acc[i + 1]);
      }
    }
    const int c = 64 * (c_first + q) + cl;
#pragma unroll
    for (int i = 0; i < 9; ++i) k9[i] = c < D ? to_f32(taps[(long)c * 9 + i]) : 0.f;
  }
  __syncthreads();
  stencil_units(us, k9, out, 64 * (c_first + nq - 1) + cl, D, b, H, W, ty0, tx0, TW, segs, 0,
                units);
}

#define TRAMBA_PROLOGUE_KG(MT, ...)                                  \
  switch (kg) {                                                      \
    case 1: { constexpr int kMT = MT, kKG = 1; __VA_ARGS__; } break; \
    case 2: { constexpr int kMT = MT, kKG = 2; __VA_ARGS__; } break; \
    default: { constexpr int kMT = MT, kKG = 4; __VA_ARGS__; } break; \
  }
#define TRAMBA_PROLOGUE_DISPATCH(MT, ...)                         \
  switch (MT) {                                                   \
    case 1: TRAMBA_PROLOGUE_KG(1, __VA_ARGS__) break;             \
    case 2: TRAMBA_PROLOGUE_KG(2, __VA_ARGS__) break;             \
    case 3: TRAMBA_PROLOGUE_KG(3, __VA_ARGS__) break;             \
    case 4: TRAMBA_PROLOGUE_KG(4, __VA_ARGS__) break;             \
    default: return (int)cudaErrorInvalidValue;                   \
  }

}  // namespace

extern "C" {

// K5's plan at these shapes: plan[0..4] = TH, TW, MT, groups, stages; an
// error for shapes the kernel does not take.
int prologue_plan(int B, int H, int W, int dm, int D, int* plan) {
  ProloguePlan p;
  if (!plan_prologue(B, H, W, dm, D, &p)) return (int)cudaErrorInvalidValue;
  plan[0] = p.TH;
  plan[1] = p.TW;
  plan[2] = p.MT;
  plan[3] = p.groups;
  plan[4] = p.stages;
  return 0;
}

// K5.  x (B, H, W, dm) bf16; ln_w, ln_b (dm) fp32, or both null (y = x);
// w_in (D, dm) bf16; taps (D, 3*3) bf16; out (B, H, W, D) bf16.  dm, D
// multiples of 16, dm <= 1024.  One launch.
int prologue_launch(const bf16* x, const float* ln_w, const float* ln_b, const bf16* w_in,
                    const bf16* taps, bf16* out, int B, int H, int W, int dm, int D,
                    void* stream) {
  ProloguePlan p;
  if (!plan_prologue(B, H, W, dm, D, &p) || (ln_w == nullptr) != (ln_b == nullptr))
    return (int)cudaErrorInvalidValue;
  CUtensorMap map_w;
  if (!weight_map(&map_w, w_in, D, dm)) return (int)cudaErrorInvalidValue;
  // 16-byte groups of a row a lane holds in the LayerNorm gather
  const int kg = dm <= 256 ? 1 : dm <= 512 ? 2 : 4;
  TRAMBA_PROLOGUE_DISPATCH(p.MT, {
    auto kern = prologue_kernel<kMT, kKG>;
    cudaError_t e = allow_smem(kern, p.smem);
    if (e != cudaSuccess) return (int)e;
    kern<<<dim3(p.tiles, B, p.groups), kThreads, p.smem, static_cast<cudaStream_t>(stream)>>>(
        map_w, x, ln_w, ln_b, taps, out, H, W, dm, D, p.TH, p.TW, p.cpg, p.stages);
  });
  TRAMBA_CHECK_LAUNCH();
  return 0;
}

}  // extern "C"
