// K3 expand_ln and K4 final_head: the decoder's upsamplers and its last head.
//
// K3 replaces _expand_pallas (tramba_tpu/ops/fused_expand.py:59): x @ w^T,
// then the x2 pixel shuffle in (p1, p2, c) channel order, then LayerNorm over
// each output pixel's co = f*C/4 channels (PatchExpand f=2, FreqExpand2D f=4):
// weight row g co + j is shuffle position g = 2 p1 + p2, channel j, and lands
// at out[b, 2h + p1, 2w + p2, j].
// K4 replaces _final_head_pallas (:165): h = x @ w1^T (C -> 16C), LayerNorm of
// each of the 16 slots of C channels, then the 1x1 seg conv: seg[m, s] =
// rstd_s sum_c (h_sc - mean_s) u_c + sum_c ln_b_c seg_w_c + seg_b, u = ln_w
// seg_w.  The TPU kernel folded LN and head into three matmuls against
// block-diagonal selectors (and a one-pass E[h^2] - E[h]^2 variance) to suit
// its matrix unit; here the slot's sums sit in registers and the statistics
// take two passes over them.  The 16C-wide h never reaches device memory.
//
// What bounds them on an H100.  K3 does 2 C operations per expanded value and
// writes 2 bytes (bf16) of it: at C 128-256 (the 48 px maps) it is bound by
// its output bytes, at C 512-1024 (12-24 px) by the tensor cores.  K4 does
// 32 C^2 operations a pixel on 2 C + 32 bytes: bound by the operations.
// Both run their products where those bounds are reachable.
//
// bf16 (one launch each, the main path): the products run as warpgroup
// wgmma from 64 x 64 TMA boxes in the 128-byte swizzled layout
// (common.cuh "staged tiles"), two consumer warpgroups a block and the fp32
// sums in registers; the LayerNorm (and K4's head) are computed from the
// accumulators in an epilogue:
//   - each row's statistics: the thread's columns, then the quad's four
//     lanes (shuffles xor 1, 2), then, where the two warpgroups split the
//     row's columns, a shared array of their two partials added in a fixed
//     order; two passes (the mean, then the squared deviations); columns
//     past the block's valid width (TMA zeros, or the next group's rows)
//     are masked out of both;
//   - K3 (expand_wgmma_kernel): a block owns 128 pixel rows (the two
//     warpgroups split the rows) and the columns of one shuffle group, or of
//     the pair (p1, 0), (p1, 1) where co <= 128 (their weight rows are
//     contiguous and each input pixel writes 2 co contiguous channels), or 64
//     rows whose co > 256 columns the warpgroups split (co <= 512: at most
//     256 columns, 128 fp32 registers a thread, a warpgroup; that keeps the
//     tile in registers, where a shared fp32 tile of 64 x 512 would take 128
//     KB and the TMA ring's room).  x and w stream as k-slabs of 64 through
//     the ring; the normalised bf16 tile is staged in the drained ring and
//     stored with 16-byte writes, each pixel's channels contiguous;
//   - K4 (head_wgmma_kernel): a block owns 128 rows (64 at C > 128, the
//     columns split), its x tile resident in shared memory (one TMA load),
//     and walks the 16 slots with each slot's C x C slice of w1 streaming
//     through the ring; two accumulator sets, so that one slot's epilogue
//     runs while the next slot's first products are in flight; the 16
//     logits a row are gathered in shared memory and written once.
// fp32 (TF32 off, as JAX's Precision.HIGHEST), and bf16 beyond the register
// tile (co > 512, C > 256: no model's shape): expand_simt_kernel and
// head_simt_kernel compute BM x BN register micro-tiles of SIMT FMAs from
// cp.async-staged shared tiles (x and w read once per block tile, k in
// order).  K3 splits a group's columns over a thread block cluster, whose
// blocks exchange their rows' partial sums through distributed shared
// memory, so that a 12 px map's few rows still fill the card; K4 gathers a
// slot's columns in a shared fp32 tile and takes the statistics a warp a
// row.  BM (64, 32 or 16 rows) and K4's slot groups are chosen so that the
// blocks fill whole waves of the card (plan_simt).  The fp32 pipes (67
// TFLOP/s) bound them: the products, not the bytes.  K3 takes co <= 4096
// (8 chunks of 512) there, K4 C <= ~1500 (its fp32 tile of 16 rows).
//
// Rounding (the rounding points of _expand_kernel and _head_kernel): the
// products accumulate in fp32, the LayerNorm (and the head) run in fp32 on
// the unrounded product, and only the output is rounded in bf16.  Every sum
// has a fixed order (no atomics): two launches give the same bits.
#include "common.cuh"

#include <cooperative_groups.h>

namespace {

namespace cg = cooperative_groups;

constexpr float kLnEps = 1e-5f;

// ---------------------------------------------------------------------------
// Plans
// ---------------------------------------------------------------------------

constexpr int kRouteWgmma = 0, kRouteSimt = 1;

// The tiling of one K3 or K4 launch (expand_ln_plan / final_head_plan report
// it; ops/expand_stages.py mirrors it).
struct ExpandPlan {
  int route;     // kRouteWgmma or kRouteSimt
  int rows;      // rows of a block tile
  int wn;        // wgmma: columns a warpgroup owns; SIMT: columns of a chunk
  int split;     // wgmma: 1 = the warpgroups split the columns, 0 = the rows
  int gpb;       // K3: shuffle groups a block (2: (p1, 0) and (p1, 1)); K4: 1
  int sets;      // grid y: K3 4 / gpb (SIMT: 4 x column chunks); K4 slot groups
  long tiles;    // grid x: row tiles
  int stages;    // ring slots
  size_t smem;   // dynamic shared memory of a block
};

constexpr int pad_to(int v, int m) { return (v + m - 1) / m * m; }

constexpr size_t kBoxBytes = (size_t)kBox * 2;
constexpr size_t kHalfSm = 113 * 1024;  // two blocks an SM below this

// Ring slots: as many as fit `budget` beside `fixed` bytes (8 at most), at
// least 3 (the ring issues 2 tiles behind the one consumed).
static inline int ring_stages(size_t fixed, size_t stage, size_t budget) {
  return budget > fixed ? (int)std::min<size_t>(8, (budget - fixed) / stage) : 0;
}

// K3 in bf16 at co <= 512.
static inline bool plan_expand_wgmma(long M, int C, int co, ExpandPlan* p) {
  if (co > 512 || C < 8) return false;
  p->route = kRouteWgmma;
  p->gpb = co <= 128 ? 2 : 1;
  const int ncol = p->gpb * co;
  p->split = ncol > 256;
  p->rows = p->split ? 64 : 128;
  p->wn = p->split ? pad_to(ncol, 128) / 2 : pad_to(ncol, 64);
  const int ncol_pad = p->split ? 2 * p->wn : p->wn;
  const size_t stage = (size_t)(p->rows / 64 + ncol_pad / 64) * kBoxBytes;
  const size_t fixed = 1024 + 2 * 64 * 4;  // mbarriers and alignment; the split's row sums
  const size_t out_tile = (size_t)p->rows * (ncol_pad + 8) * 2;  // staged in the drained ring
  const int nk = (C + 63) / 64;
  const int fit = ring_stages(fixed, stage, kSmemBlock);
  p->stages = std::max(3, std::min(fit, nk + 1));
  while (p->stages < fit && (size_t)p->stages * stage < out_tile) ++p->stages;
  p->smem = fixed + (size_t)p->stages * stage;
  p->sets = 4 / p->gpb;
  p->tiles = (M + p->rows - 1) / p->rows;
  return p->stages >= 3 && p->stages <= fit && (size_t)p->stages * stage >= out_tile;
}

// K4's slot groups (grid y, 16 / sets slots a block): the fewest waves x
// slots a block (plus one for the block's own start and end) over 132 SMs
// of bps blocks each, the fewer groups on a tie.  Where the row tiles alone
// fill about a wave, the slots are split so that the last wave is not
// nearly empty (K4 at B2: 144 tiles of 128 rows, 1.09 waves).
static inline int slot_groups(long tiles, int bps) {
  int best = 1;
  long best_cost = -1;
  for (int sets = 1; sets <= 16; sets *= 2) {
    const long blocks = tiles * sets, per = 132L * bps;
    const long cost = (blocks + per - 1) / per * (16 / sets + 1);
    if (best_cost < 0 || cost < best_cost) {
      best_cost = cost;
      best = sets;
    }
  }
  return best;
}

// K4 in bf16 at C <= 256.
static inline bool plan_head_wgmma(long M, int C, ExpandPlan* p) {
  if (C > 256 || C < 8) return false;
  p->route = kRouteWgmma;
  p->gpb = 1;
  p->split = C > 128;
  p->rows = p->split ? 64 : 128;
  p->wn = p->split ? 128 : pad_to(C, 64);
  const int ncol_pad = p->split ? 256 : p->wn;
  const size_t stage = (size_t)(ncol_pad / 64) * kBoxBytes;
  // mbarriers and alignment, the resident x tile, the logits, u, row sums
  const size_t fixed = 1024 + (size_t)p->rows * pad_to(C, 64) * 2 + (size_t)p->rows * 16 * 4 +
                       256 * 4 + 3 * 2 * 64 * 4;
  // two blocks an SM where their registers (WN 64: two 32-float sets) and
  // four slots fit
  const size_t budget = p->wn == 64 && fixed + 4 * stage <= kHalfSm ? kHalfSm : kSmemBlock;
  p->stages = ring_stages(fixed, stage, budget);
  p->smem = fixed + (size_t)p->stages * stage;
  p->tiles = (M + p->rows - 1) / p->rows;
  p->sets = slot_groups(p->tiles, budget == kHalfSm ? 2 : 1);
  return p->stages >= 3;
}

// The SIMT route: BM x BN chunks, 256 threads as 8 warps down the rows and
// 32 lanes across the columns, BM BN / 256 = 32 sums a thread.
// k a stage: K3's blocks hold no fp32 tile, so their ring takes slabs of 32
// (half the barriers); K4's 16 keep two blocks an SM beside its tile
constexpr int kSimtK3 = 32, kSimtK4 = 16;
constexpr int kSimtStages = 3;
constexpr int kSimtTile = 8192;  // BM x BN

// elements of a staged row of KS, padded by 16 bytes
template <typename T, int KS>
__host__ __device__ constexpr int simt_ld() { return KS + 16 / (int)sizeof(T); }

static inline size_t simt_smem(int bm, int width, bool head, int elem) {
  const int bn = kSimtTile / bm, ld = (head ? kSimtK4 : kSimtK3) + 16 / elem;
  const size_t ring = (size_t)kSimtStages * (bm + bn) * ld * elem;
  return head ? (size_t)bm * width * 4 + (size_t)bm * 16 * 4 + ring : ring + 2 * bm * 4;
}

// BM: the rows whose blocks take the fewest waves x work a block (132 SMs,
// two blocks an SM where their shared memory allows), the larger on a tie.
// K3: grid y 4 ncl, ncl = ceil(co / BN) chunks a group (a cluster of at
// most 8); K4: grid y the slot groups (slot_groups).
static inline bool plan_simt(long M, int width, bool head, int elem, ExpandPlan* p) {
  long best = -1;
  for (int bm = 64; bm >= 16; bm /= 2) {
    const size_t smem = simt_smem(bm, width, head, elem);
    const int bn = kSimtTile / bm, ncl = (width + bn - 1) / bn;
    if (smem > kSmemBlock || (!head && ncl > 8)) continue;
    const int bps = 2 * smem <= 228 * 1024 ? 2 : 1;
    const long tiles = (M + bm - 1) / bm;
    const int sets = head ? slot_groups(tiles, bps) : 4 * ncl;
    const long waves = (tiles * sets + 132L * bps - 1) / (132L * bps);
    const long cost = waves * (bm + 16) * bn * (head ? ncl * (16 / sets + 1) : 1);
    if (best < 0 || cost < best) {
      best = cost;
      p->rows = bm;
      p->wn = bn;
      p->smem = smem;
      p->sets = sets;
    }
  }
  if (best < 0) return false;
  p->route = kRouteSimt;
  p->split = 0;
  p->gpb = 1;
  p->tiles = (M + p->rows - 1) / p->rows;
  p->stages = kSimtStages;
  return true;
}

static inline bool plan_expand(long M, int C, int co, bool bf16_io, ExpandPlan* p) {
  if (M < 1 || C < 1 || co < 1 || C % (bf16_io ? 8 : 4) || co % 2) return false;
  if (bf16_io && plan_expand_wgmma(M, C, co, p)) return true;
  return plan_simt(M, co, false, bf16_io ? 2 : 4, p);
}

static inline bool plan_head(long M, int C, bool bf16_io, ExpandPlan* p) {
  if (M < 1 || C < 1 || C % (bf16_io ? 8 : 4)) return false;
  if (bf16_io && plan_head_wgmma(M, C, p)) return true;
  return plan_simt(M, C, true, bf16_io ? 2 : 4, p);
}

// ---------------------------------------------------------------------------
// Epilogue helpers of the wgmma kernels
// ---------------------------------------------------------------------------

// Sum over the four lanes of a quad (the lanes holding one row's columns).
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

// Column (within the warpgroup's WN) of accumulator element i of this lane.
__device__ __forceinline__ int acc_col(int i, int lane) {
  return 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
}

// Where the two warpgroups split a row's columns: the row's sum of both
// partials, in warpgroup order (buf: [2][64] floats; a block barrier on each
// side of the exchange).  Else v itself.
template <bool kSplit>
__device__ __forceinline__ void across_warpgroups(float (&v)[2], float* buf, int wg, int wrow,
                                                  int lane) {
  if constexpr (kSplit) {
    if ((lane & 3) == 0) {
      buf[wg * 64 + wrow] = v[0];
      buf[wg * 64 + wrow + 8] = v[1];
    }
    __syncthreads();
#pragma unroll
    for (int h = 0; h < 2; ++h) v[h] = buf[wrow + 8 * h] + buf[64 + wrow + 8 * h];
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// K3, bf16: wgmma from TMA-staged tiles
// ---------------------------------------------------------------------------
//
// Block (row tile, group set): RW = 64 (kSplit: warpgroup w owns columns
// [w WN, (w + 1) WN) of the block) or 128 rows (warpgroup w owns rows [64 w,
// 64 w + 64), all WN columns).  The block's columns are weight rows g0 co +
// [0, NCOL); those >= gpb co are the next group's rows or TMA zeros, masked.
// A ring slot holds the k-slab's RW / 64 boxes of x, then NCOL / 64 boxes
// of w; thread 0 issues slab t + stages - 2 after the block's barrier of slab
// t, into the slot of slab t - 2, whose wgmma groups every warpgroup has
// waited for (wait_group 1 after each commit).
template <int WN, bool kSplit>
__global__ void __launch_bounds__(256, 1)
    expand_wgmma_kernel(const __grid_constant__ CUtensorMap map_x,
                        const __grid_constant__ CUtensorMap map_w, const float* __restrict__ ln_w,
                        const float* __restrict__ ln_b, bf16* __restrict__ out, long M, int H,
                        int W, int C, int co, int gpb, int stages) {
  constexpr int RW = kSplit ? 64 : 128, NCOL = kSplit ? 2 * WN : WN;
  constexpr int NA = RW / 64, NB = NCOL / 64, NACC = WN / 2;
  extern __shared__ float4 smem4[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem4);  // one mbarrier a slot (8 at most)
  bf16* ring = tiles_start(smem4, 64);
  float* red = reinterpret_cast<float*>(ring + (size_t)stages * (NA + NB) * kBox);  // [2][64]
  const int wg = threadIdx.x >> 7, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long m0 = (long)blockIdx.x * RW;
  const int g0 = blockIdx.y * gpb, nk = (C + 63) / 64, ncols = gpb * co;
  auto issue = [&](int t) {
    const int slot = t % stages;
    bf16* dst = ring + (size_t)slot * (NA + NB) * kBox;
    mbar_expect_tx(full + slot, (NA + NB) * kBox * 2);
#pragma unroll
    for (int a = 0; a < NA; ++a) tma_load_2d(dst + a * kBox, &map_x, 64 * t, (int)(m0 + 64 * a),
                                             full + slot);
#pragma unroll
    for (int b = 0; b < NB; ++b)
      tma_load_2d(dst + (NA + b) * kBox, &map_w, 64 * t, g0 * co + 64 * b, full + slot);
  };
  if (threadIdx.x == 0) {
    for (int i = 0; i < stages; ++i) mbar_init(full + i, 1);
    mbar_init_fence();
    for (int t = 0; t < min(nk, stages - 2); ++t) issue(t);
  }

  float acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.f;
  const int rbox = kSplit ? 0 : wg;       // this warpgroup's box of x rows
  const int cb0 = kSplit ? wg * WN : 0;   // its first column of the block
  for (int t = 0; t < nk; ++t) {
    __syncthreads();  // slab t - 2's reads are done (and the barriers initialised)
    if (threadIdx.x == 0 && t + stages - 2 < nk) issue(t + stages - 2);
    mbar_wait(full + t % stages, (t / stages) & 1);
    const bf16* st = ring + (size_t)(t % stages) * (NA + NB) * kBox;
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < 4; ++s)
      wgmma_m64nk16<WN>(acc, wgmma_desc_sw128(st + rbox * kBox + 16 * s),
                        wgmma_desc_sw128(st + (NA * 64 + cb0) * 64 + 16 * s), t > 0 || s > 0);
    wgmma_commit();
    wgmma_wait<1>();
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // Statistics of each (row, group) from the registers: this thread's rows
  // wrow and wrow + 8 of its warpgroup, the columns of group 0 (< co) and of
  // group 1 ([co, 2 co) when gpb = 2; kSplit has gpb = 1).
  const int wrow = 16 * (warp & 3) + (lane >> 2);
  float s0[2] = {0.f, 0.f}, s1[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < NACC; ++i) {
    const int cb = cb0 + acc_col(i, lane), h = (i >> 1) & 1;
    s0[h] += cb < co ? acc[i] : 0.f;
    s1[h] += cb >= co && cb < ncols ? acc[i] : 0.f;
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    s0[h] = quad_sum(s0[h]);
    s1[h] = quad_sum(s1[h]);
  }
  across_warpgroups<kSplit>(s0, red, wg, wrow, lane);
  float mean0[2], mean1[2], q0[2] = {0.f, 0.f}, q1[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mean0[h] = s0[h] / co;
    mean1[h] = s1[h] / co;
  }
#pragma unroll
  for (int i = 0; i < NACC; ++i) {
    const int cb = cb0 + acc_col(i, lane), h = (i >> 1) & 1;
    const float d0 = acc[i] - mean0[h], d1 = acc[i] - mean1[h];
    q0[h] += cb < co ? d0 * d0 : 0.f;
    q1[h] += cb >= co && cb < ncols ? d1 * d1 : 0.f;
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    q0[h] = quad_sum(q0[h]);
    q1[h] = quad_sum(q1[h]);
  }
  across_warpgroups<kSplit>(q0, red, wg, wrow, lane);

  // Normalised bf16 rows into the drained ring ([RW][NCOL + 8]: a padded
  // stride keeps the quad's rows on distinct banks), then each pixel's gpb
  // co channels to its (contiguous) place in out, 16 bytes a write where co
  // allows.
  __syncthreads();  // every warpgroup's products are done: the ring is free
  constexpr int LDO = NCOL + 8;
  bf16* Os = ring;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float r0 = rsqrtf(q0[h] / co + kLnEps), r1 = rsqrtf(q1[h] / co + kLnEps);
    const int r = (kSplit ? 0 : 64 * wg) + wrow + 8 * h;
#pragma unroll
    for (int i = 2 * h; i < NACC; i += 4) {  // elements i, i + 1 of row half h
      const int cb = cb0 + acc_col(i, lane);
      if (cb >= ncols) continue;
      const bool second = cb >= co;
      const int j = second ? cb - co : cb;
      const float m = second ? mean1[h] : mean0[h], rs = second ? r1 : r0;
      *reinterpret_cast<__nv_bfloat162*>(Os + r * LDO + cb) =
          __floats2bfloat162_rn((acc[i] - m) * rs * ln_w[j] + ln_b[j],
                                (acc[i + 1] - m) * rs * ln_w[j + 1] + ln_b[j + 1]);
    }
  }
  __syncthreads();
  const int p1 = g0 >> 1, p2 = g0 & 1;
  auto store = [&](auto vec) {
    using V = decltype(vec);
    constexpr int E = sizeof(V) / 2;  // bf16 a write
    const int per = ncols / E;
    for (int e = threadIdx.x; e < RW * per; e += blockDim.x) {
      const int r = e / per, c = (e - r * per) * E;
      const long m = m0 + r;
      if (m >= M) continue;
      const int wq = (int)(m % W);
      const long bh = m / W;
      const int hq = (int)(bh % H);
      const long b = bh / H;
      bf16* o = out + ((b * 2 * H + 2 * hq + p1) * (2L * W) + 2 * wq + p2) * co + c;
      *reinterpret_cast<V*>(o) = *reinterpret_cast<const V*>(Os + r * LDO + c);
    }
  };
  if (co % 8 == 0) {
    store(uint4{});
  } else if (co % 4 == 0) {
    store(uint2{});
  } else {
    store(0u);
  }
}

// ---------------------------------------------------------------------------
// K4, bf16: wgmma, x resident, 16 slots through the ring
// ---------------------------------------------------------------------------
//
// Block (row tile, slot group): RW = 128 rows (warpgroup w rows [64 w, 64 w
// + 64), WN = C padded to 64 columns) or, at C > 128, 64 rows whose 256
// padded columns the two warpgroups split (WN = 128), and slots s0 + [0,
// spb), spb = 16 / gridDim.y.  x's RW x C tile is loaded once (its own
// mbarrier) as nk k-blocks of RW / 64 boxes; the ring streams the block's
// i-th slot's k-slab u (step t = i nk + u) as NCOL / 64 boxes of w1 rows s C
// + [0, NCOL).  Slot i sums into acc[i % 2]; after the first commit of slot
// i and wait_group 1, slot i - 1's products are complete and its epilogue
// runs while slot i's first slab is on the tensor cores.
template <int WN, bool kSplit>
__global__ void __launch_bounds__(256, 1)
    head_wgmma_kernel(const __grid_constant__ CUtensorMap map_x,
                      const __grid_constant__ CUtensorMap map_w, const float* __restrict__ ln_w,
                      const float* __restrict__ ln_b, const float* __restrict__ seg_w,
                      const float* __restrict__ seg_b, bf16* __restrict__ out, long M, int C,
                      int stages) {
  constexpr int RW = kSplit ? 64 : 128, NCOL = kSplit ? 2 * WN : WN;
  constexpr int NA = RW / 64, NB = NCOL / 64, NACC = WN / 2;
  extern __shared__ float4 smem4[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem4);  // a slot each (8 at most), then x's
  uint64_t* xbar = full + 8;
  const int spb = 16 / gridDim.y, s0 = blockIdx.y * spb, nk = (C + 63) / 64, T = spb * nk;
  bf16* As = tiles_start(smem4, 128);  // [nk][NA] boxes
  bf16* ring = As + (size_t)nk * NA * kBox;
  float* Ls = reinterpret_cast<float*>(ring + (size_t)stages * NB * kBox);  // [RW][spb] logits
  float* Us = Ls + RW * 16;  // [256] u = ln_w seg_w, zeros past C
  float* red = Us + 256;     // [3][2][64] row partials of the split
  const int wg = threadIdx.x >> 7, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long m0 = (long)blockIdx.x * RW;
  auto issue = [&](int t) {
    const int slot = t % stages, i = t / nk, u = t - i * nk, s = s0 + i;
    bf16* dst = ring + (size_t)slot * NB * kBox;
    mbar_expect_tx(full + slot, NB * kBox * 2);
#pragma unroll
    for (int b = 0; b < NB; ++b)
      tma_load_2d(dst + b * kBox, &map_w, 64 * u, s * C + 64 * b, full + slot);
  };
  if (threadIdx.x == 0) {
    for (int i = 0; i < stages; ++i) mbar_init(full + i, 1);
    mbar_init(xbar, 1);
    mbar_init_fence();
    mbar_expect_tx(xbar, nk * NA * kBox * 2);
    for (int u = 0; u < nk; ++u)
      for (int a = 0; a < NA; ++a)
        tma_load_2d(As + (size_t)(u * NA + a) * kBox, &map_x, 64 * u, (int)(m0 + 64 * a), xbar);
    for (int t = 0; t < min(T, stages - 2); ++t) issue(t);
  }
  for (int c = threadIdx.x; c < 256; c += blockDim.x) Us[c] = c < C ? ln_w[c] * seg_w[c] : 0.f;
  // sum ln_b seg_w + seg_b, by every warp in the same order
  float cst = 0.f;
  for (int c = lane; c < C; c += 32) cst = fmaf(ln_b[c], seg_w[c], cst);
  cst = warp_sum(cst) + seg_b[0];

  const int rbox = kSplit ? 0 : wg, cb0 = kSplit ? wg * WN : 0;
  const int wrow = 16 * (warp & 3) + (lane >> 2), rblk = (kSplit ? 0 : 64 * wg) + wrow;
  // the logit of the block's slot s (local) of this thread's two rows
  auto epilogue = [&](float(&acc)[NACC], int s) {
    float sm[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < NACC; ++i) sm[(i >> 1) & 1] += cb0 + acc_col(i, lane) < C ? acc[i] : 0.f;
    sm[0] = quad_sum(sm[0]);
    sm[1] = quad_sum(sm[1]);
    across_warpgroups<kSplit>(sm, red, wg, wrow, lane);
    const float mean[2] = {sm[0] / C, sm[1] / C};
    float q[2] = {0.f, 0.f}, pu[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < NACC; ++i) {
      const int cb = cb0 + acc_col(i, lane), h = (i >> 1) & 1;
      const float d = cb < C ? acc[i] - mean[h] : 0.f;
      q[h] = fmaf(d, d, q[h]);
      pu[h] = fmaf(d, Us[cb], pu[h]);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      q[h] = quad_sum(q[h]);
      pu[h] = quad_sum(pu[h]);
    }
    across_warpgroups<kSplit>(q, red + 128, wg, wrow, lane);
    across_warpgroups<kSplit>(pu, red + 256, wg, wrow, lane);
    if ((lane & 3) == 0 && (!kSplit || wg == 0)) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
        Ls[(rblk + 8 * h) * spb + s] = rsqrtf(q[h] / C + kLnEps) * pu[h] + cst;
    }
  };
  // the block's slot i into cur; prev holds slot i - 1 until its epilogue
  auto slot = [&](int i, float(&cur)[NACC], float(&prev)[NACC]) {
    for (int u = 0; u < nk; ++u) {
      const int t = i * nk + u;
      __syncthreads();  // step t - 2's reads are done (and barriers, Us, As's issue)
      if (threadIdx.x == 0 && t + stages - 2 < T) issue(t + stages - 2);
      if (t == 0) mbar_wait(xbar, 0);
      mbar_wait(full + t % stages, (t / stages) & 1);
      const bf16* st = ring + (size_t)(t % stages) * NB * kBox;
      fence_regs(cur);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < 4; ++k)
        wgmma_m64nk16<WN>(cur, wgmma_desc_sw128(As + (size_t)(u * NA + rbox) * kBox + 16 * k),
                          wgmma_desc_sw128(st + cb0 * 64 + 16 * k), u > 0 || k > 0);
      wgmma_commit();
      wgmma_wait<1>();
      if (u == 0 && i > 0) {
        fence_regs(prev);
        epilogue(prev, i - 1);
      }
    }
  };
  float acc0[NACC], acc1[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc0[i] = acc1[i] = 0.f;
  for (int i = 0; i < spb; i += 2) {
    slot(i, acc0, acc1);
    if (i + 1 < spb) slot(i + 1, acc1, acc0);
  }
  wgmma_wait<0>();
  if (spb & 1) {
    fence_regs(acc0);
    epilogue(acc0, spb - 1);
  } else {
    fence_regs(acc1);
    epilogue(acc1, spb - 1);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < RW * spb; e += blockDim.x) {
    const long m = m0 + e / spb;
    if (m < M) out[m * 16 + s0 + e % spb] = __float2bfloat16_rn(Ls[e]);
  }
}

// ---------------------------------------------------------------------------
// K3 / K4, fp32 (and bf16 beyond the wgmma tiles): SIMT register micro-tiles
// ---------------------------------------------------------------------------
//
// A block computes BM rows by BN = 8192 / BM columns at a time: warp w (of 8)
// owns rows w + 8 i, lane l columns l + 32 j (TM = BM / 8 by TN = BN / 32
// sums a thread), over k-slabs of KS staged by cp.async in a ring of 3
// (zero-filled past the edges; KS = 32 for K3, 16 for K4), each product
// summed in k order.
//   K3 (expand_simt_kernel): a block owns one chunk of BN columns of one
//     shuffle group; the ncl = ceil(co / BN) chunks of a group run as one
//     thread block cluster (grid y = 4 ncl, cluster y = ncl).  The sums stay
//     in registers: each row's partial sum over the block's columns (a warp
//     holds whole rows of its chunk: warp_sum), the ncl partials read from
//     every block of the cluster in rank order (distributed shared memory),
//     then the same for the squared deviations, and each block writes its
//     columns of the normalised rows.  So a 12 px map's few rows still make
//     4 ncl blocks a row tile, and no block holds a whole fp32 row.
//   K4 (head_simt_kernel): a block walks the slots of slot group blockIdx.y
//     and each slot's chunks of C columns (the ring runs on from one chunk
//     and slot to the next) into Es (BM x C fp32 in shared memory); with a
//     slot complete, a warp a row takes its statistics (warp_row_stats) and
//     the head sum, and the logits are written at the end.

// Four consecutive elements of a staged row as fp32.
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ld4(const bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// The staged product of the SIMT kernels: nq k-slabs q of KS (k-slab q % nk
// of chunk q / nk), chunk c's weight rows from row_of(c) (+ [0, BN), valid
// below cols_of(c)), into acc; done(q, acc) runs after each chunk's last slab.
template <typename T, int BM, int KS, typename RowOf, typename ColsOf, typename Done>
__device__ __forceinline__ void simt_product(const T* __restrict__ x, const T* __restrict__ w,
                                             long M, int C, long m0, int nq, T* As, T* Bs,
                                             const RowOf& row_of, const ColsOf& cols_of,
                                             const Done& done) {
  constexpr int BN = kSimtTile / BM, TM = BM / 8, TN = BN / 32;
  constexpr int LD = simt_ld<T, KS>(), V = 16 / (int)sizeof(T), KV = KS / V;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nk = (C + KS - 1) / KS;
  auto stage = [&](int q) {
    const int k0 = (q % nk) * KS, c = q / nk, ncols = cols_of(c);
    const long wrow0 = row_of(c);
    T* a = As + (q % kSimtStages) * BM * LD;
    T* b = Bs + (q % kSimtStages) * BN * LD;
    for (int i = threadIdx.x; i < (BM + BN) * KV; i += blockDim.x) {
      const int r = i / KV, cc = (i - r * KV) * V;
      const bool kin = k0 + cc < C;
      if (r < BM) {
        const bool ok = kin && m0 + r < M;
        cp_async16(a + r * LD + cc, ok ? x + (m0 + r) * C + k0 + cc : x, ok);
      } else {
        const int n = r - BM;
        const bool ok = kin && n < ncols;
        cp_async16(b + n * LD + cc, ok ? w + (wrow0 + n) * C + k0 + cc : w, ok);
      }
    }
  };
  for (int q = 0; q < kSimtStages - 1; ++q) {
    if (q < nq) stage(q);
    cp_async_commit();
  }
  float acc[TM][TN];
  for (int q = 0; q < nq; ++q) {
    if (q % nk == 0) {
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
    }
    cp_async_wait<kSimtStages - 2>();
    __syncthreads();  // slab q has landed; slab q - 1's reads (and the last done) are over
    if (q + kSimtStages - 1 < nq) stage(q + kSimtStages - 1);
    cp_async_commit();
    const T* a = As + (q % kSimtStages) * BM * LD;
    const T* b = Bs + (q % kSimtStages) * BN * LD;
#pragma unroll
    for (int k4 = 0; k4 < KS; k4 += 4) {
      float4 av[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = ld4(a + (warp + 8 * i) * LD + k4);
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = ld4(b + (lane + 32 * j) * LD + k4);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          acc[i][j] = fmaf(av[i].x, bv[j].x, acc[i][j]);
          acc[i][j] = fmaf(av[i].y, bv[j].y, acc[i][j]);
          acc[i][j] = fmaf(av[i].z, bv[j].z, acc[i][j]);
          acc[i][j] = fmaf(av[i].w, bv[j].w, acc[i][j]);
        }
    }
    if (q % nk == nk - 1) done(q, acc);
  }
}

template <typename T, int BM>
__global__ void __launch_bounds__(256)
    expand_simt_kernel(const T* __restrict__ x, const T* __restrict__ w,
                       const float* __restrict__ ln_w, const float* __restrict__ ln_b,
                       T* __restrict__ out, long M, int H, int W, int C, int co) {
  constexpr int BN = kSimtTile / BM, TM = BM / 8, TN = BN / 32, LD = simt_ld<T, kSimtK3>();
  extern __shared__ float4 smem4[];
  T* As = reinterpret_cast<T*>(smem4);   // [stages][BM][LD]
  T* Bs = As + kSimtStages * BM * LD;    // [stages][BN][LD]
  float* part = reinterpret_cast<float*>(Bs + kSimtStages * BN * LD);  // [2][BM] row partials
  cg::cluster_group cluster = cg::this_cluster();
  const int ncl = gridDim.y / 4, rank = blockIdx.y % ncl, g = blockIdx.y / ncl;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long m0 = (long)blockIdx.x * BM;
  const int c0 = rank * BN, nk = (C + kSimtK3 - 1) / kSimtK3;
  auto done = [&](int, float(&acc)[TM][TN]) {
    // each row's sum over the cluster's columns, in rank order
    auto row_sums = [&](float(&v)[TM], float* buf) {
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        v[i] = warp_sum(v[i]);
        if (lane == 0) buf[warp + 8 * i] = v[i];
      }
      cluster.sync();
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        v[i] = 0.f;
        for (int r = 0; r < ncl; ++r) v[i] += cluster.map_shared_rank(buf, r)[warp + 8 * i];
      }
    };
    float mean[TM], q[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      mean[i] = 0.f;
#pragma unroll
      for (int j = 0; j < TN; ++j) mean[i] += c0 + lane + 32 * j < co ? acc[i][j] : 0.f;
    }
    row_sums(mean, part);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      mean[i] /= co;
      q[i] = 0.f;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const float d = acc[i][j] - mean[i];
        q[i] += c0 + lane + 32 * j < co ? d * d : 0.f;
      }
    }
    row_sums(q, part + BM);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const long m = m0 + warp + 8 * i;
      if (m >= M) continue;
      const float rstd = rsqrtf(q[i] / co + kLnEps);
      const int wq = (int)(m % W);
      const long bh = m / W;
      const int hq = (int)(bh % H);
      const long b = bh / H;
      T* o = out + ((b * 2 * H + 2 * hq + (g >> 1)) * (2L * W) + 2 * wq + (g & 1)) * co;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int col = c0 + lane + 32 * j;
        if (col < co) o[col] = from_f32<T>((acc[i][j] - mean[i]) * rstd * ln_w[col] + ln_b[col]);
      }
    }
    cluster.sync();  // every block has read the others' partials
  };
  simt_product<T, BM, kSimtK3>(
      x, w, M, C, m0, nk, As, Bs, [&](int) { return (long)g * co + c0; },
      [&](int) { return min(BN, co - c0); }, done);
}

template <typename T, int BM>
__global__ void __launch_bounds__(256)
    head_simt_kernel(const T* __restrict__ x, const T* __restrict__ w1,
                     const float* __restrict__ ln_w, const float* __restrict__ ln_b,
                     const float* __restrict__ seg_w, const float* __restrict__ seg_b,
                     T* __restrict__ out, long M, int C) {
  constexpr int BN = kSimtTile / BM, TM = BM / 8, TN = BN / 32, LD = simt_ld<T, kSimtK4>();
  extern __shared__ float4 smem4[];
  float* Es = reinterpret_cast<float*>(smem4);  // [BM][C]
  float* Ls = Es + (size_t)BM * C;              // [BM][spb]
  T* As = reinterpret_cast<T*>(Ls + BM * 16);   // [stages][BM][LD]
  T* Bs = As + kSimtStages * BM * LD;           // [stages][BN][LD]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long m0 = (long)blockIdx.x * BM;
  const int spb = 16 / gridDim.y, s0 = blockIdx.y * spb;
  const int nk = (C + kSimtK4 - 1) / kSimtK4, nchunk = (C + BN - 1) / BN;
  float cst = 0.f;  // sum ln_b seg_w + seg_b, by every warp in the same order
  for (int c = lane; c < C; c += 32) cst = fmaf(ln_b[c], seg_w[c], cst);
  cst = warp_sum(cst) + seg_b[0];
  auto done = [&](int q, float(&acc)[TM][TN]) {
    const int cq = q / nk, chunk = cq % nchunk;
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int col = chunk * BN + lane + 32 * j;
        if (col < C) Es[(warp + 8 * i) * C + col] = acc[i][j];
      }
    if (chunk != nchunk - 1) return;
    __syncthreads();  // the slot's columns are all in Es
    for (int r = warp; r < BM; r += 8) {
      const float* row = Es + (size_t)r * C;
      float mean, rstd;
      warp_row_stats(row, C, kLnEps, &mean, &rstd);
      float pu = 0.f;
      for (int c = lane; c < C; c += 32) pu = fmaf(row[c] - mean, ln_w[c] * seg_w[c], pu);
      pu = warp_sum(pu);
      if (lane == 0) Ls[r * spb + cq / nchunk] = rstd * pu + cst;
    }
  };
  simt_product<T, BM, kSimtK4>(
      x, w1, M, C, m0, spb * nchunk * nk, As, Bs,
      [&](int c) { return (long)(s0 + c / nchunk) * C + (c % nchunk) * BN; },
      [&](int c) { return min(BN, C - (c % nchunk) * BN); }, done);
  __syncthreads();
  for (int e = threadIdx.x; e < BM * spb; e += blockDim.x) {
    const long m = m0 + e / spb;
    if (m < M) out[m * 16 + s0 + e % spb] = from_f32<T>(Ls[e]);
  }
}

#define TRAMBA_SIMT_BM(BM, ...)                              \
  switch (BM) {                                              \
    case 64: { constexpr int kBM = 64; __VA_ARGS__; } break; \
    case 32: { constexpr int kBM = 32; __VA_ARGS__; } break; \
    default: { constexpr int kBM = 16; __VA_ARGS__; } break; \
  }

template <typename T>
int launch_simt(const ExpandPlan& p, bool head, const T* x, const T* w, const float* ln_w,
                const float* ln_b, const float* seg_w, const float* seg_b, T* out, long M, int H,
                int W, int C, int co, cudaStream_t s) {
  const dim3 grid((unsigned)p.tiles, p.sets);
  TRAMBA_SIMT_BM(p.rows, {
    if (head) {
      auto kern = head_simt_kernel<T, kBM>;
      cudaError_t e = allow_smem(kern, p.smem);
      if (e != cudaSuccess) return (int)e;
      kern<<<grid, 256, p.smem, s>>>(x, w, ln_w, ln_b, seg_w, seg_b, out, M, C);
    } else {
      auto kern = expand_simt_kernel<T, kBM>;
      cudaError_t e = allow_smem(kern, p.smem);
      if (e != cudaSuccess) return (int)e;
      cudaLaunchConfig_t cfg = {};
      cfg.gridDim = grid;
      cfg.blockDim = dim3(256, 1, 1);
      cfg.dynamicSmemBytes = p.smem;
      cfg.stream = s;
      cudaLaunchAttribute attr[1];
      attr[0].id = cudaLaunchAttributeClusterDimension;
      attr[0].val.clusterDim.x = 1;
      attr[0].val.clusterDim.y = p.sets / 4;  // a group's column chunks
      attr[0].val.clusterDim.z = 1;
      cfg.attrs = attr;
      cfg.numAttrs = 1;
      e = cudaLaunchKernelEx(&cfg, kern, x, w, ln_w, ln_b, out, M, H, W, C, co);
      if (e != cudaSuccess) return (int)e;
    }
  });
  TRAMBA_CHECK_LAUNCH();
  return 0;
}

template <typename Kern, typename... Args>
int launch_wgmma(Kern kern, const ExpandPlan& p, cudaStream_t s, Args... args) {
  cudaError_t e = allow_smem(kern, p.smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<dim3((unsigned)p.tiles, p.sets), 256, p.smem, s>>>(args...);
  TRAMBA_CHECK_LAUNCH();
  return 0;
}

static inline void write_plan(const ExpandPlan& p, int* plan) {
  plan[0] = p.route;
  plan[1] = p.rows;
  plan[2] = p.wn;
  plan[3] = p.split;
  plan[4] = p.gpb;
  plan[5] = p.sets;
  plan[6] = (int)p.tiles;
  plan[7] = p.stages;
  plan[8] = (int)p.smem;
}

}  // namespace

extern "C" {

// K3's plan at these shapes: plan[0..8] = route (0 wgmma, 1 SIMT), rows,
// wn, split, gpb, sets, tiles, stages, smem bytes; an error for shapes the
// kernel does not take.
int expand_ln_plan(int B, int H, int W, int C, int co, int bf16_io, int* plan) {
  ExpandPlan p;
  if (!plan_expand((long)B * H * W, C, co, bf16_io, &p)) return (int)cudaErrorInvalidValue;
  write_plan(p, plan);
  return 0;
}

// K4's plan, as expand_ln_plan's.
int final_head_plan(long M, int C, int bf16_io, int* plan) {
  ExpandPlan p;
  if (!plan_head(M, C, bf16_io, &p)) return (int)cudaErrorInvalidValue;
  write_plan(p, plan);
  return 0;
}

// K3.  x (B, H, W, C), w (4*co, C) and out (B, 2H, 2W, co) all fp32 (bf16 = 0)
// or all bf16 (bf16 = 1); ln_w, ln_b (co) fp32.  C % 4 == 0 (fp32) or
// C % 8 == 0 (bf16).  One launch.
int expand_ln_launch(const void* x, const void* w, const float* ln_w, const float* ln_b,
                     void* out, int B, int H, int W, int C, int co, int bf16_io, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long M = (long)B * H * W;
  ExpandPlan p;
  if (!plan_expand(M, C, co, bf16_io, &p)) return (int)cudaErrorInvalidValue;
  if (p.route == kRouteSimt) {
    if (bf16_io)
      return launch_simt(p, false, static_cast<const bf16*>(x), static_cast<const bf16*>(w), ln_w,
                         ln_b, nullptr, nullptr, static_cast<bf16*>(out), M, H, W, C, co, s);
    return launch_simt(p, false, static_cast<const float*>(x), static_cast<const float*>(w), ln_w,
                       ln_b, nullptr, nullptr, static_cast<float*>(out), M, H, W, C, co, s);
  }
  CUtensorMap map_x, map_w;
  const bf16* xb = static_cast<const bf16*>(x);
  if (!weight_map(&map_x, xb, M, C) || !weight_map(&map_w, static_cast<const bf16*>(w), 4L * co, C))
    return (int)cudaErrorInvalidValue;
  bf16* o = static_cast<bf16*>(out);
#define TRAMBA_EXPAND(WN, SPLIT)                                                                 \
  return launch_wgmma(expand_wgmma_kernel<WN, SPLIT>, p, s, map_x, map_w, ln_w, ln_b, o, M, H, W, \
                      C, co, p.gpb, p.stages)
  if (p.split) {
    if (p.wn == 192) TRAMBA_EXPAND(192, true);
    TRAMBA_EXPAND(256, true);
  }
  switch (p.wn) {
    case 64: TRAMBA_EXPAND(64, false);
    case 128: TRAMBA_EXPAND(128, false);
    case 192: TRAMBA_EXPAND(192, false);
    default: TRAMBA_EXPAND(256, false);
  }
#undef TRAMBA_EXPAND
}

// K4.  x (M, C) with M = B*h*w, w1 (16*C, C) and out (M, 16) all fp32
// (bf16 = 0) or all bf16 (bf16 = 1); ln_w, ln_b, seg_w (C), seg_b (1) fp32.
// C % 4 == 0 (fp32) or C % 8 == 0 (bf16).  One launch.
int final_head_launch(const void* x, const void* w1, const float* ln_w, const float* ln_b,
                      const float* seg_w, const float* seg_b, void* out, long M, int C,
                      int bf16_io, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  ExpandPlan p;
  if (!plan_head(M, C, bf16_io, &p)) return (int)cudaErrorInvalidValue;
  if (p.route == kRouteSimt) {
    if (bf16_io)
      return launch_simt(p, true, static_cast<const bf16*>(x), static_cast<const bf16*>(w1), ln_w,
                         ln_b, seg_w, seg_b, static_cast<bf16*>(out), M, 1, 1, C, C, s);
    return launch_simt(p, true, static_cast<const float*>(x), static_cast<const float*>(w1), ln_w,
                       ln_b, seg_w, seg_b, static_cast<float*>(out), M, 1, 1, C, C, s);
  }
  CUtensorMap map_x, map_w;
  if (!weight_map(&map_x, static_cast<const bf16*>(x), M, C) ||
      !weight_map(&map_w, static_cast<const bf16*>(w1), 16L * C, C))
    return (int)cudaErrorInvalidValue;
  bf16* o = static_cast<bf16*>(out);
#define TRAMBA_HEAD(WN, SPLIT) \
  return launch_wgmma(head_wgmma_kernel<WN, SPLIT>, p, s, map_x, map_w, ln_w, ln_b, seg_w, seg_b, \
                      o, M, C, p.stages)
  if (p.split) TRAMBA_HEAD(128, true);
  if (p.wn == 64) TRAMBA_HEAD(64, false);
  TRAMBA_HEAD(128, false);
#undef TRAMBA_HEAD
}

}  // extern "C"
