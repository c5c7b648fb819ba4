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
// K12 is one launch (sra_kernel, below): each block normalises its own rows
// (no LayerNorm launch, no round trip of the LN'd rows or of q) and runs the
// q projection, the scores, p v and the output projection on wgmma, the
// scores and probabilities in registers.  What bounds it on an H100: at the
// 96 px and 48 px stages its bytes (x read and out written once: 4 C bytes
// a row, against 4 C^2 + 4 Lk C operations), at 24 px and 12 px the
// products on the bf16 tensor cores; both bounds are microseconds at B16, so
// what decides its time is latency: the chain of each head's four products
// and its softmax inside a block, and how many blocks run at once.  The
// design's answers:
//   * rows a block by stage: 128 (two warpgroups) up to C 192, so that the
//     image's k and v boxes (144 keys x 64 = 18 KB each a head) are staged
//     once for twice the rows; 64 above, where the LN'd rows and the merged
//     heads of 128 rows would not fit;
//   * filling 132 SMs at 48, 24 and 12 px (288, 144 and 36 row tiles at
//     B16): a thread block cluster per row tile whose blocks split the
//     heads (2, 5 and 8 blocks at those stages); each
//     then reads the others' merged head outputs through distributed shared
//     memory and writes its own slice of the output projection's columns;
//     the cluster size comes from a cost in whole waves (plan_sra);
//   * keys beyond what registers hold: up to 4 key tiles of 64 (256 keys)
//     in one pass; more take two passes over key chunks inside the launch,
//     so every key count runs;
//   * widths a block cannot hold (C above 768, heads above 128 wide, or
//     padded heads over 227 KB; no PVTv2 model has one): the wide route
//     (three SIMT launches, below), so K12 takes every shape its earlier
//     three-launch version took;
//   * registers: the scores of 3-4 key tiles, q's and p's fragments and the
//     head's output are live at once, so a thread gets 232 (__maxnreg__),
//     and a block has no producer warp (a ninth warp would put three warps
//     on one SM sub-partition, over its 16K registers): thread 0 refills
//     the ring as the warps release its slots.
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

#include <cooperative_groups.h>

namespace cg = cooperative_groups;

namespace {

constexpr size_t kSmemMax = 227 * 1024;

// ---- K12: one launch ----------------------------------------------------------
//
// One block per (image, tile of R = 64 nwg query rows, head group); the
// blocks of one row tile that split its heads form a thread block cluster
// (plan_sra: `cluster` blocks, a divisor of nh up to 8, chosen so that the
// grid fills the SMs in whole waves).  nwg warpgroups of 64 rows each; the
// block's first thread also issues every TMA copy: first the block's rows
// of x into As (64 x 64 boxes in the 128-byte swizzle, zeros past C and
// past the last row), then every other operand box through one ring of
// `stages` 8 KB slots (full / empty mbarriers; a slot is refilled as soon
// as every warp has released it), in the order the warps take them:
//   per own head h: the head's rows of wq (NQ 64-row boxes a K-block of x),
//   [in two passes: every key tile of k_h], then key chunk by key chunk the
//   chunk's tiles of k_h and of v_h (3-D boxes of 64 keys x 64 head columns,
//   zeros past Lk); then the output projection's boxes of wp (the block's
//   own 64-column output chunks, a box a K-block of the merged heads).
// Shared memory (1024-aligned after the mbarriers):
//   As [Cp / 64][R][64] the block's rows of x, normalised in place (two
//      threads a row, fp32 statistics, one rounding), 128-byte swizzle: the
//      q projection's A;
//   Os [Cq / 64][R][64] the merged head outputs, the same layout: the output
//      projection's A (head h at K-blocks h NQ .. h NQ + NQ - 1).  Where a
//      block has one head and Cq = Cp, Os is As: its q is computed before
//      any head output is written;
//   ring `stages` boxes.
// A warpgroup's chain for its 64 rows, per own head, all of it on wgmma:
//   q_h = As wq_h^T (m64n64k16, A and B in shared memory), then + bq, x the
//   scale, one rounding, packed straight into A fragments (qf: the
//   accumulator layout of a 64 x 64 tile is that of four k16 A fragments);
//   S = q_h k_h^T with A from registers (KT key tiles of 64 in registers,
//   keys from Lk on -inf); the softmax on the accumulator fragments (a row's
//   64 KT scores lie in the four lanes of a quad: two shuffles), p =
//   bf16(e / sum) packed as A fragments; O_h = P v_h with A from registers
//   and v_h's box as the N-major B; one rounding of O_h into Os.
// Keys beyond the KT tiles a thread holds (Lk > 64 KT) take two passes over
// key chunks of KT tiles: the first finds each row's max and sum (rescaled
// from chunk to chunk), the second recomputes the scores and rounds p =
// bf16(exp(s - max) / sum) as the one-pass route does.
// With a cluster, after its heads each block reads the other blocks' head
// outputs of its rows from their Os through distributed shared memory; then
// out = Os wp^T + bp for its own output chunks, one rounding, stored from
// the accumulators.
constexpr int kSraRing = 8;  // most ring slots

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// d (+)= A B, m64n64k16, A from registers (a: this warp's m16n8k16 A
// fragment of 16 rows, packed bf16 pairs) and B from shared memory
// (descriptor b: K-major, or N-major with TRANS_B), d as wgmma_m64n64k16's.
template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], const unsigned (&a)[4],
                                                   uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d), "n"(TRANS_B));
}

// Keeps the compiler from changing registers that an asynchronous wgmma
// reads (its A fragments) before the wgmma has completed.
template <int N>
__device__ __forceinline__ void fence_uregs(unsigned (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(bar);
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(s) : "memory");
}

// TMA: the box at (c0, c1, c2) of the 3-D tensor map `map` into shared
// memory, counted on `bar`; elements outside the tensor arrive as zeros.
__device__ __forceinline__ void tma_load_3d(void* smem, const void* map, int c0, int c1, int c2,
                                            uint64_t* bar) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  const unsigned b = (unsigned)__cvta_generic_to_shared(bar);
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(s),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(b)
      : "memory");
}

// Barrier `id` (1-15) over `threads` threads of the block.
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Tensor map of k or v (B nh, Lk, hdp) bf16 as 64 keys x 64 head columns of
// one head, 128-byte swizzle, zeros past Lk.
static inline bool kv_map(CUtensorMap* map, const bf16* t, int hdp, int Lk, long heads) {
  const EncodeTiledFn encode = encode_tiled();
  if (!encode) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)hdp, (cuuint64_t)Lk, (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)hdp * 2, (cuuint64_t)Lk * hdp * 2};
  const cuuint32_t box[3] = {64, 64, 1}, elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<bf16*>(t), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

// Tiling of one K12 launch.
struct SraPlan {
  int nq;       // head width in 64-column chunks (hd padded to 64 nq)
  int nwg;      // consumer warpgroups a block (64 query rows each)
  int rows;     // query rows a block: 64 nwg
  int cluster;  // blocks a row tile (its heads split over them)
  int tiles;    // row tiles an image
  int kt;       // key tiles of 64 a thread holds in registers
  int chunks;   // key chunks of kt tiles: 1 = one pass, else two
  int stages;   // ring slots
  int alias;    // 1 where Os is As
  int per_sm;   // blocks an SM (0 on the wide route)
  size_t smem;
  long blocks;
  int wide;     // 1: the wide route's three launches (below)
  int keys;     // keys a chunk
};

constexpr size_t kSmemHalf = 113 * 1024;  // two blocks an SM below this

// Shared bytes of a K12 block without its ring: the mbarriers and
// alignment, As, and Os unless it is As.
static size_t sra_fixed(int rows, int Cp, int Cq, bool alias) {
  return 1024 + (size_t)2 * rows * (Cp + (alias ? 0 : Cq));
}

static bool plan_sra_fast(int B, int N, int C, int nh, int Lk, int sms, SraPlan* p) {
  if (C > 768) return false;
  const int hdp = (C / nh + 63) / 64 * 64;
  p->nq = hdp / 64;
  if (p->nq > 2) return false;
  const int Cp = (C + 63) / 64 * 64, Cq = nh * hdp, ktiles = (Lk + 63) / 64;
  const size_t slot = (size_t)kBox * 2;
  const int least = std::max(2, p->nq + 1);  // ring slots: a key tile's boxes and one more
  // two warpgroups (128 rows, one block an SM) up to C 192 with 64-wide
  // heads where their tiles fit; else one (two blocks an SM where they fit)
  p->nwg = C <= 192 && p->nq == 1 && sra_fixed(128, Cp, Cq, false) + least * slot <= kSmemMax
               ? 2 : 1;
  p->rows = 64 * p->nwg;
  p->tiles = (N + p->rows - 1) / p->rows;
  const int kt_max = std::min(ktiles, p->nq == 1 ? 4 : 2);
  // per cluster size d (a divisor of nh up to 8): its blocks an SM, and the
  // waves of blocks per unit of work, ceil(tiles d / (sms per_sm)) / d; the
  // cheapest, the smallest such d
  bool found = false;
  double best = 0.0;
  for (int d = 1; d <= 8 && d <= nh; ++d) {
    if (nh % d) continue;
    const bool alias = d == nh && Cq == Cp;
    const size_t fixed = sra_fixed(p->rows, Cp, Cq, alias);
    if (fixed + least * slot > kSmemMax) continue;
    const bool two = p->nwg == 1 && fixed + (size_t)(kt_max * p->nq + 1) * slot <= kSmemHalf;
    const size_t budget = two ? kSmemHalf : kSmemMax;
    const int per_sm = two ? 2 : 1;
    const long slots = (long)sms * per_sm, blocks = (long)B * p->tiles * d;
    const double cost = (double)((blocks + slots - 1) / slots) / d;
    if (found && cost >= best) continue;
    found = true;
    best = cost;
    p->cluster = d;
    p->alias = alias;
    p->per_sm = per_sm;
    p->stages = (int)std::min<size_t>(kSraRing, (budget - fixed) / slot);
    p->smem = fixed + (size_t)p->stages * slot;
  }
  if (!found) return false;
  p->kt = kt_max;
  while (p->kt > 1 && p->stages < p->kt * p->nq + 1) --p->kt;
  p->chunks = (ktiles + p->kt - 1) / p->kt;
  p->blocks = (long)B * p->tiles * p->cluster;
  p->wide = 0;
  p->keys = 64 * p->kt;
  return p->blocks <= 0x7fffffffL;
}

// Every thread of every block of the cluster arrives, then waits: the
// shared-memory writes before it are seen by the cluster's reads after it.
__device__ __forceinline__ void cluster_sync_all() {
  asm volatile("barrier.cluster.arrive.release;\nbarrier.cluster.wait.acquire;\n" ::: "memory");
}

// The ring of operand boxes: box i of the block's schedule sits in slot i %
// stages.  The schedule, in the order the warps take the boxes: per own
// head h (rank, rank + cluster, ...), its rows of wq (nq 64-row boxes a
// K-block of x), [with two passes: every key tile of k_h], then key chunk by
// key chunk its tiles of k_h and of v_h; then wp's boxes of the block's
// output chunks.  Thread 0 issues the first `stages` boxes, then box i +
// stages as soon as every warp has released box i.
struct SraRing {
  bf16* base;
  uint64_t* full;
  uint64_t* empty;
  int stages;
  const CUtensorMap *wq, *k, *v, *wp;
  int nq, kt, nh, cluster, rank, b, nkc, nkq, ntiles, chunks, head_boxes, own_heads, total;

  __device__ __forceinline__ const bf16* box(int i) const {
    return base + (size_t)(i % stages) * kBox;
  }
  __device__ __forceinline__ void wait(int i) const {
    mbar_wait(full + i % stages, (i / stages) & 1);
  }
  __device__ __forceinline__ void issue(int i) const {
    bf16* dst = base + (size_t)(i % stages) * kBox;
    uint64_t* bar = full + i % stages;
    mbar_expect_tx(bar, kBox * 2);
    if (i >= own_heads * head_boxes) {  // wp
      const int w = i - own_heads * head_boxes;
      tma_load_2d(dst, wp, 64 * (w % nkq), 64 * (rank + w / nkq * cluster), bar);
      return;
    }
    const int h = rank + i / head_boxes * cluster, bh = b * nh + h;
    int r = i % head_boxes;
    if (r < nq * nkc) {
      tma_load_2d(dst, wq, 64 * (r % nkc), 64 * (h * nq + r / nkc), bar);
      return;
    }
    r -= nq * nkc;
    if (chunks > 1) {
      if (r < ntiles * nq) {
        tma_load_3d(dst, k, 64 * (r % nq), 64 * (r / nq), bh, bar);
        return;
      }
      r -= ntiles * nq;
    }
    const int ch = r / (2 * kt * nq), nt = min(kt, ntiles - ch * kt);
    r -= ch * 2 * kt * nq;
    const bool is_v = r >= nt * nq;
    if (is_v) r -= nt * nq;
    tma_load_3d(dst, is_v ? v : k, 64 * (r % nq), 64 * (ch * kt + r / nq), bh, bar);
  }
  // after the warp's wgmmas that read box i have completed
  __device__ __forceinline__ void release(int i, int lane) const {
    if (lane == 0) mbar_arrive(empty + i % stages);
    if (threadIdx.x == 0 && i + stages < total) {
      mbar_wait(empty + i % stages, (i / stages) & 1);
      issue(i + stages);
    }
  }
};

// acc = A B^T over nk K-blocks: A this warpgroup's 64 rows of a [nk][R][64]
// tile (rows 64 wg ..), B the ring's boxes t .. t + nk - 1.
__device__ __forceinline__ void sra_ring_product(float (&acc)[32], const SraRing& rg, int& t,
                                                 const bf16* A, int nk, int R, int wg, int lane) {
  for (int kb = 0; kb < nk; ++kb) {
    rg.wait(t);
    const bf16* tl = rg.box(t);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < 4; ++s)
      wgmma_m64n64k16(acc, wgmma_desc_sw128(A + (size_t)kb * R * 64 + wg * kBox + 16 * s),
                      wgmma_desc_sw128(tl + 16 * s), kb > 0 || s > 0);
    wgmma_commit();
    if (kb > 0) {
      wgmma_wait<1>();
      rg.release(t - 1, lane);
    }
    ++t;
  }
  wgmma_wait<0>();
  rg.release(t - 1, lane);
  fence_regs(acc);
}

// S = q_h k^T over key tiles j0 .. j0 + nt (nt <= KT) from the ring's next
// nt NQ boxes (tile j, head columns 64 c: box t + j NQ + c); keys from Lk on
// get -inf.  Returns nt.
template <int NQ, int KT>
__device__ __forceinline__ int sra_scores(float (&S)[KT][32], unsigned (&qf)[NQ][4][4],
                                          const SraRing& rg, int& t, int j0, int ntiles, int Lk,
                                          int t4, int lane) {
  const int nt = min(KT, ntiles - j0);
  for (int i = 0; i < nt * NQ; ++i) rg.wait(t + i);
#pragma unroll
  for (int j = 0; j < KT; ++j) fence_regs(S[j]);
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < KT; ++j) {
    if (j >= nt) continue;
#pragma unroll
    for (int c = 0; c < NQ; ++c)
#pragma unroll
      for (int s = 0; s < 4; ++s)
        wgmma_m64n64k16_rs<0>(S[j], qf[c][s], wgmma_desc_sw128(rg.box(t + j * NQ + c) + 16 * s),
                              c > 0 || s > 0);
  }
  wgmma_commit();
  wgmma_wait<0>();
#pragma unroll
  for (int j = 0; j < KT; ++j) fence_regs(S[j]);
#pragma unroll
  for (int c = 0; c < NQ; ++c)
#pragma unroll
    for (int s = 0; s < 4; ++s) fence_uregs(qf[c][s]);
  for (int i = 0; i < nt * NQ; ++i) rg.release(t + i, lane);
  t += nt * NQ;
#pragma unroll
  for (int j = 0; j < KT; ++j) {
    if (j >= nt || 64 * (j0 + j + 1) <= Lk) continue;
#pragma unroll
    for (int i = 0; i < 32; ++i)
      if (64 * (j0 + j) + 8 * (i >> 2) + 2 * t4 + (i & 1) >= Lk) S[j][i] = -INFINITY;
  }
  return nt;
}

// The running max and sum of this thread's two rows (g, g + 8) over the
// chunk's scores S (nt of KT tiles; exp'd in place where `keep`).
template <int KT>
__device__ __forceinline__ void sra_row_stats(float (&S)[KT][32], int nt, bool keep, float& m0,
                                              float& m1, float& l0, float& l1) {
  float c0 = -INFINITY, c1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < KT; ++j) {
    if (j >= nt) continue;
#pragma unroll
    for (int i = 0; i < 32; i += 4) {
      c0 = fmaxf(c0, fmaxf(S[j][i], S[j][i + 1]));
      c1 = fmaxf(c1, fmaxf(S[j][i + 2], S[j][i + 3]));
    }
  }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    c0 = fmaxf(c0, __shfl_xor_sync(0xffffffffu, c0, o));
    c1 = fmaxf(c1, __shfl_xor_sync(0xffffffffu, c1, o));
  }
  const float n0 = fmaxf(m0, c0), n1 = fmaxf(m1, c1);
  float s0 = 0.f, s1 = 0.f;
#pragma unroll
  for (int j = 0; j < KT; ++j) {
    if (j >= nt) continue;
#pragma unroll
    for (int i = 0; i < 32; i += 4) {
      const float e0 = expf(S[j][i] - n0), e1 = expf(S[j][i + 1] - n0);
      const float e2 = expf(S[j][i + 2] - n1), e3 = expf(S[j][i + 3] - n1);
      s0 += e0 + e1;
      s1 += e2 + e3;
      if (keep) {
        S[j][i] = e0;
        S[j][i + 1] = e1;
        S[j][i + 2] = e2;
        S[j][i + 3] = e3;
      }
    }
  }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    s0 += __shfl_xor_sync(0xffffffffu, s0, o);
    s1 += __shfl_xor_sync(0xffffffffu, s1, o);
  }
  l0 = l0 * expf(m0 - n0) + s0;  // exp(-inf) = 0 before the first chunk
  l1 = l1 * expf(m1 - n1) + s1;
  m0 = n0;
  m1 = n1;
}

// y = bf16((x - mean) rstd ln_w + ln_b) of the 8 values of one 16-byte group
// (columns 8 j ..), in place.
__device__ __forceinline__ void ln_group(uint4& raw, int j, float mean, float rstd,
                                         const float* __restrict__ ln_w,
                                         const float* __restrict__ ln_b) {
  __nv_bfloat162* v = reinterpret_cast<__nv_bfloat162*>(&raw);
  const float4 w0 = __ldg(reinterpret_cast<const float4*>(ln_w) + 2 * j);
  const float4 w1 = __ldg(reinterpret_cast<const float4*>(ln_w) + 2 * j + 1);
  const float4 b0 = __ldg(reinterpret_cast<const float4*>(ln_b) + 2 * j);
  const float4 b1 = __ldg(reinterpret_cast<const float4*>(ln_b) + 2 * j + 1);
  const float w[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
  const float bb[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(v[e]);
    v[e] = __floats2bfloat162_rn((f.x - mean) * rstd * w[2 * e] + bb[2 * e],
                                 (f.y - mean) * rstd * w[2 * e + 1] + bb[2 * e + 1]);
  }
}

// The sum of the 8 values of a 16-byte group, and with `mean` given the sum
// of their squared deviations from it.
__device__ __forceinline__ float group_sum(const uint4& raw) {
  const __nv_bfloat162* v = reinterpret_cast<const __nv_bfloat162*>(&raw);
  float s = 0.f;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(v[e]);
    s += f.x + f.y;
  }
  return s;
}
__device__ __forceinline__ float group_sq(const uint4& raw, float mean) {
  const __nv_bfloat162* v = reinterpret_cast<const __nv_bfloat162*>(&raw);
  float q = 0.f;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(v[e]);
    q = fmaf(f.x - mean, f.x - mean, q);
    q = fmaf(f.y - mean, f.y - mean, q);
  }
  return q;
}

// bf16(LN(x) ln_w + ln_b) in place of the block's R rows of x in As (fp32
// statistics in two passes over shared memory, eps): two threads a row, each
// every other 16-byte group of it; columns past C stay zero.
__device__ __forceinline__ void sra_ln_in_place(bf16* As, int R, int C,
                                                const float* __restrict__ ln_w,
                                                const float* __restrict__ ln_b, float eps) {
  const int r = threadIdx.x >> 1, half = threadIdx.x & 1, groups = C / 8;
  if (r >= R) return;
  auto group = [&](int j) { return reinterpret_cast<uint4*>(As + sw128_offset(r, 8 * j, R)); };
  float s = 0.f;
  for (int j = half; j < groups; j += 2) s += group_sum(*group(j));
  const float mean = (s + __shfl_xor_sync(0xffffffffu, s, 1)) / C;
  float q = 0.f;
  for (int j = half; j < groups; j += 2) q += group_sq(*group(j), mean);
  const float rstd = rsqrtf((q + __shfl_xor_sync(0xffffffffu, q, 1)) / C + eps);
  for (int j = half; j < groups; j += 2) {
    uint4 raw = *group(j);
    ln_group(raw, j, mean, rstd, ln_w, ln_b);
    *group(j) = raw;
  }
}

// The consumer warpgroups' part of sra_kernel (see there).
template <int NQ, int KT, int NWG>
__device__ __forceinline__ void sra_consumer(bf16* As, bf16* Os, const SraRing rg,
                                             uint64_t* xfull, const float* __restrict__ ln_w,
                                             const float* __restrict__ ln_b,
                                             const float* __restrict__ bq,
                                             const float* __restrict__ bp, bf16* __restrict__ out,
                                             int N, int C, int nh, int Lk, int cluster,
                                             int chunks, float scale, float eps, int rank, int b,
                                             long q0, int n_wp) {
  constexpr int HDP = 64 * NQ, R = 64 * NWG;
  const int Cp = (C + 63) & ~63, nkc = Cp / 64, nkq = nh * NQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ntiles = (Lk + 63) / 64;

  // the block's rows of x, normalised in place
  mbar_wait(xfull, 0);
  sra_ln_in_place(As, R, C, ln_w, ln_b, eps);
  fence_proxy_async();
  named_sync(1, 128 * NWG);

  const int wg = warp >> 2, g = lane >> 2, t4 = lane & 3;
  const int wrow = 16 * (warp & 3) + g;  // rows wrow, wrow + 8 of the warpgroup's 64
  int t = 0;  // the ring's box counter, in the schedule's order
  float acc[32];
  for (int h = rank; h < nh; h += cluster) {
    // q_h, rounded once, as A fragments: qf[c][s] covers head columns 64 c + 16 s
    unsigned qf[NQ][4][4];
#pragma unroll
    for (int c = 0; c < NQ; ++c) {
      sra_ring_product(acc, rg, t, As, nkc, R, wg, lane);
#pragma unroll
      for (int s = 0; s < 4; ++s)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 8 * s + 2 * e, col = h * HDP + 64 * c + 8 * (i >> 2) + 2 * t4;
          qf[c][s][e] =
              pack_bf16((acc[i] + bq[col]) * scale, (acc[i + 1] + bq[col + 1]) * scale);
        }
    }
    float S[KT][32];
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
    int nt = 0;
    for (int ch = 0; ch < chunks; ++ch) {  // pass 1: each row's max and sum
      nt = sra_scores<NQ, KT>(S, qf, rg, t, ch * KT, ntiles, Lk, t4, lane);
      sra_row_stats<KT>(S, nt, chunks == 1, m0, m1, l0, l1);
    }
    const float inv0 = 1.f / l0, inv1 = 1.f / l1;
    float O[NQ][32];
    for (int ch = 0; ch < chunks; ++ch) {  // pass 2 (one pass: S holds e already)
      if (chunks > 1) {
        nt = sra_scores<NQ, KT>(S, qf, rg, t, ch * KT, ntiles, Lk, t4, lane);
#pragma unroll
        for (int j = 0; j < KT; ++j)
#pragma unroll
          for (int i = 0; i < 32; i += 4) {
            S[j][i] = expf(S[j][i] - m0);
            S[j][i + 1] = expf(S[j][i + 1] - m0);
            S[j][i + 2] = expf(S[j][i + 2] - m1);
            S[j][i + 3] = expf(S[j][i + 3] - m1);
          }
      }
      // p = bf16(e / sum) as A fragments (P[j][s]: keys 64 (j0 + j) + 16 s),
      // packed a key tile at a time just before its products, each tile's
      // fragments kept until its products are done (one tile in flight)
      for (int i = 0; i < nt * NQ; ++i) rg.wait(t + i);
      unsigned P[KT][4][4];
#pragma unroll
      for (int j = 0; j < KT; ++j) {
        if (j >= nt) continue;
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          P[j][s][0] = pack_bf16(S[j][8 * s] * inv0, S[j][8 * s + 1] * inv0);
          P[j][s][1] = pack_bf16(S[j][8 * s + 2] * inv1, S[j][8 * s + 3] * inv1);
          P[j][s][2] = pack_bf16(S[j][8 * s + 4] * inv0, S[j][8 * s + 5] * inv0);
          P[j][s][3] = pack_bf16(S[j][8 * s + 6] * inv1, S[j][8 * s + 7] * inv1);
        }
#pragma unroll
        for (int c = 0; c < NQ; ++c) fence_regs(O[c]);
        wgmma_fence();
#pragma unroll
        for (int s = 0; s < 4; ++s)
#pragma unroll
          for (int c = 0; c < NQ; ++c)
            wgmma_m64n64k16_rs<1>(O[c], P[j][s],
                                  wgmma_desc_sw128(rg.box(t + j * NQ + c) + 1024 * s),
                                  ch > 0 || j > 0 || s > 0);
        wgmma_commit();
        if (j > 0) {
          wgmma_wait<1>();
#pragma unroll
          for (int s = 0; s < 4; ++s) fence_uregs(P[j - 1][s]);
        }
      }
      wgmma_wait<0>();
#pragma unroll
      for (int c = 0; c < NQ; ++c) fence_regs(O[c]);
#pragma unroll
      for (int j = 0; j < KT; ++j)
        if (j == nt - 1)
#pragma unroll
          for (int s = 0; s < 4; ++s) fence_uregs(P[j][s]);
      for (int i = 0; i < nt * NQ; ++i) rg.release(t + i, lane);
      t += nt * NQ;
    }
    // the head's output, rounded once, into its columns of the merged rows
#pragma unroll
    for (int c = 0; c < NQ; ++c)
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int row = 64 * wg + wrow + 8 * ((i >> 1) & 1);
        const int col = h * HDP + 64 * c + 8 * (i >> 2) + 2 * t4;
        *reinterpret_cast<__nv_bfloat162*>(Os + sw128_offset(row, col, R)) =
            __floats2bfloat162_rn(O[c][i], O[c][i + 1]);
      }
  }

  if (cluster > 1) {  // the other blocks' heads of this warpgroup's rows
    cluster_sync_all();
    cg::cluster_group cl = cg::this_cluster();
    for (int h = 0; h < nh; ++h) {
      if (h % cluster == rank) continue;
      const bf16* src = cl.map_shared_rank(Os, h % cluster);
      for (int c = 0; c < NQ; ++c) {  // the 64 x 64 box, all its loads in flight at once
        const size_t off = (size_t)(h * NQ + c) * R * 64 + wg * kBox;
        uint4 v[kBox / 8 / 128];
#pragma unroll
        for (int k = 0; k < kBox / 8 / 128; ++k)
          v[k] = reinterpret_cast<const uint4*>(src + off)[(tid & 127) + 128 * k];
#pragma unroll
        for (int k = 0; k < kBox / 8 / 128; ++k)
          reinterpret_cast<uint4*>(Os + off)[(tid & 127) + 128 * k] = v[k];
      }
    }
  }
  fence_proxy_async();
  named_sync(2 + wg, 128);

  // out = Os wp^T + bp for the block's output chunks, one rounding, stored
  // from the accumulators
  for (int i = 0; i < n_wp / nkq; ++i) {
    const int oc = rank + i * cluster;
    sra_ring_product(acc, rg, t, Os, nkq, R, wg, lane);
#pragma unroll
    for (int k = 0; k < 32; k += 2) {
      const long row = q0 + 64 * wg + wrow + 8 * ((k >> 1) & 1);
      const int col = 64 * oc + 8 * (k >> 2) + 2 * t4;
      if (row < N && col < C)
        *reinterpret_cast<__nv_bfloat162*>(out + ((long)b * N + row) * C + col) =
            __floats2bfloat162_rn(acc[k] + bp[col], acc[k + 1] + bp[col + 1]);
    }
  }
  if (cluster > 1) cluster_sync_all();  // no block leaves while another reads its Os
}

// The block: every thread computes; thread 0 also issues the copies
// (SraRing), the block's rows of x into As first.  232 registers a thread:
// two warps an SM sub-partition (one block of two warpgroups, or two blocks
// of one, an SM).
template <int NQ, int KT, int NWG>
__global__ void __maxnreg__(232)
    sra_kernel(const __grid_constant__ CUtensorMap map_x,
               const __grid_constant__ CUtensorMap map_wq,
               const __grid_constant__ CUtensorMap map_k,
               const __grid_constant__ CUtensorMap map_v,
               const __grid_constant__ CUtensorMap map_wp, const float* __restrict__ ln_w,
               const float* __restrict__ ln_b, const float* __restrict__ bq,
               const float* __restrict__ bp, bf16* __restrict__ out, int N, int C, int nh, int Lk,
               int cluster, int stages, int chunks, int alias, float scale, float eps) {
  constexpr int R = 64 * NWG;
  extern __shared__ float4 smem4[];
  const int Cp = (C + 63) & ~63, nkc = Cp / 64, nkq = nh * NQ;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem4);
  uint64_t* empty = full + kSraRing;
  uint64_t* xfull = empty + kSraRing;
  bf16* As = tiles_start(smem4, (2 * kSraRing + 1) * 8);
  bf16* Os = alias ? As : As + (size_t)R * Cp;
  bf16* ring = (alias ? As + (size_t)R * Cp : Os + (size_t)R * nkq * 64);
  const int rank = blockIdx.x % cluster, b = blockIdx.y;
  const long q0 = (long)(blockIdx.x / cluster) * R;  // the tile's first query row in the image
  const int ntiles = (Lk + 63) / 64, noc = (C + 63) / 64;
  const int n_wp = (noc - rank + cluster - 1) / cluster * nkq;  // wp boxes of this block
  const int head_boxes = NQ * nkc + (chunks > 1 ? ntiles * NQ : 0) + 2 * ntiles * NQ;
  const int own_heads = nh / cluster;
  const SraRing rg{ring, full, empty, stages, &map_wq, &map_k, &map_v, &map_wp, NQ, KT, nh,
                   cluster, rank, b, nkc, nkq, ntiles, chunks, head_boxes, own_heads,
                   own_heads * head_boxes + n_wp};
  if (threadIdx.x == 0) {
    for (int i = 0; i < stages; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, 4 * NWG);
    }
    mbar_init(xfull, 1);
    mbar_init_fence();
    mbar_expect_tx(xfull, nkc * NWG * kBox * 2);  // x's rows (zeros past the last)
    for (int kb = 0; kb < nkc; ++kb)
      for (int w = 0; w < NWG; ++w)
        tma_load_2d(As + (size_t)kb * R * 64 + w * kBox, &map_x, 64 * kb,
                    (int)((long)b * N + q0 + 64 * w), xfull);
    for (int i = 0; i < min(stages, rg.total); ++i) rg.issue(i);
  }
  __syncthreads();
  sra_consumer<NQ, KT, NWG>(As, Os, rg, xfull, ln_w, ln_b, bq, bp, out, N, C, nh, Lk, cluster,
                            chunks, scale, eps, rank, b, q0, n_wp);
}

// One launch of K12's kernel for NQ, KT and NWG with plan p (a cluster of
// p.cluster blocks along x).
template <int NQ, int KT, int NWG>
static int launch_sra(const SraPlan& p, const CUtensorMap& map_x, const CUtensorMap& map_wq,
                      const CUtensorMap& map_k, const CUtensorMap& map_v,
                      const CUtensorMap& map_wp, const float* ln_w, const float* ln_b,
                      const float* bq, const float* bp, bf16* out, int B, int N, int C, int nh,
                      int Lk, float scale, float eps, cudaStream_t s) {
  auto kern = sra_kernel<NQ, KT, NWG>;
  cudaError_t e = allow_smem(kern, p.smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(p.tiles * p.cluster), (unsigned)B, 1);
  cfg.blockDim = dim3(128 * NWG, 1, 1);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kern, map_x, map_wq, map_k, map_v, map_wp, ln_w, ln_b, bq, bp,
                         out, N, C, nh, Lk, p.cluster, p.stages, p.chunks, p.alias, scale, eps);
  return (int)e;
}

static bool sm_count(int* sms) {
  static int n = 0;
  int dev = 0;
  if (n == 0 && (cudaGetDevice(&dev) != cudaSuccess ||
                 cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess))
    return false;
  *sms = n;
  return true;
}

// ---- K12's wide route ----------------------------------------------------------
//
// Shapes the one-launch kernel's block cannot hold (C above 768, heads
// wider than 128, or padded heads whose merged tile overflows 227 KB; no
// PVTv2 model has one) run three launches of plain SIMT code instead, with
// the same rounding points:
//   (w1) sra_wide_gemm_kernel<true>: q = bf16((bf16(LN(x)) wq^T + bq) scale)
//        into a (B N, C) bf16 scratch;
//   (w2) sra_wide_attn_kernel: per (16 query rows, head, image) the two key
//        passes of the one-launch kernel over chunks of `keys` keys (the
//        first: each row's running max and sum; the second: the scores
//        again, p = bf16(exp(s - max) / sum), O_h += p v_h), then bf16(O_h)
//        written over the block's own q_h in the scratch;
//   (w3) sra_wide_gemm_kernel<false>: out = bf16(O wp^T + bp).
// Heads keep their width (no padding); the keys a chunk are the most of 64,
// 32, 16, 8 whose working set fits one block (sra_wide_smem).
constexpr int kWideTile = 64;   // (w1) / (w3): a block's 64 x 64 output tile
constexpr int kWideK = 32;      // and its K step
constexpr int kWideRows = 16;   // (w2): query rows a block
constexpr int kWideThreads = 256;

// out[m, j] = bf16((sum_k A[m, k] w[j, k] + bias[j]) scale) for m < M, j <
// Nout; A = bf16(LN(x)) (statistics in fp32, two passes) where LN, else x.
// Each thread owns a 4 x 4 block of the tile.
template <bool LN>
__global__ void __launch_bounds__(kWideThreads)
    sra_wide_gemm_kernel(const bf16* __restrict__ x, const float* __restrict__ ln_w,
                         const float* __restrict__ ln_b, const bf16* __restrict__ w,
                         const float* __restrict__ bias, bf16* __restrict__ out, long M, int K,
                         int Nout, float scale, float eps) {
  __shared__ float As[kWideK][kWideTile + 4], Ws[kWideK][kWideTile + 4];
  __shared__ float s_mean[kWideTile], s_rstd[kWideTile];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const long m0 = (long)blockIdx.x * kWideTile;
  const int n0 = blockIdx.y * kWideTile;
  if (LN) {  // four threads a row
    const int r = tid >> 2, part = tid & 3;
    const long m = m0 + r;
    float s = 0.f, q = 0.f;
    if (m < M)
      for (int k = part; k < K; k += 4) s += __bfloat162float(x[m * K + k]);
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    const float mean = s / K;
    if (m < M)
      for (int k = part; k < K; k += 4) {
        const float d = __bfloat162float(x[m * K + k]) - mean;
        q = fmaf(d, d, q);
      }
    q += __shfl_xor_sync(0xffffffffu, q, 1);
    q += __shfl_xor_sync(0xffffffffu, q, 2);
    if (part == 0) {
      s_mean[r] = mean;
      s_rstd[r] = rsqrtf(q / K + eps);
    }
    __syncthreads();
  }
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += kWideK) {
    for (int i = tid; i < kWideTile * kWideK; i += kWideThreads) {
      const int r = i / kWideK, k = i % kWideK;
      const long m = m0 + r;
      const int j = n0 + r;
      float v = 0.f;
      if (m < M && k0 + k < K) {
        v = __bfloat162float(x[m * K + k0 + k]);
        if (LN)
          v = __bfloat162float(__float2bfloat16_rn((v - s_mean[r]) * s_rstd[r] * ln_w[k0 + k] +
                                                   ln_b[k0 + k]));
      }
      As[k][r] = v;
      Ws[k][r] = j < Nout && k0 + k < K ? __bfloat162float(w[(long)j * K + k0 + k]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kWideK; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&As[k][4 * ty]);
      const float4 c = *reinterpret_cast<const float4*>(&Ws[k][4 * tx]);
      const float av[4] = {a.x, a.y, a.z, a.w}, cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], cv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long m = m0 + 4 * ty + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + 4 * tx + j;
      if (m < M && n < Nout) out[m * Nout + n] = __float2bfloat16_rn((acc[i][j] + bias[n]) * scale);
    }
  }
}

// Shared bytes of (w2) for heads hd wide and `keys` keys a chunk: O_h [16][hd]
// fp32, the scores [16][keys] fp32, each row's max and sum, q_h [16][hd]
// bf16, k_h or v_h's chunk [keys][hd + 2] bf16 (an odd number of words a row).
__host__ __device__ inline size_t sra_wide_smem(int hd, int keys) {
  return (size_t)kWideRows * hd * 4 + (size_t)kWideRows * keys * 4 + 2 * kWideRows * 4 +
         (size_t)kWideRows * hd * 2 + (size_t)keys * (hd + 2) * 2;
}

// The keys a chunk of (w2) for heads hd wide: the most of 64, 32, 16, 8 whose
// working set fits one block; 0 where none does.
static int sra_wide_keys(int hd) {
  for (int keys = 64; keys >= 8; keys /= 2)
    if (sra_wide_smem(hd, keys) <= kSmemMax) return keys;
  return 0;
}

// (w2): q, the (B N, C) scratch, holds bf16 q (head h at columns h hd ..);
// k, v (B, nh, Lk, hd) bf16.  Block (x, h, b): query rows 16 x .. of image b,
// head h.  Writes bf16(O_h) over its own q_h.
__global__ void __launch_bounds__(kWideThreads)
    sra_wide_attn_kernel(bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, int N, int C, int nh, int Lk, int keys) {
  extern __shared__ float4 smem4[];
  const int hd = C / nh, h = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int ldk = hd + 2;
  float* O = reinterpret_cast<float*>(smem4);
  float* S = O + kWideRows * hd;
  float* s_max = S + kWideRows * keys;
  float* s_sum = s_max + kWideRows;
  bf16* qs = reinterpret_cast<bf16*>(s_sum + kWideRows);
  bf16* kv = qs + kWideRows * hd;
  const long r0 = (long)blockIdx.x * kWideRows;
  const int nr = (int)min((long)kWideRows, N - r0);
  bf16* qrow = q + ((long)b * N + r0) * C + (long)h * hd;
  const bf16* kh = k + ((long)b * nh + h) * Lk * hd;
  const bf16* vh = v + ((long)b * nh + h) * Lk * hd;
  const bf16 zero = __float2bfloat16_rn(0.f);
  for (int i = tid; i < kWideRows * hd; i += kWideThreads) {
    const int r = i / hd, d = i % hd;
    qs[i] = r < nr ? qrow[(long)r * C + d] : zero;
    O[i] = 0.f;
  }
  if (tid < kWideRows) {
    s_max[tid] = -INFINITY;
    s_sum[tid] = 0.f;
  }
  const int chunks = (Lk + keys - 1) / keys, warp = tid >> 5, lane = tid & 31;
  // the scores of chunk c (nk keys) into S, from its k rows staged in kv
  auto scores = [&](int c, int nk) {
    __syncthreads();  // kv and S free
    for (int i = tid; i < nk * hd; i += kWideThreads) {
      const int j = i / hd, d = i % hd;
      kv[j * ldk + d] = kh[((long)c * keys + j) * hd + d];
    }
    __syncthreads();
    for (int i = tid; i < kWideRows * keys; i += kWideThreads) {
      const int r = i / keys, j = i % keys;
      float s = -INFINITY;
      if (j < nk) {
        const __nv_bfloat162* qa = reinterpret_cast<const __nv_bfloat162*>(qs + r * hd);
        const __nv_bfloat162* ka = reinterpret_cast<const __nv_bfloat162*>(kv + j * ldk);
        s = 0.f;
        for (int d = 0; d < hd / 2; ++d) {
          const float2 a = __bfloat1622float2(qa[d]), c2 = __bfloat1622float2(ka[d]);
          s = fmaf(a.x, c2.x, s);
          s = fmaf(a.y, c2.y, s);
        }
      }
      S[i] = s;
    }
    __syncthreads();
  };
  // pass 1: each row's running max and sum, rescaled from chunk to chunk
  for (int c = 0; c < chunks; ++c) {
    const int nk = min(keys, Lk - c * keys);
    scores(c, nk);
    for (int r = warp; r < kWideRows; r += kWideThreads / 32) {
      float m = -INFINITY;
      for (int j = lane; j < nk; j += 32) m = fmaxf(m, S[r * keys + j]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
      const float mn = fmaxf(s_max[r], m);
      float e = 0.f;
      for (int j = lane; j < nk; j += 32) e += expf(S[r * keys + j] - mn);
      e = warp_sum(e);
      if (lane == 0) {
        s_sum[r] = s_sum[r] * expf(s_max[r] - mn) + e;
        s_max[r] = mn;
      }
    }
  }
  // pass 2: the scores again, p rounded once, O_h += p v_h
  for (int c = 0; c < chunks; ++c) {
    const int nk = min(keys, Lk - c * keys);
    scores(c, nk);
    for (int i = tid; i < kWideRows * keys; i += kWideThreads) {
      const int r = i / keys, j = i % keys;
      S[i] = j < nk ? __bfloat162float(__float2bfloat16_rn(expf(S[i] - s_max[r]) / s_sum[r]))
                    : 0.f;
    }
    for (int i = tid; i < nk * hd; i += kWideThreads) {  // kv: v's chunk (k no longer read)
      const int j = i / hd, d = i % hd;
      kv[j * ldk + d] = vh[((long)c * keys + j) * hd + d];
    }
    __syncthreads();
    for (int i = tid; i < kWideRows * hd; i += kWideThreads) {
      const int r = i / hd, d = i % hd;
      float o = O[i];
      for (int j = 0; j < nk; ++j) o = fmaf(S[r * keys + j], __bfloat162float(kv[j * ldk + d]), o);
      O[i] = o;
    }
  }
  __syncthreads();
  for (int i = tid; i < nr * hd; i += kWideThreads) {
    const int r = i / hd, d = i % hd;
    qrow[(long)r * C + d] = __float2bfloat16_rn(O[i]);
  }
}

// The wide route's plan fields (see SraPlan): heads unpadded (nq 0), no
// warpgroups, 16 query rows a block, `keys` keys a chunk, blocks of (w2).
static bool plan_sra_wide(int B, int N, int C, int nh, int Lk, SraPlan* p) {
  if (C % nh || (C / nh) % 8) return false;
  const int hd = C / nh, keys = sra_wide_keys(hd);
  if (keys == 0 || nh > 65535 || B > 65535) return false;
  p->wide = 1;
  p->keys = keys;
  p->nq = p->nwg = p->kt = p->stages = p->alias = p->per_sm = 0;
  p->rows = kWideRows;
  p->cluster = 1;
  p->tiles = (N + kWideRows - 1) / kWideRows;
  p->chunks = (Lk + keys - 1) / keys;
  p->smem = sra_wide_smem(hd, keys);
  p->blocks = (long)B * p->tiles * nh;
  return (long)B * N / kWideTile < 0x7fffffffL && p->tiles <= 0x7fffffff;
}

// The three launches of the wide route; scratch (B N, C) bf16.
static int launch_sra_wide(const SraPlan& p, const bf16* x, const float* ln_w, const float* ln_b,
                           const bf16* wq, const float* bq, const bf16* k, const bf16* v,
                           const bf16* wp, const float* bp, bf16* out, bf16* scratch, int B,
                           int N, int C, int nh, int Lk, float scale, float eps,
                           cudaStream_t s) {
  if (scratch == nullptr) return (int)cudaErrorInvalidValue;
  const long M = (long)B * N;
  const dim3 ggrid((unsigned)((M + kWideTile - 1) / kWideTile),
                   (unsigned)((C + kWideTile - 1) / kWideTile));
  sra_wide_gemm_kernel<true><<<ggrid, kWideThreads, 0, s>>>(x, ln_w, ln_b, wq, bq, scratch, M, C,
                                                            C, scale, eps);
  TRAMBA_CHECK_LAUNCH();
  cudaError_t e = allow_smem(sra_wide_attn_kernel, p.smem);
  if (e != cudaSuccess) return (int)e;
  sra_wide_attn_kernel<<<dim3((unsigned)p.tiles, (unsigned)nh, (unsigned)B), kWideThreads, p.smem,
                         s>>>(scratch, k, v, N, C, nh, Lk, p.keys);
  TRAMBA_CHECK_LAUNCH();
  sra_wide_gemm_kernel<false><<<ggrid, kWideThreads, 0, s>>>(scratch, nullptr, nullptr, wp, bp,
                                                             out, M, C, C, 1.f, 0.f);
  TRAMBA_CHECK_LAUNCH();
  return 0;
}

// The plan of a K12 call: the one-launch kernel where its block holds the
// shape, else the wide route.
static bool plan_sra(int B, int N, int C, int nh, int Lk, int sms, SraPlan* p) {
  if (B < 1 || N < 1 || nh < 1 || Lk < 1 || C < 8 || C % nh || C % 8 || sms < 1) return false;
  return plan_sra_fast(B, N, C, nh, Lk, sms, p) || plan_sra_wide(B, N, C, nh, Lk, p);
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

// The plan of a K12 call: plan[0..13] = head-width chunks of 64, warpgroups
// a block, query rows a block, blocks a row tile (the cluster), row tiles an
// image, key tiles held in registers, key chunks (two passes where > 1),
// ring slots, whether the merged heads share the LayerNorm's tile, blocks an
// SM, shared bytes, blocks, whether the wide route runs, keys a chunk.
int sra_plan(int B, int N, int C, int nh, int Lk, int* plan) {
  SraPlan p;
  int sms = 0;
  if (!sm_count(&sms) || !plan_sra(B, N, C, nh, Lk, sms, &p)) return (int)cudaErrorInvalidValue;
  const int v[14] = {p.nq,     p.nwg,       p.rows,          p.cluster, p.tiles,
                     p.kt,     p.chunks,    p.stages,        p.alias,   p.per_sm,
                     (int)p.smem, (int)p.blocks, p.wide, p.keys};
  std::copy(v, v + 14, plan);
  return 0;
}

// K12: one launch (sra_kernel).  x (B, N, C) bf16; ln_w, ln_b (C) fp32
// (LayerNorm with eps); wq (Cq, C) bf16 and bq (Cq) fp32, each head's rows
// padded with zeros to hdp = hd rounded up to 64 (Cq = nh hdp); k, v (B, nh,
// Lk, hdp) bf16; wp (C, Cq) bf16, each head's input columns padded to hdp;
// bp (C) fp32; out (B, N, C) bf16 = bf16(bf16(concat_h bf16(softmax(q_h
// k_h^T)) v_h) wp^T + bp), q = bf16((bf16(LN(x)) wq^T + bq) scale).  C a
// multiple of 8 up to 768, hd up to 128 (plan_sra).  Where the plan takes
// the wide route, the operands are not padded (hdp = hd, Cq = C) and
// scratch is (B N, C) bf16 (else unused): three launches.
int sra_launch(const bf16* x, const float* ln_w, const float* ln_b, const bf16* wq,
               const float* bq, const bf16* k, const bf16* v, const bf16* wp, const float* bp,
               bf16* out, bf16* scratch, int B, int N, int C, int nh, int Lk, float scale,
               float eps, void* stream) {
  SraPlan p;
  int sms = 0;
  if (!sm_count(&sms) || !plan_sra(B, N, C, nh, Lk, sms, &p)) return (int)cudaErrorInvalidValue;
  if (p.wide)
    return launch_sra_wide(p, x, ln_w, ln_b, wq, bq, k, v, wp, bp, out, scratch, B, N, C, nh, Lk,
                           scale, eps, static_cast<cudaStream_t>(stream));
  const int hdp = 64 * p.nq, Cq = nh * hdp;
  CUtensorMap map_x, map_wq, map_k, map_v, map_wp;
  if (!weight_map(&map_x, x, (long)B * N, C) || !weight_map(&map_wq, wq, Cq, C) ||
      !kv_map(&map_k, k, hdp, Lk, (long)B * nh) || !kv_map(&map_v, v, hdp, Lk, (long)B * nh) ||
      !weight_map(&map_wp, wp, C, Cq))
    return (int)cudaErrorInvalidValue;
  // the instantiations: one or two 64-column chunks a head, key tiles held
  // in registers, consumer warpgroups (two only with 64-wide heads)
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc = (int)cudaErrorInvalidValue;
#define TRAMBA_SRA_CASE(NQ_, KT_, NWG_)                                                      \
  if (p.nq == NQ_ && p.kt == KT_ && p.nwg == NWG_)                                           \
  rc = launch_sra<NQ_, KT_, NWG_>(p, map_x, map_wq, map_k, map_v, map_wp, ln_w, ln_b, bq, bp, \
                                  out, B, N, C, nh, Lk, scale, eps, s)
  TRAMBA_SRA_CASE(1, 1, 2);
  TRAMBA_SRA_CASE(1, 2, 2);
  TRAMBA_SRA_CASE(1, 3, 2);
  TRAMBA_SRA_CASE(1, 4, 2);
  TRAMBA_SRA_CASE(1, 1, 1);
  TRAMBA_SRA_CASE(1, 2, 1);
  TRAMBA_SRA_CASE(1, 3, 1);
  TRAMBA_SRA_CASE(1, 4, 1);
  TRAMBA_SRA_CASE(2, 1, 1);
  TRAMBA_SRA_CASE(2, 2, 1);
#undef TRAMBA_SRA_CASE
  if (rc) return rc;
  TRAMBA_CHECK_LAUNCH();
  return 0;
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
