// K14 linear_scan: the generic first-order linear recurrence of the parallel
// layer and of SS2D with d_state > 1,
//   h_t = a_t * h_{t-1} + b_t   (h_{-1} = 0),
// in fp32 along the rows t of (R, L, C) tensors, or, with `reverse`, from the
// last row back (h_t = a_t * h_{t+1} + b_t, h_L = 0).  The adjoint of the
// recurrence is this launch reversed, so the backward needs no flipped copies.
//
// It replaces _linear_scan_pallas (tramba_tpu/ops/selective_scan.py:642,
// kernel _scan_chunk_kernel :617).  That kernel walks L in chunks of 256 rows
// with the carry in VMEM scratch between grid steps, because a TPU grid runs
// in order on one core, and runs each chunk as a log-depth masked scan across
// its rows.
//
// What bounds it on an H100: its bytes.  a and b are read once and h written
// once, 12 B an element, against about 3 fp32 operations an element.  So the
// kernel has to keep enough bytes in flight to fill the memory system and
// read each element once.  A thread per column walking all L rows (this
// kernel's first port) has only R * C threads, about one warp an SM at the
// 96 px tensor-parallel shape, and reached 25% of the bound there.
//
// The design: one pass over segments.  Each column's L steps are cut into
// segments of up to kSeg rows (linear_scan_plan); a block takes one segment
// of kCh consecutive channels of one row r, so a launch has R * ceil(C / kCh)
// * segments blocks, several waves at every shape the port runs.
//  1. The block copies its segment of a and b into shared memory (cp.async,
//     16 bytes a copy where C % 4 == 0): 64 KB a block, three blocks an SM,
//     so about 190 KB of loads are in flight on each SM.
//  2. Eight walkers a channel (a warp is one walker of 32 channels, so every
//     shared-memory access of a warp is one conflict-free row) run their
//     rows from a zero state, leaving in shared memory the local state and
//     the running product of a, and their parts' summaries (product, end
//     state).  Warp 0 joins the eight summaries into the segment's.
//  3. The carry entering the segment comes from a decoupled look-back over
//     the earlier segments of the same columns: each block publishes its
//     segment's summary (flag 1) as soon as it has it, and its inclusive
//     end state (flag 2) once it knows its carry; a block looks back (a
//     lane a segment, 32 at a time) for the nearest inclusive state whose
//     later segments have all published their summaries, and folds those
//     summaries onto it in order (all eight warps load them, kGather at a
//     time, warp 0 folds).  Every inclusive state is itself the fold
//     of all the column's summaries from segment 0 in that order, so the
//     carry is the same fmaf chain whichever state the search finds first:
//     two launches give the same bits.  A block waits mostly for its
//     nearest predecessor's summary.  Blocks take their segment from an
//     atomic ticket, in the order (row, channel group, segment), so every
//     block a block waits for has started.  The last segment of a column
//     publishes nothing.  Of the two ways to join the segments (look-back,
//     or a cluster of blocks passing the carry through distributed shared
//     memory), the look-back was taken because it needs no co-scheduling:
//     any L makes any number of segments.
//  4. Each walker writes h_t = h_t^local + (prod_{s <= t} a_s) * e, with e the
//     state entering its part (the carry through the earlier parts).
// So a and b are read from device memory once and h written once; no
// summary / carry / rerun passes.  Where the scan has many columns (R C >=
// kColumnsMin: SS2D with d_state 16, the tensor-parallel core at 24 px and
// 12 px) one thread a column already keeps enough bytes in flight, and the
// plan takes the column route instead: each thread walks its column's L
// rows with the next kSteps rows of a and b in registers (no staging, no
// look-back).  `reverse` walks the same segments from
// the end: logical step t is row L - 1 - t.  A product of a that underflows
// to zero is the true product: the state then no longer depends on the carry.
#include "common.cuh"

namespace {

constexpr int kCh = 32;       // channels a block
constexpr int kParts = 8;     // walkers a channel (warps a block)
constexpr int kSeg = 256;     // most rows a segment
constexpr int kThreads = kCh * kParts;
constexpr int kGather = 32;   // earlier segments' summaries loaded at a time in the look-back
// The column route: from this many columns (R C) one thread a column
// already keeps kSteps rows of a and b in flight for 4 warps an SM, and it
// saves the segments' staging and look-back
constexpr long kColumnsMin = 16384;
constexpr int kColThreads = 128;  // threads (columns) a block on the column route
constexpr int kSteps = 16;        // rows of a and b a thread holds in registers per group

struct ScanPlan {
  int route;  // 0: segments; 1: one thread a column
  int seg, segments, groups, parts;
  long blocks;
  size_t smem;
};

bool plan_scan(long R, int L, int C, ScanPlan* p) {
  if (R <= 0 || L <= 0 || C <= 0) return false;
  p->route = R * C >= kColumnsMin;
  if (p->route) {
    p->seg = L;
    p->segments = 1;
    p->groups = (C + kColThreads - 1) / kColThreads;
    p->parts = 1;
    p->smem = 0;
  } else {
    p->seg = L < kSeg ? L : kSeg;
    p->segments = (L + p->seg - 1) / p->seg;
    p->groups = (C + kCh - 1) / kCh;
    p->parts = kParts;
    p->smem = (size_t)2 * p->seg * kCh * 4;
  }
  p->blocks = R * p->groups * p->segments;
  return p->blocks <= 0x7fffffffL;
}

__device__ __forceinline__ int ld_flag(const int* f) {
  return *reinterpret_cast<const volatile int*>(f);
}
__device__ __forceinline__ void st_flag(int* f, int v) { *reinterpret_cast<volatile int*>(f) = v; }

// flags [blocks] (zeroed by the launcher), ticket; agg [blocks][2][kCh]
// (segment product, end state from zero), incl [blocks][kCh] (inclusive end
// state), each indexed by the block's ticket.
__global__ void __launch_bounds__(kThreads)
    linear_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                       float* __restrict__ h, int L, int C, int seg, int segments, int groups,
                       int vec4, int reverse, int* __restrict__ ticket, int* __restrict__ flags,
                       float* __restrict__ agg, float* __restrict__ incl) {
  extern __shared__ float4 smem4[];
  float* sa = reinterpret_cast<float*>(smem4);  // [seg][kCh]: a, then the running product
  float* sb = sa + seg * kCh;                   // [seg][kCh]: b, then the local state
  __shared__ float part_a[kParts][kCh], part_h[kParts][kCh], s_carry[kCh];
  __shared__ float pred_a[kGather][kCh], pred_h[kGather][kCh];  // earlier segments' summaries
  __shared__ long s_from;  // the segment whose inclusive state the carry starts from
  __shared__ int s_id;
  const int tid = threadIdx.x, ch = tid & (kCh - 1), part = tid >> 5;
  if (tid == 0) s_id = atomicAdd(ticket, 1);
  __syncthreads();
  const long id = s_id;
  const int s = (int)(id % segments);
  const long rg = id / segments;
  const int c0 = (int)(rg % groups) * kCh;
  const long base = rg / groups * (long)L * C;
  const int t0 = s * seg, n = min(seg, L - t0);
  auto row_of = [&](int i) -> long { return reverse ? (long)(L - 1 - t0 - i) : (long)(t0 + i); };

  // 1. the segment into shared memory
  if (vec4) {
    for (int i = tid; i < n * (kCh / 4); i += kThreads) {
      const int r = i / (kCh / 4), q = 4 * (i % (kCh / 4));
      const long o = base + row_of(r) * C + c0 + q;
      const bool ok = c0 + q < C;
      cp_async16(sa + r * kCh + q, ok ? a + o : a, ok);
      cp_async16(sb + r * kCh + q, ok ? b + o : b, ok);
    }
  } else {
    for (int i = tid; i < n * kCh; i += kThreads) {
      const int r = i / kCh, q = i % kCh;
      const bool ok = c0 + q < C;
      const long o = base + row_of(r) * C + c0 + q;
      __pipeline_memcpy_async(sa + r * kCh + q, ok ? a + o : a, 4, ok ? 0 : 4);
      __pipeline_memcpy_async(sb + r * kCh + q, ok ? b + o : b, 4, ok ? 0 : 4);
    }
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // 2. each walker's rows from a zero state
  const int rp = (n + kParts - 1) / kParts, r0 = min(n, part * rp), r1 = min(n, r0 + rp);
  float st = 0.f, pa = 1.f;
  for (int i = r0; i < r1; ++i) {
    const float av = sa[i * kCh + ch];
    st = fmaf(av, st, sb[i * kCh + ch]);
    pa *= av;
    sb[i * kCh + ch] = st;
    sa[i * kCh + ch] = pa;
  }
  part_a[part][ch] = pa;
  part_h[part][ch] = st;
  __syncthreads();

  // 3. the segment's summary, published, and the carry entering it: the
  // nearest earlier inclusive end state of the column, then the summaries
  // after it folded in order (the same operations as folding from segment
  // 0, so the bits do not depend on which state was found first)
  const bool last = s == segments - 1;  // no later segment reads this one
  float A = 1.f, H = 0.f;
  if (part == 0) {
#pragma unroll
    for (int p = 0; p < kParts; ++p) {
      H = fmaf(part_a[p][ch], H, part_h[p][ch]);
      A *= part_a[p][ch];
    }
    if (s > 0 && !last) {
      agg[id * 2 * kCh + ch] = A;
      agg[id * 2 * kCh + kCh + ch] = H;
      __threadfence();
      __syncwarp();
      if (ch == 0) st_flag(flags + id, 1);
    }
    long j = -1;
    if (s > 0) {
      // lane i watches segment top - i; the nearest inclusive state whose
      // later segments have all published their summaries ends the search
      const long first = id - s;
      long top = id - 1;
      while (j < 0) {
        const long mine = top - ch;
        const int f = mine >= first ? ld_flag(flags + mine) : 0;
        const unsigned ready = __ballot_sync(0xffffffffu, mine >= first && f >= 1);
        const unsigned incl_at = __ballot_sync(0xffffffffu, mine >= first && f == 2);
        if (incl_at) {
          const int i = __ffs(incl_at) - 1;
          const unsigned nearer = (1u << i) - 1u;
          if ((ready & nearer) == nearer) j = top - i;
        } else if (ready == 0xffffffffu) {
          top -= kCh;
        }
      }
      __threadfence();
      s_carry[ch] = __ldcg(incl + j * kCh + ch);
    }
    if (ch == 0) s_from = j;
  }
  __syncthreads();
  // the summaries after j, kGather at a time: every warp loads its share,
  // warp 0 folds them in order
  for (long k0 = s_from + 1; s > 0 && k0 < id; k0 += kGather) {
    for (int k = part; k < kGather && k0 + k < id; k += kParts) {
      pred_a[k][ch] = __ldcg(agg + (k0 + k) * 2 * kCh + ch);
      pred_h[k][ch] = __ldcg(agg + (k0 + k) * 2 * kCh + kCh + ch);
    }
    __syncthreads();
    if (part == 0) {
      float carry = s_carry[ch];
      for (int k = 0; k < kGather && k0 + k < id; ++k)
        carry = fmaf(pred_a[k][ch], carry, pred_h[k][ch]);
      s_carry[ch] = carry;
    }
    __syncthreads();
  }
  if (part == 0) {
    const float carry = s > 0 ? s_carry[ch] : 0.f;
    if (!last) {
      incl[id * kCh + ch] = fmaf(A, carry, H);
      __threadfence();
      __syncwarp();
      if (ch == 0) st_flag(flags + id, 2);
    }
    s_carry[ch] = carry;
  }
  __syncthreads();

  // 4. the state entering this walker's part, then its rows
  float e = s_carry[ch];
  for (int p = 0; p < part; ++p) e = fmaf(part_a[p][ch], e, part_h[p][ch]);
  if (c0 + ch < C)
    for (int i = r0; i < r1; ++i)
      __stcs(h + base + row_of(i) * C + c0 + ch, fmaf(sa[i * kCh + ch], e, sb[i * kCh + ch]));
}

// The column route: one thread a column (r, c) walks all L rows, the next
// kSteps rows of a and b loaded while it runs the current ones; block x
// covers kColThreads channels of one row r.
__device__ __forceinline__ void load_group(const float* __restrict__ a,
                                           const float* __restrict__ b, long first, long step,
                                           int t0, int L, float (&av)[kSteps],
                                           float (&bv)[kSteps]) {
#pragma unroll
  for (int i = 0; i < kSteps; ++i) {
    if (t0 + i < L) {
      const long o = first + (long)(t0 + i) * step;
      av[i] = __ldcs(a + o);
      bv[i] = __ldcs(b + o);
    }
  }
}

__global__ void __launch_bounds__(kColThreads)
    linear_scan_columns_kernel(const float* __restrict__ a, const float* __restrict__ b,
                               float* __restrict__ h, int L, int C, int groups, int reverse) {
  const long r = blockIdx.x / groups;
  const int c = (blockIdx.x % groups) * kColThreads + threadIdx.x;
  if (c >= C) return;
  const long step = reverse ? -(long)C : (long)C;
  const long first = r * L * C + c + (reverse ? (long)(L - 1) * C : 0L);
  float an[kSteps], bn[kSteps];
  load_group(a, b, first, step, 0, L, an, bn);
  float carry = 0.f;
  for (int t0 = 0; t0 < L; t0 += kSteps) {
    float ac[kSteps], bc[kSteps];
#pragma unroll
    for (int i = 0; i < kSteps; ++i) {
      ac[i] = an[i];
      bc[i] = bn[i];
    }
    load_group(a, b, first, step, t0 + kSteps, L, an, bn);
#pragma unroll
    for (int i = 0; i < kSteps; ++i) {
      if (t0 + i < L) {
        carry = fmaf(ac[i], carry, bc[i]);
        h[first + (long)(t0 + i) * step] = carry;
      }
    }
  }
}

}  // namespace

extern "C" {

// The plan of a K14 call on (R, L, C): plan[0..6] = the route (0 segments,
// 1 one thread a column), rows a segment, segments a column, channels a
// block, walkers a channel, blocks, shared bytes a block.  On the segment
// route the wrapper sizes the scratch from it: 1 + blocks ints and 3 * kCh
// * blocks floats.
int linear_scan_plan(long R, int L, int C, int* plan) {
  ScanPlan p;
  if (!plan_scan(R, L, C, &p)) return (int)cudaErrorInvalidValue;
  const int v[7] = {p.route, p.seg, p.segments, p.route ? kColThreads : kCh, p.parts,
                    (int)p.blocks, (int)p.smem};
  std::copy(v, v + 7, plan);
  return 0;
}

// K14.  a, b, h (R, L, C) fp32, contiguous; reverse = 0 scans rows 0 .. L-1,
// reverse = 1 rows L-1 .. 0.  On the segment route iscratch (1 + blocks)
// ints, zeroed here, and fscratch 3 * kCh * blocks floats; unused on the
// column route.
int linear_scan_launch(const float* a, const float* b, float* h, long R, int L, int C,
                       int reverse, int* iscratch, float* fscratch, void* stream) {
  ScanPlan p;
  if (!plan_scan(R, L, C, &p)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.route) {
    linear_scan_columns_kernel<<<(unsigned)p.blocks, kColThreads, 0, s>>>(a, b, h, L, C, p.groups,
                                                                        reverse);
    TRAMBA_CHECK_LAUNCH();
    return 0;
  }
  cudaError_t e = cudaMemsetAsync(iscratch, 0, (size_t)(1 + p.blocks) * sizeof(int), s);
  if (e != cudaSuccess) return (int)e;
  e = allow_smem(linear_scan_kernel, p.smem);
  if (e != cudaSuccess) return (int)e;
  const int vec4 = C % 4 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(b) % 16 == 0;
  linear_scan_kernel<<<(unsigned)p.blocks, kThreads, p.smem, s>>>(
      a, b, h, L, C, p.seg, p.segments, p.groups, vec4, reverse, iscratch, iscratch + 1,
      fscratch, fscratch + 2 * kCh * p.blocks);
  TRAMBA_CHECK_LAUNCH();
  return 0;
}

}  // extern "C"
