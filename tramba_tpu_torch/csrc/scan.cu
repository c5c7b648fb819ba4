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
// its rows.  Here the carry never leaves a register: one thread owns one
// column (r, c) and walks all L rows of it, so any L and C work, with no
// multiple of 128 or 256 asked for.
//
// What bounds it on an H100: by its bytes (a and b read once, h written once:
// 12 B per element) it would take (R*L*C*12 B) / 3.35 TB/s.  But it is a
// dependent chain of L steps per column and has only R*C threads: 4,096 for
// Tramba-V's tensor-parallel core at 96 px with B 4 and K 4, about one warp
// per SM.  So it is latency-bound.  The design does one thing about that: a
// thread keeps the next kSteps rows of a and b in registers, loaded while it
// runs the current kSteps steps, so that the loads of a group are in flight
// together and overlap the chain.  Neighbouring threads read neighbouring
// channels, so each warp's loads and stores are whole 128-byte lines.  A
// chunked design (per-chunk summaries and a carry pass, the algebra of the
// sequence-parallel scan) would spread L over more threads; it is left to a
// later change.
#include "common.cuh"

namespace {

constexpr int kSteps = 16;  // rows of a and b a thread holds in registers per group

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

// One thread per column (r, c); block x covers channels of one row r.
__global__ void linear_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                                   float* __restrict__ h, int L, int C, int cblocks,
                                   int reverse) {
  const long r = blockIdx.x / cblocks;
  const int c = (blockIdx.x % cblocks) * blockDim.x + threadIdx.x;
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

// K14.  a, b, h (R, L, C) fp32, contiguous; reverse = 0 scans rows 0 .. L-1,
// reverse = 1 rows L-1 .. 0.
int linear_scan_launch(const float* a, const float* b, float* h, int R, int L, int C,
                       int reverse, void* stream) {
  if (R <= 0 || L <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  const int threads = C >= 128 ? 128 : (C + 31) / 32 * 32;
  const int cblocks = (C + threads - 1) / threads;
  const long blocks = (long)R * cblocks;
  if (blocks > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  linear_scan_kernel<<<(unsigned)blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      a, b, h, L, C, cblocks, reverse);
  TRAMBA_CHECK_LAUNCH();
  return 0;
}

}  // extern "C"
