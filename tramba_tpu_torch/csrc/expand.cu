// K3 expand_ln and K4 final_head: the decoder's upsamplers and its last head.
//
// K3 replaces _expand_pallas (tramba_tpu/ops/fused_expand.py:59): x @ w^T,
// then the x2 pixel shuffle in (p1, p2, c) channel order, then LayerNorm over
// each output pixel's co = f*C/4 channels (PatchExpand f=2, FreqExpand2D f=4).
// K4 replaces _final_head_pallas (:165): x @ w1^T (C -> 16C), LayerNorm of
// each of the 16 slots of C channels, then the 1x1 seg conv, giving 16 logits
// per coarse pixel.  The TPU kernel folded LN and head into three matmuls
// against block-diagonal selectors to suit its matrix unit; here each slot's
// C values sit in shared memory and one warp reduces them directly.
//
// Both share one kernel.  A block stages P input rows in shared memory, then
// computes the expanded channels one group (one shuffle position, or one
// head slot) at a time into a P x co shared tile, normalises each row with a
// warp, and writes the group out.  The expanded tensor (16C wide for K4) never
// reaches device memory.  They are bound by the SIMT matrix product: x is read
// once and w from L2 once per block, and the output is written once.
#include "common.cuh"

namespace {

template <int P, bool kHead>
__global__ void expand_groups_kernel(const float* __restrict__ x, const float* __restrict__ w,
                                     const float* __restrict__ ln_w,
                                     const float* __restrict__ ln_b,
                                     const float* __restrict__ seg_w,
                                     const float* __restrict__ seg_b, float* __restrict__ out,
                                     long M, int H, int W, int C, int G, int co) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);  // [P][C]
  float* es = xs + P * C;                       // [P][co]
  const long m0 = (long)blockIdx.x * P;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nwarps = blockDim.x >> 5;
  load_rows<P>(x, M, C, m0, xs);
  for (int g = 0; g < G; ++g) {
    __syncthreads();  // xs is loaded, and the previous group's tile is consumed
    for (int j = threadIdx.x; j < co; j += blockDim.x) {
      float acc[P];
      rows_dot<P>(xs, C, w + ((long)g * co + j) * C, C, acc);
#pragma unroll
      for (int p = 0; p < P; ++p) es[p * co + j] = acc[p];
    }
    __syncthreads();
    for (int p = warp; p < P; p += nwarps) {
      const long m = m0 + p;
      if (m >= M) continue;
      const float* row = es + p * co;
      float mean, rstd;
      warp_row_stats(row, co, 1e-5f, &mean, &rstd);
      if constexpr (kHead) {
        float s = 0.f;
        for (int i = lane; i < co; i += 32)
          s = fmaf((row[i] - mean) * rstd * ln_w[i] + ln_b[i], seg_w[i], s);
        s = warp_sum(s);
        if (lane == 0) out[m * G + g] = s + seg_b[0];
      } else {
        const int wq = (int)(m % W);
        const long bh = m / W;
        const int hq = (int)(bh % H);
        const long b = bh / H;
        const int p1 = g >> 1, p2 = g & 1;
        float* o = out + ((b * 2 * H + 2 * hq + p1) * (2L * W) + 2 * wq + p2) * co;
        for (int i = lane; i < co; i += 32) o[i] = (row[i] - mean) * rstd * ln_w[i] + ln_b[i];
      }
    }
  }
}

constexpr long kExpandBudget = 96 * 1024;  // shared bytes for the x tile plus one group

template <bool kHead>
int launch_groups(const float* x, const float* w, const float* ln_w, const float* ln_b,
                  const float* seg_w, const float* seg_b, float* out, long M, int H, int W,
                  int C, int G, int co, cudaStream_t s) {
  const int P = rows_per_block(M, C + co, kExpandBudget);
  const size_t smem = (size_t)P * (C + co) * 4;
  const int threads = co >= 256 ? 256 : ((co + 31) / 32) * 32;
  const unsigned blocks = (unsigned)((M + P - 1) / P);
  TRAMBA_DISPATCH_P(P, {
    cudaError_t e = allow_smem(expand_groups_kernel<kP, kHead>, smem);
    if (e != cudaSuccess) return (int)e;
    expand_groups_kernel<kP, kHead><<<blocks, threads, smem, s>>>(x, w, ln_w, ln_b, seg_w, seg_b,
                                                                  out, M, H, W, C, G, co);
  });
  TRAMBA_CHECK_LAUNCH();
  return 0;
}

}  // namespace

extern "C" {

// K3.  x (B, H, W, C); w (4*co, C); ln_w, ln_b (co); out (B, 2H, 2W, co).
// C % 4 == 0.
int expand_ln_launch(const float* x, const float* w, const float* ln_w, const float* ln_b,
                     float* out, int B, int H, int W, int C, int co, void* stream) {
  return launch_groups<false>(x, w, ln_w, ln_b, nullptr, nullptr, out, (long)B * H * W, H, W, C,
                              4, co, static_cast<cudaStream_t>(stream));
}

// K4.  x (M, C) with M = B*h*w; w1 (16*C, C); ln_w, ln_b, seg_w (C); seg_b (1);
// out (M, 16).  C % 4 == 0.
int final_head_launch(const float* x, const float* w1, const float* ln_w, const float* ln_b,
                      const float* seg_w, const float* seg_b, float* out, long M, int C,
                      void* stream) {
  return launch_groups<true>(x, w1, ln_w, ln_b, seg_w, seg_b, out, M, 1, 1, C, 16, C,
                             static_cast<cudaStream_t>(stream));
}

}  // extern "C"
