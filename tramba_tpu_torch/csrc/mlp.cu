// K6 ln_mlp and K7 ln_dwms_mlp: the block FFNs of the bf16 inference path,
// and the bf16 LayerNorm launch that K5, K6 and K7 start with.
//
// K6 replaces _mlp_pallas (tramba_tpu/ops/fused_mlp.py:130, kernel :115):
//   y = bf16(LN(x)); h = bf16(GELU(y @ w1^T + b1)); out = bf16(h @ w2^T + b2).
// K7 replaces _dwms_pallas (:360, kernel :312):
//   h = y @ w1^T + b1 (fp32, zero outside the image: SAME padding pads h, b1
//   included); a = h + dw3(h) + dw5(h) + dw7(h) + c3 + c5 + c7 with bf16 taps
//   on the unrounded h; out = bf16(bf16(GELU(a)) @ w2^T + b2).
// Both keep the 4x-wide hidden tensor on chip: the hidden dimension is walked
// in chunks of HC channels, each chunk's fc2 product is added to an fp32
// output tile in shared memory, and only the bf16 output reaches device
// memory.  Where a map gives too few blocks to fill the card in whole waves
// (the 24 and 12 px maps), the chunks are split over S blocks per tile (grid
// z): each writes its fp32 partial sum, and one more launch adds b2 to the S
// partials and rounds, the one rounding the TPU kernel makes there.
// Where JAX on a TPU gives the 12 px d=1024 MLP to XLA (its VMEM weight
// budget), K6 runs it like every other shape.
//
// What bounds them on an H100: the two products (4*d*d multiply-adds per
// pixel each, d = 128..1024), which run as bf16 wmma tiles with fp32
// accumulation (common.cuh) reading the weights from L2; K7 also pays its
// 83 depthwise taps per hidden value in fp32 SIMT FMA and the fc1 of a 3-px
// halo around each 8x8 tile (196 rows for 64 outputs).  A block's tiles are
// sized to fit the 227 KB of shared memory of one block, and the LN runs
// once per pixel in its own launch, so halo pixels are not renormalised.
#include <algorithm>

#include "common.cuh"

namespace {

// y[m, :] = bf16(LN(x[m, :]) * ln_w + ln_b), fp32 statistics (eps 1e-5);
// one warp per row.
__global__ void ln_rows_kernel(const bf16* __restrict__ x, const float* __restrict__ ln_w,
                               const float* __restrict__ ln_b, bf16* __restrict__ y, long M,
                               int d) {
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
  const float rstd = rsqrtf(warp_sum(q) / d + 1e-5f);
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

// One block per (BM rows, split).  Shared: ys [BM][d+8] bf16 (the LN'd rows),
// h32 [BM][HC+4] fp32 (fc1 chunk), hs [BM][HC+8] bf16 (GELU chunk),
// acc [BM][d+4] fp32 (the output tile: started at b2 and written as bf16 to
// out, or, when the hidden chunks are split (part != null), started at 0 and
// written as fp32 to part[split]).
__global__ void ln_mlp_kernel(const bf16* __restrict__ y, const bf16* __restrict__ w1,
                              const float* __restrict__ b1, const bf16* __restrict__ w2,
                              const float* __restrict__ b2, bf16* __restrict__ out,
                              float* __restrict__ part, long M, int d, int hid, int BM, int HC,
                              int cps) {
  extern __shared__ float4 smem4[];
  const int ldy = d + 8, ld32 = HC + 4, ldhs = HC + 8, ldacc = d + 4;
  bf16* ys = reinterpret_cast<bf16*>(smem4);
  float* h32 = reinterpret_cast<float*>(ys + BM * ldy);
  bf16* hs = reinterpret_cast<bf16*>(h32 + BM * ld32);
  float* acc = reinterpret_cast<float*>(hs + BM * ldhs);
  const long m0 = (long)blockIdx.x * BM;
  const int vn = d / 8;
  for (int i = threadIdx.x; i < BM * vn; i += blockDim.x) {
    const int p = i / vn, v = i - p * vn;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (m0 + p < M) val = __ldg(reinterpret_cast<const uint4*>(y + (m0 + p) * d) + v);
    *reinterpret_cast<uint4*>(ys + p * ldy + v * 8) = val;
  }
  for (int i = threadIdx.x; i < BM * d; i += blockDim.x) {
    const int p = i / d, j = i - p * d;
    acc[p * ldacc + j] = part ? 0.f : b2[j];
  }
  __syncthreads();
  int c_first, c_last;
  split_range(hid, HC, cps, &c_first, &c_last);
  for (int c0 = c_first; c0 < c_last; c0 += HC) {
    mma_tiles(ys, ldy, w1 + (long)c0 * d, d, h32, ld32, BM / 16, HC / 16, d, false);
    __syncthreads();
    for (int i = threadIdx.x; i < BM * HC; i += blockDim.x) {
      const int p = i / HC, j = i - p * HC;
      hs[p * ldhs + j] = __float2bfloat16_rn(gelu_exact(h32[p * ld32 + j] + b1[c0 + j]));
    }
    __syncthreads();
    mma_tiles(hs, ldhs, w2 + c0, hid, acc, ldacc, BM / 16, d / 16, HC, true);
    __syncthreads();
  }
  float* part_s = part ? part + blockIdx.z * M * d : nullptr;
  for (int i = threadIdx.x; i < BM * d; i += blockDim.x) {
    const int p = i / d, j = i - p * d;
    if (m0 + p >= M) continue;
    if (part_s) {
      part_s[(m0 + p) * d + j] = acc[p * ldacc + j];
    } else {
      out[(m0 + p) * d + j] = __float2bfloat16_rn(acc[p * ldacc + j]);
    }
  }
}

size_t mlp_smem(int BM, int d, int HC) {
  return (size_t)BM * ((d + 8) * 2 + (HC + 4) * 4 + (HC + 8) * 2 + (d + 4) * 4);
}

// ---- K7 -------------------------------------------------------------------

constexpr int kT = 8;                   // output tile kT x kT pixels
constexpr int kE = kT + 6;              // with the 3-px halo: 14 x 14
constexpr int kEP = kE * kE;            // 196 halo pixels
constexpr int kMP = (kEP + 15) / 16 * 16;  // 208 rows, padded for 16-row tiles
constexpr int kTP = kT * kT;            // 64 output pixels

// One block per (8x8 output tile, image, split).  Shared: ys [208][KC+8] bf16
// (channels [k0, k0+KC) of the LN'd halo tile), h32 [208][HC+4] fp32 (fc1
// chunk of the halo tile), hs [64][HC+8] bf16 (GELU chunk), acc [64][d+4] fp32
// (output tile; b2 and the split partials as in K6).
__global__ void ln_dwms_kernel(const bf16* __restrict__ y, const bf16* __restrict__ w1,
                               const float* __restrict__ b1, const bf16* __restrict__ k3,
                               const float* __restrict__ c3, const bf16* __restrict__ k5,
                               const float* __restrict__ c5, const bf16* __restrict__ k7,
                               const float* __restrict__ c7, const bf16* __restrict__ w2,
                               const float* __restrict__ b2, bf16* __restrict__ out,
                               float* __restrict__ part, int H, int W, int d, int hid, int KC,
                               int HC, int cps) {
  extern __shared__ float4 smem4[];
  const int ldy = KC + 8, ld32 = HC + 4, ldhs = HC + 8, ldacc = d + 4;
  bf16* ys = reinterpret_cast<bf16*>(smem4);
  float* h32 = reinterpret_cast<float*>(ys + kMP * ldy);
  bf16* hs = reinterpret_cast<bf16*>(h32 + kMP * ld32);
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
    // fc1 of the halo tile, K-chunked when the whole LN'd tile does not fit
    for (int k0 = 0; k0 < d; k0 += KC) {
      if (KC < d || c0 == c_first) {
        __syncthreads();
        stage_halo(y, b, H, W, d, ty0 - 3, tx0 - 3, kE, kE, kMP, k0, KC, ys, ldy);
        __syncthreads();
      }
      mma_tiles(ys, ldy, w1 + (long)c0 * d + k0, d, h32, ld32, kMP / 16, HC / 16, KC, k0 > 0);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < kEP * HC; i += blockDim.x) {
      const int e = i / HC, j = i - e * HC;
      const int gy = ty0 - 3 + e / kE, gx = tx0 - 3 + e % kE;
      const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
      float* v = h32 + e * ld32 + j;
      *v = inside ? *v + b1[c0 + j] : 0.f;
    }
    __syncthreads();
    {
      // thread -> channel j of the chunk; the block's threads cover HC
      // channels times kThreads / HC pixel groups
      const int j = threadIdx.x % HC, g = threadIdx.x / HC, G = blockDim.x / HC;
      const int c = c0 + j;
      float t3[9], t5[25], t7[49];
#pragma unroll
      for (int i = 0; i < 9; ++i) t3[i] = to_f32(k3[(long)c * 9 + i]);
#pragma unroll
      for (int i = 0; i < 25; ++i) t5[i] = to_f32(k5[(long)c * 25 + i]);
#pragma unroll
      for (int i = 0; i < 49; ++i) t7[i] = to_f32(k7[(long)c * 49 + i]);
      const float cb3 = c3[c], cb5 = c5[c], cb7 = c7[c];
      const float* hj = h32 + j;
      for (int p = g; p < kTP; p += G) {
        const int py = p / kT, px = p % kT;
        float a = hj[((py + 3) * kE + px + 3) * ld32] + cb3;
        a += cb5;
        a += cb7;
#pragma unroll
        for (int u = 0; u < 3; ++u)
#pragma unroll
          for (int v = 0; v < 3; ++v)
            a = fmaf(t3[u * 3 + v], hj[((py + 2 + u) * kE + px + 2 + v) * ld32], a);
#pragma unroll
        for (int u = 0; u < 5; ++u)
#pragma unroll
          for (int v = 0; v < 5; ++v)
            a = fmaf(t5[u * 5 + v], hj[((py + 1 + u) * kE + px + 1 + v) * ld32], a);
#pragma unroll
        for (int u = 0; u < 7; ++u)
#pragma unroll
          for (int v = 0; v < 7; ++v)
            a = fmaf(t7[u * 7 + v], hj[((py + u) * kE + px + v) * ld32], a);
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

size_t dwms_smem(int d, int KC, int HC) {
  return (size_t)kMP * ((KC + 8) * 2 + (HC + 4) * 4) + (size_t)kTP * ((HC + 8) * 2 + (d + 4) * 4);
}

constexpr size_t kSmemMax = 227 * 1024;

// The largest hidden chunk HC (then K chunk KC) whose tiles fit one block.
bool pick_dwms_chunks(int d, int hid, int* KC, int* HC) {
  for (int hc = 128; hc >= 16; hc /= 2) {
    if (hid % hc || kThreads % hc) continue;
    const int kcs[] = {d, 256, 128, 64, 32, 16};
    for (int kc : kcs) {
      if (kc > d || d % kc) continue;
      if (dwms_smem(d, kc, hc) <= kSmemMax) {
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
// rounding to whole chunks per split.
template <typename Kern>
int pick_splits(Kern kernel, size_t smem, long blocks, int nchunks, int* splits) {
  cudaError_t e = allow_smem(kernel, smem);
  int per_sm = 0, dev = 0, sms = 0;
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const long slots = std::max(1L, (long)per_sm * sms);
  int best = 1;
  double best_cost = (double)((blocks + slots - 1) / slots);
  for (int s = 2; s <= std::min(8, nchunks); ++s) {
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

// Tiling of one K6 launch: rows per block BM and hidden chunk HC.
struct MlpPlan {
  int BM, HC;
  size_t smem;
  long blocks;
};

bool plan_mlp(long M, int d, int hid, MlpPlan* p) {
  if (d % 16 || hid % 16) return false;
  p->HC = 128;
  while (hid % p->HC) p->HC /= 2;
  // 32-row blocks where the map is large enough to fill the card with them
  p->BM = (M >= 132L * 32 && mlp_smem(32, d, p->HC) <= kSmemMax) ? 32 : 16;
  while (mlp_smem(p->BM, d, p->HC) > kSmemMax && p->HC > 16) p->HC /= 2;
  p->smem = mlp_smem(p->BM, d, p->HC);
  p->blocks = (M + p->BM - 1) / p->BM;
  return p->smem <= kSmemMax;
}

}  // namespace

extern "C" {

// bf16 LayerNorm of the rows of x (M, d) into y (M, d); ln_w, ln_b (d) fp32.
int layer_norm_bf16_launch(const bf16* x, const float* ln_w, const float* ln_b, bf16* y, long M,
                           int d, void* stream) {
  const int rows = kThreads / 32;
  ln_rows_kernel<<<(unsigned)((M + rows - 1) / rows), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(x, ln_w, ln_b, y, M, d);
  TRAMBA_CHECK_LAUNCH();
  return 0;
}

// Splits of the hidden dimension that ln_mlp_launch should use for these
// shapes (see pick_splits).
int ln_mlp_splits(long M, int d, int hid, int* splits) {
  MlpPlan p;
  if (!plan_mlp(M, d, hid, &p)) return (int)cudaErrorInvalidValue;
  return pick_splits(ln_mlp_kernel, p.smem, p.blocks, hid / p.HC, splits);
}

// K6.  y (M, d) bf16, already LN'd; w1 (hid, d) bf16; b1 (hid) fp32;
// w2 (d, hid) bf16; b2 (d) fp32; out (M, d) bf16; `splits` from
// ln_mlp_splits, with scratch part (splits, M, d) fp32 when it is above 1.
// d, hid multiples of 16.
int ln_mlp_launch(const bf16* y, const bf16* w1, const float* b1, const bf16* w2,
                  const float* b2, bf16* out, float* part, long M, int d, int hid, int splits,
                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  MlpPlan p;
  if (!plan_mlp(M, d, hid, &p) || splits < 1) return (int)cudaErrorInvalidValue;
  cudaError_t e = allow_smem(ln_mlp_kernel, p.smem);
  if (e != cudaSuccess) return (int)e;
  const int nchunks = hid / p.HC, cps = (nchunks + splits - 1) / splits;
  const int S = (nchunks + cps - 1) / cps;
  ln_mlp_kernel<<<dim3((unsigned)p.blocks, 1, S), kThreads, p.smem, s>>>(
      y, w1, b1, w2, b2, out, S > 1 ? part : nullptr, M, d, hid, p.BM, p.HC, cps);
  TRAMBA_CHECK_LAUNCH();
  return S > 1 ? finish_split(part, b2, out, M * d, d, S, s) : 0;
}

// Splits of the hidden dimension that ln_dwms_mlp_launch should use.
int ln_dwms_mlp_splits(int B, int H, int W, int d, int hid, int* splits) {
  int KC, HC;
  if (d % 16 || hid % 16 || !pick_dwms_chunks(d, hid, &KC, &HC))
    return (int)cudaErrorInvalidValue;
  const long tiles = (long)((H + kT - 1) / kT) * ((W + kT - 1) / kT);
  return pick_splits(ln_dwms_kernel, dwms_smem(d, KC, HC), tiles * B, hid / HC, splits);
}

// K7.  y (B, H, W, d) bf16, already LN'd; w1 (hid, d) bf16; b1 (hid) fp32;
// k3 (hid, 3*3), k5 (hid, 5*5), k7 (hid, 7*7) bf16; c3, c5, c7 (hid) fp32;
// w2 (d, hid) bf16; b2 (d) fp32; out (B, H, W, d) bf16; `splits` from
// ln_dwms_mlp_splits, with scratch part (splits, B, H, W, d) fp32 when it is
// above 1.  d, hid multiples of 16.
int ln_dwms_mlp_launch(const bf16* y, const bf16* w1, const float* b1, const bf16* k3,
                       const float* c3, const bf16* k5, const float* c5, const bf16* k7,
                       const float* c7, const bf16* w2, const float* b2, bf16* out, float* part,
                       int B, int H, int W, int d, int hid, int splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int KC, HC;
  if (d % 16 || hid % 16 || splits < 1 || !pick_dwms_chunks(d, hid, &KC, &HC))
    return (int)cudaErrorInvalidValue;
  const size_t smem = dwms_smem(d, KC, HC);
  cudaError_t e = allow_smem(ln_dwms_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const int tiles = ((H + kT - 1) / kT) * ((W + kT - 1) / kT);
  const int nchunks = hid / HC, cps = (nchunks + splits - 1) / splits;
  const int S = (nchunks + cps - 1) / cps;
  ln_dwms_kernel<<<dim3(tiles, B, S), kThreads, smem, s>>>(
      y, w1, b1, k3, c3, k5, c5, k7, c7, w2, b2, out, S > 1 ? part : nullptr, H, W, d, hid, KC,
      HC, cps);
  TRAMBA_CHECK_LAUNCH();
  return S > 1 ? finish_split(part, b2, out, (long)B * H * W * d, d, S, s) : 0;
}

}  // extern "C"
