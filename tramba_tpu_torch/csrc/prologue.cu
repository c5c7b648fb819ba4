// K5 prologue: the SS2D prologue of the bf16 inference path,
//   u = y @ w_in^T (fp32), zero outside the image;
//   out = bf16(SiLU(dw3x3(u))) with bf16 taps applied in fp32,
// where y = bf16(LN(x)) (the launch in mlp.cu) or, for the DFVSS guides,
// y = x.
//
// It replaces _prologue_pallas (tramba_tpu/ops/fused_prologue.py:94, kernel
// :57) and the front of _small_pallas (fused_ss2d_small.py:103-131).  The
// conv pads u, not x: a pixel outside the image contributes 0, not the
// in-projection of a zero (or LN-bias) row, so halo rows outside the image are
// staged as zeros and their products stay 0.
//
// One block per (8x8 output tile, DC output channels, image): it stages the
// 10x10 halo tile of y in shared memory (KC input channels at a time),
// multiplies it by DC rows of w_in with bf16 wmma tiles into an fp32 tile,
// then each thread applies the 3x3 taps of one channel and SiLU and writes
// bf16.  What bounds it on an H100: the in-projection (dm*D multiply-adds per
// pixel, 1.56x for the halo) on the tensor cores, with w_in read from L2 by
// every block; the wide map is written once.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kT = 8;                      // output tile kT x kT pixels
constexpr int kE = kT + 2;                 // with the 1-px halo: 10 x 10
constexpr int kMP = (kE * kE + 15) / 16 * 16;  // 112 rows, padded for 16-row tiles

// Shared: ys [112][KC+8] bf16, u32 [112][DC+4] fp32.
__global__ void prologue_kernel(const bf16* __restrict__ y, const bf16* __restrict__ w_in,
                                const bf16* __restrict__ taps, bf16* __restrict__ out, int H,
                                int W, int dm, int D, int KC, int DC) {
  extern __shared__ float4 smem4[];
  const int ldy = KC + 8, ld32 = DC + 4;
  bf16* ys = reinterpret_cast<bf16*>(smem4);
  float* u32 = reinterpret_cast<float*>(ys + kMP * ldy);
  const int tiles_x = (W + kT - 1) / kT;
  const int ty0 = (blockIdx.x / tiles_x) * kT, tx0 = (blockIdx.x % tiles_x) * kT;
  const int c0 = blockIdx.y * DC;
  const int b = blockIdx.z;
  for (int k0 = 0; k0 < dm; k0 += KC) {
    __syncthreads();
    stage_halo(y, b, H, W, dm, ty0 - 1, tx0 - 1, kE, kE, kMP, k0, KC, ys, ldy);
    __syncthreads();
    mma_tiles(ys, ldy, w_in + (long)c0 * dm + k0, dm, u32, ld32, kMP / 16, DC / 16, KC, k0 > 0);
  }
  __syncthreads();
  const int j = threadIdx.x % DC, g = threadIdx.x / DC, G = blockDim.x / DC;
  const int c = c0 + j;
  float t[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) t[i] = to_f32(taps[(long)c * 9 + i]);
  const float* uj = u32 + j;
  for (int p = g; p < kT * kT; p += G) {
    const int py = p / kT, px = p % kT;
    const int gy = ty0 + py, gx = tx0 + px;
    if (gy >= H || gx >= W) continue;
    float a = 0.f;
#pragma unroll
    for (int u = 0; u < 3; ++u)
#pragma unroll
      for (int v = 0; v < 3; ++v) a = fmaf(t[u * 3 + v], uj[((py + u) * kE + px + v) * ld32], a);
    out[(((long)b * H + gy) * W + gx) * D + c] = __float2bfloat16_rn(a / (1.f + expf(-a)));
  }
}

size_t prologue_smem(int KC, int DC) {
  return (size_t)kMP * ((KC + 8) * 2 + (DC + 4) * 4);
}

}  // namespace

extern "C" {

// K5.  y (B, H, W, dm) bf16 (LN'd, or the raw input); w_in (D, dm) bf16;
// taps (D, 3*3) bf16; out (B, H, W, D) bf16.  dm, D multiples of 16.
int prologue_launch(const bf16* y, const bf16* w_in, const bf16* taps, bf16* out, int B, int H,
                    int W, int dm, int D, void* stream) {
  if (dm % 16 || D % 16) return (int)cudaErrorInvalidValue;
  int KC = 16;  // input channels per staged chunk: a multiple of 16 dividing dm, <= 256
  for (int kc = 32; kc <= 256 && kc <= dm; kc += 16)
    if (dm % kc == 0) KC = kc;
  const int DC = D % 64 == 0 ? 64 : (D % 32 == 0 ? 32 : 16);
  const size_t smem = prologue_smem(KC, DC);
  cudaError_t e = allow_smem(prologue_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(((H + kT - 1) / kT) * ((W + kT - 1) / kT), D / DC, B);
  prologue_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      y, w_in, taps, out, H, W, dm, D, KC, DC);
  TRAMBA_CHECK_LAUNCH();
  return 0;
}

}  // extern "C"
