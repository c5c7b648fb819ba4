// Host-side image preprocessing for the data pipeline (plain C++, no CUDA).
//
// The port's own copy of tramba_tpu/native/preprocess.cpp: separable
// triangle-filter (bilinear) resampling with the same fixed-point
// quantization PIL uses — per-axis coefficient tables in Q22, intermediate
// rounding to uint8 — so outputs are bit-exact with
// PIL.Image.resize(..., BILINEAR), plus nearest-neighbor mask resize and
// fused ImageNet normalization.  A threaded batch entry point preprocesses
// a whole eval batch.  The same integer arithmetic as the JAX package's
// file, with the loops reordered: the horizontal pass sums a tap's channels
// together, and the vertical pass accumulates whole rows, which the
// compiler vectorises.
//
// Built with g++ at first use into a shared library, bound via ctypes
// (tramba_tpu_torch/data/native.py).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr int kPrecisionBits = 32 - 8 - 2;  // PIL's Q22 coefficient format

struct Coeffs {
  std::vector<int> bounds;  // xmin per output index
  std::vector<int> sizes;   // taps per output index
  std::vector<int> coeffs;  // quantized weights, ksize per output index
  int ksize = 0;
};

// Triangle-filter coefficient table, PIL semantics (support scales with
// the downscale factor; weights normalized then quantized round-half-up).
Coeffs precompute(int in_size, int out_size) {
  Coeffs c;
  double scale = static_cast<double>(in_size) / out_size;
  double filterscale = std::max(scale, 1.0);
  double support = 1.0 * filterscale;  // bilinear support = 1
  int ksize = static_cast<int>(std::ceil(support)) * 2 + 1;
  c.ksize = ksize;
  c.bounds.resize(out_size);
  c.sizes.resize(out_size);
  c.coeffs.assign(static_cast<size_t>(out_size) * ksize, 0);
  std::vector<double> w(ksize);
  for (int xx = 0; xx < out_size; ++xx) {
    double center = (xx + 0.5) * scale;
    double ww = 0.0;
    double ss = 1.0 / filterscale;
    int xmin = static_cast<int>(std::max(0.0, std::floor(center - support)));
    int xmax = static_cast<int>(std::min(static_cast<double>(in_size),
                                         std::ceil(center + support))) - xmin;
    for (int x = 0; x < xmax; ++x) {
      double arg = (x + xmin - center + 0.5) * ss;
      double v = std::abs(arg) < 1.0 ? 1.0 - std::abs(arg) : 0.0;  // triangle
      w[x] = v;
      ww += v;
    }
    for (int x = 0; x < xmax; ++x) {
      if (ww != 0.0) w[x] /= ww;
      c.coeffs[static_cast<size_t>(xx) * ksize + x] =
          static_cast<int>(w[x] < 0 ? -0.5 + w[x] * (1 << kPrecisionBits)
                                    : 0.5 + w[x] * (1 << kPrecisionBits));
    }
    c.bounds[xx] = xmin;
    c.sizes[xx] = xmax;
  }
  return c;
}

inline uint8_t clip8(int in) {
  int v = in >> kPrecisionBits;
  return static_cast<uint8_t>(std::min(255, std::max(0, v)));
}

// Horizontal pass of one row, the channels of a tap summed together (CH
// fixed where the compiler can unroll it, 0 for any ch).
template <int CH>
void resize_row(const uint8_t* row, int ch, uint8_t* trow, int ow, const Coeffs& cx) {
  const int c = CH ? CH : ch;
  int ss[4];
  for (int xx = 0; xx < ow; ++xx) {
    const uint8_t* src = row + static_cast<size_t>(cx.bounds[xx]) * c;
    const int* k = cx.coeffs.data() + static_cast<size_t>(xx) * cx.ksize;
    const int xmax = cx.sizes[xx];
    for (int b0 = 0; b0 < c; b0 += 4) {
      const int nb = std::min(4, c - b0);
      for (int b = 0; b < nb; ++b) ss[b] = 1 << (kPrecisionBits - 1);
      for (int x = 0; x < xmax; ++x)
        for (int b = 0; b < nb; ++b) ss[b] += src[x * c + b0 + b] * k[x];
      for (int b = 0; b < nb; ++b) trow[xx * c + b0 + b] = clip8(ss[b]);
    }
  }
}

// One image: (h, w, ch) uint8 -> (oh, ow, ch) uint8, PIL-exact: the
// horizontal pass first, its output rounded to uint8, then the vertical
// pass, as PIL does.  Integer sums, so the order of the taps within a
// pass does not change the result.
void resize_bilinear_one(const uint8_t* in, int h, int w, int ch, uint8_t* out,
                         int oh, int ow) {
  Coeffs cx = precompute(w, ow);
  Coeffs cy = precompute(h, oh);
  // horizontal pass: (h, w) -> (h, ow)
  const size_t n = static_cast<size_t>(ow) * ch;
  std::vector<uint8_t> tmp(static_cast<size_t>(h) * n);
  for (int y = 0; y < h; ++y) {
    const uint8_t* row = in + static_cast<size_t>(y) * w * ch;
    uint8_t* trow = tmp.data() + static_cast<size_t>(y) * n;
    if (ch == 3)
      resize_row<3>(row, ch, trow, ow, cx);
    else if (ch == 1)
      resize_row<1>(row, ch, trow, ow, cx);
    else
      resize_row<0>(row, ch, trow, ow, cx);
  }
  // vertical pass: (h, ow) -> (oh, ow), a whole output row accumulated tap
  // by tap over contiguous input rows
  std::vector<int> acc(n);
  for (int yy = 0; yy < oh; ++yy) {
    const int ymin = cy.bounds[yy];
    const int ymax = cy.sizes[yy];
    const int* k = cy.coeffs.data() + static_cast<size_t>(yy) * cy.ksize;
    std::fill(acc.begin(), acc.end(), 1 << (kPrecisionBits - 1));
    for (int y = 0; y < ymax; ++y) {
      const uint8_t* src = tmp.data() + static_cast<size_t>(ymin + y) * n;
      const int ky = k[y];
      for (size_t i = 0; i < n; ++i) acc[i] += src[i] * ky;
    }
    uint8_t* orow = out + static_cast<size_t>(yy) * n;
    for (size_t i = 0; i < n; ++i) orow[i] = clip8(acc[i]);
  }
}

// PIL NEAREST: sample at floor((i + 0.5) * scale).
void resize_nearest_one(const uint8_t* in, int h, int w, int ch, uint8_t* out,
                        int oh, int ow) {
  double sy = static_cast<double>(h) / oh;
  double sx = static_cast<double>(w) / ow;
  for (int yy = 0; yy < oh; ++yy) {
    int y = std::min(h - 1, static_cast<int>((yy + 0.5) * sy));
    for (int xx = 0; xx < ow; ++xx) {
      int x = std::min(w - 1, static_cast<int>((xx + 0.5) * sx));
      std::memcpy(out + (static_cast<size_t>(yy) * ow + xx) * ch,
                  in + (static_cast<size_t>(y) * w + x) * ch, ch);
    }
  }
}

void normalize_one(const uint8_t* in, int n, int ch, const float* mean,
                   const float* stddev, float* out) {
  for (int i = 0; i < n; ++i)
    for (int b = 0; b < ch; ++b)
      out[static_cast<size_t>(i) * ch + b] =
          (in[static_cast<size_t>(i) * ch + b] / 255.0f - mean[b]) / stddev[b];
}

}  // namespace

extern "C" {

void resize_bilinear_u8(const uint8_t* in, int h, int w, int ch, uint8_t* out,
                        int oh, int ow) {
  resize_bilinear_one(in, h, w, ch, out, oh, ow);
}

void resize_nearest_u8(const uint8_t* in, int h, int w, int ch, uint8_t* out,
                       int oh, int ow) {
  resize_nearest_one(in, h, w, ch, out, oh, ow);
}

void normalize_f32(const uint8_t* in, int n, int ch, const float* mean,
                   const float* stddev, float* out) {
  normalize_one(in, n, ch, mean, stddev, out);
}

// Fused batched eval-path preprocessing: N independent images (each with its
// own size, packed back to back with offsets), resized to (size, size),
// normalized, written into a contiguous (N, size, size, 3) float32 batch and
// the masks into (N, size, size, 1) float32 in [0, 1].  Threaded across
// images.
void preprocess_eval_batch(const uint8_t* images, const int64_t* img_offsets,
                           const int* img_h, const int* img_w,
                           const uint8_t* masks, const int64_t* mask_offsets,
                           int n, int size, const float* mean,
                           const float* stddev, float* out_images,
                           float* out_masks, int num_threads) {
  auto work = [&](int start, int step) {
    std::vector<uint8_t> rbuf(static_cast<size_t>(size) * size * 3);
    std::vector<uint8_t> mbuf(static_cast<size_t>(size) * size);
    for (int i = start; i < n; i += step) {
      resize_bilinear_one(images + img_offsets[i], img_h[i], img_w[i], 3,
                          rbuf.data(), size, size);
      normalize_one(rbuf.data(), size * size, 3, mean, stddev,
                    out_images + static_cast<size_t>(i) * size * size * 3);
      resize_nearest_one(masks + mask_offsets[i], img_h[i], img_w[i], 1,
                         mbuf.data(), size, size);
      float* om = out_masks + static_cast<size_t>(i) * size * size;
      for (int p = 0; p < size * size; ++p) om[p] = mbuf[p] / 255.0f;
    }
  };
  int t = std::max(1, num_threads);
  std::vector<std::thread> threads;
  for (int i = 1; i < t; ++i) threads.emplace_back(work, i, t);
  work(0, t);
  for (auto& th : threads) th.join();
}

}  // extern "C"
