// Native image-geometry kernel for the data pipeline's hot path (a copy of
// the JAX package's tpu_compressed_dp/native/image_ops.cpp, so that the two
// loaders produce the same bytes).
//
// The per-image work that dominates the host's time: fused crop + resize +
// horizontal flip from a decoded RGB buffer straight into the collated
// uint8 NHWC batch, with no intermediate allocations beyond one float
// scratch row block.
//
// Resize semantics match PIL's BILINEAR (a separable triangle filter whose
// support scales with the downscale ratio -- i.e. antialiased area-weighted
// sampling, not naive 4-tap bilinear), so swapping the Python path for this
// one changes pixels by rounding only.  Called from Python via ctypes
// (tpu_compressed_dp_torch/data/native.py); ctypes drops the GIL for the
// duration, so the loaders' thread pools parallelise across images.
//
// Build: g++ -O3 -fPIC -shared -pthread image_ops.cpp -o libimageops.so

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Taps {
  std::vector<int> start;    // first source index per output index
  std::vector<int> count;    // taps per output index
  std::vector<float> weight; // flattened [out][tap] weights, normalised
  int max_count = 0;
};

// PIL-compatible triangle-filter taps mapping src range [lo, hi) -> out_size.
Taps make_taps(float lo, float hi, int src_size, int out_size) {
  Taps t;
  t.start.resize(out_size);
  t.count.resize(out_size);
  const double scale = (hi - lo) / out_size;
  const double filterscale = std::max(scale, 1.0);
  const double support = 1.0 * filterscale; // bilinear support = 1.0
  t.max_count = (int)std::ceil(support * 2 + 1);
  t.weight.assign((size_t)out_size * t.max_count, 0.0f);
  for (int j = 0; j < out_size; ++j) {
    const double center = lo + (j + 0.5) * scale;
    int xmin = (int)std::max(0.0, std::floor(center - support + 0.5));
    int xmax = (int)std::min((double)src_size, std::floor(center + support + 0.5));
    if (xmax <= xmin) { // degenerate box: clamp to nearest valid pixel
      xmin = std::min(std::max(xmin, 0), src_size - 1);
      xmax = xmin + 1;
    }
    double total = 0.0;
    std::vector<double> w(xmax - xmin);
    for (int x = xmin; x < xmax; ++x) {
      const double d = (x + 0.5 - center) / filterscale;
      const double tw = std::max(0.0, 1.0 - std::abs(d)); // triangle
      w[x - xmin] = tw;
      total += tw;
    }
    if (total <= 0.0) { w.assign(w.size(), 1.0); total = (double)w.size(); }
    t.start[j] = xmin;
    t.count[j] = xmax - xmin;
    for (int k = 0; k < xmax - xmin; ++k)
      t.weight[(size_t)j * t.max_count + k] = (float)(w[k] / total);
  }
  return t;
}

inline uint8_t clamp_u8(float v) {
  return (uint8_t)std::min(255.0f, std::max(0.0f, v + 0.5f));
}

} // namespace

extern "C" {

// Crop the box [x0,y0,x1,y1) out of src (sh x sw x 3 uint8), resize to
// (dh x dw) with PIL-BILINEAR semantics, optional horizontal flip, write
// into dst (dh x dw x 3 uint8).  Returns 0 on success.
int crop_resize_bilinear(const uint8_t* src, int sh, int sw,
                         float x0, float y0, float x1, float y1,
                         uint8_t* dst, int dh, int dw, int flip) {
  if (!src || !dst || sh <= 0 || sw <= 0 || dh <= 0 || dw <= 0) return 1;
  x0 = std::max(0.0f, std::min(x0, (float)sw));
  x1 = std::max(x0, std::min(x1, (float)sw));
  y0 = std::max(0.0f, std::min(y0, (float)sh));
  y1 = std::max(y0, std::min(y1, (float)sh));

  const Taps tx = make_taps(x0, x1, sw, dw);
  const Taps ty = make_taps(y0, y1, sh, dh);

  // horizontal pass: src rows [row_lo, row_hi) -> float (rows x dw x 3)
  const int row_lo = ty.start.empty() ? 0 : *std::min_element(ty.start.begin(), ty.start.end());
  int row_hi = 0;
  for (int j = 0; j < dh; ++j) row_hi = std::max(row_hi, ty.start[j] + ty.count[j]);
  const int rows = row_hi - row_lo;
  std::vector<float> mid((size_t)rows * dw * 3);
  for (int r = 0; r < rows; ++r) {
    const uint8_t* srow = src + (size_t)(r + row_lo) * sw * 3;
    float* mrow = mid.data() + (size_t)r * dw * 3;
    for (int j = 0; j < dw; ++j) {
      float acc0 = 0, acc1 = 0, acc2 = 0;
      const int s = tx.start[j], c = tx.count[j];
      const float* w = &tx.weight[(size_t)j * tx.max_count];
      for (int k = 0; k < c; ++k) {
        const uint8_t* p = srow + (size_t)(s + k) * 3;
        acc0 += w[k] * p[0];
        acc1 += w[k] * p[1];
        acc2 += w[k] * p[2];
      }
      mrow[j * 3 + 0] = acc0;
      mrow[j * 3 + 1] = acc1;
      mrow[j * 3 + 2] = acc2;
    }
  }

  // vertical pass + flip + u8 store
  for (int i = 0; i < dh; ++i) {
    const int s = ty.start[i], c = ty.count[i];
    const float* w = &ty.weight[(size_t)i * ty.max_count];
    uint8_t* drow = dst + (size_t)i * dw * 3;
    for (int j = 0; j < dw; ++j) {
      float acc0 = 0, acc1 = 0, acc2 = 0;
      for (int k = 0; k < c; ++k) {
        const float* p = mid.data() + ((size_t)(s + k - row_lo) * dw + j) * 3;
        acc0 += w[k] * p[0];
        acc1 += w[k] * p[1];
        acc2 += w[k] * p[2];
      }
      const int jj = flip ? (dw - 1 - j) : j;
      drow[jj * 3 + 0] = clamp_u8(acc0);
      drow[jj * 3 + 1] = clamp_u8(acc1);
      drow[jj * 3 + 2] = clamp_u8(acc2);
    }
  }
  return 0;
}

} // extern "C"
