// The eval crop with a plain C interface: for each object box of one RGB
// uint8 frame, crop → keep-ratio bilinear resize → center pad → normalise,
// and the 3×3 affine pad ∘ resize ∘ crop.
//
// The semantics are those of CropResizePadNormalize in the JAX package's
// native library; the arithmetic is the numpy witness
// scflow_torch/data/pipeline._crop_one's, bit for bit: float32 throughout,
// each tap position (o + 0.5)·inv − 0.5 rounded once (std::fma), then
// + start in float32, the bilinear sum in the witness's order, the
// transform's −c·scale + offset rounded once. Built with -ffp-contract=off
// so that no other multiply-add is fused. Taps outside the frame read
// pad_val. No thread pool: callers run images on threads of their own
// (ctypes releases the GIL).
//
// Build: data/_build.py (C++17, standard library only).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

namespace {

constexpr int kChannels = 3;

struct Tap {
  int64_t a, b;   // source indices of the two taps, -1 where outside
  float frac;
};

// Taps of n output samples starting at crop offset `start` over `size`
// source samples.
void Taps(int n, int64_t start, int64_t size, float inv, Tap* taps) {
  for (int o = 0; o < n; ++o) {
    const float s = std::fma(float(o) + 0.5f, inv, -0.5f) + float(start);
    const float fl = std::floor(s);
    const int64_t i0 = int64_t(fl);
    auto inside = [&](int64_t i) { return i >= 0 && i < size ? i : -1; };
    taps[o] = {inside(i0), inside(i0 + 1), s - fl};
  }
}

void CropOne(const uint8_t* img, int64_t h, int64_t w, const float* box,
             int out_size, float pad_val, const float* mean,
             const float* stdv, float* out, float* transform) {
  const int64_t x1 = int64_t(box[0]), y1 = int64_t(box[1]);   // toward 0
  const int64_t x2 = int64_t(box[2]), y2 = int64_t(box[3]);
  const int64_t ch = y2 - y1, cw = x2 - x1;
  if (ch <= 0 || cw <= 0) return;        // pad only, identity transform
  const float scale = float(out_size) / float(std::max(ch, cw));
  const int rh = int(std::min<int64_t>(std::lround(float(ch) * scale),
                                       out_size));
  const int rw = int(std::min<int64_t>(std::lround(float(cw) * scale),
                                       out_size));
  const int top = out_size / 2 - rh / 2, left = out_size / 2 - rw / 2;
  const float inv = 1.0f / scale;
  std::vector<Tap> ys(rh), xs(rw);
  Taps(rh, y1, h, inv, ys.data());
  Taps(rw, x1, w, inv, xs.data());
  // per output sample j = ox·3 + c of a row: its taps' byte offsets in a
  // source row (-1 outside the frame), weights, mean and std
  const int64_t width = int64_t(rw) * kChannels;
  std::vector<int64_t> off_a(width), off_b(width);
  std::vector<float> fx(width), gx(width), mean_j(width), std_j(width);
  for (int ox = 0; ox < rw; ++ox)
    for (int c = 0; c < kChannels; ++c) {
      const int64_t j = int64_t(ox) * kChannels + c;
      const Tap t = xs[ox];
      off_a[j] = t.a >= 0 ? t.a * kChannels + c : -1;
      off_b[j] = t.b >= 0 ? t.b * kChannels + c : -1;
      fx[j] = t.frac;
      gx[j] = 1.0f - t.frac;
      mean_j[j] = mean[c];
      std_j[j] = stdv[c];
    }
  // (1 − fx)·v0 + fx·v1 along the row of source row y (-1: a pad row),
  // for the last two rows used; a new row takes the slot not `keep`
  std::vector<float> rows[2] = {std::vector<float>(width),
                                std::vector<float>(width)};
  int64_t row_of[2] = {-2, -2};
  auto horizontal = [&](int64_t y, int64_t keep) -> const float* {
    for (int k = 0; k < 2; ++k)
      if (row_of[k] == y) return rows[k].data();
    const int k = row_of[0] == keep ? 1 : 0;
    const uint8_t* src = y >= 0 ? img + y * w * kChannels : nullptr;
    float* dst = rows[k].data();
    for (int64_t j = 0; j < width; ++j) {
      const float v0 = src && off_a[j] >= 0 ? float(src[off_a[j]]) : pad_val;
      const float v1 = src && off_b[j] >= 0 ? float(src[off_b[j]]) : pad_val;
      dst[j] = gx[j] * v0 + fx[j] * v1;
    }
    row_of[k] = y;
    return dst;
  };
  for (int oy = 0; oy < rh; ++oy) {
    const Tap ty = ys[oy];
    const float* t0 = horizontal(ty.a, -3);
    const float* t1 = horizontal(ty.b, ty.a);
    const float fy = ty.frac, gy = 1.0f - ty.frac;
    float* dst = out + ((int64_t(top) + oy) * out_size + left) * kChannels;
    for (int64_t j = 0; j < width; ++j)
      dst[j] = (gy * t0[j] + fy * t1[j] - mean_j[j]) / std_j[j];
  }
  transform[0] = transform[4] = scale;
  transform[2] = std::fma(float(-x1), scale, float(left));
  transform[5] = std::fma(float(-y1), scale, float(top));
}

}  // namespace

extern "C" {

// img: h × w × 3 uint8; boxes: n × 4 xyxy (|v| < 2^24, checked by the
// caller); out: n × out_size × out_size × 3 float32; transforms: n × 9.
void scflow_crop_resize_pad(const uint8_t* img, int64_t h, int64_t w,
                            const float* boxes, int n, int out_size,
                            float pad_val, const float* mean,
                            const float* stdv, float* out,
                            float* transforms) {
  const int64_t plane = int64_t(out_size) * out_size * kChannels;
  float pad[kChannels];
  for (int c = 0; c < kChannels; ++c) pad[c] = (pad_val - mean[c]) / stdv[c];
  for (int i = 0; i < n; ++i) {
    float* patch = out + i * plane;
    for (int64_t j = 0; j < plane; j += kChannels)
      std::copy(pad, pad + kChannels, patch + j);
    float* t = transforms + i * 9;
    std::fill(t, t + 9, 0.0f);
    t[0] = t[4] = t[8] = 1.0f;
    CropOne(img, h, w, boxes + i * 4, out_size, pad_val, mean, stdv, patch,
            t);
  }
}

}  // extern "C"
