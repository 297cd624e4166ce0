// The pixel passes of the training recipe's crop and color augmentations,
// with a plain C interface: OpenCV's uint8 INTER_LINEAR resize, its
// bit-exact GaussianBlur (k 3 and 5), RGB→GRAY, RGB↔HSV, and RandomHSV's
// whole pixel pass fused (RGB→HSV, the shifts and scalings, HSV→RGB).
//
// Each is the numpy witness of scflow_torch/data/cvops.py (or
// color_aug.random_hsv), bit for bit, and so OpenCV 5.0.0's output: the
// same fixed-point steps, the same float32 steps in the same order, and
// std::fma exactly where the witness (and OpenCV's vector code) fuses a
// multiply-add. Built with -ffp-contract=off so that no other
// multiply-add is fused and the bits do not depend on -march.
//
// Build: data/_build.py (C++17, standard library only).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

namespace {

constexpr int kResizeBits = 11;   // INTER_RESIZE_COEF_BITS
constexpr int kHsvShift = 12;
constexpr int64_t kHsvStep = 32;   // pixels a vector step of HSV2RGB

struct ResizeTap {
  int64_t a, b;     // source indices (clipped to the image)
  int32_t wa, wb;   // 11-bit weights
};

// cv2's bilinear taps along one axis: positions (d + 0.5)·scale − 0.5 in
// double rounded to float32. Horizontally a tap outside the image moves to
// the edge with weights (1, 0); vertically only the index is clipped.
std::vector<ResizeTap> ResizeTaps(int64_t n_out, int64_t n_in,
                                  bool clamp_weight) {
  const double scale = 1.0 / (double(n_out) / double(n_in));
  std::vector<ResizeTap> taps(n_out);
  for (int64_t d = 0; d < n_out; ++d) {
    const float pos = float((double(d) + 0.5) * scale - 0.5);
    int64_t i0 = int64_t(std::floor(pos));
    float frac = pos - float(i0);
    if (clamp_weight) {
      if (i0 < 0) frac = 0.0f, i0 = 0;
      if (i0 >= n_in - 1) frac = 0.0f, i0 = n_in - 1;
    }
    const float one = float(1 << kResizeBits);
    taps[d] = {std::clamp<int64_t>(i0, 0, n_in - 1),
               std::clamp<int64_t>(i0 + 1, 0, n_in - 1),
               int32_t(std::nearbyint((1.0f - frac) * one)),
               int32_t(std::nearbyint(frac * one))};
  }
  return taps;
}

// BORDER_REFLECT_101 (numpy's "reflect"): the edge is not repeated.
int64_t Reflect101(int64_t p, int64_t n) {
  if (n == 1) return 0;
  while (p < 0 || p >= n) p = p < 0 ? -p : 2 * n - 2 - p;
  return p;
}

// GaussianBlur with the K integer taps in both directions; a constant K
// lets the compiler unroll the stencils and divide by shifts.
template <int K>
void Blur(const uint8_t* src, int64_t h, int64_t w, int64_t c, uint8_t* dst,
          const int32_t (&taps)[K]) {
  constexpr int r = K / 2;
  constexpr int32_t total = K == 3 ? 16 : 256;   // (sum of the taps)^2
  const int64_t width = w * c;
  // horizontal sums of every source row: the columns within r of an edge
  // through the reflected indices, the others as a contiguous stencil
  std::vector<int32_t> rows(h * width);
  for (int64_t y = 0; y < h; ++y) {
    const uint8_t* s = src + y * width;
    int32_t* out = rows.data() + y * width;
    for (int64_t x = 0; x < w; ++x) {
      if (x == r && w - r > r) x = w - r;     // the interior runs below
      for (int64_t ch = 0; ch < c; ++ch) {
        int32_t acc = 0;
        for (int i = 0; i < K; ++i)
          acc += taps[i] * s[Reflect101(x - r + i, w) * c + ch];
        out[x * c + ch] = acc;
      }
    }
    for (int64_t j = r * c; j < (w - r) * c; ++j) {
      int32_t acc = 0;
      for (int i = 0; i < K; ++i) acc += taps[i] * s[j + (i - r) * c];
      out[j] = acc;
    }
  }
  const int32_t* tap_rows[K];
  for (int64_t y = 0; y < h; ++y) {
    for (int i = 0; i < K; ++i)
      tap_rows[i] = rows.data() + Reflect101(y - r + i, h) * width;
    uint8_t* d = dst + y * width;
    for (int64_t j = 0; j < width; ++j) {
      int32_t acc = 0;
      for (int i = 0; i < K; ++i) acc += taps[i] * tap_rows[i][j];
      d[j] = uint8_t((acc + total / 2) / total);
    }
  }
}

struct HsvTables {
  int32_t sdiv[256], hdiv[256];
  HsvTables() {
    sdiv[0] = hdiv[0] = 0;
    for (int i = 1; i < 256; ++i) {
      sdiv[i] = int32_t(std::nearbyint(double(255 << kHsvShift) / i));
      hdiv[i] = int32_t(std::nearbyint(double(180 << kHsvShift) / (6.0 * i)));
    }
  }
};

const HsvTables& Tables() {
  static const HsvTables tables;
  return tables;
}

inline void RgbToHsv(const uint8_t* px, int32_t* hsv) {
  const HsvTables& t = Tables();
  const int32_t r = px[0], g = px[1], b = px[2];
  const int32_t v = std::max(std::max(r, g), b);
  const int32_t diff = v - std::min(std::min(r, g), b);
  const int32_t round = 1 << (kHsvShift - 1);
  const int32_t s = (diff * t.sdiv[v] + round) >> kHsvShift;
  int32_t h = v == r ? g - b : (v == g ? b - r + 2 * diff : r - g + 4 * diff);
  h = (h * t.hdiv[diff] + round) >> kHsvShift;   // arithmetic: floor
  hsv[0] = h < 0 ? h + 180 : h;
  hsv[1] = s;
  hsv[2] = v;
}

// (r, g, b) columns of the sector table per sector: cv2's sector_data.
constexpr int kSector[6][3] = {{0, 3, 1}, {2, 0, 1}, {1, 0, 3},
                               {1, 2, 0}, {3, 1, 0}, {0, 1, 2}};

// cv2 converts a row kHsvStep pixels a vector step, truncating, and the
// row's last width % kHsvStep pixels in scalar code, rounding half to even
// (`round`); both fuse the two 1 − s·x terms. h, s, v ≥ 0, so an int
// conversion is the vector code's trunc.
inline void HsvToRgb(int32_t hh, int32_t ss, int32_t vv, bool round,
                     uint8_t* px) {
  float h = float(hh) * float(6.0 / 180.0);
  const float s = float(ss) * float(1.0 / 255.0);
  const float v = float(vv) * float(1.0 / 255.0);
  const int sector = int(h);
  h = h - float(sector);
  const float tab[4] = {v, v * (1.0f - s), v * std::fma(-s, h, 1.0f),
                        v * std::fma(-s, 1.0f - h, 1.0f)};
  const int* order = kSector[sector % 6];
  for (int c = 0; c < 3; ++c) {
    const float x = tab[order[c]] * 255.0f;
    px[c] = uint8_t(std::clamp(int32_t(round ? std::nearbyint(x) : x), 0,
                               255));
  }
}

// Calls f(i, round) for the n pixels of rows `width` long.
template <typename F>
void ForRows(int64_t n, int64_t width, F f) {
  const int64_t vector_part = width / kHsvStep * kHsvStep;
  for (int64_t row = 0; row < n; row += width)
    for (int64_t x = 0; x < width && row + x < n; ++x)
      f(row + x, x >= vector_part);
}

// numpy's float32 `a % b` for b > 0: fmod, moved into [0, b) by adding b
// (in float32, which can round up to b itself).
inline float RemainderPositive(float a, float b) {
  float m = std::fmod(a, b);
  if (m < 0.0f) m += b;
  return m == 0.0f ? 0.0f : m;
}

}  // namespace

extern "C" {

// cv2.resize(INTER_LINEAR) of an h × w × c uint8 image to oh × ow × c:
// an integer horizontal pass, then cv2's vectorised vertical pass
// ((b0·(r0 >> 4)) >> 16) + ((b1·(r1 >> 4)) >> 16) + 2) >> 2.
void scflow_resize_linear(const uint8_t* src, int64_t h, int64_t w,
                          int64_t c, uint8_t* dst, int64_t oh, int64_t ow) {
  const std::vector<ResizeTap> xs = ResizeTaps(ow, w, true);
  const std::vector<ResizeTap> ys = ResizeTaps(oh, h, false);
  const int64_t width = ow * c;
  // horizontal passes of the last two source rows used; a new row takes
  // the slot of the lower one, never that of `keep`
  std::vector<int32_t> rows[2] = {std::vector<int32_t>(width),
                                  std::vector<int32_t>(width)};
  int64_t row_of[2] = {-1, -1};
  auto horizontal = [&](int64_t y, int64_t keep) -> const int32_t* {
    for (int k = 0; k < 2; ++k)
      if (row_of[k] == y) return rows[k].data();
    const int k = row_of[0] == keep ? 1
                  : row_of[1] == keep ? 0
                  : row_of[0] <= row_of[1] ? 0 : 1;
    const uint8_t* s = src + y * w * c;
    int32_t* out = rows[k].data();
    for (int64_t x = 0; x < ow; ++x) {
      const ResizeTap t = xs[x];
      for (int64_t ch = 0; ch < c; ++ch)
        out[x * c + ch] = s[t.a * c + ch] * t.wa + s[t.b * c + ch] * t.wb;
    }
    row_of[k] = y;
    return out;
  };
  for (int64_t y = 0; y < oh; ++y) {
    const ResizeTap t = ys[y];
    const int32_t* r0 = horizontal(t.a, -2);
    const int32_t* r1 = horizontal(t.b, t.a);
    uint8_t* d = dst + y * width;
    for (int64_t i = 0; i < width; ++i) {
      const int32_t v = (((t.wa * (r0[i] >> 4)) >> 16) +
                         ((t.wb * (r1[i] >> 4)) >> 16) + 2) >> 2;
      d[i] = uint8_t(std::clamp(v, 0, 255));
    }
  }
}

// cv2.GaussianBlur(img, (k, k), 0), k 3 or 5: the integer kernels
// (1, 2, 1) and (1, 4, 6, 4, 1) in both directions, BORDER_REFLECT_101,
// the sum rounded half up. Returns 1 for another k.
int scflow_gaussian_blur(const uint8_t* src, int64_t h, int64_t w,
                         int64_t c, int k, uint8_t* dst) {
  if (k == 3) {
    Blur<3>(src, h, w, c, dst, {1, 2, 1});
  } else if (k == 5) {
    Blur<5>(src, h, w, c, dst, {1, 4, 6, 4, 1});
  } else {
    return 1;
  }
  return 0;
}

// cv2.cvtColor(COLOR_RGB2GRAY) of n pixels: 15-bit weights, half up.
void scflow_rgb_to_gray(const uint8_t* src, int64_t n, uint8_t* dst) {
  for (int64_t i = 0; i < n; ++i) {
    const uint8_t* p = src + 3 * i;
    dst[i] = uint8_t((9798 * p[0] + 19235 * p[1] + 3735 * p[2] +
                      (1 << 14)) >> 15);
  }
}

// cv2.cvtColor(COLOR_RGB2HSV) of n pixels: H in [0, 180].
void scflow_rgb_to_hsv(const uint8_t* src, int64_t n, uint8_t* dst) {
  int32_t hsv[3];
  for (int64_t i = 0; i < n; ++i) {
    RgbToHsv(src + 3 * i, hsv);
    for (int c = 0; c < 3; ++c) dst[3 * i + c] = uint8_t(hsv[c]);
  }
}

// cv2.cvtColor(COLOR_HSV2RGB) of n pixels in rows of `width`.
void scflow_hsv_to_rgb(const uint8_t* src, int64_t n, int64_t width,
                       uint8_t* dst) {
  ForRows(n, width, [&](int64_t i, bool round) {
    const uint8_t* p = src + 3 * i;
    HsvToRgb(p[0], p[1], p[2], round, dst + 3 * i);
  });
}

// RandomHSV's pixel pass on n RGB pixels in rows of `width`, given its
// draws as float32: HSV; H ← (H + dh) mod 180 (numpy's float32 %),
// S ← clip(S·ds, 0, 255), V ← clip(V·dv, 0, 255); each truncated to
// uint8; back to RGB. The new H, S and V depend on the old value alone:
// tables of 256 per call.
void scflow_hsv_jitter(const uint8_t* src, int64_t n, int64_t width,
                       float dh, float ds, float dv, uint8_t* dst) {
  uint8_t hue[256], sat[256], val[256];
  for (int i = 0; i < 256; ++i) {
    hue[i] = uint8_t(RemainderPositive(float(i) + dh, 180.0f));
    sat[i] = uint8_t(std::clamp(float(i) * ds, 0.0f, 255.0f));
    val[i] = uint8_t(std::clamp(float(i) * dv, 0.0f, 255.0f));
  }
  ForRows(n, width, [&](int64_t i, bool round) {
    int32_t hsv[3];
    RgbToHsv(src + 3 * i, hsv);
    HsvToRgb(hue[hsv[0]], sat[hsv[1]], val[hsv[2]], round, dst + 3 * i);
  });
}

}  // extern "C"
