// PNG row unfiltering (ISO/IEC 15948 §9) with a plain C interface.
//
// The Python decoder (scflow_torch/data/imageio.py) parses the chunks,
// checks the header and inflates the IDAT stream with zlib; this pass
// undoes every row's filter in one call: None, Sub, Up, Average and Paeth,
// 1-4 bytes per pixel, any width. Sums wrap mod 256. It is the numpy
// witness imageio._unfilter, byte for byte.
//
// Build: data/_build.py (C++17, standard library only).

#include <cstdint>
#include <cstdlib>

namespace {

inline uint8_t Paeth(int a, int b, int c) {
  const int pa = std::abs(b - c), pb = std::abs(a - c),
            pc = std::abs(a + b - 2 * c);
  if (pa <= pb && pa <= pc) return uint8_t(a);
  return uint8_t(pb <= pc ? b : c);
}

}  // namespace

extern "C" {

// raw: height rows of (1 filter byte + stride bytes), as inflated; out:
// height × stride unfiltered bytes. Returns 0, or the type of the first
// row whose filter is unknown (5-255), with that row in *bad_row.
int scflow_png_unfilter(const uint8_t* raw, int64_t height, int64_t stride,
                        int bpp, uint8_t* out, int64_t* bad_row) {
  for (int64_t y = 0; y < height; ++y) {
    const uint8_t* line = raw + y * (stride + 1);
    const int kind = line[0];
    ++line;
    uint8_t* cur = out + y * stride;
    const uint8_t* up = y > 0 ? cur - stride : nullptr;
    switch (kind) {
      case 0:
        for (int64_t i = 0; i < stride; ++i) cur[i] = line[i];
        break;
      case 1:
        for (int64_t i = 0; i < stride; ++i)
          cur[i] = uint8_t(line[i] + (i >= bpp ? cur[i - bpp] : 0));
        break;
      case 2:
        for (int64_t i = 0; i < stride; ++i)
          cur[i] = uint8_t(line[i] + (up ? up[i] : 0));
        break;
      case 3:
        for (int64_t i = 0; i < stride; ++i) {
          const int left = i >= bpp ? cur[i - bpp] : 0;
          cur[i] = uint8_t(line[i] + ((left + (up ? up[i] : 0)) >> 1));
        }
        break;
      case 4:
        if (!up) {            // first row: b = c = 0, so Paeth picks a (Sub)
          for (int64_t i = 0; i < stride; ++i)
            cur[i] = uint8_t(line[i] + (i >= bpp ? cur[i - bpp] : 0));
          break;
        }
        for (int64_t i = 0; i < bpp && i < stride; ++i)
          cur[i] = uint8_t(line[i] + up[i]);       // a = c = 0: picks b
        for (int64_t i = bpp; i < stride; ++i)
          cur[i] = uint8_t(line[i] + Paeth(cur[i - bpp], up[i], up[i - bpp]));
        break;
      default:
        *bad_row = y;
        return kind;
    }
  }
  return 0;
}

}  // extern "C"
