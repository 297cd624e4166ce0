// A self-contained JPEG decoder with a plain C interface.
//
// It decodes the files cv2.imread decodes through libjpeg-turbo with that
// library's defaults (ISLOW IDCT, fancy upsampling) and returns the same
// pixels, bit for bit: RGB for a color read (libjpeg's JCS_RGB output) and
// the Y plane for a gray read (JCS_GRAYSCALE, chroma not decoded). Every
// step is integer arithmetic copied from libjpeg-turbo's C code, so the
// output does not depend on the compiler's flags:
//
//   jdhuff.c / jdphuff.c   sequential and progressive Huffman decoding
//   jidctint.c             jpeg_idct_islow, with its range-limit table
//   jdsample.c             h2v1 / h2v2 / h1v2 fancy upsampling, int_upsample
//   jdcolor.c              ycc_rgb_convert, rgb_gray_convert
//   jdmainct.c             the context rows at the image's edges
//   jdapimin.c             default_decompress_parms (the color space)
//
// Accepted: Huffman baseline, extended sequential (SOF0/SOF1) and
// progressive (SOF2) files at 8-bit precision with 1 or 3 components, any
// integral sampling factors, restart intervals, JFIF YCbCr and Adobe /
// 'R','G','B' RGB. Refused, with a message: arithmetic coding, lossless
// and hierarchical processes, 12-bit precision, 2 or 4 components, an
// EXIF orientation cv2 would apply, a progressive file whose first ten
// coefficients are not fully refined (libjpeg would block-smooth it) and a
// truncated or corrupt entropy stream (libjpeg pads with zeros and warns).
//
// Build: c++ -std=c++17 -O2 -fPIC -shared jpeg_decode.cpp (no library).

#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <exception>
#include <string>
#include <utility>
#include <vector>

namespace {

struct Refused : std::exception {
  std::string msg;
  explicit Refused(std::string m) : msg(std::move(m)) {}
};

[[noreturn]] void refuse(const std::string& msg) { throw Refused(msg); }

// Header incomplete: the data ends before the first scan (jpeg_info only).
struct NeedMore : std::exception {};

// jpeg_natural_order: zigzag index -> natural (row-major) index.
const int kNatural[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// Block smoothing (jdcoefct.c) looks at the first SAVED_COEFS coefficients
// of a progressive file: 6 in libjpeg-turbo 2.0, 10 since 2.1.
constexpr int kSmoothedCoefs = 10;
constexpr int kLookBits = 9;

struct Huffman {
  bool defined = false;
  int max_symbol = 0;
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint8_t huffval[256];
  uint16_t lookup[1 << kLookBits];  // (length << 8) | symbol; 0: longer

  // jpeg_make_d_derived_tbl
  void build(const uint8_t counts[17], const uint8_t* vals, int nvals) {
    std::memcpy(huffval, vals, nvals);
    max_symbol = 0;
    for (int i = 0; i < nvals; i++)
      if (vals[i] > max_symbol) max_symbol = vals[i];
    std::memset(lookup, 0, sizeof lookup);
    int32_t code = 0;
    int p = 0;
    for (int l = 1; l <= 16; l++) {
      if (counts[l]) {
        valoffset[l] = p - code;
        for (int i = 0; i < counts[l]; i++, p++, code++) {
          if (l <= kLookBits) {
            int shift = kLookBits - l;
            for (int c = 0; c < (1 << shift); c++)
              lookup[(code << shift) + c] = (uint16_t)((l << 8) | vals[p]);
          }
        }
        maxcode[l] = code - 1;
      } else {
        maxcode[l] = -1;
      }
      // no code may be all ones
      if (code >= (int32_t(1) << l)) refuse("bad Huffman table");
      code <<= 1;
    }
    maxcode[17] = 0x7FFFFFFF;
    defined = true;
  }
};

// Reads the entropy-coded segment: drops stuffed zeros (FF 00, also after
// fill FFs) and stops at a marker. Past the marker it supplies zero bits,
// as libjpeg does, and counts them: consuming one is a truncated stream.
struct BitReader {
  const uint8_t* data;
  size_t size;
  size_t pos;
  uint64_t acc = 0;  // left-aligned: bit 63 is the next bit
  int nbits = 0;
  int fake = 0;  // zero bits at the end of acc that are not data
  bool at_marker = false;

  BitReader(const uint8_t* d, size_t n, size_t p) : data(d), size(n), pos(p) {}

  void fill() {
    while (nbits <= 56) {
      uint64_t byte = 0;
      if (!at_marker) {
        if (pos >= size) {
          at_marker = true;
        } else if (data[pos] != 0xFF) {
          byte = data[pos++];
        } else {
          size_t p = pos + 1;
          while (p < size && data[p] == 0xFF) p++;
          if (p < size && data[p] == 0) {
            byte = 0xFF;
            pos = p + 1;
          } else {
            at_marker = true;  // pos stays on the marker's first FF
          }
        }
      }
      if (at_marker) fake += 8;
      acc |= byte << (56 - nbits);
      nbits += 8;
    }
  }
  void need(int n) {
    if (nbits < n) fill();
  }
  uint32_t peek(int n) const { return (uint32_t)(acc >> (64 - n)); }
  void skip(int n) {
    acc <<= n;
    nbits -= n;
    if (nbits < fake) refuse("truncated or corrupt entropy-coded data");
  }
  int bits(int n) {
    need(n);
    int v = (int)peek(n);
    skip(n);
    return v;
  }
  int bit() { return bits(1); }
  int decode(const Huffman& t) {
    need(16);
    uint16_t e = t.lookup[peek(kLookBits)];
    if (e) {
      skip(e >> 8);
      return e & 0xFF;
    }
    int l = kLookBits + 1;
    int32_t code = (int32_t)peek(l);
    while (code > t.maxcode[l]) {
      if (++l > 16) refuse("corrupt entropy-coded data (bad Huffman code)");
      code = (int32_t)peek(l);
    }
    skip(l);
    return t.huffval[(code + t.valoffset[l]) & 0xFF];
  }
  // Whole bytes of data left unread in the buffer: libjpeg counts them
  // as discarded (finish_pass_huff, process_restart).
  void check_consumed() const {
    if (nbits - fake >= 8) refuse("corrupt entropy-coded data (extraneous bytes)");
  }
  // The marker at pos (after fill FFs); pos moves past it. Data before it
  // is what libjpeg's next_marker discards with a warning: refused.
  int next_marker() {
    check_consumed();
    acc = 0;
    nbits = fake = 0;
    at_marker = false;
    if (pos >= size) return -1;
    if (data[pos] != 0xFF) refuse("corrupt entropy-coded data (extraneous bytes)");
    while (pos < size && data[pos] == 0xFF) pos++;
    if (pos >= size) return -1;
    return data[pos++];  // not 0: fill() stopped at this marker
  }
};

// How a scan codes its coefficients.
enum ScanKind { kSequential, kDcFirst, kDcRefine, kAcFirst, kAcRefine };

// HUFF_EXTEND
inline int extend(int v, int s) { return v < (1 << (s - 1)) ? v + (-(1 << s) + 1) : v; }

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int dc_table = 0, ac_table = 0;
  int dw = 0, dh = 0;    // downsampled width / height in samples
  int wib = 0, hib = 0;  // width / height in blocks (non-interleaved scans)
  int bw = 0, bh = 0;    // blocks in the buffer (whole MCUs)
  bool latched = false;
  int16_t quant[64];  // natural order, latched at the first scan
  int coef_bits[64];  // progressive: Al of the last scan, -1 never coded
  int pred = 0;
  std::vector<int16_t> coef;
  int16_t* block(int bx, int by) { return &coef[((size_t)by * bw + bx) * 64]; }
};

struct Decoder {
  const uint8_t* data;
  size_t size;
  size_t pos = 0;
  int width = 0, height = 0, precision = 0, ncomp = 0;
  int process = -1;  // SOF n; -1 before the frame header
  bool progressive = false;
  int maxh = 1, maxv = 1, mcux = 0, mcuy = 0;
  int restart_interval = 0;
  bool saw_jfif = false, saw_adobe = false;
  int adobe_transform = 0;
  bool quant_defined[4] = {false, false, false, false};
  uint16_t quant[4][64];  // natural order
  Huffman dc[4], ac[4];
  std::vector<Component> comps;
  bool is_rgb = false;  // jpeg_color_space JCS_RGB (else YCbCr or gray)
  int eobrun = 0;

  Decoder(const uint8_t* d, size_t n) : data(d), size(n) {}

  int u8() {
    if (pos >= size) throw NeedMore();
    return data[pos++];
  }
  int u16() {
    int hi = u8();
    return (hi << 8) | u8();
  }
  // A marker segment's payload: [start, end).
  std::pair<size_t, size_t> segment() {
    int len = u16();
    if (len < 2) refuse("bad marker segment length");
    size_t start = pos, end = pos + (size_t)(len - 2);
    if (end > size) throw NeedMore();
    pos = end;
    return {start, end};
  }
  // libjpeg's next_marker: an FF, fill FFs, the marker. libjpeg skips
  // other bytes before it with a warning; they are refused here.
  int next_marker() {
    if (u8() != 0xFF) refuse("corrupt data (extraneous bytes before a marker)");
    int c;
    do c = u8(); while (c == 0xFF);
    if (c == 0) refuse("corrupt data (extraneous bytes before a marker)");
    return c;
  }

  // ---- marker segments --------------------------------------------------

  void read_sof(int marker) {
    if (process >= 0) refuse("more than one frame header");
    auto [s, e] = segment();
    size_t p = s;
    if (e - s < 6) refuse("short frame header");
    precision = data[p];
    height = (data[p + 1] << 8) | data[p + 2];
    width = (data[p + 3] << 8) | data[p + 4];
    ncomp = data[p + 5];
    p += 6;
    process = marker - 0xC0;
    progressive = marker == 0xC2;
    if (precision != 8)
      refuse(std::to_string(precision) + "-bit precision (8-bit only)");
    if (ncomp == 4)
      refuse("4 components (CMYK/YCCK) are not decoded (1 or 3 only)");
    if (ncomp != 1 && ncomp != 3)
      refuse(std::to_string(ncomp) + " components (1 or 3 only)");
    if (width == 0 || height == 0)
      refuse("empty image or height defined by DNL (not supported)");
    if ((int64_t)width * height > (int64_t(1) << 30))  // cv2's pixel limit
      refuse("more than 2^30 pixels");
    if (e - p < (size_t)(3 * ncomp)) refuse("short frame header");
    comps.resize(ncomp);
    maxh = maxv = 1;
    for (auto& c : comps) {
      c.id = data[p];
      c.h = data[p + 1] >> 4;
      c.v = data[p + 1] & 15;
      c.tq = data[p + 2];
      p += 3;
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4)
        refuse("bad sampling factors");
      if (c.tq > 3) refuse("bad quantization table index");
      if (c.h > maxh) maxh = c.h;
      if (c.v > maxv) maxv = c.v;
    }
    for (auto& c : comps)
      if (maxh % c.h || maxv % c.v)
        refuse("fractional sampling factors (not supported)");
    mcux = (width + 8 * maxh - 1) / (8 * maxh);
    mcuy = (height + 8 * maxv - 1) / (8 * maxv);
    for (auto& c : comps) {
      c.dw = (int)(((int64_t)width * c.h + maxh - 1) / maxh);
      c.dh = (int)(((int64_t)height * c.v + maxv - 1) / maxv);
      c.wib = (c.dw + 7) / 8;
      c.hib = (c.dh + 7) / 8;
      c.bw = mcux * c.h;
      c.bh = mcuy * c.v;
      for (int k = 0; k < 64; k++) c.coef_bits[k] = -1;
    }
  }

  void read_dqt() {
    auto [s, e] = segment();
    size_t p = s;
    while (p < e) {
      int pq = data[p] >> 4, tq = data[p] & 15;
      p++;
      if (tq > 3 || pq > 1) refuse("bad quantization table");
      size_t n = pq ? 128 : 64;
      if (p + n > e) refuse("short quantization table");
      for (int k = 0; k < 64; k++) {
        int q = pq ? (data[p + 2 * k] << 8) | data[p + 2 * k + 1] : data[p + k];
        quant[tq][kNatural[k]] = (uint16_t)q;
      }
      quant_defined[tq] = true;
      p += n;
    }
  }

  void read_dht() {
    auto [s, e] = segment();
    size_t p = s;
    while (p < e) {
      if (p + 17 > e) refuse("short Huffman table");
      int tc = data[p] >> 4, th = data[p] & 15;
      uint8_t counts[17] = {0};
      int total = 0;
      for (int l = 1; l <= 16; l++) total += counts[l] = data[p + l];
      p += 17;
      if (tc > 1 || th > 3 || total > 256 || p + total > e)
        refuse("bad Huffman table");
      (tc ? ac[th] : dc[th]).build(counts, data + p, total);
      p += total;
    }
  }

  void read_app(int marker) {
    auto [s, e] = segment();
    const uint8_t* d = data + s;
    size_t n = e - s;
    if (marker == 0xE0 && n >= 14 && std::memcmp(d, "JFIF\0", 5) == 0) {
      saw_jfif = true;
    } else if (marker == 0xEE && n >= 12 && std::memcmp(d, "Adobe", 5) == 0) {
      saw_adobe = true;
      adobe_transform = d[11];
    } else if (marker == 0xE1 && n >= 14 && std::memcmp(d, "Exif\0\0", 6) == 0) {
      check_orientation(d + 6, n - 6);
    }
  }

  // cv2.imread rotates or flips by the EXIF orientation (2..8); the port
  // does not, so it refuses such a file rather than return other pixels.
  static void check_orientation(const uint8_t* t, size_t n) {
    bool le;
    if (t[0] == 'I' && t[1] == 'I') le = true;
    else if (t[0] == 'M' && t[1] == 'M') le = false;
    else return;
    auto rd16 = [&](size_t o) -> int {
      return le ? t[o] | (t[o + 1] << 8) : (t[o] << 8) | t[o + 1];
    };
    auto rd32 = [&](size_t o) -> uint32_t {
      return le ? (uint32_t)rd16(o) | ((uint32_t)rd16(o + 2) << 16)
                : ((uint32_t)rd16(o) << 16) | (uint32_t)rd16(o + 2);
    };
    uint32_t ifd = rd32(4);
    if ((size_t)ifd + 2 > n) return;
    int count = rd16(ifd);
    for (int i = 0; i < count; i++) {
      size_t at = ifd + 2 + 12 * (size_t)i;
      if (at + 12 > n) return;
      if (rd16(at) == 0x0112) {
        int value = rd16(at + 8);
        if (value >= 2 && value <= 8)
          refuse("EXIF orientation " + std::to_string(value) +
                 " (cv2 would rotate or flip the image; not supported)");
        return;
      }
    }
  }

  // Walk the markers up to the first SOS (left unread) and check the frame.
  void read_headers() {
    if (size < 2 || data[0] != 0xFF || data[1] != 0xD8) refuse("not a JPEG file");
    pos = 2;
    for (;;) {
      int m = next_marker();
      if (m == 0xDA) {
        if (process < 0) refuse("scan before the frame header");
        // default_decompress_parms: the color space of 3 components, from
        // the markers seen before the first scan
        if (ncomp == 3) {
          if (saw_jfif)
            is_rgb = false;
          else if (saw_adobe)
            is_rgb = adobe_transform == 0;
          else
            is_rgb = comps[0].id == 'R' && comps[1].id == 'G' && comps[2].id == 'B';
        }
        return;
      }
      handle_marker(m);
    }
  }

  void handle_marker(int m) {
    switch (m) {
      case 0xC0: case 0xC1: case 0xC2:
        read_sof(m);
        break;
      case 0xC3:
        refuse("lossless JPEG (SOF3) is not supported");
      case 0xC5: case 0xC6: case 0xC7:
        refuse("hierarchical JPEG (SOF" + std::to_string(m - 0xC0) +
               ") is not supported");
      case 0xC9: case 0xCA: case 0xCB: case 0xCD: case 0xCE: case 0xCF:
        refuse("arithmetic-coded JPEG (SOF" + std::to_string(m - 0xC0) +
               ") is not supported");
      case 0xCC:
        refuse("arithmetic-coded JPEG (DAC) is not supported");
      case 0xC4: read_dht(); break;
      case 0xDB: read_dqt(); break;
      case 0xDD: {
        auto [s, e] = segment();
        if (e - s < 2) refuse("short restart interval");
        restart_interval = (data[s] << 8) | data[s + 1];
        break;
      }
      case 0xD8: refuse("duplicate SOI marker");
      case 0xD9: refuse("EOI before the first scan");
      case 0xDC: case 0xFE: segment(); break;  // DNL, COM
      case 0x01: case 0xD0: case 0xD1: case 0xD2: case 0xD3:
      case 0xD4: case 0xD5: case 0xD6: case 0xD7:
        break;  // parameterless (libjpeg traces and ignores them)
      default:
        if (m >= 0xE0 && m <= 0xEF) {
          read_app(m);
          break;
        }
        char buf[64];
        std::snprintf(buf, sizeof buf, "unknown JPEG marker 0x%02X", m);
        refuse(buf);
    }
  }

  // ---- scans -----------------------------------------------------------

  void latch_quant(Component& c) {
    if (c.latched) return;
    if (!quant_defined[c.tq]) refuse("quantization table missing");
    for (int k = 0; k < 64; k++) c.quant[k] = (int16_t)quant[c.tq][k];
    c.latched = true;
  }

  // Reads the SOS header at pos (after the marker), decodes the scan.
  void decode_scan() {
    auto [s, e] = segment();
    size_t p = s;
    if (e - s < 1) refuse("short scan header");
    int ns = data[p++];
    if (ns < 1 || ns > 4 || ns > ncomp || e - p < (size_t)(2 * ns + 3))
      refuse("bad scan header");
    std::vector<Component*> sc;
    for (int i = 0; i < ns; i++) {
      int id = data[p], tables = data[p + 1];
      p += 2;
      Component* found = nullptr;
      for (auto& c : comps)
        if (c.id == id) found = &c;
      if (!found) refuse("scan names an unknown component");
      for (auto* c : sc)
        if (c == found) refuse("scan names a component twice");
      found->dc_table = tables >> 4;
      found->ac_table = tables & 15;
      if (found->dc_table > 3 || found->ac_table > 3) refuse("bad Huffman table index");
      sc.push_back(found);
    }
    int ss = data[p], se = data[p + 1], ah = data[p + 2] >> 4, al = data[p + 2] & 15;
    if (ns > 1) {
      int blocks = 0;
      for (auto* c : sc) blocks += c->h * c->v;
      if (blocks > 10) refuse("too many blocks in an MCU");
    }
    for (auto* c : sc) latch_quant(*c);

    ScanKind kind;
    if (!progressive) {
      kind = kSequential;  // Ss/Se/Ah/Al ignored, as libjpeg does
    } else {
      bool bad = false;
      if (ss == 0) {
        bad = se != 0;
      } else {
        bad = ss > se || se > 63 || ns != 1;
      }
      if (ah != 0 && al != ah - 1) bad = true;
      if (al > 13) bad = true;
      if (bad) refuse("invalid progressive scan parameters");
      for (auto* c : sc) {
        if (ss != 0 && c->coef_bits[0] < 0) refuse("bogus progression (AC before DC)");
        for (int k = ss; k <= se; k++) {
          int expected = c->coef_bits[k] < 0 ? 0 : c->coef_bits[k];
          if (ah != expected) refuse("bogus progression (scan out of order)");
          c->coef_bits[k] = al;
        }
      }
      kind = ss == 0 ? (ah == 0 ? kDcFirst : kDcRefine) : (ah == 0 ? kAcFirst : kAcRefine);
    }
    for (auto* c : sc) {
      bool need_dc = kind == kSequential || kind == kDcFirst;
      bool need_ac = kind == kSequential || kind == kAcFirst || kind == kAcRefine;
      if (need_dc && (!dc[c->dc_table].defined || dc[c->dc_table].max_symbol > 15))
        refuse("DC Huffman table missing or bad");
      if (need_ac && !ac[c->ac_table].defined) refuse("AC Huffman table missing");
      if (c->coef.empty()) c->coef.assign((size_t)c->bw * c->bh * 64, 0);
      c->pred = 0;
    }
    eobrun = 0;

    BitReader br(data, size, pos);
    // MCU layout: one block per MCU for a single-component scan
    int nmcu;
    int mcus_per_row;
    if (ns == 1) {
      mcus_per_row = sc[0]->wib;
      nmcu = sc[0]->wib * sc[0]->hib;
    } else {
      mcus_per_row = mcux;
      nmcu = mcux * mcuy;
    }
    int restarts_to_go = restart_interval;
    int next_rst = 0;
    for (int m = 0; m < nmcu; m++) {
      if (restart_interval) {
        if (restarts_to_go == 0) {
          int marker = br.next_marker();
          if (marker != 0xD0 + next_rst)
            refuse("corrupt entropy-coded data (restart marker missing)");
          next_rst = (next_rst + 1) & 7;
          restarts_to_go = restart_interval;
          for (auto* c : sc) c->pred = 0;
          eobrun = 0;
        }
        restarts_to_go--;
      }
      int mx = m % mcus_per_row, my = m / mcus_per_row;
      if (ns == 1) {
        decode_block(br, kind, *sc[0], sc[0]->block(mx, my), ss, se, al);
      } else {
        for (auto* c : sc)
          for (int by = 0; by < c->v; by++)
            for (int bx = 0; bx < c->h; bx++)
              decode_block(br, kind, *c, c->block(mx * c->h + bx, my * c->v + by), ss, se, al);
      }
    }
    br.check_consumed();
    pos = br.pos;  // on the next marker
  }

  void decode_block(BitReader& br, ScanKind kind, Component& c, int16_t* blk,
                    int ss, int se, int al) {
    switch (kind) {
      case kSequential: {  // jdhuff.c decode_mcu_slow
        int s = br.decode(dc[c.dc_table]);
        if (s) s = extend(br.bits(s), s);
        c.pred += s;
        blk[0] = (int16_t)c.pred;
        const Huffman& t = ac[c.ac_table];
        for (int k = 1; k < 64; k++) {
          int rs = br.decode(t);
          int r = rs >> 4;
          s = rs & 15;
          if (s) {
            k += r;
            if (k > 63) refuse("corrupt entropy-coded data (coefficient past 63)");
            blk[kNatural[k]] = (int16_t)extend(br.bits(s), s);
          } else {
            if (r != 15) break;
            k += 15;
          }
        }
        break;
      }
      case kDcFirst: {  // jdphuff.c decode_mcu_DC_first
        int s = br.decode(dc[c.dc_table]);
        if (s) s = extend(br.bits(s), s);
        c.pred += s;
        blk[0] = (int16_t)(c.pred * (1 << al));
        break;
      }
      case kDcRefine:
        if (br.bit()) blk[0] |= (int16_t)(1 << al);
        break;
      case kAcFirst: {
        if (eobrun > 0) {
          eobrun--;
          break;
        }
        const Huffman& t = ac[c.ac_table];
        for (int k = ss; k <= se; k++) {
          int rs = br.decode(t);
          int r = rs >> 4, s = rs & 15;
          if (s) {
            k += r;
            if (k > se) refuse("corrupt entropy-coded data (coefficient past the band)");
            blk[kNatural[k]] = (int16_t)(extend(br.bits(s), s) * (1 << al));
          } else if (r == 15) {
            k += 15;
          } else {
            eobrun = 1 << r;
            if (r) eobrun += br.bits(r);
            eobrun--;
            break;
          }
        }
        break;
      }
      case kAcRefine:
        ac_refine(br, c, blk, ss, se, al);
        break;
    }
  }

  // jdphuff.c decode_mcu_AC_refine
  void ac_refine(BitReader& br, Component& c, int16_t* blk, int ss, int se, int al) {
    const int p1 = 1 << al;
    const int m1 = -1 * (1 << al);
    int k = ss;
    if (eobrun == 0) {
      const Huffman& t = ac[c.ac_table];
      for (; k <= se; k++) {
        int rs = br.decode(t);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          if (s != 1) refuse("corrupt entropy-coded data (bad refinement code)");
          s = br.bit() ? p1 : m1;
        } else if (r != 15) {
          eobrun = 1 << r;
          if (r) eobrun += br.bits(r);
          break;  // the rest of the block is handled by the EOB run
        }
        // skip r zero coefficients, correcting the nonzero ones passed
        do {
          int16_t* coef = blk + kNatural[k];
          if (*coef != 0) {
            if (br.bit() && (*coef & p1) == 0)
              *coef = (int16_t)(*coef >= 0 ? *coef + p1 : *coef + m1);
          } else {
            if (--r < 0) break;  // the target zero coefficient
          }
          k++;
        } while (k <= se);
        if (s) {
          if (k > se) refuse("corrupt entropy-coded data (coefficient past the band)");
          blk[kNatural[k]] = (int16_t)s;
        }
      }
    }
    if (eobrun > 0) {
      for (; k <= se; k++) {
        int16_t* coef = blk + kNatural[k];
        if (*coef != 0 && br.bit() && (*coef & p1) == 0)
          *coef = (int16_t)(*coef >= 0 ? *coef + p1 : *coef + m1);
      }
      eobrun--;
    }
  }

  // Decode every scan up to EOI (or the end of the data, which libjpeg
  // treats as EOI with a warning).
  void read_all() {
    try {
      read_headers();
    } catch (const NeedMore&) {
      refuse("truncated file");
    }
    for (;;) {
      decode_scan();
      int m;
      try {
        do {
          m = next_marker();
          if (m != 0xDA && m != 0xD9) handle_marker(m);
        } while (m != 0xDA && m != 0xD9);
      } catch (const NeedMore&) {
        break;  // the data ends after a scan: libjpeg supplies an EOI
      }
      if (m == 0xD9) break;
    }
    for (auto& c : comps) {
      if (c.coef.empty()) refuse("a component is never coded");
      if (progressive)
        for (int k = 0; k < kSmoothedCoefs; k++)
          if (c.coef_bits[k] != 0)
            refuse("progressive scans leave the first coefficients incomplete "
                   "(libjpeg would block-smooth them; not supported)");
    }
  }
};

// ---- jidctint.c jpeg_idct_islow -------------------------------------------

constexpr int kConstBits = 13;
constexpr int kPass1Bits = 2;
constexpr int32_t FIX_0_298631336 = 2446;
constexpr int32_t FIX_0_390180644 = 3196;
constexpr int32_t FIX_0_541196100 = 4433;
constexpr int32_t FIX_0_765366865 = 6270;
constexpr int32_t FIX_0_899976223 = 7373;
constexpr int32_t FIX_1_175875602 = 9633;
constexpr int32_t FIX_1_501321110 = 12299;
constexpr int32_t FIX_1_847759065 = 15137;
constexpr int32_t FIX_1_961570560 = 16069;
constexpr int32_t FIX_2_053119869 = 16819;
constexpr int32_t FIX_2_562915447 = 20995;
constexpr int32_t FIX_3_072711026 = 25172;

inline int64_t descale(int64_t x, int n) { return (x + (int64_t(1) << (n - 1))) >> n; }

// The post-IDCT range-limit table (jdmaster.c prepare_range_limit_table),
// indexed by x & RANGE_MASK: x + 128 clamped to 0..255 for -384 <= x < 384,
// and wrapping beyond, as libjpeg's table does.
struct RangeLimit {
  uint8_t t[1024];
  RangeLimit() {
    for (int i = 0; i < 1024; i++)
      t[i] = i < 128 ? (uint8_t)(i + 128) : i < 512 ? 255 : i < 896 ? 0 : (uint8_t)(i - 896);
  }
  uint8_t operator()(int64_t x) const { return t[x & 1023]; }
};
const RangeLimit kRange;

void idct_islow(const int16_t* in, const int16_t* q, uint8_t* out, int stride) {
  int ws[64];
  for (int col = 0; col < 8; col++) {
    const int16_t* ip = in + col;
    const int16_t* qp = q + col;
    int* wp = ws + col;
    if (!ip[8] && !ip[16] && !ip[24] && !ip[32] && !ip[40] && !ip[48] && !ip[56]) {
      int dcval = (int)((int64_t)ip[0] * qp[0] * (1 << kPass1Bits));
      for (int r = 0; r < 8; r++) wp[8 * r] = dcval;
      continue;
    }
    int64_t z2 = (int64_t)ip[16] * qp[16], z3 = (int64_t)ip[48] * qp[48];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = (int64_t)ip[0] * qp[0];
    z3 = (int64_t)ip[32] * qp[32];
    int64_t tmp0 = (z2 + z3) * (1 << kConstBits);
    int64_t tmp1 = (z2 - z3) * (1 << kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;

    tmp0 = (int64_t)ip[56] * qp[56];
    tmp1 = (int64_t)ip[40] * qp[40];
    tmp2 = (int64_t)ip[24] * qp[24];
    tmp3 = (int64_t)ip[8] * qp[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int sh = kConstBits - kPass1Bits;
    wp[0] = (int)descale(tmp10 + tmp3, sh);
    wp[56] = (int)descale(tmp10 - tmp3, sh);
    wp[8] = (int)descale(tmp11 + tmp2, sh);
    wp[48] = (int)descale(tmp11 - tmp2, sh);
    wp[16] = (int)descale(tmp12 + tmp1, sh);
    wp[40] = (int)descale(tmp12 - tmp1, sh);
    wp[24] = (int)descale(tmp13 + tmp0, sh);
    wp[32] = (int)descale(tmp13 - tmp0, sh);
  }
  for (int row = 0; row < 8; row++) {
    const int* wp = ws + 8 * row;
    uint8_t* op = out + (size_t)row * stride;
    if (!wp[1] && !wp[2] && !wp[3] && !wp[4] && !wp[5] && !wp[6] && !wp[7]) {
      uint8_t v = kRange(descale(wp[0], kPass1Bits + 3));
      for (int i = 0; i < 8; i++) op[i] = v;
      continue;
    }
    int64_t z2 = wp[2], z3 = wp[6];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    int64_t tmp0 = ((int64_t)wp[0] + wp[4]) * (1 << kConstBits);
    int64_t tmp1 = ((int64_t)wp[0] - wp[4]) * (1 << kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;

    tmp0 = wp[7];
    tmp1 = wp[5];
    tmp2 = wp[3];
    tmp3 = wp[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int sh = kConstBits + kPass1Bits + 3;
    op[0] = kRange(descale(tmp10 + tmp3, sh));
    op[7] = kRange(descale(tmp10 - tmp3, sh));
    op[1] = kRange(descale(tmp11 + tmp2, sh));
    op[6] = kRange(descale(tmp11 - tmp2, sh));
    op[2] = kRange(descale(tmp12 + tmp1, sh));
    op[5] = kRange(descale(tmp12 - tmp1, sh));
    op[3] = kRange(descale(tmp13 + tmp0, sh));
    op[4] = kRange(descale(tmp13 - tmp0, sh));
  }
}

// A component's samples after the IDCT: its blocks, row-major.
struct Plane {
  std::vector<uint8_t> px;
  int stride = 0;
  const uint8_t* row(int y) const { return px.data() + (size_t)y * stride; }
};

Plane inverse_dct(Component& c) {
  Plane p;
  p.stride = c.wib * 8;
  p.px.assign((size_t)p.stride * c.hib * 8, 0);
  for (int by = 0; by < c.hib; by++)
    for (int bx = 0; bx < c.wib; bx++)
      idct_islow(c.block(bx, by), c.quant, p.px.data() + (size_t)by * 8 * p.stride + bx * 8,
                 p.stride);
  return p;
}

// ---- jdsample.c: a component brought to the image's size ------------------

void upsample(const Component& c, const Plane& in, int maxh, int maxv, int width,
              int height, uint8_t* out) {
  const int hx = maxh / c.h, vy = maxv / c.v, dw = c.dw, dh = c.dh;
  auto clampx = [&](int j) { return j < 0 ? 0 : j >= dw ? dw - 1 : j; };
  if (hx == 1 && vy == 1) {  // fullsize_upsample
    for (int y = 0; y < height; y++) std::memcpy(out + (size_t)y * width, in.row(y), width);
  } else if (hx == 2 && vy == 1 && dw > 2) {  // h2v1_fancy_upsample
    for (int y = 0; y < height; y++) {
      const uint8_t* r = in.row(y);
      uint8_t* o = out + (size_t)y * width;
      for (int x = 0; x < width; x++) {
        int j = x >> 1;
        int near3 = r[j] * 3;
        o[x] = (x & 1) ? (uint8_t)((near3 + r[clampx(j + 1)] + 2) >> 2)
                       : (uint8_t)((near3 + r[clampx(j - 1)] + 1) >> 2);
      }
    }
  } else if (hx == 1 && vy == 2) {  // h1v2_fancy_upsample
    for (int y = 0; y < height; y++) {
      int i = y >> 1;
      int other = (y & 1) ? (i + 1 < dh ? i + 1 : dh - 1) : (i > 0 ? i - 1 : 0);
      int bias = (y & 1) ? 2 : 1;
      const uint8_t* r0 = in.row(i);
      const uint8_t* r1 = in.row(other);
      uint8_t* o = out + (size_t)y * width;
      for (int x = 0; x < width; x++) o[x] = (uint8_t)((r0[x] * 3 + r1[x] + bias) >> 2);
    }
  } else if (hx == 2 && vy == 2 && dw > 2) {  // h2v2_fancy_upsample
    std::vector<int> colsum(dw);
    for (int y = 0; y < height; y++) {
      int i = y >> 1;
      int other = (y & 1) ? (i + 1 < dh ? i + 1 : dh - 1) : (i > 0 ? i - 1 : 0);
      const uint8_t* r0 = in.row(i);
      const uint8_t* r1 = in.row(other);
      for (int j = 0; j < dw; j++) colsum[j] = r0[j] * 3 + r1[j];
      uint8_t* o = out + (size_t)y * width;
      for (int x = 0; x < width; x++) {
        int j = x >> 1;
        int this3 = colsum[j] * 3;
        o[x] = (x & 1) ? (uint8_t)((this3 + colsum[clampx(j + 1)] + 7) >> 4)
                       : (uint8_t)((this3 + colsum[clampx(j - 1)] + 8) >> 4);
      }
    }
  } else {  // int_upsample, and the box h2v1/h2v2 upsamplers
    for (int y = 0; y < height; y++) {
      const uint8_t* r = in.row(y / vy);
      uint8_t* o = out + (size_t)y * width;
      for (int x = 0; x < width; x++) o[x] = r[x / hx];
    }
  }
}

// ---- jdcolor.c ------------------------------------------------------------

constexpr int kScaleBits = 16;
constexpr int32_t kOneHalf = int32_t(1) << (kScaleBits - 1);
constexpr int32_t fix(double x) { return (int32_t)(x * (1 << kScaleBits) + 0.5); }

struct YccTables {
  int cr_r[256], cb_b[256];
  int32_t cr_g[256], cb_g[256];
  int32_t r_y[256], g_y[256], b_y[256];
  YccTables() {  // build_ycc_rgb_table, build_rgb_y_table
    for (int i = 0; i < 256; i++) {
      int32_t x = i - 128;
      cr_r[i] = (int)((fix(1.40200) * x + kOneHalf) >> kScaleBits);
      cb_b[i] = (int)((fix(1.77200) * x + kOneHalf) >> kScaleBits);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + kOneHalf;
      r_y[i] = fix(0.29900) * i;
      g_y[i] = fix(0.58700) * i;
      b_y[i] = fix(0.11400) * i + kOneHalf;
    }
  }
};
const YccTables kYcc;

inline uint8_t clamp255(int v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); }

// IDCT, upsampling and color conversion of a decoded file into out.
void render(Decoder& d, bool gray, uint8_t* out) {
  const int w = d.width, h = d.height;
  const size_t npx = (size_t)w * h;
  // components the output needs: Y alone for a gray read of YCbCr
  int needed = (gray && !d.is_rgb) ? 1 : d.ncomp;
  std::vector<std::vector<uint8_t>> full(needed);
  for (int ci = 0; ci < needed; ci++) {
    Component& c = d.comps[ci];
    Plane p = inverse_dct(c);
    full[ci].resize(npx);
    upsample(c, p, d.maxh, d.maxv, w, h, full[ci].data());
  }
  if (needed == 1) {
    const uint8_t* y = full[0].data();
    if (gray) {
      std::memcpy(out, y, npx);
    } else {
      for (size_t i = 0; i < npx; i++) out[3 * i] = out[3 * i + 1] = out[3 * i + 2] = y[i];
    }
    return;
  }
  const uint8_t *c0 = full[0].data(), *c1 = full[1].data(), *c2 = full[2].data();
  if (d.is_rgb) {
    if (gray) {  // rgb_gray_convert
      for (size_t i = 0; i < npx; i++)
        out[i] = (uint8_t)((kYcc.r_y[c0[i]] + kYcc.g_y[c1[i]] + kYcc.b_y[c2[i]]) >> kScaleBits);
    } else {
      for (size_t i = 0; i < npx; i++) {
        out[3 * i] = c0[i];
        out[3 * i + 1] = c1[i];
        out[3 * i + 2] = c2[i];
      }
    }
    return;
  }
  for (size_t i = 0; i < npx; i++) {  // ycc_rgb_convert
    int y = c0[i], cb = c1[i], cr = c2[i];
    out[3 * i] = clamp255(y + kYcc.cr_r[cr]);
    out[3 * i + 1] = clamp255(y + (int)((kYcc.cb_g[cb] + kYcc.cr_g[cr]) >> kScaleBits));
    out[3 * i + 2] = clamp255(y + kYcc.cb_b[cb]);
  }
}

void set_error(char* err, size_t err_size, const std::string& msg) {
  if (err && err_size) std::snprintf(err, err_size, "%s", msg.c_str());
}

}  // namespace

extern "C" {

// Header of a JPEG file, read up to its first scan: info = {width, height,
// components, precision, process (SOF n: 0 baseline, 1 extended, 2
// progressive)}. Returns 0, 1 if the decoder would refuse the file (the
// reason in err), or 2 if the data ends before the first scan.
int scflow_jpeg_info(const uint8_t* data, size_t size, int32_t* info, char* err,
                     size_t err_size) {
  try {
    Decoder d(data, size);
    d.read_headers();
    info[0] = d.width;
    info[1] = d.height;
    info[2] = d.ncomp;
    info[3] = d.precision;
    info[4] = d.process;
    return 0;
  } catch (const NeedMore&) {
    set_error(err, err_size, "the data ends before the first scan");
    return 2;
  } catch (const Refused& e) {
    set_error(err, err_size, e.msg);
    return 1;
  } catch (const std::exception& e) {
    set_error(err, err_size, e.what());
    return 1;
  }
}

// Decode a whole file into out: height x width x 3 RGB, or height x width
// with gray. out_size must be that many bytes. Returns 0, or 1 with the
// reason in err.
int scflow_jpeg_decode(const uint8_t* data, size_t size, int gray, uint8_t* out,
                       size_t out_size, char* err, size_t err_size) {
  try {
    Decoder d(data, size);
    d.read_all();
    if (out_size != (size_t)d.width * d.height * (gray ? 1 : 3))
      refuse("output buffer of the wrong size");
    render(d, gray != 0, out);
    return 0;
  } catch (const Refused& e) {
    set_error(err, err_size, e.msg);
    return 1;
  } catch (const std::exception& e) {
    set_error(err, err_size, e.what());
    return 1;
  }
}

}  // extern "C"
