// Host JPEG codec with a plain C interface, loaded with ctypes by
// acezero_tpu_torch/io/jpeg.py and built by acezero_tpu_torch/ops/build.py.
//
// The decoder reads every 8-bit JPEG that libjpeg-turbo decodes for PIL:
// Huffman or arithmetic coding (jdarith.c's QM decoder, DAC conditioning),
// sequential (SOF0/SOF1/SOF9) and progressive (SOF2/SOF10) DCT frames,
// lossless frames (SOF3: predictors 1-7, point transforms; jdlossls.c,
// jddiffct.c), one, three or four components, any sampling factors 1-4
// that are whole fractions of the largest with at most 10 blocks in an
// interleaved MCU, restart intervals, any image size. Its pixels are those
// of libjpeg-turbo's default decompression: the islow integer IDCT
// (jidctint.c), jdsample.c's upsampling (fancy h2v1, h1v2 and h2v2, box
// replication for other ratios and for lossless samples), the fixed-point
// YCbCr->RGB tables and YCCK->CMYK (jdcolor.c); the colour space is chosen
// as libjpeg's default_decompress_parms chooses it, and four components
// come out as PIL stores them (Adobe's inverted CMYK). What libjpeg-turbo
// or PIL refuses fails with a message: 12-bit samples, hierarchical frames
// (SOF5-7, SOF13-15), lossless arithmetic coding (SOF11), a height in a DNL
// marker, two components, a lossless frame with a colour transform, other
// sampling factors, truncated or corrupt data.
//
// The encoder writes baseline JPEG as libjpeg-turbo's defaults do: the IJG
// tables scaled by jpeg_set_quality, rgb_ycc_convert, h2v2_downsample (4:2:0)
// or none (4:4:4), jpeg_fdct_islow with libjpeg-turbo's reciprocal
// quantisation, the standard Huffman tables and a JFIF APP0 header. Four
// components are CMYK as PIL saves mode CMYK: each sample inverted (PIL's
// "CMYK;I"), no colour transform, components 'C', 'M', 'Y', 'K' at 1 x 1
// on quantisation table 0 and the luma Huffman tables, an Adobe APP14
// marker (transform 0) and no JFIF header (jcparam.c's JCS_CMYK).
//
// Every function is integer arithmetic: the same bits on every host.

#include <algorithm>
#include <climits>
#include <cstdarg>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Error {
  std::string msg;
};

[[noreturn]] void fail(const char* fmt, ...) {
  char buf[256];
  va_list ap;
  va_start(ap, fmt);
  vsnprintf(buf, sizeof buf, fmt, ap);
  va_end(ap);
  throw Error{buf};
}

// zigzag position -> natural (row-major) index; the 16 extra entries send a
// corrupt run past the end to coefficient 63, as libjpeg's table does
const int kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,  12, 19, 26, 33,
    40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36,
    29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54,
    47, 55, 62, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

inline int be16(const uint8_t* p) { return (p[0] << 8) | p[1]; }
inline int ceil_div(int a, int b) { return (a + b - 1) / b; }
inline uint8_t clamp255(int v) { return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v)); }

// libjpeg's FIX(x) at a given number of fraction bits
constexpr int32_t fix(double x, int bits) { return static_cast<int32_t>(x * (1L << bits) + 0.5); }

// ------------------------------------------------------------ islow IDCT

constexpr int CONST_BITS = 13;
constexpr int PASS1_BITS = 2;
constexpr int32_t F_0_298631336 = 2446, F_0_390180644 = 3196, F_0_541196100 = 4433, F_0_765366865 = 6270,
                  F_0_899976223 = 7373, F_1_175875602 = 9633, F_1_501321110 = 12299, F_1_847759065 = 15137,
                  F_1_961570560 = 16069, F_2_053119869 = 16819, F_2_562915447 = 20995, F_3_072711026 = 25172;

inline int32_t descale(int64_t x, int n) { return static_cast<int32_t>((x + (int64_t{1} << (n - 1))) >> n); }

// jpeg_idct_islow: dequantise, two 1-D passes, +128 and clamp. libjpeg's C
// range-limit table wraps values far outside [-512, 511]; its x86 SIMD code
// saturates them, and saturation is what this does.
void idct_islow(const int16_t* coef, const uint16_t* q, uint8_t* out, int stride) {
  int32_t ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t* in = coef + c;
    const uint16_t* qq = q + c;
    if (!in[8] && !in[16] && !in[24] && !in[32] && !in[40] && !in[48] && !in[56]) {
      int32_t dc = static_cast<int32_t>(in[0]) * qq[0] * (1 << PASS1_BITS);
      for (int r = 0; r < 8; ++r) ws[r * 8 + c] = dc;
      continue;
    }
    int64_t z2 = static_cast<int64_t>(in[16]) * qq[16], z3 = static_cast<int64_t>(in[48]) * qq[48];
    int64_t z1 = (z2 + z3) * F_0_541196100;
    int64_t tmp2 = z1 - z3 * F_1_847759065;
    int64_t tmp3 = z1 + z2 * F_0_765366865;
    z2 = static_cast<int64_t>(in[0]) * qq[0];
    z3 = static_cast<int64_t>(in[32]) * qq[32];
    int64_t tmp0 = (z2 + z3) * (1 << CONST_BITS);
    int64_t tmp1 = (z2 - z3) * (1 << CONST_BITS);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = static_cast<int64_t>(in[56]) * qq[56];
    tmp1 = static_cast<int64_t>(in[40]) * qq[40];
    tmp2 = static_cast<int64_t>(in[24]) * qq[24];
    tmp3 = static_cast<int64_t>(in[8]) * qq[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * F_1_175875602;
    tmp0 *= F_0_298631336;
    tmp1 *= F_2_053119869;
    tmp2 *= F_3_072711026;
    tmp3 *= F_1_501321110;
    z1 *= -F_0_899976223;
    z2 *= -F_2_562915447;
    z3 *= -F_1_961570560;
    z4 *= -F_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    constexpr int s = CONST_BITS - PASS1_BITS;
    ws[0 * 8 + c] = descale(tmp10 + tmp3, s);
    ws[7 * 8 + c] = descale(tmp10 - tmp3, s);
    ws[1 * 8 + c] = descale(tmp11 + tmp2, s);
    ws[6 * 8 + c] = descale(tmp11 - tmp2, s);
    ws[2 * 8 + c] = descale(tmp12 + tmp1, s);
    ws[5 * 8 + c] = descale(tmp12 - tmp1, s);
    ws[3 * 8 + c] = descale(tmp13 + tmp0, s);
    ws[4 * 8 + c] = descale(tmp13 - tmp0, s);
  }
  constexpr int s = CONST_BITS + PASS1_BITS + 3;
  for (int r = 0; r < 8; ++r) {
    const int32_t* w = ws + r * 8;
    uint8_t* o = out + static_cast<size_t>(r) * stride;
    if (!w[1] && !w[2] && !w[3] && !w[4] && !w[5] && !w[6] && !w[7]) {
      uint8_t v = clamp255(descale(w[0], PASS1_BITS + 3) + 128);
      for (int i = 0; i < 8; ++i) o[i] = v;
      continue;
    }
    int64_t z2 = w[2], z3 = w[6];
    int64_t z1 = (z2 + z3) * F_0_541196100;
    int64_t tmp2 = z1 - z3 * F_1_847759065;
    int64_t tmp3 = z1 + z2 * F_0_765366865;
    int64_t tmp0 = (static_cast<int64_t>(w[0]) + w[4]) * (1 << CONST_BITS);
    int64_t tmp1 = (static_cast<int64_t>(w[0]) - w[4]) * (1 << CONST_BITS);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * F_1_175875602;
    tmp0 *= F_0_298631336;
    tmp1 *= F_2_053119869;
    tmp2 *= F_3_072711026;
    tmp3 *= F_1_501321110;
    z1 *= -F_0_899976223;
    z2 *= -F_2_562915447;
    z3 *= -F_1_961570560;
    z4 *= -F_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    o[0] = clamp255(descale(tmp10 + tmp3, s) + 128);
    o[7] = clamp255(descale(tmp10 - tmp3, s) + 128);
    o[1] = clamp255(descale(tmp11 + tmp2, s) + 128);
    o[6] = clamp255(descale(tmp11 - tmp2, s) + 128);
    o[2] = clamp255(descale(tmp12 + tmp1, s) + 128);
    o[5] = clamp255(descale(tmp12 - tmp1, s) + 128);
    o[3] = clamp255(descale(tmp13 + tmp0, s) + 128);
    o[4] = clamp255(descale(tmp13 - tmp0, s) + 128);
  }
}

// ------------------------------------------------------------ decoder

struct Huffman {
  bool defined = false;
  uint8_t fast_len[512];  // codes of up to 9 bits, looked up by the next 9 bits
  uint8_t fast_val[512];
  int32_t maxcode[18];
  int32_t valoffset[17];
  uint8_t vals[256];
};

void build_huffman(Huffman& t, const uint8_t* counts, const uint8_t* vals, int nvals) {
  memset(t.fast_len, 0, sizeof t.fast_len);
  memset(t.vals, 0, sizeof t.vals);
  memcpy(t.vals, vals, nvals);
  int code = 0, k = 0;
  for (int l = 1; l <= 16; ++l) {
    int c = counts[l - 1];
    t.valoffset[l] = k - code;
    for (int i = 0; i < c && l <= 9; ++i) {
      int shift = 9 - l, base = (code + i) << shift;
      for (int j = 0; j < (1 << shift); ++j) {
        t.fast_len[base + j] = static_cast<uint8_t>(l);
        t.fast_val[base + j] = vals[k + i];
      }
    }
    code += c;
    k += c;
    t.maxcode[l] = c ? code - 1 : -1;
    if (code >= (1 << l) && c) fail("corrupt JPEG data: bad Huffman table");
    code <<= 1;
  }
  t.maxcode[17] = INT32_MAX;
  t.defined = true;
}

// Entropy-coded bits, with 0xFF00 unstuffed. At a marker or the end of the
// data it feeds zero bits, as libjpeg does, but reading any of them fails:
// the scan was truncated or corrupt.
struct Reader {
  const uint8_t* d;
  size_t n, pos;
  uint64_t buf = 0;
  int bits = 0, fake = 0;
  bool stop = false, eof = false;

  void fill() {
    while (bits <= 56) {
      uint32_t b = 0;
      if (!stop) {
        if (pos >= n) {
          stop = eof = true;
        } else if (d[pos] == 0xFF) {
          if (pos + 1 < n && d[pos + 1] == 0x00) {
            b = 0xFF;
            pos += 2;
          } else {
            stop = true;  // a marker: pos stays on it
            eof = pos + 1 >= n;
          }
        } else {
          b = d[pos++];
        }
      }
      if (stop) fake += 8;
      buf |= static_cast<uint64_t>(b) << (56 - bits);
      bits += 8;
    }
  }
  void consume(int k) {
    buf <<= k;
    bits -= k;
    if (bits < fake) fail(eof ? "truncated JPEG data" : "corrupt JPEG data: a scan ends before its last block");
  }
  int get(int k) {
    if (k == 0) return 0;
    if (bits < k) fill();
    int v = static_cast<int>(buf >> (64 - k));
    consume(k);
    return v;
  }
  int decode(const Huffman& h) {
    if (bits < 16) fill();
    int peek = static_cast<int>(buf >> 55);
    int l = h.fast_len[peek];
    if (l) {
      int v = h.fast_val[peek];
      consume(l);
      return v;
    }
    int code16 = static_cast<int>(buf >> 48);
    for (l = 10; l <= 16; ++l) {
      int c = code16 >> (16 - l);
      if (c <= h.maxcode[l]) {
        int v = h.vals[(h.valoffset[l] + c) & 0xFF];
        consume(l);
        return v;
      }
    }
    fail("corrupt JPEG data: bad Huffman code");
  }
  void restart() {
    buf = 0;
    bits = fake = 0;
    stop = eof = false;
  }
};

inline int extend(int v, int t) { return v < (1 << (t - 1)) ? v - (1 << t) + 1 : v; }

// ITU T.81 Table D.2 as libjpeg's jaricom.c packs it: Qe << 16,
// Next_Index_MPS << 8, Switch_MPS << 7, Next_Index_LPS. Entry 113 is the
// fixed bin of the sign and DC-refinement decisions.
const uint32_t kAritab[114] = {
    0x5a1d0181, 0x2586020e, 0x11140310, 0x080b0412, 0x03d80514, 0x01da0617, 0x00e50719, 0x006f081c, 0x0036091e,
    0x001a0a21, 0x000d0b23, 0x00060c09, 0x00030d0a, 0x00010d0c, 0x5a7f0f8f, 0x3f251024, 0x2cf21126, 0x207c1227,
    0x17b91328, 0x1182142a, 0x0cef152b, 0x09a1162d, 0x072f172e, 0x055c1830, 0x04061931, 0x03031a33, 0x02401b34,
    0x01b11c36, 0x01441d38, 0x00f51e39, 0x00b71f3b, 0x008a203c, 0x0068213e, 0x004e223f, 0x003b2320, 0x002c0921,
    0x5ae125a5, 0x484c2640, 0x3a0d2741, 0x2ef12843, 0x261f2944, 0x1f332a45, 0x19a82b46, 0x15182c48, 0x11772d49,
    0x0e742e4a, 0x0bfb2f4b, 0x09f8304d, 0x0861314e, 0x0706324f, 0x05cd3330, 0x04de3432, 0x040f3532, 0x03633633,
    0x02d43734, 0x025c3835, 0x01f83936, 0x01a43a37, 0x01603b38, 0x01253c39, 0x00f63d3a, 0x00cb3e3b, 0x00ab3f3d,
    0x008f203d, 0x5b1241c1, 0x4d044250, 0x412c4351, 0x37d84452, 0x2fe84553, 0x293c4654, 0x23794756, 0x1edf4857,
    0x1aa94957, 0x174e4a48, 0x14244b48, 0x119c4c4a, 0x0f6b4d4a, 0x0d514e4b, 0x0bb64f4d, 0x0a40304d, 0x583251d0,
    0x4d1c5258, 0x438e5359, 0x3bdd545a, 0x34ee555b, 0x2eae565c, 0x299a575d, 0x25164756, 0x557059d8, 0x4ca95a5f,
    0x44d95b60, 0x3e225c61, 0x38245d63, 0x32b45e63, 0x2e17565d, 0x56a860df, 0x4f466165, 0x47e56266, 0x41cf6367,
    0x3c3d6468, 0x375e5d63, 0x52316669, 0x4c0f676a, 0x4639686b, 0x415e6367, 0x56276ae9, 0x50e76b6c, 0x4b85676d,
    0x55976d6e, 0x504f6b6f, 0x5a106fee, 0x55226d70, 0x59eb6ff0, 0x5a1d7171};

// The QM decoder of arithmetic-coded data (jdarith.c's arith_decode). At a
// marker it feeds zero bytes, as the standard has it: an arithmetic-coded
// segment may end before its decoder stops reading. pos stays on the
// marker's last 0xFF.
struct ArithReader {
  const uint8_t* d;
  size_t n, pos;
  int64_t c = 0, a = 0;
  int ct = -16;  // -16: two bytes to read before the first decision
  bool marker = false;

  int byte() {
    if (marker) return 0;
    if (pos >= n) fail("truncated JPEG data");
    int v = d[pos];
    if (v != 0xFF) {
      ++pos;
      return v;
    }
    size_t p = pos + 1;
    while (p < n && d[p] == 0xFF) ++p;
    if (p >= n) fail("truncated JPEG data");
    if (d[p] == 0x00) {
      pos = p + 1;
      return 0xFF;
    }
    marker = true;
    pos = p - 1;
    return 0;
  }
  int decode(uint8_t* st) {
    while (a < 0x8000) {
      if (--ct < 0) {
        c = (c << 8) | byte();
        if ((ct += 8) < 0 && ++ct == 0) a = 0x8000;
      }
      a <<= 1;
    }
    int sv = *st;
    uint32_t e = kAritab[sv & 0x7F];
    int nl = e & 0xFF, nm = (e >> 8) & 0xFF;
    int64_t qe = e >> 16;
    int64_t temp = a - qe;
    a = temp;
    temp <<= ct;
    if (c >= temp) {
      c -= temp;
      if (a < qe) {
        a = qe;
        *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
      } else {
        a = qe;
        *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
        sv ^= 0x80;
      }
    } else if (a < 0x8000) {
      if (a < qe) {
        *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
        sv ^= 0x80;
      } else {
        *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
      }
    }
    return sv >> 7;
  }
  void restart() {
    c = a = 0;
    ct = -16;
    marker = false;
  }
};

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;  // h, v: the frame's factors; 1 x 1 in a one-component frame
  int sv = 1;            // the factor v as written (a lossless scan's rows per iMCU row)
  int bw = 0, bh = 0;    // units (8 x 8 blocks, lossless: samples) allocated: the MCU grid's, or the component's own in a one-component frame
  int cbw = 0, cbh = 0;  // units that hold the component's samples
  int cw = 0, ch = 0;    // samples: libjpeg's downsampled_width and downsampled_height
  std::vector<int16_t> coef;     // DCT coefficients, 64 per block
  std::vector<uint8_t> samples;  // lossless: the samples, bw per row
  std::vector<int32_t> diff;     // lossless: the current scan's differences
  uint16_t q[64];
  bool q_latched = false, scanned = false;
  int dc_tab = 0, ac_tab = 0, pred = 0, dc_context = 0;
};

enum class Space { kGray, kYCbCr, kRGB, kCMYK, kYCCK };

struct Decoder {
  const uint8_t* d;
  size_t n, pos = 0;
  uint16_t qt[4][64];
  bool qt_defined[4] = {false, false, false, false};
  Huffman dc[4], ac[4];
  uint8_t arith_dc_l[16], arith_dc_u[16], arith_ac_k[16];  // DAC conditioning
  int restart_interval = 0;
  bool jfif = false, adobe = false;
  int adobe_transform = -1;
  int space3 = -1;  // three components: -1 libjpeg's guess, 0 no colour transform, 1 YCbCr
  bool frame = false, progressive = false, arith = false, lossless = false, eoi = false;
  int width = 0, height = 0, ncomp = 0, hmax = 1, vmax = 1, mcux = 0, mcuy = 0, scans = 0;
  Component comp[4];
  int eobrun = 0;
  // one scan
  int ss = 0, se = 0, ah = 0, al = 0;
  uint8_t dc_stats[16][64], ac_stats[16][256], fixed_bin = 113;

  Decoder(const uint8_t* data, size_t size) : d(data), n(size) {
    for (int i = 0; i < 16; ++i) {
      arith_dc_l[i] = 0;
      arith_dc_u[i] = 1;
      arith_ac_k[i] = 5;
    }
  }

  // the next marker's code, pos after it; fill bytes 0xFF are skipped and so
  // is stray data before the marker (libjpeg warns and skips it too)
  int next_marker() {
    for (;;) {
      while (pos < n && d[pos] != 0xFF) ++pos;
      while (pos < n && d[pos] == 0xFF) ++pos;
      if (pos >= n) fail("truncated JPEG data (no end-of-image marker)");
      int m = d[pos++];
      if (m != 0x00) return m;
    }
  }

  void read_sof(int m, const uint8_t* s, int sl) {
    if (frame) fail("corrupt JPEG data: a second start-of-frame marker");
    if (sl < 6) fail("corrupt JPEG data: short start-of-frame segment");
    if (s[0] != 8) fail("unsupported JPEG: %d-bit samples (SOF%d); only 8-bit is read", s[0], m - 0xC0);
    height = be16(s + 1);
    width = be16(s + 3);
    ncomp = s[5];
    if (height == 0) fail("unsupported JPEG: the height is given in a DNL marker");
    if (width == 0) fail("corrupt JPEG data: zero width");
    if (ncomp != 1 && ncomp != 3 && ncomp != 4) fail("unsupported JPEG: %d components", ncomp);
    if (sl < 6 + 3 * ncomp) fail("corrupt JPEG data: short start-of-frame segment");
    progressive = m == 0xC2 || m == 0xCA;
    arith = m >= 0xC9;
    lossless = m == 0xC3;
    for (int i = 0; i < ncomp; ++i) {
      Component& c = comp[i];
      c.id = s[6 + 3 * i];
      c.h = s[7 + 3 * i] >> 4;
      c.v = s[7 + 3 * i] & 15;
      c.sv = c.v;
      c.tq = s[8 + 3 * i];
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3) fail("corrupt JPEG data: bad component parameters");
    }
    if (ncomp == 1) comp[0].h = comp[0].v = 1;  // a single component is coded one unit per MCU at any factors
    hmax = vmax = 1;
    for (int i = 0; i < ncomp; ++i) {
      hmax = std::max(hmax, comp[i].h);
      vmax = std::max(vmax, comp[i].v);
    }
    for (int i = 0; i < ncomp; ++i) {  // jdsample.c upsamples by whole ratios only
      if (hmax % comp[i].h || vmax % comp[i].v) {
        std::string f;
        for (int j = 0; j < ncomp; ++j) f += (j ? "," : "") + std::to_string(comp[j].h) + "x" + std::to_string(comp[j].v);
        fail("unsupported JPEG sampling factors %s (each a whole fraction of the largest is read)", f.c_str());
      }
    }
    const int unit = lossless ? 1 : 8;
    mcux = ceil_div(width, unit * hmax);
    mcuy = ceil_div(height, unit * vmax);
    for (int i = 0; i < ncomp; ++i) {
      Component& c = comp[i];
      c.cw = ceil_div(width * c.h, hmax);
      c.ch = ceil_div(height * c.v, vmax);
      c.cbw = ceil_div(c.cw, unit);
      c.cbh = ceil_div(c.ch, unit);
      c.bw = ncomp == 1 ? c.cbw : mcux * c.h;
      c.bh = ncomp == 1 ? c.cbh : mcuy * c.v;
    }
    frame = true;
  }

  void read_dqt(const uint8_t* s, int sl) {
    int p = 0;
    while (p < sl) {
      int pq = s[p] >> 4, t = s[p] & 15;
      ++p;
      if (t > 3 || pq > 1 || p + 64 * (pq + 1) > sl) fail("corrupt JPEG data: bad quantization table");
      for (int k = 0; k < 64; ++k) {
        qt[t][kNatural[k]] = static_cast<uint16_t>(pq ? be16(s + p + 2 * k) : s[p + k]);
      }
      p += 64 * (pq + 1);
      qt_defined[t] = true;
    }
  }

  void read_dht(const uint8_t* s, int sl) {
    int p = 0;
    while (p < sl) {
      if (p + 17 > sl) fail("corrupt JPEG data: bad Huffman table");
      int tc = s[p] >> 4, th = s[p] & 15;
      int total = 0;
      for (int i = 0; i < 16; ++i) total += s[p + 1 + i];
      if (tc > 1 || th > 3 || total > 256 || p + 17 + total > sl) fail("corrupt JPEG data: bad Huffman table");
      build_huffman(tc ? ac[th] : dc[th], s + p + 1, s + p + 17, total);
      p += 17 + total;
    }
  }

  // jdmarker.c's get_dac: DC tables 0-15 take L and U, AC tables (16-31) K
  void read_dac(const uint8_t* s, int sl) {
    for (int p = 0; p + 1 < sl; p += 2) {
      int t = s[p], val = s[p + 1];
      if (t >= 32) fail("corrupt JPEG data: bad DAC table %d", t);
      if (t >= 16) {
        arith_ac_k[t - 16] = static_cast<uint8_t>(val);
      } else {
        arith_dc_l[t] = static_cast<uint8_t>(val & 15);
        arith_dc_u[t] = static_cast<uint8_t>(val >> 4);
        if (arith_dc_l[t] > arith_dc_u[t]) fail("corrupt JPEG data: bad DAC value 0x%02X", val);
      }
    }
  }

  void parse(bool header_only) {
    if (n < 3 || d[0] != 0xFF || d[1] != 0xD8) fail("not a JPEG file");
    pos = 2;
    for (;;) {
      int m = next_marker();
      if (m == 0xD9) {
        eoi = true;
        break;
      }
      if (m == 0xD8) fail("corrupt JPEG data: a second start-of-image marker");
      if ((m >= 0xD0 && m <= 0xD7) || m == 0x01) continue;  // no segment follows
      if (pos + 2 > n) fail("truncated JPEG data");
      int len = be16(d + pos);
      if (len < 2 || pos + len > n) fail("truncated JPEG data");
      const uint8_t* s = d + pos + 2;
      int sl = len - 2;
      pos += len;
      switch (m) {
        case 0xC0:
        case 0xC1:
        case 0xC2:
        case 0xC3:
        case 0xC9:
        case 0xCA:
          read_sof(m, s, sl);
          if (header_only) return;
          for (int i = 0; i < ncomp; ++i) {
            size_t units = static_cast<size_t>(comp[i].bw) * comp[i].bh;
            if (lossless) {
              comp[i].samples.assign(units, 0);
            } else {
              comp[i].coef.assign(units * 64, 0);
            }
          }
          break;
        case 0xCB:
          fail("unsupported JPEG: lossless arithmetic coding (SOF11, marker 0xFFCB)");
        case 0xC5:
        case 0xC6:
        case 0xC7:
        case 0xCD:
        case 0xCE:
        case 0xCF:
          fail("unsupported JPEG: hierarchical coding (SOF%d, marker 0xFF%02X)", m - 0xC0, m);
        case 0xC4:
          read_dht(s, sl);
          break;
        case 0xCC:
          read_dac(s, sl);
          break;
        case 0xDB:
          read_dqt(s, sl);
          break;
        case 0xDD:
          if (sl < 2) fail("corrupt JPEG data: short DRI segment");
          restart_interval = be16(s);
          break;
        case 0xDC:
          fail("unsupported JPEG: DNL marker (0xFFDC)");
        case 0xDA:
          if (!frame) fail("corrupt JPEG data: scan before the start of frame");
          if (header_only) fail("corrupt JPEG data: scan before the start of frame");
          scan(s, sl);
          break;
        case 0xE0:
          if (sl >= 5 && memcmp(s, "JFIF\0", 5) == 0) jfif = true;
          break;
        case 0xEE:
          if (sl >= 12 && memcmp(s, "Adobe", 5) == 0) {
            adobe = true;
            adobe_transform = s[11];
          }
          break;
        default:
          break;  // other APPn, COM
      }
    }
    if (!frame) fail("JPEG without a start-of-frame marker");
    if (!header_only && scans == 0) fail("JPEG without scan data");
  }

  // ---- one scan

  void scan(const uint8_t* s, int sl) {
    int ns = sl >= 1 ? s[0] : 0;
    if (ns < 1 || ns > ncomp || sl < 4 + 2 * ns) fail("corrupt JPEG data: bad start-of-scan segment");
    Component* sc[4];
    const int ntab = arith ? 16 : 4;
    for (int i = 0; i < ns; ++i) {
      int cid = s[1 + 2 * i], t = s[2 + 2 * i];
      Component* c = nullptr;
      for (int j = 0; j < ncomp; ++j)
        if (comp[j].id == cid) c = &comp[j];
      if (c == nullptr) fail("corrupt JPEG data: a scan names component %d that the frame has not", cid);
      for (int j = 0; j < i; ++j)
        if (sc[j] == c) fail("corrupt JPEG data: a component twice in one scan");
      c->dc_tab = t >> 4;
      c->ac_tab = t & 15;
      if (c->dc_tab >= ntab || c->ac_tab >= ntab) fail("corrupt JPEG data: bad entropy table number");
      sc[i] = c;
    }
    ss = s[1 + 2 * ns];
    se = s[2 + 2 * ns];
    ah = s[3 + 2 * ns] >> 4;
    al = s[3 + 2 * ns] & 15;
    if (lossless) {  // Ss is the predictor, Al the point transform (jdlossls.c)
      if (ss < 1 || ss > 7 || se != 0 || ah != 0 || al >= 8) fail("corrupt JPEG data: bad lossless scan parameters");
    } else if (progressive) {
      bool dc_scan = ss == 0;
      if ((dc_scan && se != 0) || (!dc_scan && (se < ss || se > 63 || ns != 1)) || al > 13 || ah > 13)
        fail("corrupt JPEG data: bad progressive scan parameters");
    } else {
      ss = 0;
      se = 63;
      ah = al = 0;  // libjpeg warns about other values in a sequential scan and ignores them
    }
    int units_in_mcu = 0;
    for (int i = 0; i < ns; ++i) {
      Component* c = sc[i];
      units_in_mcu += ns == 1 ? 1 : c->h * c->v;
      if (!lossless && !c->q_latched) {  // libjpeg latches a component's table at its first scan
        if (!qt_defined[c->tq]) fail("corrupt JPEG data: quantization table %d is not defined", c->tq);
        memcpy(c->q, qt[c->tq], sizeof c->q);
        c->q_latched = true;
      }
      if (!arith) {
        bool need_dc = (ss == 0 && ah == 0) || lossless, need_ac = se > 0 && !lossless;
        if ((need_dc && !dc[c->dc_tab].defined) || (need_ac && !ac[c->ac_tab].defined))
          fail("corrupt JPEG data: a scan uses an undefined Huffman table");
      }
      if (lossless) {
        if (c->scanned) fail("corrupt JPEG data: component %d in two lossless scans", c->id);
        c->diff.assign(static_cast<size_t>(c->bw) * c->bh, 0);
      }
      c->pred = 0;
      c->dc_context = 0;
    }
    if (units_in_mcu > 10)
      fail("unsupported JPEG: sampling factors too large for an interleaved scan (%d blocks in an MCU, at most 10)",
           units_in_mcu);
    eobrun = 0;
    if (arith) reset_arith_stats(sc, ns);

    int ux, uy;
    if (ns == 1) {
      ux = sc[0]->cbw;
      uy = sc[0]->cbh;
    } else {
      ux = mcux;
      uy = mcuy;
    }
    if (lossless && restart_interval % ux)
      fail("corrupt JPEG data: restart interval %d is not a whole number of rows of %d", restart_interval, ux);
    std::vector<int> reset_rows{0};  // lossless: MCU rows where the predictor starts over
    Reader r{d, n, pos};
    ArithReader ar{d, n, pos};
    int togo = restart_interval, next_rst = 0;
    for (int my = 0; my < uy; ++my) {
      for (int mx = 0; mx < ux; ++mx) {
        if (restart_interval) {
          if (togo == 0) {
            if (arith) {
              arith_restart(ar, next_rst);
              reset_arith_stats(sc, ns);
            } else {
              read_restart(r, next_rst);
            }
            next_rst = (next_rst + 1) & 7;
            for (int i = 0; i < ns; ++i) {
              sc[i]->pred = 0;
              sc[i]->dc_context = 0;
            }
            eobrun = 0;
            togo = restart_interval;
            if (lossless) reset_rows.push_back(my);
          }
          --togo;
        }
        if (ns == 1) {
          unit(r, ar, *sc[0], static_cast<size_t>(my) * sc[0]->bw + mx);
        } else {
          for (int i = 0; i < ns; ++i) {
            Component* c = sc[i];
            for (int by = 0; by < c->v; ++by)
              for (int bx = 0; bx < c->h; ++bx)
                unit(r, ar, *c, static_cast<size_t>(my * c->v + by) * c->bw + (mx * c->h + bx));
          }
        }
      }
    }
    pos = arith ? ar.pos : r.pos;  // on the next marker, or on the padding before it
    if (lossless) {
      for (int i = 0; i < ns; ++i) undifference(*sc[i], ns == 1, reset_rows);
    }
    ++scans;
  }

  void unit(Reader& r, ArithReader& ar, Component& c, size_t u) {
    if (lossless) {
      c.diff[u] = lossless_diff(r, c);
    } else if (arith) {
      arith_block(ar, c, &c.coef[u * 64]);
    } else {
      block(r, c, &c.coef[u * 64]);
    }
  }

  void read_restart(Reader& r, int expect) {
    r.restart();
    size_t p = r.pos;
    while (p < n && d[p] != 0xFF) ++p;  // the rest of the interval's last byte was already read
    while (p + 1 < n && d[p + 1] == 0xFF) ++p;
    if (p + 1 >= n) fail("truncated JPEG data");
    if (d[p + 1] != 0xD0 + expect) fail("corrupt JPEG data: expected RST%d, found marker 0xFF%02X", expect, d[p + 1]);
    r.pos = p + 2;
  }

  // ---- Huffman-coded DCT blocks

  void block(Reader& r, Component& c, int16_t* blk) {
    if (!progressive) {
      int t = r.decode(dc[c.dc_tab]);
      if (t > 16) fail("corrupt JPEG data: bad DC difference");
      int diff = t ? extend(r.get(t), t) : 0;
      c.pred += diff;
      blk[0] = static_cast<int16_t>(c.pred);
      const Huffman& h = ac[c.ac_tab];
      for (int k = 1; k < 64; ++k) {
        int rs = r.decode(h);
        int run = rs >> 4, s = rs & 15;
        if (s) {
          k += run;
          blk[kNatural[k]] = static_cast<int16_t>(extend(r.get(s), s));
        } else {
          if (run != 15) break;
          k += 15;
        }
      }
      return;
    }
    if (ss == 0) {  // DC scans
      if (ah == 0) {
        int t = r.decode(dc[c.dc_tab]);
        if (t > 16) fail("corrupt JPEG data: bad DC difference");
        int diff = t ? extend(r.get(t), t) : 0;
        c.pred += diff;
        blk[0] = static_cast<int16_t>(static_cast<uint32_t>(c.pred) << al);
      } else if (r.get(1)) {
        blk[0] = static_cast<int16_t>(blk[0] | (1 << al));
      }
      return;
    }
    const Huffman& h = ac[c.ac_tab];
    if (ah == 0) {  // AC first pass
      if (eobrun > 0) {
        --eobrun;
        return;
      }
      for (int k = ss; k <= se; ++k) {
        int rs = r.decode(h);
        int run = rs >> 4, s = rs & 15;
        if (s) {
          k += run;
          blk[kNatural[k]] = static_cast<int16_t>(static_cast<uint32_t>(extend(r.get(s), s)) << al);
        } else if (run < 15) {
          eobrun = (1 << run) - 1;
          if (run) eobrun += r.get(run);
          break;
        } else {
          k += 15;
        }
      }
      return;
    }
    // AC refinement (libjpeg's decode_mcu_AC_refine)
    int p1 = 1 << al, m1 = -(1 << al);
    int k = ss;
    if (eobrun == 0) {
      for (; k <= se; ++k) {
        int rs = r.decode(h);
        int run = rs >> 4, s = rs & 15;
        if (s) {
          s = r.get(1) ? p1 : m1;  // s is 1 in a valid stream
        } else if (run != 15) {
          eobrun = 1 << run;
          if (run) eobrun += r.get(run);
          break;
        }
        do {
          int16_t* coef = blk + kNatural[k];
          if (*coef != 0) {
            if (r.get(1) && (*coef & p1) == 0) *coef = static_cast<int16_t>(*coef + (*coef >= 0 ? p1 : m1));
          } else if (--run < 0) {
            break;
          }
          ++k;
        } while (k <= se);
        if (s) blk[kNatural[k]] = static_cast<int16_t>(s);
      }
    }
    if (eobrun > 0) {
      for (; k <= se; ++k) {
        int16_t* coef = blk + kNatural[k];
        if (*coef != 0 && r.get(1) && (*coef & p1) == 0)
          *coef = static_cast<int16_t>(*coef + (*coef >= 0 ? p1 : m1));
      }
      --eobrun;
    }
  }

  // ---- arithmetic-coded DCT blocks (jdarith.c)

  // libjpeg's start_pass and process_restart: the statistics of the scan's
  // tables start over
  void reset_arith_stats(Component* const* sc, int ns) {
    for (int i = 0; i < ns; ++i) {
      if (!progressive || (ss == 0 && ah == 0)) memset(dc_stats[sc[i]->dc_tab], 0, 64);
      if (!progressive || ss != 0) memset(ac_stats[sc[i]->ac_tab], 0, 256);
    }
    fixed_bin = 113;
  }

  // past the RSTn marker that ends an interval: the decoder may have met it
  // already, or the interval's last bytes (unread) come before it
  void arith_restart(ArithReader& ar, int expect) {
    size_t p = ar.pos;
    if (!ar.marker) {
      for (;;) {
        while (p < n && d[p] != 0xFF) ++p;
        while (p + 1 < n && d[p + 1] == 0xFF) ++p;
        if (p + 1 >= n) fail("truncated JPEG data");
        if (d[p + 1] != 0x00) break;
        p += 2;
      }
    }
    if (d[p + 1] != 0xD0 + expect) fail("corrupt JPEG data: expected RST%d, found marker 0xFF%02X", expect, d[p + 1]);
    ar.pos = p + 2;
    ar.restart();
  }

  // Figures F.19 and F.21-F.24 from bin st: a nonzero DC difference's sign
  // and magnitude, as jdarith.c decodes them; *sign_out for the context
  int arith_dc_diff(ArithReader& ar, Component& c, uint8_t* base, int& sign_out) {
    uint8_t* st = base + c.dc_context;
    if (ar.decode(st) == 0) {
      c.dc_context = 0;
      return 0;
    }
    int sign = ar.decode(st + 1);
    st += 2 + sign;
    int m = ar.decode(st);
    if (m != 0) {
      st = base + 20;
      while (ar.decode(st)) {
        if ((m <<= 1) == 0x8000) fail("corrupt JPEG data: arithmetic-coded DC magnitude overflow");
        ++st;
      }
    }
    const int tbl = c.dc_tab;
    if (m < static_cast<int>((1L << arith_dc_l[tbl]) >> 1))
      c.dc_context = 0;
    else if (m > static_cast<int>((1L << arith_dc_u[tbl]) >> 1))
      c.dc_context = 12 + sign * 4;
    else
      c.dc_context = 4 + sign * 4;
    int v = m;
    st += 14;
    while (m >>= 1)
      if (ar.decode(st)) v |= m;
    v += 1;
    sign_out = sign;
    return sign ? -v : v;
  }

  // an AC coefficient's sign and magnitude (k: its zigzag index)
  int arith_ac_value(ArithReader& ar, uint8_t* base, uint8_t* st, int k, int tbl) {
    int sign = ar.decode(&fixed_bin);
    st += 2;
    int m = ar.decode(st);
    if (m != 0 && ar.decode(st)) {
      m <<= 1;
      st = base + (k <= arith_ac_k[tbl] ? 189 : 217);
      while (ar.decode(st)) {
        if ((m <<= 1) == 0x8000) fail("corrupt JPEG data: arithmetic-coded AC magnitude overflow");
        ++st;
      }
    }
    int v = m;
    st += 14;
    while (m >>= 1)
      if (ar.decode(st)) v |= m;
    v += 1;
    return sign ? -v : v;
  }

  void arith_block(ArithReader& ar, Component& c, int16_t* blk) {
    int sign = 0;
    if (!progressive) {
      int v = arith_dc_diff(ar, c, dc_stats[c.dc_tab], sign);
      c.pred = (c.pred + v) & 0xFFFF;
      blk[0] = static_cast<int16_t>(c.pred);
      arith_ac_first(ar, c, blk, 1, 63, 0);
      return;
    }
    if (ss == 0) {
      if (ah == 0) {
        c.pred += arith_dc_diff(ar, c, dc_stats[c.dc_tab], sign);
        blk[0] = static_cast<int16_t>(static_cast<uint32_t>(c.pred) << al);
      } else if (ar.decode(&fixed_bin)) {
        blk[0] = static_cast<int16_t>(blk[0] | (1 << al));
      }
      return;
    }
    if (ah == 0) {
      arith_ac_first(ar, c, blk, ss, se, al);
      return;
    }
    // AC refinement (decode_mcu_AC_refine)
    uint8_t* base = ac_stats[c.ac_tab];
    const int p1 = 1 << al, m1 = -(1 << al);
    int kex = se;
    for (; kex > 0; --kex)
      if (blk[kNatural[kex]]) break;
    for (int k = ss; k <= se; ++k) {
      uint8_t* st = base + 3 * (k - 1);
      if (k > kex && ar.decode(st)) break;  // EOB
      for (;;) {
        int16_t* coef = blk + kNatural[k];
        if (*coef) {
          if (ar.decode(st + 2)) *coef = static_cast<int16_t>(*coef + (*coef < 0 ? m1 : p1));
          break;
        }
        if (ar.decode(st + 1)) {
          *coef = static_cast<int16_t>(ar.decode(&fixed_bin) ? m1 : p1);
          break;
        }
        st += 3;
        if (++k > se) fail("corrupt JPEG data: arithmetic-coded spectral overflow");
      }
    }
  }

  // Figure F.20: the AC coefficients k0..k1 of a sequential block or a
  // first progressive pass (decode_mcu, decode_mcu_AC_first)
  void arith_ac_first(ArithReader& ar, Component& c, int16_t* blk, int k0, int k1, int shift) {
    uint8_t* base = ac_stats[c.ac_tab];
    for (int k = k0; k <= k1; ++k) {
      uint8_t* st = base + 3 * (k - 1);
      if (ar.decode(st)) break;  // EOB
      while (ar.decode(st + 1) == 0) {
        st += 3;
        if (++k > k1) fail("corrupt JPEG data: arithmetic-coded spectral overflow");
      }
      int v = arith_ac_value(ar, base, st, k, c.ac_tab);
      blk[kNatural[k]] = static_cast<int16_t>(static_cast<uint32_t>(v) << shift);
    }
  }

  // ---- lossless (jdlhuff.c, jdlossls.c, jddiffct.c)

  int lossless_diff(Reader& r, Component& c) {
    int s = r.decode(dc[c.dc_tab]);
    if (s > 16) fail("corrupt JPEG data: bad lossless difference");
    if (s == 16) return 32768;
    return s ? extend(r.get(s), s) : 0;
  }

  // The scan's differences to samples. The predictor starts over at the
  // scan's first row and at each restart. libjpeg-turbo undifferences an
  // iMCU row (in a scan of one component, sv sample rows) after decoding
  // all of it, so a restart within one starts the predictor over at the
  // iMCU row's first row; this does the same.
  void undifference(Component& c, bool single, const std::vector<int>& reset_mcu_rows) {
    std::vector<char> first_row(c.ch + 1, 0);
    for (int m : reset_mcu_rows) {
      int row = single ? m / c.sv * c.sv : m * c.v;
      if (row < c.ch) first_row[row] = 1;
    }
    const int psv = ss, initial = 1 << (8 - al - 1);
    std::vector<int> prev(c.cw), cur(c.cw);
    for (int y = 0; y < c.ch; ++y) {
      const int32_t* df = &c.diff[static_cast<size_t>(y) * c.bw];
      if (first_row[y]) {
        int ra = (df[0] + initial) & 0xFFFF;
        cur[0] = ra;
        for (int x = 1; x < c.cw; ++x) cur[x] = ra = (df[x] + ra) & 0xFFFF;
      } else {
        int rb = prev[0], rc;
        int ra = (df[0] + rb) & 0xFFFF;
        cur[0] = ra;
        for (int x = 1; x < c.cw; ++x) {
          rc = rb;
          rb = prev[x];
          int p;
          switch (psv) {
            case 1: p = ra; break;
            case 2: p = rb; break;
            case 3: p = rc; break;
            case 4: p = ra + rb - rc; break;
            case 5: p = ra + ((rb - rc) >> 1); break;
            case 6: p = rb + ((ra - rc) >> 1); break;
            default: p = (ra + rb) >> 1; break;
          }
          cur[x] = ra = (df[x] + p) & 0xFFFF;
        }
      }
      uint8_t* o = &c.samples[static_cast<size_t>(y) * c.bw];
      for (int x = 0; x < c.cw; ++x) o[x] = static_cast<uint8_t>(cur[x] << al);
      std::swap(prev, cur);
    }
    std::vector<int32_t>().swap(c.diff);
    c.scanned = true;
  }

  // ---- samples

  // libjpeg's default_decompress_parms
  Space color_space() const {
    if (ncomp == 1) return Space::kGray;
    if (ncomp == 4) return adobe && adobe_transform != 0 ? Space::kYCCK : Space::kCMYK;
    if (space3 >= 0) return space3 == 1 ? Space::kYCbCr : Space::kRGB;  // set by the caller (a TIFF's photometric)
    if (jfif) return Space::kYCbCr;
    if (adobe) return adobe_transform == 0 ? Space::kRGB : Space::kYCbCr;
    if (comp[0].id == 'R' && comp[1].id == 'G' && comp[2].id == 'B') return Space::kRGB;
    return lossless ? Space::kRGB : Space::kYCbCr;  // lossless files without a marker are taken for RGB
  }

  enum class Up { kFull, kH2V1, kH1V2, kH2V2, kInt };

  void output(uint8_t* out) {
    if (!eoi) fail("truncated JPEG data (no end-of-image marker)");
    const Space space = color_space();
    if (lossless && (space == Space::kYCbCr || space == Space::kYCCK))
      fail("unsupported JPEG: lossless coding with a colour transform (%s)", space == Space::kYCCK ? "YCCK" : "YCbCr");
    std::vector<uint8_t> plane[4];
    size_t stride[4];
    for (int i = 0; i < ncomp; ++i) {
      Component& c = comp[i];
      if (lossless) {
        if (!c.scanned) fail("corrupt JPEG data: component %d is in no scan", c.id);
        stride[i] = static_cast<size_t>(c.bw);
        plane[i].swap(c.samples);
        continue;
      }
      if (!c.q_latched) fail("corrupt JPEG data: component %d is in no scan", c.id);
      stride[i] = static_cast<size_t>(c.bw) * 8;
      plane[i].assign(stride[i] * c.cbh * 8, 0);
      for (int by = 0; by < c.cbh; ++by)
        for (int bx = 0; bx < c.cbw; ++bx)
          idct_islow(&c.coef[(static_cast<size_t>(by) * c.bw + bx) * 64], c.q,
                     &plane[i][by * 8 * stride[i] + bx * 8], static_cast<int>(stride[i]));
      std::vector<int16_t>().swap(c.coef);
    }
    if (ncomp == 1) {
      for (int y = 0; y < height; ++y) memcpy(out + static_cast<size_t>(y) * width, &plane[0][y * stride[0]], width);
      return;
    }
    // jdsample.c's choice for each component; fancy upsampling needs the
    // DCT (lossless samples are replicated) and, across, a downsampled
    // width over 2
    Up up[4];
    std::vector<uint8_t> buf[4];
    for (int i = 0; i < ncomp; ++i) {
      const Component& c = comp[i];
      const bool fancy = !lossless, wide = fancy && c.cw > 2;
      if (c.h == hmax && c.v == vmax)
        up[i] = Up::kFull;
      else if (c.h * 2 == hmax && c.v == vmax && wide)
        up[i] = Up::kH2V1;
      else if (c.h == hmax && c.v * 2 == vmax && fancy)
        up[i] = Up::kH1V2;
      else if (c.h * 2 == hmax && c.v * 2 == vmax && wide)
        up[i] = Up::kH2V2;
      else
        up[i] = Up::kInt;
      buf[i].assign(static_cast<size_t>(c.cw) * (hmax / c.h) + 2, 0);
    }
    int32_t cr_r[256], cb_b[256], cr_g[256], cb_g[256];
    constexpr int SB = 16;
    for (int i = 0; i < 256; ++i) {
      int64_t x = i - 128;
      cr_r[i] = static_cast<int32_t>((fix(1.40200, SB) * x + (1 << (SB - 1))) >> SB);
      cb_b[i] = static_cast<int32_t>((fix(1.77200, SB) * x + (1 << (SB - 1))) >> SB);
      cr_g[i] = static_cast<int32_t>(-fix(0.71414, SB) * x);
      cb_g[i] = static_cast<int32_t>(-fix(0.34414, SB) * x + (1 << (SB - 1)));
    }
    const uint8_t* row[4];
    for (int y = 0; y < height; ++y) {
      for (int i = 0; i < ncomp; ++i) row[i] = upsampled_row(i, y, up[i], plane[i].data(), stride[i], buf[i].data());
      if (space == Space::kRGB) {
        uint8_t* o = out + static_cast<size_t>(y) * width * 3;
        for (int x = 0; x < width; ++x) {
          o[3 * x] = row[0][x];
          o[3 * x + 1] = row[1][x];
          o[3 * x + 2] = row[2][x];
        }
      } else if (space == Space::kYCbCr) {
        uint8_t* o = out + static_cast<size_t>(y) * width * 3;
        for (int x = 0; x < width; ++x) {
          int yy = row[0][x], b = row[1][x], rr = row[2][x];
          o[3 * x] = clamp255(yy + cr_r[rr]);
          o[3 * x + 1] = clamp255(yy + ((cb_g[b] + cr_g[rr]) >> SB));
          o[3 * x + 2] = clamp255(yy + cb_b[b]);
        }
      } else {
        // PIL reads four components as Adobe's inverted CMYK ("CMYK;I"):
        // CMYK samples come out as 255 minus themselves, and YCCK's
        // (jdcolor.c's ycck_cmyk_convert, C = 255 - R and so on) as R, G,
        // B and 255 - K
        uint8_t* o = out + static_cast<size_t>(y) * width * 4;
        const bool ycck = space == Space::kYCCK;
        for (int x = 0; x < width; ++x) {
          if (ycck) {
            int yy = row[0][x], b = row[1][x], rr = row[2][x];
            o[4 * x] = clamp255(yy + cr_r[rr]);
            o[4 * x + 1] = clamp255(yy + ((cb_g[b] + cr_g[rr]) >> SB));
            o[4 * x + 2] = clamp255(yy + cb_b[b]);
          } else {
            o[4 * x] = static_cast<uint8_t>(255 - row[0][x]);
            o[4 * x + 1] = static_cast<uint8_t>(255 - row[1][x]);
            o[4 * x + 2] = static_cast<uint8_t>(255 - row[2][x]);
          }
          o[4 * x + 3] = static_cast<uint8_t>(255 - row[3][x]);
        }
      }
    }
  }

  // row y of component i at the full resolution (at least `width` samples)
  const uint8_t* upsampled_row(int i, int y, Up up, const uint8_t* p, size_t stride, uint8_t* out) const {
    const Component& c = comp[i];
    const int cw = c.cw, ch = c.ch;
    switch (up) {
      case Up::kFull:
        return p + y * stride;
      case Up::kH2V1:
        upsample_h2v1(p + y * stride, cw, out);
        return out;
      case Up::kH1V2: {
        // h1v2_fancy_upsample: 3/4 nearer row + 1/4 further, biases 1 and 2
        int near = y >> 1, odd = y & 1;
        int far = odd ? std::min(near + 1, ch - 1) : std::max(near - 1, 0);
        const uint8_t *a = p + near * stride, *b = p + far * stride;
        for (int x = 0; x < cw; ++x) out[x] = static_cast<uint8_t>((a[x] * 3 + b[x] + 1 + odd) >> 2);
        return out;
      }
      case Up::kH2V2: {
        int near = y >> 1;
        int far = (y & 1) ? std::min(near + 1, ch - 1) : std::max(near - 1, 0);
        upsample_h2v2(p + near * stride, p + far * stride, cw, out);
        return out;
      }
      default: {
        // int_upsample (h2v1_upsample and h2v2_upsample among them):
        // each sample replicated hmax / h times across, vmax / v down
        const int fh = hmax / c.h, fv = vmax / c.v;
        const uint8_t* src = p + (y / fv) * stride;
        for (int x = 0; x < cw; ++x)
          for (int k = 0; k < fh; ++k) out[x * fh + k] = src[x];
        return out;
      }
    }
  }

  // jdsample.c's h2v1_fancy_upsample: 3/4 nearer + 1/4 further, biases 1
  // and 2
  static void upsample_h2v1(const uint8_t* in, int cw, uint8_t* out) {
    out[0] = in[0];
    out[1] = static_cast<uint8_t>((in[0] * 3 + in[1] + 2) >> 2);
    for (int i = 1; i < cw - 1; ++i) {
      int v = in[i] * 3;
      out[2 * i] = static_cast<uint8_t>((v + in[i - 1] + 1) >> 2);
      out[2 * i + 1] = static_cast<uint8_t>((v + in[i + 1] + 2) >> 2);
    }
    int v = in[cw - 1];
    out[2 * cw - 2] = static_cast<uint8_t>((v * 3 + in[cw - 2] + 1) >> 2);
    out[2 * cw - 1] = static_cast<uint8_t>(v);
  }

  // h2v2_fancy_upsample: column sums 3 * nearer row + further row, then the
  // h2v1 weights on the sums (biases 8 and 7)
  static void upsample_h2v2(const uint8_t* near, const uint8_t* far, int cw, uint8_t* out) {
    int last = near[0] * 3 + far[0], cur = last, next = near[1] * 3 + far[1];
    out[0] = static_cast<uint8_t>((cur * 4 + 8) >> 4);
    out[1] = static_cast<uint8_t>((cur * 3 + next + 7) >> 4);
    last = cur;
    cur = next;
    for (int i = 1; i < cw - 1; ++i) {
      next = near[i + 1] * 3 + far[i + 1];
      out[2 * i] = static_cast<uint8_t>((cur * 3 + last + 8) >> 4);
      out[2 * i + 1] = static_cast<uint8_t>((cur * 3 + next + 7) >> 4);
      last = cur;
      cur = next;
    }
    out[2 * cw - 2] = static_cast<uint8_t>((cur * 3 + last + 8) >> 4);
    out[2 * cw - 1] = static_cast<uint8_t>((cur * 4 + 7) >> 4);
  }
};

// ------------------------------------------------------------ encoder

const uint8_t kStdLumaQ[64] = {16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
                               14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
                               18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
                               49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const uint8_t kStdChromaQ[64] = {17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
                                 24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
                                 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
                                 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

// the standard Huffman tables (ITU T.81 K.3, libjpeg's jstdhuff.c)
const uint8_t kDcLumaBits[16] = {0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcChromaBits[16] = {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumaBits[16] = {0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcLumaVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61, 0x07, 0x22, 0x71,
    0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37,
    0x38, 0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x83,
    0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
    0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3,
    0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
    0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kAcChromaBits[16] = {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChromaVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61, 0x71, 0x13, 0x22,
    0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
    0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36,
    0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a,
    0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
    0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba,
    0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
    0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

struct HuffEnc {
  uint16_t code[256];
  uint8_t size[256];
};

HuffEnc make_enc(const uint8_t* bits, const uint8_t* vals) {
  HuffEnc t{};
  int code = 0, k = 0;
  for (int l = 1; l <= 16; ++l) {
    for (int i = 0; i < bits[l - 1]; ++i, ++k, ++code) {
      t.code[vals[k]] = static_cast<uint16_t>(code);
      t.size[vals[k]] = static_cast<uint8_t>(l);
    }
    code <<= 1;
  }
  return t;
}

struct BitWriter {
  std::vector<uint8_t>& out;
  uint64_t acc = 0;
  int n = 0;
  void put(uint32_t code, int size) {
    if (size == 0) return;
    acc = (acc << size) | (code & ((1u << size) - 1));
    n += size;
    while (n >= 8) {
      uint8_t b = static_cast<uint8_t>(acc >> (n - 8));
      out.push_back(b);
      if (b == 0xFF) out.push_back(0);
      n -= 8;
    }
    acc &= (uint64_t{1} << n) - 1;
  }
  void flush() {  // jchuff.c's flush_bits: fill the last byte with ones
    put(0x7F, 7);
    acc = 0;
    n = 0;
  }
};

inline int nbits(int v) {
  int n = 0;
  while (v) {
    ++n;
    v >>= 1;
  }
  return n;
}

// jpeg_fdct_islow: rows, then columns; the result is scaled up by 8
void fdct_islow(int32_t* data) {
  for (int r = 0; r < 8; ++r) {
    int32_t* p = data + r * 8;
    int64_t tmp0 = p[0] + p[7], tmp7 = p[0] - p[7], tmp1 = p[1] + p[6], tmp6 = p[1] - p[6];
    int64_t tmp2 = p[2] + p[5], tmp5 = p[2] - p[5], tmp3 = p[3] + p[4], tmp4 = p[3] - p[4];
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    p[0] = static_cast<int32_t>((tmp10 + tmp11) * (1 << PASS1_BITS));
    p[4] = static_cast<int32_t>((tmp10 - tmp11) * (1 << PASS1_BITS));
    int64_t z1 = (tmp12 + tmp13) * F_0_541196100;
    p[2] = descale(z1 + tmp13 * F_0_765366865, CONST_BITS - PASS1_BITS);
    p[6] = descale(z1 - tmp12 * F_1_847759065, CONST_BITS - PASS1_BITS);
    z1 = tmp4 + tmp7;
    int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
    int64_t z5 = (z3 + z4) * F_1_175875602;
    tmp4 *= F_0_298631336;
    tmp5 *= F_2_053119869;
    tmp6 *= F_3_072711026;
    tmp7 *= F_1_501321110;
    z1 *= -F_0_899976223;
    z2 *= -F_2_562915447;
    z3 *= -F_1_961570560;
    z4 *= -F_0_390180644;
    z3 += z5;
    z4 += z5;
    p[7] = descale(tmp4 + z1 + z3, CONST_BITS - PASS1_BITS);
    p[5] = descale(tmp5 + z2 + z4, CONST_BITS - PASS1_BITS);
    p[3] = descale(tmp6 + z2 + z3, CONST_BITS - PASS1_BITS);
    p[1] = descale(tmp7 + z1 + z4, CONST_BITS - PASS1_BITS);
  }
  for (int c = 0; c < 8; ++c) {
    int32_t* p = data + c;
    int64_t tmp0 = p[0] + p[56], tmp7 = p[0] - p[56], tmp1 = p[8] + p[48], tmp6 = p[8] - p[48];
    int64_t tmp2 = p[16] + p[40], tmp5 = p[16] - p[40], tmp3 = p[24] + p[32], tmp4 = p[24] - p[32];
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    p[0] = descale(tmp10 + tmp11, PASS1_BITS);
    p[32] = descale(tmp10 - tmp11, PASS1_BITS);
    int64_t z1 = (tmp12 + tmp13) * F_0_541196100;
    p[16] = descale(z1 + tmp13 * F_0_765366865, CONST_BITS + PASS1_BITS);
    p[48] = descale(z1 - tmp12 * F_1_847759065, CONST_BITS + PASS1_BITS);
    z1 = tmp4 + tmp7;
    int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
    int64_t z5 = (z3 + z4) * F_1_175875602;
    tmp4 *= F_0_298631336;
    tmp5 *= F_2_053119869;
    tmp6 *= F_3_072711026;
    tmp7 *= F_1_501321110;
    z1 *= -F_0_899976223;
    z2 *= -F_2_562915447;
    z3 *= -F_1_961570560;
    z4 *= -F_0_390180644;
    z3 += z5;
    z4 += z5;
    p[56] = descale(tmp4 + z1 + z3, CONST_BITS + PASS1_BITS);
    p[40] = descale(tmp5 + z2 + z4, CONST_BITS + PASS1_BITS);
    p[24] = descale(tmp6 + z2 + z3, CONST_BITS + PASS1_BITS);
    p[8] = descale(tmp7 + z1 + z4, CONST_BITS + PASS1_BITS);
  }
}

// jcdctmgr.c's compute_reciprocal with 16-bit DCT elements (libjpeg-turbo's
// SIMD build): x / divisor becomes ((|x| + corr) * recip) >> shift
struct Divisor {
  uint32_t recip, corr;
  int shift;
};

Divisor reciprocal(uint32_t divisor) {
  if (divisor == 1) return {1, 0, 16};
  int b = nbits(static_cast<int>(divisor)) - 1;
  int r = 16 + b;
  uint64_t fq = (uint64_t{1} << r) / divisor, fr = (uint64_t{1} << r) % divisor;
  uint32_t c = divisor / 2;
  if (fr == 0) {  // a power of two
    fq >>= 1;
    --r;
  } else if (fr <= divisor / 2) {
    ++c;
  } else {
    ++fq;
  }
  return {static_cast<uint32_t>(fq), c, r};
}

struct Plane {
  int bw = 0, bh = 0, stride = 0;
  std::vector<uint8_t> px;
};

void encode_image(const uint8_t* img, int h, int w, int nc, int quality, bool sub420, std::vector<uint8_t>& out) {
  if (h < 1 || w < 1 || h > 65535 || w > 65535) fail("JPEG images are 1 to 65535 pixels a side, got %dx%d", w, h);
  if (nc != 1 && nc != 3 && nc != 4) fail("JPEG encoding takes 1, 3 or 4 channels, got %d", nc);
  if (quality < 0 || quality > 100) fail("quality must be 0 to 100, got %d", quality);
  // jpeg_quality_scaling and jpeg_add_quant_table (force_baseline)
  int q = quality <= 0 ? 1 : quality;
  int scale = q < 50 ? 5000 / q : 200 - q * 2;
  uint16_t qt[2][64];
  Divisor div[2][64];
  for (int t = 0; t < 2; ++t)
    for (int i = 0; i < 64; ++i) {
      long v = ((t ? kStdChromaQ[i] : kStdLumaQ[i]) * static_cast<long>(scale) + 50) / 100;
      v = std::min(255L, std::max(1L, v));
      qt[t][i] = static_cast<uint16_t>(v);
      div[t][i] = reciprocal(static_cast<uint32_t>(v) << 3);
    }
  const bool color = nc == 3, cmyk = nc == 4;
  const int hy = color && sub420 ? 2 : 1;  // luma sampling factors (h = v)
  const int tbl[4] = {0, color, color, 0};  // quantisation and Huffman table of each component

  // full-resolution planes: rgb_ycc_convert's tables
  std::vector<uint8_t> full[3];
  if (color) {
    constexpr int SB = 16;
    const int32_t half = 1 << (SB - 1), cbcr_off = 128 << SB;
    int32_t tab[8][256];
    for (int i = 0; i < 256; ++i) {
      tab[0][i] = fix(0.29900, SB) * i;
      tab[1][i] = fix(0.58700, SB) * i;
      tab[2][i] = fix(0.11400, SB) * i + half;
      tab[3][i] = -fix(0.16874, SB) * i;
      tab[4][i] = -fix(0.33126, SB) * i;
      tab[5][i] = fix(0.50000, SB) * i + cbcr_off + half - 1;  // B->Cb and R->Cr
      tab[6][i] = -fix(0.41869, SB) * i;
      tab[7][i] = -fix(0.08131, SB) * i;
    }
    for (auto& f : full) f.resize(static_cast<size_t>(h) * w);
    for (size_t i = 0; i < static_cast<size_t>(h) * w; ++i) {
      int r = img[3 * i], g = img[3 * i + 1], b = img[3 * i + 2];
      full[0][i] = static_cast<uint8_t>((tab[0][r] + tab[1][g] + tab[2][b]) >> SB);
      full[1][i] = static_cast<uint8_t>((tab[3][r] + tab[4][g] + tab[5][b]) >> SB);
      full[2][i] = static_cast<uint8_t>((tab[5][r] + tab[6][g] + tab[7][b]) >> SB);
    }
  }
  auto at = [&](int ci, int y, int x) -> int {
    y = std::min(y, h - 1);
    x = std::min(x, w - 1);
    size_t i = static_cast<size_t>(y) * w + x;
    if (cmyk) return 255 - img[4 * i + ci];
    return color ? full[ci][i] : img[i];
  };
  // each component's samples over its whole blocks: the image edges
  // replicated (jcsample.c's expand_right_edge, jcprepct.c's
  // expand_bottom_edge), chroma through h2v2_downsample for 4:2:0
  Plane pl[4];
  for (int ci = 0; ci < nc; ++ci) {
    Plane& p = pl[ci];
    bool down = ci > 0 && hy == 2;
    p.bw = down ? ceil_div(w, 16) : ceil_div(w, 8);
    p.bh = down ? ceil_div(h, 16) : ceil_div(h, 8);
    p.stride = p.bw * 8;
    p.px.resize(static_cast<size_t>(p.stride) * p.bh * 8);
    if (!down) {
      for (int y = 0; y < p.bh * 8; ++y)
        for (int x = 0; x < p.stride; ++x) p.px[static_cast<size_t>(y) * p.stride + x] = static_cast<uint8_t>(at(ci, y, x));
      continue;
    }
    int rows = ceil_div(h, 2);  // rows made from image rows; the rest repeat the last of them
    for (int y = 0; y < p.bh * 8; ++y) {
      uint8_t* o = &p.px[static_cast<size_t>(y) * p.stride];
      if (y >= rows) {
        memcpy(o, &p.px[static_cast<size_t>(rows - 1) * p.stride], p.stride);
        continue;
      }
      for (int x = 0; x < p.stride; ++x) {
        int bias = (x & 1) ? 2 : 1;
        int v = at(ci, 2 * y, 2 * x) + at(ci, 2 * y, 2 * x + 1) + at(ci, 2 * y + 1, 2 * x) + at(ci, 2 * y + 1, 2 * x + 1);
        o[x] = static_cast<uint8_t>((v + bias) >> 2);
      }
    }
  }
  // quantised coefficients of every block
  std::vector<int16_t> coef[4];
  for (int ci = 0; ci < nc; ++ci) {
    const Plane& p = pl[ci];
    const Divisor* dv = div[tbl[ci]];
    coef[ci].resize(static_cast<size_t>(p.bw) * p.bh * 64);
    int32_t blk[64];
    for (int by = 0; by < p.bh; ++by)
      for (int bx = 0; bx < p.bw; ++bx) {
        for (int r = 0; r < 8; ++r)
          for (int c = 0; c < 8; ++c)
            blk[r * 8 + c] = p.px[static_cast<size_t>(by * 8 + r) * p.stride + bx * 8 + c] - 128;
        fdct_islow(blk);
        int16_t* o = &coef[ci][(static_cast<size_t>(by) * p.bw + bx) * 64];
        for (int i = 0; i < 64; ++i) {
          int32_t t = blk[i];
          uint32_t a = static_cast<uint32_t>(t < 0 ? -t : t);
          uint32_t v = static_cast<uint32_t>((static_cast<uint64_t>(a + dv[i].corr) * dv[i].recip) >> dv[i].shift);
          o[i] = static_cast<int16_t>(t < 0 ? -static_cast<int32_t>(v) : static_cast<int32_t>(v));
        }
      }
  }

  // headers: SOI, JFIF APP0 (version 1.01, no density unit, 1:1) or for
  // CMYK Adobe APP14 (version 100, no flags, transform 0), DQT, SOF0, DHT
  auto put16 = [&](int v) {
    out.push_back(static_cast<uint8_t>(v >> 8));
    out.push_back(static_cast<uint8_t>(v & 255));
  };
  const uint8_t app0[] = {0xFF, 0xD8, 0xFF, 0xE0, 0x00, 0x10, 'J', 'F', 'I', 'F', 0x00,
                          0x01, 0x01, 0x00, 0x00, 0x01, 0x00, 0x01, 0x00, 0x00};
  const uint8_t app14[] = {0xFF, 0xD8, 0xFF, 0xEE, 0x00, 0x0E, 'A', 'd', 'o', 'b', 'e',
                           0x00, 0x64, 0x00, 0x00, 0x00, 0x00, 0x00};
  if (cmyk)
    out.insert(out.end(), app14, app14 + sizeof app14);
  else
    out.insert(out.end(), app0, app0 + sizeof app0);
  for (int t = 0; t < (color ? 2 : 1); ++t) {
    out.push_back(0xFF);
    out.push_back(0xDB);
    put16(67);
    out.push_back(static_cast<uint8_t>(t));
    for (int k = 0; k < 64; ++k) out.push_back(static_cast<uint8_t>(qt[t][kNatural[k]]));
  }
  out.push_back(0xFF);
  out.push_back(0xC0);
  put16(8 + 3 * nc);
  out.push_back(8);
  put16(h);
  put16(w);
  out.push_back(static_cast<uint8_t>(nc));
  const uint8_t cmyk_ids[4] = {'C', 'M', 'Y', 'K'};
  for (int ci = 0; ci < nc; ++ci) {
    out.push_back(cmyk ? cmyk_ids[ci] : static_cast<uint8_t>(ci + 1));
    out.push_back(static_cast<uint8_t>(ci == 0 ? (hy << 4) | hy : 0x11));
    out.push_back(static_cast<uint8_t>(tbl[ci]));
  }
  auto dht = [&](int cls_id, const uint8_t* bits, const uint8_t* vals) {
    int total = 0;
    for (int i = 0; i < 16; ++i) total += bits[i];
    out.push_back(0xFF);
    out.push_back(0xC4);
    put16(19 + total);
    out.push_back(static_cast<uint8_t>(cls_id));
    out.insert(out.end(), bits, bits + 16);
    out.insert(out.end(), vals, vals + total);
  };
  dht(0x00, kDcLumaBits, kDcVals);
  dht(0x10, kAcLumaBits, kAcLumaVals);
  if (color) {
    dht(0x01, kDcChromaBits, kDcVals);
    dht(0x11, kAcChromaBits, kAcChromaVals);
  }
  out.push_back(0xFF);
  out.push_back(0xDA);
  put16(6 + 2 * nc);
  out.push_back(static_cast<uint8_t>(nc));
  for (int ci = 0; ci < nc; ++ci) {
    out.push_back(cmyk ? cmyk_ids[ci] : static_cast<uint8_t>(ci + 1));
    out.push_back(static_cast<uint8_t>(tbl[ci] ? 0x11 : 0x00));
  }
  out.push_back(0);
  out.push_back(63);
  out.push_back(0);

  // entropy-coded data in MCU order; jccoefct.c's dummy blocks past the
  // right and bottom edges of the luma MCUs: AC zero, DC that of the block
  // before
  const HuffEnc hdc[2] = {make_enc(kDcLumaBits, kDcVals), make_enc(kDcChromaBits, kDcVals)};
  const HuffEnc hac[2] = {make_enc(kAcLumaBits, kAcLumaVals), make_enc(kAcChromaBits, kAcChromaVals)};
  BitWriter bw{out};
  int last_dc[4] = {0, 0, 0, 0};
  auto encode_block = [&](int ci, const int16_t* b, int dcval) {
    const HuffEnc& d = hdc[tbl[ci]];
    const HuffEnc& a = hac[tbl[ci]];
    int diff = dcval - last_dc[ci];
    last_dc[ci] = dcval;
    int mag = diff < 0 ? -diff : diff, nb = nbits(mag);
    bw.put(d.code[nb], d.size[nb]);
    bw.put(static_cast<uint32_t>(diff < 0 ? diff - 1 : diff), nb);
    int run = 0;
    for (int k = 1; k < 64; ++k) {
      int v = b ? b[kNatural[k]] : 0;
      if (v == 0) {
        ++run;
        continue;
      }
      while (run > 15) {
        bw.put(a.code[0xF0], a.size[0xF0]);
        run -= 16;
      }
      int m = v < 0 ? -v : v, n = nbits(m), sym = (run << 4) + n;
      bw.put(a.code[sym], a.size[sym]);
      bw.put(static_cast<uint32_t>(v < 0 ? v - 1 : v), n);
      run = 0;
    }
    if (run > 0) bw.put(a.code[0], a.size[0]);
  };
  if (!color || hy == 1) {
    const int bwid = pl[0].bw, bhgt = pl[0].bh;
    for (int by = 0; by < bhgt; ++by)
      for (int bx = 0; bx < bwid; ++bx)
        for (int ci = 0; ci < nc; ++ci) {
          const int16_t* b = &coef[ci][(static_cast<size_t>(by) * bwid + bx) * 64];
          encode_block(ci, b, b[0]);
        }
  } else {
    const int mcux = ceil_div(w, 16), mcuy = ceil_div(h, 16);
    const Plane& y = pl[0];
    for (int my = 0; my < mcuy; ++my)
      for (int mx = 0; mx < mcux; ++mx) {
        int prev_dc = 0;
        for (int yi = 0; yi < 2; ++yi)
          for (int xi = 0; xi < 2; ++xi) {
            int bx = 2 * mx + xi, by = 2 * my + yi;
            if (by < y.bh && bx < y.bw) {
              const int16_t* b = &coef[0][(static_cast<size_t>(by) * y.bw + bx) * 64];
              prev_dc = b[0];
              encode_block(0, b, b[0]);
            } else {
              encode_block(0, nullptr, prev_dc);
            }
          }
        for (int ci = 1; ci < 3; ++ci) {
          const int16_t* b = &coef[ci][(static_cast<size_t>(my) * pl[ci].bw + mx) * 64];
          encode_block(ci, b, b[0]);
        }
      }
  }
  bw.flush();
  out.push_back(0xFF);
  out.push_back(0xD9);
}

void set_error(char* err, int errlen, const std::string& msg) {
  if (err && errlen > 0) {
    snprintf(err, static_cast<size_t>(errlen), "%s", msg.c_str());
  }
}

}  // namespace

extern "C" {

// (height, width, components) of a JPEG held in memory; 0, or 1 with a message
int acz_jpeg_header(const uint8_t* data, size_t size, int32_t* hwc, char* err, int errlen) {
  try {
    Decoder dec(data, size);
    dec.parse(true);
    hwc[0] = dec.height;
    hwc[1] = dec.width;
    hwc[2] = dec.ncomp;
    return 0;
  } catch (const Error& e) {
    set_error(err, errlen, e.msg);
  } catch (const std::exception& e) {
    set_error(err, errlen, std::string("JPEG decode failed: ") + e.what());
  }
  return 1;
}

// decode into `out`, which holds height * width * components bytes; for
// three components `space3` overrides libjpeg's colour-space guess: 0 no
// colour transform, 1 YCbCr -> RGB, -1 the guess (as acz_jpeg_decode)
int acz_jpeg_decode_space(const uint8_t* data, size_t size, int space3, uint8_t* out, size_t out_size, char* err,
                          int errlen) {
  try {
    Decoder dec(data, size);
    dec.space3 = space3;
    dec.parse(false);
    if (out_size != static_cast<size_t>(dec.height) * dec.width * dec.ncomp)
      fail("output buffer of %zu bytes for a %dx%dx%d image", out_size, dec.height, dec.width, dec.ncomp);
    dec.output(out);
    return 0;
  } catch (const Error& e) {
    set_error(err, errlen, e.msg);
  } catch (const std::exception& e) {
    set_error(err, errlen, std::string("JPEG decode failed: ") + e.what());
  }
  return 1;
}

// decode into `out`, which holds height * width * components bytes
int acz_jpeg_decode(const uint8_t* data, size_t size, uint8_t* out, size_t out_size, char* err, int errlen) {
  return acz_jpeg_decode_space(data, size, -1, out, out_size, err, errlen);
}

// encode an (h, w, c) uint8 image, c 1 (gray), 3 (RGB) or 4 (CMYK, as PIL
// holds mode CMYK), into `out` of `cap` bytes.
// Returns the file's length (larger than cap: nothing was written, call
// again with that capacity), or -1 with a message.
int64_t acz_jpeg_encode(const uint8_t* img, int h, int w, int c, int quality, int subsample_420, uint8_t* out,
                        size_t cap, char* err, int errlen) {
  try {
    std::vector<uint8_t> buf;
    buf.reserve(cap);
    encode_image(img, h, w, c, quality, subsample_420 != 0, buf);
    if (buf.size() <= cap) memcpy(out, buf.data(), buf.size());
    return static_cast<int64_t>(buf.size());
  } catch (const Error& e) {
    set_error(err, errlen, e.msg);
  } catch (const std::exception& e) {
    set_error(err, errlen, std::string("JPEG encode failed: ") + e.what());
  }
  return -1;
}

}  // extern "C"
