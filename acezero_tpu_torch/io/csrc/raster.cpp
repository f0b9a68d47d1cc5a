// Host codecs of the simple raster formats with a plain C interface, loaded
// with ctypes by acezero_tpu_torch/io/raster.py (and through it io/tga.py,
// io/sgi.py, io/pcx.py, io/sun.py and io/qoi.py), built by
// acezero_tpu_torch/ops/build.py.
//
// Each decoder runs Pillow's decoder of the format step for step, as PIL's
// ImageFile.load drives it, so that a file gives PIL's bytes and PIL's
// refusals, corrupt files included:
//   - acz_tga_rle_decode (libImaging/TgaRleDecode.c): packets of a header
//     byte and one pixel (a run of up to 128) or up to 128 pixels (a
//     literal); a literal runs on across rows and past the image's end, a
//     run that crosses the end of a row is an overrun; a packet is taken
//     only when all its bytes are there; the decoder stops once the last
//     row is full. A pixel is depth / 8 bytes, so 1-bit images never fill.
//   - acz_sgi_rle_decode (SgiRleDecode.c): the offset and length tables
//     of every row and channel; each row expands into one row buffer that
//     is never cleared (a short row keeps the previous row's tail); the
//     length counts packets, not bytes, and a last packet that is not the
//     0 terminator stops the whole decode with no error (the rows from
//     there on stay 0); a run past the row's width, a read past the end of
//     the file (a literal may not reach its last byte) or an offset inside
//     the header is an overrun; 16-bit samples keep their high byte.
//   - acz_pcx_decode (PcxDecode.c): bytes of 0xC0 and above are runs of
//     their low six bits; a run past the line is cut and marks an overrun
//     that fails the image when its last line is done; each line of
//     `line_bytes` has its planes moved to the unpacker's stride as
//     PcxDecode.c moves them.
//   - acz_sun_rle_decode (SunRleDecode.c): 0x80 n v is n + 1 bytes of v,
//     0x80 0 a literal 0x80, anything else itself; rows carry no padding
//     and runs cross them.
//   - acz_qoi_decode: QoiImagePlugin.QoiDecoder, its Python statement by
//     statement: the 64-entry index (a missing entry reads 0, 0, 0, 0), the
//     index, diff, luma, run, RGB and RGBA ops; the end marker is not read.
// The encoders write the bytes of Pillow's: acz_tga_rle_encode
// (TgaRleEncode.c: packets within a row, a run where the next pixel
// repeats, a literal up to a repeat inside its 128-pixel window),
// acz_pcx_encode (PcxEncode.c: runs of up to 63 within a plane, a lone byte
// below 0xC0 as itself, zero padding after each plane; the last plane of
// one-byte planes lost as Pillow loses it) and acz_qoi_encode
// (QoiImagePlugin.QoiEncoder).
//
// Integer code throughout: the same bytes on every host. No read goes past
// the buffer it is given.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

// Pillow's decoder error codes (Imaging.h) and ImageFile's messages for them
constexpr int kTruncated = 1;  // ImageFile.load: the file ends first
constexpr int kOverrun = 2;    // IMAGING_CODEC_OVERRUN

void set_error(char* err, int errlen, const std::string& msg) {
  if (err && errlen > 0) snprintf(err, static_cast<size_t>(errlen), "%s", msg.c_str());
}

int fail(int code, char* err, int errlen) {
  set_error(err, errlen, code == kTruncated ? "image file is truncated" : "buffer overrun when reading image file");
  return code;
}

// A growing output buffer handed to the caller with malloc.
int64_t hand_over(const std::vector<uint8_t>& v, void** out, char* err, int errlen) {
  void* p = malloc(v.empty() ? 1 : v.size());
  if (!p) {
    set_error(err, errlen, "out of memory");
    return -1;
  }
  if (!v.empty()) memcpy(p, v.data(), v.size());
  *out = p;
  return static_cast<int64_t>(v.size());
}

// SgiRleDecode.c's expandrow and expandrow2: the packets of one row and
// channel into `dest` (every z-th sample of `bpc` bytes). Returns 0, 1 (a
// last packet that is not the terminator: stop) or -1 (overrun).
int sgi_expand(uint8_t* dest, const uint8_t* buf, int64_t bufsize, int64_t src, int64_t n, int z, int64_t xsize,
               int bpc) {
  const int64_t end = bufsize - 1;  // &ptr[bufsize - 1]
  int64_t x = 0;
  for (; n > 0; n--) {
    uint8_t pixel;
    if (bpc == 1) {
      if (src > end) return -1;
      pixel = buf[src++];
    } else {
      if (src + 1 > end) return -1;
      pixel = buf[src + 1];
      src += 2;
    }
    if (n == 1 && pixel != 0) return 1;
    int count = pixel & 0x7f;
    if (!count) return 0;
    if (x + count > xsize) return -1;
    x += count;
    if (pixel & 0x80) {
      if (src + static_cast<int64_t>(bpc) * count > end) return -1;
      for (; count > 0; count--) {
        memcpy(dest, buf + src, bpc);
        src += bpc;
        dest += static_cast<int64_t>(z) * bpc;
      }
    } else {
      if (src + bpc - 1 > end) return -1;
      for (; count > 0; count--) {
        memcpy(dest, buf + src, bpc);
        dest += static_cast<int64_t>(z) * bpc;
      }
      src += bpc;
    }
  }
  return 0;
}

uint32_t be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) | (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

// PcxEncode.c's runs of one plane of one line.
void pcx_plane(std::vector<uint8_t>& out, const uint8_t* p, int64_t n) {
  int last = p[0], count = 1;
  auto flush = [&]() {
    if (count == 1 && last < 0xc0) {
      out.push_back(static_cast<uint8_t>(last));
    } else if (count > 0) {
      out.push_back(static_cast<uint8_t>(0xc0 | count));
      out.push_back(static_cast<uint8_t>(last));
    }
  };
  for (int64_t i = 1; i < n; i++) {
    if (count == 63) {
      out.push_back(0xff);
      out.push_back(static_cast<uint8_t>(last));
      count = 0;
    }
    if (p[i] == last) {
      count++;
    } else {
      flush();
      last = p[i];
      count = 1;
    }
  }
  flush();
}

struct Rgba {
  uint8_t v[4];
};

int qoi_hash(const Rgba& p) { return (p.v[0] * 3 + p.v[1] * 5 + p.v[2] * 7 + p.v[3] * 11) % 64; }

}  // namespace

extern "C" {

// TGA RLE: the packets of `n` bytes at `src`, pixels of `pixel` bytes, into
// `rows` rows of `row_bytes` bytes in the file's order. Returns 0, or
// kTruncated / kOverrun with a message in `err` where PIL's load raises.
int acz_tga_rle_decode(const uint8_t* src, size_t n, int pixel, int64_t row_bytes, int64_t rows, uint8_t* out,
                       char* err, int errlen) {
  const int64_t total = row_bytes * rows;
  int64_t x = 0;  // bytes of the image written
  size_t i = 0;
  while (true) {
    if (i >= n) return fail(kTruncated, err, errlen);
    const int64_t count = (src[i] & 0x7f) + 1;
    const int64_t len = static_cast<int64_t>(pixel) * count;
    if (src[i] & 0x80) {
      if (n - i < static_cast<size_t>(1 + pixel)) return fail(kTruncated, err, errlen);
      if (x % row_bytes + len > row_bytes) return fail(kOverrun, err, errlen);
      for (int64_t k = 0; k < count; k++) memcpy(out + x + k * pixel, src + i + 1, pixel);
      x += len;
      i += 1 + pixel;
    } else {
      if (n - i < static_cast<size_t>(1 + len)) return fail(kTruncated, err, errlen);
      const int64_t take = len < total - x ? len : total - x;
      memcpy(out + x, src + i + 1, take);
      x += take;
      i += 1 + len;
    }
    if (x >= total) return 0;
  }
}

// SGI RLE: `buf` is the file after its 512-byte header (`n` bytes), the
// image `xsize` x `ysize` of `bands` channels
// of `bpc` bytes; `out` receives ysize rows of xsize * bands bytes from the
// top (the file stores rows from the bottom), zero-filled by the caller.
int acz_sgi_rle_decode(const uint8_t* buf, size_t n, int64_t xsize, int64_t ysize, int bands, int bpc, uint8_t* out,
                       char* err, int errlen) {
  const int64_t bufsize = static_cast<int64_t>(n);
  const int64_t tablen = static_cast<int64_t>(bands) * ysize;
  if (bufsize < 8 * tablen) return fail(kOverrun, err, errlen);
  std::vector<uint8_t> row(static_cast<size_t>(xsize * bands * 2), 0);
  const int64_t line = xsize * bands;
  for (int64_t r = 0; r < ysize; r++) {
    const int64_t y = ysize - 1 - r;
    for (int ch = 0; ch < bands; ch++) {
      const int64_t t = r + ch * ysize;
      int64_t offset = be32(buf + 4 * t);
      // SgiRleDecode.c passes the length on as an int: 2^31 and up is negative
      const int64_t length = static_cast<int32_t>(be32(buf + 4 * (tablen + t)));
      if (offset < 512) return fail(kOverrun, err, errlen);
      offset -= 512;
      const int status = sgi_expand(row.data() + ch * bpc, buf, bufsize, offset, length, bands, xsize, bpc);
      if (status == -1) return fail(kOverrun, err, errlen);
      if (status == 1) return 0;
    }
    uint8_t* dst = out + y * line;
    for (int64_t k = 0; k < line; k++) dst[k] = row[static_cast<size_t>(k * bpc)];
  }
  return 0;
}

// PCX: the run-length lines of `n` bytes at `src` into `ysize` lines of
// `line_bytes` bytes each, planes moved as PcxDecode.c moves them for an
// unpacker of `bits` bits a pixel.
int acz_pcx_decode(const uint8_t* src, size_t n, int64_t xsize, int64_t ysize, int64_t line_bytes, int bits,
                   uint8_t* out, char* err, int errlen) {
  if ((xsize * bits + 7) / 8 > line_bytes) return fail(kOverrun, err, errlen);
  std::vector<uint8_t> buffer(static_cast<size_t>(line_bytes), 0);
  int64_t x = 0, y = 0;
  bool overrun = false;
  size_t i = 0;
  while (true) {
    if (i >= n) return fail(kTruncated, err, errlen);
    if ((src[i] & 0xC0) == 0xC0) {
      if (n - i < 2) return fail(kTruncated, err, errlen);
      for (int c = src[i] & 0x3F; c > 0; c--) {
        if (x >= line_bytes) {
          overrun = true;
          break;
        }
        buffer[x++] = src[i + 1];
      }
      i += 2;
    } else {
      buffer[x++] = src[i++];
    }
    if (x >= line_bytes) {
      int64_t xs, bands, stride = 0;
      if (bits == 2 || bits == 4) {
        xs = (xsize + 7) / 8;
        bands = bits;
        stride = line_bytes / bits;
      } else {
        xs = xsize;
        bands = line_bytes / xsize;
        if (bands != 0) stride = line_bytes / bands;
      }
      if (stride > xs) {
        for (int64_t b = 1; b < bands; b++) memmove(&buffer[b * xs], &buffer[b * stride], xs);
      }
      memcpy(out + y * line_bytes, buffer.data(), line_bytes);
      x = 0;
      if (++y >= ysize) return overrun ? fail(kOverrun, err, errlen) : 0;
    }
  }
}

// Sun raster RLE: `total` bytes of rows (no padding) from `n` bytes at `src`.
int acz_sun_rle_decode(const uint8_t* src, size_t n, int64_t total, uint8_t* out, char* err, int errlen) {
  int64_t x = 0;
  size_t i = 0;
  while (x < total) {
    if (i >= n) return fail(kTruncated, err, errlen);
    if (src[i] == 0x80) {
      if (n - i < 2) return fail(kTruncated, err, errlen);
      if (src[i + 1] == 0) {
        out[x++] = 0x80;
        i += 2;
      } else {
        if (n - i < 3) return fail(kTruncated, err, errlen);
        int64_t count = src[i + 1] + 1;
        if (count > total - x) count = total - x;
        memset(out + x, src[i + 2], count);
        x += count;
        i += 3;
      }
    } else {
      out[x++] = src[i++];
    }
  }
  return 0;
}

// QOI: the op stream of `n` bytes at `src` into xsize * ysize pixels of
// `bands` (3 or 4) bytes.
int acz_qoi_decode(const uint8_t* src, size_t n, int64_t xsize, int64_t ysize, int bands, uint8_t* out, char* err,
                   int errlen) {
  Rgba index[64];
  memset(index, 0, sizeof(index));
  Rgba prev = {{0, 0, 0, 255}};
  const int64_t total = xsize * ysize * bands;
  int64_t have = 0;
  size_t i = 0;
  auto emit = [&](const Rgba& p) {
    for (int c = 0; c < bands && have < total; c++) out[have++] = p.v[c];
  };
  while (have < total) {
    if (i >= n) return fail(kTruncated, err, errlen);
    const uint8_t byte = src[i++];
    Rgba value;
    if (byte == 0xFE) {  // QOI_OP_RGB
      if (n - i < 3) return fail(kTruncated, err, errlen);
      value = {{src[i], src[i + 1], src[i + 2], prev.v[3]}};
      i += 3;
    } else if (byte == 0xFF) {  // QOI_OP_RGBA
      if (n - i < 4) return fail(kTruncated, err, errlen);
      value = {{src[i], src[i + 1], src[i + 2], src[i + 3]}};
      i += 4;
    } else {
      const int op = byte >> 6;
      if (op == 0) {  // QOI_OP_INDEX
        value = index[byte & 0x3F];
      } else if (op == 1) {  // QOI_OP_DIFF
        value = {{static_cast<uint8_t>(prev.v[0] + ((byte & 0x30) >> 4) - 2),
                  static_cast<uint8_t>(prev.v[1] + ((byte & 0x0C) >> 2) - 2),
                  static_cast<uint8_t>(prev.v[2] + (byte & 0x03) - 2), prev.v[3]}};
      } else if (op == 2) {  // QOI_OP_LUMA
        if (i >= n) return fail(kTruncated, err, errlen);
        const uint8_t second = src[i++];
        const int dg = (byte & 0x3F) - 32, dr = ((second & 0xF0) >> 4) - 8, db = (second & 0x0F) - 8;
        value = {{static_cast<uint8_t>(prev.v[0] + dg + dr), static_cast<uint8_t>(prev.v[1] + dg),
                  static_cast<uint8_t>(prev.v[2] + dg + db), prev.v[3]}};
      } else {  // QOI_OP_RUN: no index update
        for (int k = (byte & 0x3F) + 1; k > 0; k--) emit(prev);
        continue;
      }
    }
    prev = value;
    index[qoi_hash(value)] = value;
    emit(value);
  }
  return 0;
}

// TGA RLE: `rows` rows of `xsize` pixels of `pixel` bytes, in the order the
// file stores them. Returns the byte count and the bytes in `*out` (free
// with acz_raster_free), or -1.
int64_t acz_tga_rle_encode(const uint8_t* rows, int64_t xsize, int64_t nrows, int pixel, void** out, char* err,
                           int errlen) {
  std::vector<uint8_t> v;
  auto same = [&](const uint8_t* a, const uint8_t* b) { return memcmp(a, b, pixel) == 0; };
  for (int64_t y = 0; y < nrows; y++) {
    const uint8_t* r = rows + y * xsize * pixel;
    int64_t x = 0;
    while (x < xsize) {
      const uint8_t* px = r + x * pixel;
      int64_t k;
      if (x + 1 < xsize && same(px, px + pixel)) {
        k = 2;
        while (x + k < xsize && k < 128 && same(r + (x + k) * pixel, px)) k++;
        v.push_back(static_cast<uint8_t>(0x80 | (k - 1)));
        v.insert(v.end(), px, px + pixel);
      } else {
        k = 1;
        // a repeat ends the literal only where its pair lies inside the
        // packet's 128-pixel window
        while (x + k < xsize && k < 128 &&
               !(k + 1 < 128 && x + k + 1 < xsize && same(r + (x + k) * pixel, r + (x + k + 1) * pixel)))
          k++;
        v.push_back(static_cast<uint8_t>(k - 1));
        v.insert(v.end(), px, px + k * pixel);
      }
      x += k;
    }
  }
  return hand_over(v, out, err, errlen);
}

// PCX: `ysize` lines of `planes` planes of `plane_bytes` bytes each, every
// plane followed by `padding` zero bytes.
int64_t acz_pcx_encode(const uint8_t* lines, int64_t ysize, int planes, int64_t plane_bytes, int padding, void** out,
                       char* err, int errlen) {
  std::vector<uint8_t> v;
  for (int64_t y = 0; y < ysize; y++) {
    for (int p = 0; p < planes; p++) {
      // PcxEncode.c starts a plane's run on its first byte and flushes it
      // at the plane's end; with one byte a plane the last plane's run is
      // started as the line ends, and never written
      if (plane_bytes == 1 && planes > 1 && p == planes - 1) break;
      pcx_plane(v, lines + (y * planes + p) * plane_bytes, plane_bytes);
      v.insert(v.end(), static_cast<size_t>(padding), 0);
    }
  }
  return hand_over(v, out, err, errlen);
}

// QOI: xsize * ysize pixels of `bands` (3 or 4) bytes, the op stream and
// the end marker.
int64_t acz_qoi_encode(const uint8_t* px, int64_t xsize, int64_t ysize, int bands, void** out, char* err,
                       int errlen) {
  std::vector<uint8_t> v;
  Rgba seen[64];
  bool has[64] = {false};
  seen[0] = {{0, 0, 0, 0}};
  has[0] = true;
  Rgba prev = {{0, 0, 0, 255}};
  int run = 0;
  auto delta = [](int a, int b) {
    int d = (a - b) & 255;
    return d >= 128 ? d - 256 : d;
  };
  const int64_t count = xsize * ysize;
  for (int64_t i = 0; i < count; i++) {
    const uint8_t* p = px + i * bands;
    const Rgba pixel = {{p[0], p[1], p[2], static_cast<uint8_t>(bands == 4 ? p[3] : 255)}};
    if (memcmp(pixel.v, prev.v, 4) == 0) {
      if (++run == 62) {
        v.push_back(static_cast<uint8_t>(0xC0 | (run - 1)));
        run = 0;
      }
    } else {
      if (run) {
        v.push_back(static_cast<uint8_t>(0xC0 | (run - 1)));
        run = 0;
      }
      const int h = qoi_hash(pixel);
      if (has[h] && memcmp(seen[h].v, pixel.v, 4) == 0) {
        v.push_back(static_cast<uint8_t>(h));  // QOI_OP_INDEX
      } else {
        seen[h] = pixel;
        has[h] = true;
        if (prev.v[3] == pixel.v[3]) {
          const int dr = delta(pixel.v[0], prev.v[0]), dg = delta(pixel.v[1], prev.v[1]),
                    db = delta(pixel.v[2], prev.v[2]);
          if (-2 <= dr && dr < 2 && -2 <= dg && dg < 2 && -2 <= db && db < 2) {
            v.push_back(static_cast<uint8_t>(0x40 | (dr + 2) << 4 | (dg + 2) << 2 | (db + 2)));
          } else {
            const int dgr = delta(dr, dg), dgb = delta(db, dg);
            if (-8 <= dgr && dgr < 8 && -32 <= dg && dg < 32 && -8 <= dgb && dgb < 8) {
              v.push_back(static_cast<uint8_t>(0x80 | (dg + 32)));
              v.push_back(static_cast<uint8_t>((dgr + 8) << 4 | (dgb + 8)));
            } else {
              v.push_back(0xFE);
              v.insert(v.end(), pixel.v, pixel.v + 3);
            }
          }
        } else {
          v.push_back(0xFF);
          v.insert(v.end(), pixel.v, pixel.v + 4);
        }
      }
    }
    prev = pixel;
  }
  if (run) v.push_back(static_cast<uint8_t>(0xC0 | (run - 1)));
  static const uint8_t kEnd[8] = {0, 0, 0, 0, 0, 0, 0, 1};
  v.insert(v.end(), kEnd, kEnd + 8);
  return hand_over(v, out, err, errlen);
}

void acz_raster_free(void* p) { free(p); }

}  // extern "C"
