// Host raster codecs with a plain C interface, loaded with ctypes by
// acezero_tpu_torch/io/tiff.py and io/bmp.py, built by
// acezero_tpu_torch/ops/build.py.
//
// acz_tiff_chunks decodes the strips or tiles of a TIFF image into one
// buffer of samples, as libtiff hands them to PIL: FillOrder 2 undone on
// the stored bytes (TIFFReverseBits), then PackBits (tif_packbits.c) or LZW
// (tif_lzw.c, the MSB-first codes with the early change) or nothing; a
// Deflate chunk comes here already inflated by io/tiff.py. Then, for LZW
// and Deflate, the horizontal predictor (tif_predict.c's horAcc8/16/32, on
// the sample values) or the floating-point one (fpAcc: byte planes summed,
// then put back together most significant byte first). Each chunk lands at
// its place in a planes x height x row-bytes buffer, tiles cropped at the
// image's edges. Samples keep the file's byte order; io/tiff.py reads them
// with it.
//
// acz_bmp_rle runs Pillow's BmpRleDecoder (BmpImagePlugin.py) step for
// step, so RLE8 and RLE4 bitmaps give PIL's bytes, its quirks included: an
// absolute run of RLE4 reads count // 2 bytes, runs are clipped to the row
// only in encoded mode, and the word alignment is that of the position in
// the file. A delta escape skips the two bytes after it and takes the next
// two as (right, up): right + up * width zero pixels, the column then
// where they end; where those two are cut short Pillow's unpacking fails.
//
// Every function is integer arithmetic: the same bits on every host.

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

void set_error(char* err, int errlen, const std::string& msg) {
  if (err && errlen > 0) snprintf(err, static_cast<size_t>(errlen), "%s", msg.c_str());
}

uint8_t reversed(uint8_t b) {
  b = static_cast<uint8_t>((b & 0xF0) >> 4 | (b & 0x0F) << 4);
  b = static_cast<uint8_t>((b & 0xCC) >> 2 | (b & 0x33) << 2);
  return static_cast<uint8_t>((b & 0xAA) >> 1 | (b & 0x55) << 1);
}

// PackBits: a signed count n, then n + 1 literal bytes (n >= 0) or one byte
// repeated 1 - n times (n < 0); -128 is a no-op. Stops when `out` is full.
size_t packbits(const uint8_t* in, size_t n, uint8_t* out, size_t cap) {
  size_t i = 0, o = 0;
  while (i < n && o < cap) {
    int c = static_cast<int8_t>(in[i++]);
    if (c >= 0) {
      size_t len = static_cast<size_t>(c) + 1;
      if (i + len > n) len = n - i;
      if (o + len > cap) len = cap - o;
      memcpy(out + o, in + i, len);
      i += len;
      o += len;
    } else if (c != -128) {
      if (i >= n) break;
      size_t len = static_cast<size_t>(1 - c);
      if (o + len > cap) len = cap - o;
      memset(out + o, in[i++], len);
      o += len;
    }
  }
  return o;
}

// TIFF LZW: codes of 9 to 12 bits, most significant bit first; 256 clears
// the table, 257 ends the data; the code width grows when the next free
// code reaches 2^width - 1 (the early change). Stops when `out` is full.
size_t lzw(const uint8_t* in, size_t n, uint8_t* out, size_t cap) {
  if (n >= 2 && in[0] == 0 && (in[1] & 1)) fail("old-style (LSB-first) LZW");
  const int kClear = 256, kEoi = 257;
  std::vector<int> prefix(4096), length(4096);
  std::vector<uint8_t> first(4096), last(4096);
  for (int c = 0; c < 256; ++c) {
    prefix[c] = -1;
    length[c] = 1;
    first[c] = last[c] = static_cast<uint8_t>(c);
  }
  int width = 9, next = 258, old = -1;
  uint64_t bits = 0;
  int nbits = 0;
  size_t i = 0, o = 0;
  std::vector<uint8_t> stack(4096);
  while (o < cap) {
    while (nbits < width) {
      if (i >= n) return o;  // out of data: the caller checks the length
      bits = (bits << 8) | in[i++];
      nbits += 8;
    }
    int code = static_cast<int>((bits >> (nbits - width)) & ((1u << width) - 1));
    nbits -= width;
    if (code == kEoi) break;
    if (code == kClear) {
      width = 9;
      next = 258;
      old = -1;
      continue;
    }
    int emit;
    if (old < 0) {
      if (code > 255) fail("corrupt LZW data (code %d after a clear)", code);
      emit = code;
    } else {
      if (code > next) fail("corrupt LZW data (code %d, next free %d)", code, next);
      if (next < 4096) {
        // the new entry: old's string plus the first byte of code's (of old's
        // own when code is the entry being made)
        prefix[next] = old;
        length[next] = length[old] + 1;
        first[next] = first[old];
        last[next] = code == next ? first[old] : first[code];
        ++next;
      }
      emit = code;
      if (next >= (1 << width) - 1 && width < 12) ++width;
    }
    int len = length[emit];
    int c = emit;
    for (int k = len - 1; k >= 0; --k) {
      stack[k] = last[c];
      c = prefix[c];
    }
    size_t take = static_cast<size_t>(len);
    if (o + take > cap) take = cap - o;
    memcpy(out + o, stack.data(), take);
    o += take;
    old = emit;
  }
  return o;
}

int64_t load(const uint8_t* p, int bytes, bool big) {
  uint64_t v = 0;
  for (int k = 0; k < bytes; ++k) v |= static_cast<uint64_t>(p[big ? bytes - 1 - k : k]) << (8 * k);
  return static_cast<int64_t>(v);
}

void store(uint8_t* p, int bytes, bool big, uint64_t v) {
  for (int k = 0; k < bytes; ++k) p[big ? bytes - 1 - k : k] = static_cast<uint8_t>(v >> (8 * k));
}

// undo the horizontal predictor on one row of `samples` samples of `bytes`
// bytes, `spp` to a pixel
void hor_acc(uint8_t* row, int samples, int spp, int bytes, bool big) {
  if (bytes == 1) {
    for (int i = spp; i < samples; ++i) row[i] = static_cast<uint8_t>(row[i] + row[i - spp]);
    return;
  }
  const uint64_t mask = bytes == 8 ? ~0ull : (1ull << (8 * bytes)) - 1;
  for (int i = spp; i < samples; ++i) {
    uint64_t v = static_cast<uint64_t>(load(row + i * bytes, bytes, big)) +
                 static_cast<uint64_t>(load(row + (i - spp) * bytes, bytes, big));
    store(row + i * bytes, bytes, big, v & mask);
  }
}

// undo the floating-point predictor on one row: the bytes summed with a
// stride of spp, then sample i's bytes gathered from the planes (most
// significant first) and stored in the file's byte order
void fp_acc(uint8_t* row, int samples, int spp, int bytes, bool big, std::vector<uint8_t>& tmp) {
  const int n = samples * bytes;
  for (int i = spp; i < n; ++i) row[i] = static_cast<uint8_t>(row[i] + row[i - spp]);
  tmp.assign(row, row + n);
  for (int i = 0; i < samples; ++i)
    for (int b = 0; b < bytes; ++b) row[i * bytes + (big ? b : bytes - 1 - b)] = tmp[b * samples + i];
}

}  // namespace

extern "C" {

// Decode `nchunks` strips or tiles (offsets, byte counts into `file`) into
// `out`: planes x img_h rows of ceil(img_w * spp * bps / 8) bytes, where
// spp is the samples a pixel of one chunk holds (1 when planar). A chunk
// is chunk_w x chunk_h pixels (a strip: img_w x rows per strip, the last
// one cut at the image's end), in the file's order: plane by plane, each
// row-major. compression 1 (none or inflated), 5 (LZW) or 32773
// (PackBits); predictor 1, 2 or 3 (applied only with compression 5 or
// inflate != 0). Returns 0, or 1 with a message.
int acz_tiff_chunks(const uint8_t* file, size_t file_size, const int64_t* offsets, const int64_t* counts,
                    int nchunks, int compression, int inflated, int reverse_bits, int predictor, int big_endian,
                    int bps, int spp, int chunk_w, int chunk_h, int img_w, int img_h, int planes, uint8_t* out,
                    size_t out_size, char* err, int errlen) {
  try {
    if (bps <= 0 || spp <= 0 || chunk_w <= 0 || chunk_h <= 0 || img_w <= 0 || img_h <= 0 || planes <= 0)
      fail("bad TIFF layout");
    const size_t chunk_row = (static_cast<size_t>(chunk_w) * spp * bps + 7) / 8;
    const size_t img_row = (static_cast<size_t>(img_w) * spp * bps + 7) / 8;
    if (out_size != img_row * img_h * planes) fail("output buffer of %zu bytes", out_size);
    const int across = (img_w + chunk_w - 1) / chunk_w;
    const int down = (img_h + chunk_h - 1) / chunk_h;
    if (nchunks != across * down * planes) fail("%d chunks for a %d x %d x %d grid", nchunks, across, down, planes);
    const bool predicted = predictor > 1 && (compression == 5 || inflated);
    const int bytes = bps / 8;
    if (predicted && (bps % 8 || (predictor == 2 && bytes != 1 && bytes != 2 && bytes != 4 && bytes != 8) ||
                      (predictor == 3 && bytes != 2 && bytes != 4 && bytes != 8) || predictor > 3))
      fail("predictor %d with %d-bit samples", predictor, bps);
    std::vector<uint8_t> raw, chunk, tmp;
    for (int c = 0; c < nchunks; ++c) {
      const int plane = c / (across * down);
      const int cy = (c % (across * down)) / across, cx = c % across;
      const int y0 = cy * chunk_h, x0 = cx * chunk_w;
      // a strip holds only the rows left; a tile is always whole
      const int rows = across == 1 && chunk_w == img_w && y0 + chunk_h > img_h ? img_h - y0 : chunk_h;
      const size_t want = chunk_row * rows;
      if (offsets[c] < 0 || counts[c] < 0 || static_cast<uint64_t>(offsets[c]) > file_size ||
          static_cast<uint64_t>(counts[c]) > file_size - static_cast<uint64_t>(offsets[c]))
        fail("chunk %d lies outside the file (truncated TIFF)", c);
      const uint8_t* src = file + offsets[c];
      size_t n = static_cast<size_t>(counts[c]);
      if (compression == 1 && !inflated && n > want) n = want;  // PIL reads what the strip needs
      if (reverse_bits) {
        raw.assign(src, src + n);
        for (auto& b : raw) b = reversed(b);
        src = raw.data();
      }
      const size_t bit0 = static_cast<size_t>(x0) * spp * bps;  // a multiple of 8: tiles are 16 pixels apart
      const size_t byte0 = bit0 / 8;
      const size_t copy = byte0 + chunk_row > img_row ? img_row - byte0 : chunk_row;
      uint8_t* dst = out + (static_cast<size_t>(plane) * img_h + y0) * img_row + byte0;
      if (compression == 1 && !predicted) {  // straight from the file into place
        if (n < want) fail("chunk %d holds %zu of its %zu bytes (truncated TIFF)", c, n, want);
        for (int r = 0; r < rows && y0 + r < img_h; ++r) memcpy(dst + r * img_row, src + chunk_row * r, copy);
        continue;
      }
      chunk.resize(want);
      size_t got;
      if (compression == 1) {
        got = n < want ? n : want;
        memcpy(chunk.data(), src, got);
      } else if (compression == 5) {
        got = lzw(src, n, chunk.data(), want);
      } else if (compression == 32773) {
        got = packbits(src, n, chunk.data(), want);
      } else {
        fail("compression %d", compression);
      }
      if (got < want) fail("chunk %d holds %zu of its %zu bytes (truncated TIFF)", c, got, want);
      if (predicted) {
        for (int r = 0; r < rows; ++r) {
          uint8_t* row = chunk.data() + chunk_row * r;
          if (predictor == 2)
            hor_acc(row, chunk_w * spp, spp, bytes, big_endian != 0);
          else
            fp_acc(row, chunk_w * spp, spp, bytes, big_endian != 0, tmp);
        }
      }
      for (int r = 0; r < rows && y0 + r < img_h; ++r) memcpy(dst + r * img_row, chunk.data() + chunk_row * r, copy);
    }
    return 0;
  } catch (const Error& e) {
    set_error(err, errlen, e.msg);
  } catch (const std::exception& e) {
    set_error(err, errlen, std::string("TIFF decode failed: ") + e.what());
  }
  return 1;
}

// Pillow's BmpRleDecoder over file[start:]: writes up to `cap` pixel bytes
// (one a pixel, rows bottom-up as stored) into `out` and returns how many
// it made (less than cap when the data ran out), or -1 with a message.
int64_t acz_bmp_rle(const uint8_t* file, size_t file_size, size_t start, int rle4, int64_t xsize, uint8_t* out,
                    size_t cap, char* err, int errlen) {
  try {
    if (xsize <= 0) fail("bad BMP width");
    std::vector<uint8_t> data;
    data.reserve(cap);
    size_t pos = start;
    int64_t x = 0;
    while (data.size() < cap) {
      if (pos + 2 > file_size) break;
      const int num = file[pos], byte = file[pos + 1];
      pos += 2;
      if (num) {  // encoded mode
        int64_t count = num;
        if (x + count > xsize) count = xsize - x > 0 ? xsize - x : 0;
        for (int64_t k = 0; k < count; ++k)
          data.push_back(static_cast<uint8_t>(rle4 ? (k % 2 == 0 ? byte >> 4 : byte & 0x0F) : byte));
        x += count;
      } else if (byte == 0) {  // end of line
        while (data.size() % static_cast<size_t>(xsize) != 0) data.push_back(0);
        x = 0;
      } else if (byte == 1) {  // end of bitmap
        break;
      } else if (byte == 2) {  // delta
        if (pos + 2 > file_size) break;
        pos += 2;
        if (pos + 2 > file_size) fail("truncated BMP RLE delta (PIL's unpacking of it fails)");
        const int64_t right = file[pos], up = file[pos + 1];
        pos += 2;
        data.resize(data.size() + static_cast<size_t>(right + up * xsize), 0);
        x = static_cast<int64_t>(data.size() % static_cast<size_t>(xsize));
      } else {  // absolute mode
        const size_t want = rle4 ? static_cast<size_t>(byte / 2) : static_cast<size_t>(byte);
        const size_t avail = pos <= file_size ? file_size - pos : 0;
        const size_t take = want < avail ? want : avail;
        for (size_t k = 0; k < take; ++k) {
          const uint8_t b = file[pos + k];
          if (rle4) {
            data.push_back(static_cast<uint8_t>(b >> 4));
            data.push_back(static_cast<uint8_t>(b & 0x0F));
          } else {
            data.push_back(b);
          }
        }
        pos += take;
        if (take < want) break;
        x += byte;
        if (pos % 2 != 0) ++pos;  // word alignment of the position in the file
      }
    }
    const size_t n = data.size() < cap ? data.size() : cap;
    memcpy(out, data.data(), n);
    return static_cast<int64_t>(n);
  } catch (const Error& e) {
    set_error(err, errlen, e.msg);
  } catch (const std::exception& e) {
    set_error(err, errlen, std::string("BMP RLE decode failed: ") + e.what());
  }
  return -1;
}

}  // extern "C"
