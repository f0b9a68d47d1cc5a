// Host GIF codec with a plain C interface, loaded with ctypes by
// acezero_tpu_torch/io/gif.py, built by acezero_tpu_torch/ops/build.py.
//
// acz_gif_decode runs Pillow's GIF decoder (libImaging/GifDecode.c) step
// for step, driven as PIL's ImageFile.load drives it, so that a file gives
// PIL's indices and PIL's refusals, corrupt files included:
//   - the LZW codes start at the file's minimum code size plus one and grow
//     after entry 2^n - 1 is added, up to 12 bits; a code size above 12 is
//     refused; 0 and 1 are taken as they come (with 1 the codes never grow);
//   - clear and end codes; a clear right after a clear is skipped; the first
//     code after a clear must be a literal; a code past the next free entry
//     is an error, the next free entry itself is the previous string plus
//     its first byte; once the table holds 4,096 entries no more are added
//     and the codes stay 12 bits wide until a clear;
//   - an end code stops the decoder without finishing the frame: PIL then
//     reads more of the file and decodes on from there, and a file that
//     ends first is truncated;
//   - the data sub-blocks are read whole (a block is decoded only once all
//     of it is there); a zero-length block is skipped like any other, so the
//     bytes after the image data are read as more blocks;
//   - the frame is written row by row at its offset in the image; an
//     interlaced frame in the four passes (rows 0, 8, ...; 4, 12, ...; 2, 6,
//     ...; 1, 3, ...); the decoder stops as soon as the last row is written;
//   - ImageFile.load reads the file in blocks of 65,536 bytes from the start
//     of the image data and calls the decoder on what it has not consumed;
//     a file that ends before the decoder finishes is truncated.
// Frame 0 is decoded without transparency (PIL passes -1), so every pixel
// of the frame's extent is written.
//
// acz_gif_encode writes an LZW code stream of 8-bit indices (minimum code
// size 8, a clear code first and whenever the table is full, an end code
// last), its code widths those the decoder above reads.
//
// Integer code throughout: the same bytes on every host.

#include <cstdarg>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <string>
#include <vector>

namespace {

constexpr int kTable = 4096;      // GIFTABLE
constexpr int kMaxCodeBits = 12;  // GIFBITS
constexpr int64_t kReadBlock = 65536;  // ImageFile.decodermaxblock

// Pillow's decoder error codes (Imaging.h) and ImageFile's messages for them
constexpr int kOverrun = -1, kBroken = -2, kConfig = -8;

const char* error_text(int code) {
  switch (code) {
    case kOverrun: return "image buffer overrun error";
    case kBroken: return "decoding error";
    case kConfig: return "bad configuration";
    default: return "unknown error";
  }
}

void set_error(char* err, int errlen, const std::string& msg) {
  if (err && errlen > 0) snprintf(err, static_cast<size_t>(errlen), "%s", msg.c_str());
}

// GIFDECODERSTATE and ImagingCodecState, as GifDecode.c uses them.
struct GifDecoder {
  // the image the frame lands in, and the frame's extent
  uint8_t* image = nullptr;
  int64_t image_width = 0;
  int xoff = 0, yoff = 0, xsize = 0, ysize = 0;
  int x = 0, y = 0;
  int state = 0;
  int errcode = 0;
  // configuration
  int bits = 8;
  int interlace = 0;
  // interlace parameters
  int step = 1;
  // input bit buffer
  int32_t bitbuffer = 0;
  int bitcount = 0;
  int blocksize = 0;
  // code buffer
  int codesize = 0, codemask = 0;
  int clear = 0, end = 0;
  // symbol history
  int lastcode = 0;
  uint8_t lastdata = 0;
  // symbol table
  unsigned next = 0;
  unsigned link[kTable] = {};
  uint8_t data[kTable] = {};
  int bufferindex = kTable;
  uint8_t buffer[kTable] = {};

  uint8_t* row() const { return image + (static_cast<int64_t>(y) + yoff) * image_width + xoff; }

  // NEWLINE: to the next row of the pass, or of the next pass; false once
  // the last row is written (the decoder returns -1, errcode unchanged)
  bool newline(uint8_t*& out) {
    x = 0;
    y += step;
    while (y >= ysize) {
      switch (interlace) {
        case 1: y = 4; interlace = 2; break;
        case 2: step = 4; y = 2; interlace = 3; break;
        case 3: step = 2; y = 1; interlace = 0; break;
        default: return false;
      }
    }
    out = row();
    return true;
  }

  // ImagingGifDecode: the bytes consumed (>= 0), or -1 when the decoder is
  // done (errcode 0: the frame is complete; below 0: an error)
  int64_t decode(const uint8_t* buf, int64_t bytes) {
    const uint8_t* ptr = buf;
    if (!state) {
      if (bits < 0 || bits > kMaxCodeBits) {
        errcode = kConfig;
        return -1;
      }
      clear = 1 << bits;
      end = clear + 1;
      if (interlace) {
        interlace = 1;
        step = 8;
      } else {
        step = 1;
      }
      state = 1;
    }
    uint8_t* out = row() + x;
    for (;;) {
      const uint8_t* p;
      int i;
      if (state == 1) {
        next = static_cast<unsigned>(clear + 2);
        codesize = bits + 1;
        codemask = (1 << codesize) - 1;
        bufferindex = kTable;
        state = 2;
      }
      if (bufferindex < kTable) {  // the rest of the last string, in one piece
        i = kTable - bufferindex;
        p = &buffer[bufferindex];
        bufferindex = kTable;
      } else {
        while (bitcount < codesize) {
          if (blocksize > 0) {
            const int c = *ptr++;
            bytes--;
            blocksize--;
            bitbuffer |= static_cast<int32_t>(c) << bitcount;
            bitcount += 8;
          } else {  // a new sub-block, decoded only once all of it is there
            if (bytes < 1) return ptr - buf;
            const int c = *ptr;
            if (bytes < c + 1) return ptr - buf;
            blocksize = c;
            ptr++;
            bytes--;
          }
        }
        int c = static_cast<int>(bitbuffer) & codemask;
        bitbuffer >>= codesize;
        bitcount -= codesize;
        if (c == clear) {
          if (state != 2) state = 1;
          continue;
        }
        if (c == end) break;
        i = 1;
        p = &lastdata;
        if (state == 2) {  // the first code after a clear is a literal
          if (c > clear) {
            errcode = kBroken;
            return -1;
          }
          lastdata = static_cast<uint8_t>(c);
          lastcode = c;
          state = 3;
        } else {
          const int thiscode = c;
          if (static_cast<unsigned>(c) > next) {
            errcode = kBroken;
            return -1;
          }
          if (static_cast<unsigned>(c) == next) {  // the previous string and its first byte
            if (bufferindex <= 0) {
              errcode = kBroken;
              return -1;
            }
            buffer[--bufferindex] = lastdata;
            c = lastcode;
          }
          while (c >= clear) {
            if (bufferindex <= 0 || c >= kTable) {
              errcode = kBroken;
              return -1;
            }
            buffer[--bufferindex] = data[c];
            c = static_cast<int>(link[c]);
          }
          lastdata = static_cast<uint8_t>(c);
          if (next < static_cast<unsigned>(kTable)) {  // a full table takes no more entries
            data[next] = static_cast<uint8_t>(c);
            link[next] = static_cast<unsigned>(lastcode);
            if (next == static_cast<unsigned>(codemask) && codesize < kMaxCodeBits) {
              codesize++;
              codemask = (1 << codesize) - 1;
            }
            next++;
          }
          lastcode = thiscode;
        }
      }
      if (y >= ysize) {
        errcode = kOverrun;
        return -1;
      }
      for (int k = 0; k < i; ++k) {
        *out++ = p[k];
        if (++x >= xsize && !newline(out)) return -1;
      }
    }
    return ptr - buf;
  }
};

}  // namespace

extern "C" {

// Decode frame 0's image data, which starts at `offset` of the file (just
// after the minimum code size byte), into `image` (height rows of width
// bytes, filled beforehand as PIL fills it) over the extent (x0, y0)-(x1,
// y1). Returns 0, or -1 with a message in `err` where PIL's load raises.
int acz_gif_decode(const uint8_t* file, size_t file_size, size_t offset, int bits, int interlace, int x0, int y0,
                   int x1, int y1, uint8_t* image, int64_t width, int64_t height, char* err, int errlen) {
  auto d = std::make_unique<GifDecoder>();
  int rc = 0;
  // decoder.setimage: an extent of x0 == x1 == 0 means the whole image
  if (x0 == 0 && x1 == 0) {
    d->xsize = static_cast<int>(width);
    d->ysize = static_cast<int>(height);
  } else {
    d->xoff = x0;
    d->yoff = y0;
    d->xsize = x1 - x0;
    d->ysize = y1 - y0;
  }
  if (d->xsize <= 0 || d->xsize + d->xoff > width || d->ysize <= 0 || d->ysize + d->yoff > height) {
    set_error(err, errlen, "tile cannot extend outside image");
    rc = -1;
  } else {
    d->image = image;
    d->image_width = width;
    d->bits = bits;
    d->interlace = interlace;
    // ImageFile.load: read a block, decode what is not consumed yet, until
    // the decoder is done or the file ends
    size_t start = offset, have = offset < file_size ? offset : file_size;
    for (;;) {
      const size_t more = file_size - have < static_cast<size_t>(kReadBlock) ? file_size - have : kReadBlock;
      if (more == 0) {
        set_error(err, errlen, "image file is truncated (" + std::to_string(have - start) + " bytes not processed)");
        rc = -1;
        break;
      }
      have += more;
      const int64_t n = d->decode(file + start, static_cast<int64_t>(have - start));
      if (n < 0) {
        if (d->errcode < 0) {
          set_error(err, errlen, error_text(d->errcode));
          rc = -1;
        }
        break;
      }
      start += static_cast<size_t>(n);
    }
  }
  return rc;
}

// An LZW code stream of `n` 8-bit indices (module note), in a buffer the
// caller frees with acz_gif_free; returns its length.
int64_t acz_gif_encode(const uint8_t* indices, int64_t n, void** out, char* err, int errlen) {
  constexpr int kBits = 8, kClear = 1 << kBits, kEnd = kClear + 1;
  constexpr int kHash = 1 << 13;  // open addressing over (prefix, byte), two slots an entry
  try {
    std::vector<uint8_t> bytes;
    bytes.reserve(static_cast<size_t>(n / 2 + 64));
    uint32_t acc = 0;
    int nacc = 0;
    // the decoder's table position and code width, kept in lockstep
    int dnext = kClear + 2, dsize = kBits + 1;
    bool first = true;
    auto emit = [&](int code) {
      acc |= static_cast<uint32_t>(code) << nacc;
      nacc += dsize;
      while (nacc >= 8) {
        bytes.push_back(static_cast<uint8_t>(acc & 0xFF));
        acc >>= 8;
        nacc -= 8;
      }
      if (code == kClear) {
        dnext = kClear + 2;
        dsize = kBits + 1;
        first = true;
      } else if (first) {
        first = false;
      } else if (dnext < kTable) {
        if (dnext == (1 << dsize) - 1 && dsize < kMaxCodeBits) dsize++;
        dnext++;
      }
    };
    // the table: (prefix, byte) -> code, hashed; a slot is in use where its
    // stamp is the current generation (a clear starts a new one)
    std::vector<int32_t> keys(kHash), codes(kHash), stamp(kHash, 0);
    int generation = 1;
    int next = kClear + 2;  // the encoder's next free entry
    emit(kClear);
    if (n > 0) {
      int prefix = indices[0];
      for (int64_t k = 1; k < n; ++k) {
        const int byte = indices[k];
        const int32_t key = (prefix << 8) | byte;
        uint32_t h = (static_cast<uint32_t>(key) * 2654435761u) >> (32 - 13);
        int found = -1;
        while (stamp[h] == generation) {
          if (keys[h] == key) {
            found = codes[h];
            break;
          }
          h = (h + 1) & (kHash - 1);
        }
        if (found >= 0) {
          prefix = found;
          continue;
        }
        emit(prefix);
        if (next < kTable) {
          stamp[h] = generation;
          keys[h] = key;
          codes[h] = next++;
        }
        if (next == kTable) {  // the table is full: start again
          emit(kClear);
          next = kClear + 2;
          ++generation;
        }
        prefix = byte;
      }
      emit(prefix);
    }
    emit(kEnd);
    if (nacc > 0) bytes.push_back(static_cast<uint8_t>(acc & 0xFF));
    void* buf = malloc(bytes.size() ? bytes.size() : 1);
    if (!buf) throw std::bad_alloc();
    memcpy(buf, bytes.data(), bytes.size());
    *out = buf;
    return static_cast<int64_t>(bytes.size());
  } catch (const std::exception& e) {
    set_error(err, errlen, std::string("GIF encode failed: ") + e.what());
  }
  return -1;
}

void acz_gif_free(void* p) { free(p); }

}  // extern "C"
