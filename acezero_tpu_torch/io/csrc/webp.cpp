// WebP bitstreams with a plain C interface, loaded with ctypes by
// acezero_tpu_torch/io/webp.py (which parses the RIFF container), built by
// acezero_tpu_torch/ops/build.py.
//
// acz_webp_vp8 decodes a lossy frame (RFC 6386 key frame) to RGBA as
// libwebp's WebPDecode gives it to PIL (WebPAnimDecoder, MODE_RGBA, no
// dithering): the boolean decoder, the frame header (segments, loop filter
// with sharpness and mode/reference deltas, 1-8 token partitions,
// quantisers), the key-frame modes (16x16, 4x4 B_PRED, chroma), the tokens
// with their probability updates and skip flags, the inverse WHT and DCT,
// the intra predictors over libwebp's 32-byte-stride work block (127 above
// the frame, 129 left of it, the top-right samples of the macroblock's
// right-hand 4x4 blocks taken from the row above), then the normal or
// simple loop filter in libwebp's order (left macroblock edge, inner
// vertical edges, top edge, inner horizontal edges; the filter off when
// the frame's level is 0). Prediction reads unfiltered samples, so the
// whole frame is reconstructed before it is filtered. The output stage is
// libwebp's, not the RFC's: the "fancy" upsampler of src/dsp/upsampling.c
// (packed U/V pairs, rounded in two stages, first and last rows and an
// even width's last column replicated) and VP8YUVToR/G/B of src/dsp/yuv.h
// (14-bit fixed point, clipped), cropped from the macroblock grid. An ALPH
// chunk's plane (raw or VP8L-coded, unfiltered horizontally, vertically or
// by gradient, its pre-processing field ignored) fills the alpha bytes
// unpremultiplied; without one alpha is 255. A read past the end of any
// partition fails, as libwebp's eof checks make it.
//
// acz_webp_vp8l decodes a lossless stream: the predictor (14 modes),
// cross-colour, subtract-green and colour-indexing transforms (pixel
// bundling for up to 16 colours), simple and normal prefix codes, meta
// prefix codes, the colour cache and LZ77 with the 120-entry distance map.
// Its bit reader keeps libwebp's end-of-stream rule: a stream that consumes
// more bits than it holds fails (a stream under 8 bytes may read zeros up
// to 64 bits), except that an ALPH plane decoded 8 bits a pixel (colour
// indexing alone, no cache, trivial red, blue and alpha codes) may end on
// its last pixel.
//
// acz_webp_vp8l_encode writes a VP8L stream: the subtract-green transform,
// one prefix-code group (length-limited Huffman codes), no colour cache and
// no back references.
//
// The tables below are the VP8 format's (RFC 6386): the default and update
// coefficient probabilities, the key-frame 4x4 mode probabilities in
// libwebp's mode order, the DC and AC quantiser steps, and VP8L's distance
// map. Everything is integer arithmetic: the same bits on every host.

#include <algorithm>
#include <cstdarg>
#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <queue>
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

const uint8_t kCoeffsProba0[4 * 8 * 3 * 11] = {
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128,
    189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128,
    106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128,
    1, 98, 248, 255, 236, 226, 255, 255, 128, 128, 128,
    181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128,
    78, 134, 202, 247, 198, 180, 255, 219, 128, 128, 128,
    1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128,
    184, 150, 247, 255, 236, 224, 128, 128, 128, 128, 128,
    77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128,
    1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128,
    170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128,
    37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128,
    1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128,
    207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128,
    102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128,
    1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128,
    177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128,
    80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128,
    1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    246, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    198, 35, 237, 223, 193, 187, 162, 160, 145, 155, 62,
    131, 45, 198, 221, 172, 176, 220, 157, 252, 221, 1,
    68, 47, 146, 208, 149, 167, 221, 162, 255, 223, 128,
    1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128,
    184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128,
    81, 99, 181, 242, 176, 190, 249, 202, 255, 255, 128,
    1, 129, 232, 253, 214, 197, 242, 196, 255, 255, 128,
    99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128,
    23, 91, 163, 242, 170, 187, 247, 210, 255, 255, 128,
    1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128,
    109, 178, 241, 255, 231, 245, 255, 255, 128, 128, 128,
    44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128,
    1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128,
    94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128,
    22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128,
    1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128,
    124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128,
    35, 77, 181, 251, 193, 211, 255, 205, 128, 128, 128,
    1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128,
    121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128,
    45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128,
    1, 1, 251, 255, 213, 255, 128, 128, 128, 128, 128,
    203, 1, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    137, 1, 177, 255, 224, 255, 128, 128, 128, 128, 128,
    253, 9, 248, 251, 207, 208, 255, 192, 128, 128, 128,
    175, 13, 224, 243, 193, 185, 249, 198, 255, 255, 128,
    73, 17, 171, 221, 161, 179, 236, 167, 255, 234, 128,
    1, 95, 247, 253, 212, 183, 255, 255, 128, 128, 128,
    239, 90, 244, 250, 211, 209, 255, 255, 128, 128, 128,
    155, 77, 195, 248, 188, 195, 255, 255, 128, 128, 128,
    1, 24, 239, 251, 218, 219, 255, 205, 128, 128, 128,
    201, 51, 219, 255, 196, 186, 128, 128, 128, 128, 128,
    69, 46, 190, 239, 201, 218, 255, 228, 128, 128, 128,
    1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128,
    223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128,
    141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    1, 16, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    190, 36, 230, 255, 236, 255, 128, 128, 128, 128, 128,
    149, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128,
    213, 62, 250, 255, 255, 128, 128, 128, 128, 128, 128,
    55, 93, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    202, 24, 213, 235, 186, 191, 220, 160, 240, 175, 255,
    126, 38, 182, 232, 169, 184, 228, 174, 255, 187, 128,
    61, 46, 138, 219, 151, 178, 240, 170, 255, 216, 128,
    1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128,
    166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128,
    39, 77, 162, 232, 172, 180, 245, 178, 255, 255, 128,
    1, 52, 220, 246, 198, 199, 249, 220, 255, 255, 128,
    124, 74, 191, 243, 183, 193, 250, 221, 255, 255, 128,
    24, 71, 130, 219, 154, 170, 243, 182, 255, 255, 128,
    1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128,
    149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128,
    28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128,
    1, 81, 230, 252, 204, 203, 255, 192, 128, 128, 128,
    123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128,
    20, 95, 153, 243, 164, 173, 255, 203, 128, 128, 128,
    1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128,
    168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128,
    47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128,
    1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128,
    141, 84, 213, 252, 201, 202, 255, 219, 128, 128, 128,
    42, 80, 160, 240, 162, 185, 255, 205, 128, 128, 128,
    1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    244, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    238, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
};
const uint8_t kCoeffsUpdateProba[4 * 8 * 3 * 11] = {
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 244, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    239, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255,
    250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    217, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255,
    234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    247, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255,
    234, 251, 244, 254, 255, 255, 255, 255, 255, 255, 255,
    251, 251, 243, 253, 254, 255, 254, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
};
const uint8_t kBModesProba[10 * 10 * 9] = {
    231, 120, 48, 89, 115, 113, 120, 152, 112,
    152, 179, 64, 126, 170, 118, 46, 70, 95,
    175, 69, 143, 80, 85, 82, 72, 155, 103,
    56, 58, 10, 171, 218, 189, 17, 13, 152,
    114, 26, 17, 163, 44, 195, 21, 10, 173,
    121, 24, 80, 195, 26, 62, 44, 64, 85,
    144, 71, 10, 38, 171, 213, 144, 34, 26,
    170, 46, 55, 19, 136, 160, 33, 206, 71,
    63, 20, 8, 114, 114, 208, 12, 9, 226,
    81, 40, 11, 96, 182, 84, 29, 16, 36,
    134, 183, 89, 137, 98, 101, 106, 165, 148,
    72, 187, 100, 130, 157, 111, 32, 75, 80,
    66, 102, 167, 99, 74, 62, 40, 234, 128,
    41, 53, 9, 178, 241, 141, 26, 8, 107,
    74, 43, 26, 146, 73, 166, 49, 23, 157,
    65, 38, 105, 160, 51, 52, 31, 115, 128,
    104, 79, 12, 27, 217, 255, 87, 17, 7,
    87, 68, 71, 44, 114, 51, 15, 186, 23,
    47, 41, 14, 110, 182, 183, 21, 17, 194,
    66, 45, 25, 102, 197, 189, 23, 18, 22,
    88, 88, 147, 150, 42, 46, 45, 196, 205,
    43, 97, 183, 117, 85, 38, 35, 179, 61,
    39, 53, 200, 87, 26, 21, 43, 232, 171,
    56, 34, 51, 104, 114, 102, 29, 93, 77,
    39, 28, 85, 171, 58, 165, 90, 98, 64,
    34, 22, 116, 206, 23, 34, 43, 166, 73,
    107, 54, 32, 26, 51, 1, 81, 43, 31,
    68, 25, 106, 22, 64, 171, 36, 225, 114,
    34, 19, 21, 102, 132, 188, 16, 76, 124,
    62, 18, 78, 95, 85, 57, 50, 48, 51,
    193, 101, 35, 159, 215, 111, 89, 46, 111,
    60, 148, 31, 172, 219, 228, 21, 18, 111,
    112, 113, 77, 85, 179, 255, 38, 120, 114,
    40, 42, 1, 196, 245, 209, 10, 25, 109,
    88, 43, 29, 140, 166, 213, 37, 43, 154,
    61, 63, 30, 155, 67, 45, 68, 1, 209,
    100, 80, 8, 43, 154, 1, 51, 26, 71,
    142, 78, 78, 16, 255, 128, 34, 197, 171,
    41, 40, 5, 102, 211, 183, 4, 1, 221,
    51, 50, 17, 168, 209, 192, 23, 25, 82,
    138, 31, 36, 171, 27, 166, 38, 44, 229,
    67, 87, 58, 169, 82, 115, 26, 59, 179,
    63, 59, 90, 180, 59, 166, 93, 73, 154,
    40, 40, 21, 116, 143, 209, 34, 39, 175,
    47, 15, 16, 183, 34, 223, 49, 45, 183,
    46, 17, 33, 183, 6, 98, 15, 32, 183,
    57, 46, 22, 24, 128, 1, 54, 17, 37,
    65, 32, 73, 115, 28, 128, 23, 128, 205,
    40, 3, 9, 115, 51, 192, 18, 6, 223,
    87, 37, 9, 115, 59, 77, 64, 21, 47,
    104, 55, 44, 218, 9, 54, 53, 130, 226,
    64, 90, 70, 205, 40, 41, 23, 26, 57,
    54, 57, 112, 184, 5, 41, 38, 166, 213,
    30, 34, 26, 133, 152, 116, 10, 32, 134,
    39, 19, 53, 221, 26, 114, 32, 73, 255,
    31, 9, 65, 234, 2, 15, 1, 118, 73,
    75, 32, 12, 51, 192, 255, 160, 43, 51,
    88, 31, 35, 67, 102, 85, 55, 186, 85,
    56, 21, 23, 111, 59, 205, 45, 37, 192,
    55, 38, 70, 124, 73, 102, 1, 34, 98,
    125, 98, 42, 88, 104, 85, 117, 175, 82,
    95, 84, 53, 89, 128, 100, 113, 101, 45,
    75, 79, 123, 47, 51, 128, 81, 171, 1,
    57, 17, 5, 71, 102, 57, 53, 41, 49,
    38, 33, 13, 121, 57, 73, 26, 1, 85,
    41, 10, 67, 138, 77, 110, 90, 47, 114,
    115, 21, 2, 10, 102, 255, 166, 23, 6,
    101, 29, 16, 10, 85, 128, 101, 196, 26,
    57, 18, 10, 102, 102, 213, 34, 20, 43,
    117, 20, 15, 36, 163, 128, 68, 1, 26,
    102, 61, 71, 37, 34, 53, 31, 243, 192,
    69, 60, 71, 38, 73, 119, 28, 222, 37,
    68, 45, 128, 34, 1, 47, 11, 245, 171,
    62, 17, 19, 70, 146, 85, 55, 62, 70,
    37, 43, 37, 154, 100, 163, 85, 160, 1,
    63, 9, 92, 136, 28, 64, 32, 201, 85,
    75, 15, 9, 9, 64, 255, 184, 119, 16,
    86, 6, 28, 5, 64, 255, 25, 248, 1,
    56, 8, 17, 132, 137, 255, 55, 116, 128,
    58, 15, 20, 82, 135, 57, 26, 121, 40,
    164, 50, 31, 137, 154, 133, 25, 35, 218,
    51, 103, 44, 131, 131, 123, 31, 6, 158,
    86, 40, 64, 135, 148, 224, 45, 183, 128,
    22, 26, 17, 131, 240, 154, 14, 1, 209,
    45, 16, 21, 91, 64, 222, 7, 1, 197,
    56, 21, 39, 155, 60, 138, 23, 102, 213,
    83, 12, 13, 54, 192, 255, 68, 47, 28,
    85, 26, 85, 85, 128, 128, 32, 146, 171,
    18, 11, 7, 63, 144, 171, 4, 4, 246,
    35, 27, 10, 146, 174, 171, 12, 26, 128,
    190, 80, 35, 99, 180, 80, 126, 54, 45,
    85, 126, 47, 87, 176, 51, 41, 20, 32,
    101, 75, 128, 139, 118, 146, 116, 128, 85,
    56, 41, 15, 176, 236, 85, 37, 9, 62,
    71, 30, 17, 119, 118, 255, 17, 18, 138,
    101, 38, 60, 138, 55, 70, 43, 26, 142,
    146, 36, 19, 30, 171, 255, 97, 27, 20,
    138, 45, 61, 62, 219, 1, 81, 188, 64,
    32, 41, 20, 117, 151, 142, 20, 21, 163,
    112, 19, 12, 61, 195, 128, 48, 4, 24,
};
const uint8_t kDcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17,
    18, 19, 20, 20, 21, 21, 22, 22, 23, 23, 24, 25, 25, 26, 27, 28,
    29, 30, 31, 32, 33, 34, 35, 36, 37, 37, 38, 39, 40, 41, 42, 43,
    44, 45, 46, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58,
    59, 60, 61, 62, 63, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74,
    75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89,
    91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118,
    122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157,
};
const uint16_t kAcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
    20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35,
    36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51,
    52, 53, 54, 55, 56, 57, 58, 60, 62, 64, 66, 68, 70, 72, 74, 76,
    78, 80, 82, 84, 86, 88, 90, 92, 94, 96, 98, 100, 102, 104, 106, 108,
    110, 112, 114, 116, 119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152,
    155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193, 197, 201, 205, 209,
    213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269, 274, 279, 284,
};
const uint8_t kCodeToPlane[120] = {
    24, 7, 23, 25, 40, 6, 39, 41, 22, 26,
    38, 42, 56, 5, 55, 57, 21, 27, 54, 58,
    37, 43, 72, 4, 71, 73, 20, 28, 53, 59,
    70, 74, 36, 44, 88, 69, 75, 52, 60, 3,
    87, 89, 19, 29, 86, 90, 35, 45, 68, 76,
    85, 91, 51, 61, 104, 2, 103, 105, 18, 30,
    102, 106, 34, 46, 84, 92, 67, 77, 101, 107,
    50, 62, 120, 1, 119, 121, 83, 93, 17, 31,
    100, 108, 66, 78, 118, 122, 33, 47, 117, 123,
    49, 63, 99, 109, 82, 94, 0, 116, 124, 65,
    79, 16, 32, 98, 110, 48, 115, 125, 81, 95,
    64, 114, 126, 97, 111, 80, 113, 127, 96, 112,
};


// ---------------------------------------------------------------- VP8

const uint8_t kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
const uint8_t kBands[16 + 1] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0};
const uint8_t kCat3[] = {173, 148, 140, 0};
const uint8_t kCat4[] = {176, 155, 140, 135, 0};
const uint8_t kCat5[] = {180, 157, 141, 134, 130, 0};
const uint8_t kCat6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129, 0};
const uint8_t* const kCat3456[] = {kCat3, kCat4, kCat5, kCat6};
// the 4x4 mode tree, libwebp's mode order: DC TM VE HE RD VR LD VL HD HU
const int8_t kYModesIntra4[18] = {-0, 1, -1, 2, -2, 3, 4, 6, -3, 5, -4, -5, -6, 7, -7, 8, -8, -9};
enum { B_DC_PRED = 0, B_TM_PRED, B_VE_PRED, B_HE_PRED, B_RD_PRED, B_VR_PRED, B_LD_PRED, B_VL_PRED, B_HD_PRED,
       B_HU_PRED, DC_NOTOP, DC_NOLEFT, DC_NOTOPLEFT };
const int DC_PRED = B_DC_PRED, TM_PRED = B_TM_PRED, V_PRED = B_VE_PRED, H_PRED = B_HE_PRED;

const int BPS = 32;  // the work block's stride, as libwebp's
const int Y_OFF = BPS * 1 + 8;
const int U_OFF = Y_OFF + BPS * 16 + BPS;
const int V_OFF = U_OFF + 16;
const int YUV_SIZE = BPS * 17 + BPS * 9;
const int kScan[16] = {0 + 0 * BPS,  4 + 0 * BPS,  8 + 0 * BPS,  12 + 0 * BPS, 0 + 4 * BPS,  4 + 4 * BPS,
                       8 + 4 * BPS,  12 + 4 * BPS, 0 + 8 * BPS,  4 + 8 * BPS,  8 + 8 * BPS,  12 + 8 * BPS,
                       0 + 12 * BPS, 4 + 12 * BPS, 8 + 12 * BPS, 12 + 12 * BPS};

inline int log2floor(uint32_t v) { return 31 - __builtin_clz(v); }
inline uint8_t clip8(int v) { return static_cast<uint8_t>(v < 0 ? 0 : v > 255 ? 255 : v); }
inline int sclip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }  // VP8ksclip1
inline int sclip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }      // VP8ksclip2

// libwebp's VP8BitReader as its x86-64 and aarch64 builds run it: a 64-bit
// window filled 56 bits at a time while 8 bytes remain, then a byte at a
// time; `eof` is set when a bit is asked for whose 8-bit window runs past
// the end (or at once for an empty partition). A valid stream never leaves
// the window's value at or above the range; a corrupt one can, and then
// the bits decoded depend on this exact arithmetic: the window compared
// after truncation to 32 bits, and get_signed's sign mask.
struct BoolReader {
  const uint8_t* buf = nullptr;
  const uint8_t* buf_end = nullptr;
  const uint8_t* buf_max = nullptr;  // bulk loads while buf < buf_max
  uint64_t value = 0;
  int bits = -8;
  uint32_t range = 254;  // range - 1
  bool eof = false;

  void init(const uint8_t* p, size_t n) {
    buf = p;
    buf_end = p + n;
    buf_max = (n >= 8) ? p + n - 8 + 1 : p;
    value = 0;
    bits = -8;
    range = 254;
    eof = false;
    load();
  }
  void load() {
    if (buf < buf_max) {
      uint64_t in = 0;
      for (int i = 0; i < 7; ++i) in = (in << 8) | buf[i];
      buf += 7;
      value = in | (value << 56);
      bits += 56;
    } else if (buf < buf_end) {
      bits += 8;
      value = static_cast<uint64_t>(*buf++) | (value << 8);
    } else if (!eof) {
      value <<= 8;
      bits += 8;
      eof = true;
    } else {
      bits = 0;
    }
  }
  int get(int prob) {
    uint32_t r = range;
    if (bits < 0) load();
    const int pos = bits;
    const uint32_t split = (r * static_cast<uint32_t>(prob)) >> 8;
    const uint32_t v = static_cast<uint32_t>(value >> pos);
    int bit;
    if (v > split) {
      r -= split;
      value -= static_cast<uint64_t>(split + 1) << pos;
      bit = 1;
    } else {
      r = split + 1;
      bit = 0;
    }
    const int shift = 7 ^ log2floor(r);
    r <<= shift;
    bits -= shift;
    range = r - 1;
    return bit;
  }
  // VP8GetSigned: a bit at probability 1/2 giving the sign of v
  int get_signed(int v) {
    if (bits < 0) load();
    const int pos = bits;
    const uint32_t split = range >> 1;
    const uint32_t val = static_cast<uint32_t>(value >> pos);
    const int32_t mask = static_cast<int32_t>(split - val) >> 31;  // -1 or 0
    bits -= 1;
    range += static_cast<uint32_t>(mask);
    range |= 1;
    value -= static_cast<uint64_t>((split + 1) & static_cast<uint32_t>(mask)) << pos;
    return (v ^ mask) - mask;
  }
  uint32_t literal(int n) {
    uint32_t v = 0;
    while (n-- > 0) v |= static_cast<uint32_t>(get(0x80)) << n;
    return v;
  }
  int signed_literal(int n) {
    const int v = static_cast<int>(literal(n));
    return get(0x80) ? -v : v;
  }
};

struct BandProbas {
  uint8_t p[3][11];
};

struct FInfo {
  int limit = 0, ilevel = 0, inner = 0, hev_thresh = 0;
};

struct MBContext {  // VP8MB: non-zero bits of the blocks at an edge
  uint8_t nz = 0, nz_dc = 0;
};

struct MBData {
  int16_t coeffs[384];
  uint8_t is_i4x4 = 0, imodes[16] = {0}, uvmode = 0, segment = 0, skip = 0;
  uint32_t non_zero_y = 0, non_zero_uv = 0;
};

struct Quant {
  int y1[2], y2[2], uv[2];
};

struct TopSamples {
  uint8_t y[16], u[8], v[8];
};

// Intra predictors on the work block (dst at the block's top-left sample).
void put16(int v, uint8_t* dst) {
  for (int j = 0; j < 16; ++j) memset(dst + j * BPS, v, 16);
}
void true_motion(uint8_t* dst, int size) {
  const uint8_t* top = dst - BPS;
  const int tl = top[-1];
  for (int y = 0; y < size; ++y) {
    const int l = dst[-1];
    for (int x = 0; x < size; ++x) dst[x] = clip8(top[x] + l - tl);
    dst += BPS;
  }
}
void predict16(int mode, uint8_t* dst) {
  int dc;
  switch (mode) {
    case B_DC_PRED:
      dc = 16;
      for (int j = 0; j < 16; ++j) dc += dst[-1 + j * BPS] + dst[j - BPS];
      put16(dc >> 5, dst);
      break;
    case DC_NOTOP:
      dc = 8;
      for (int j = 0; j < 16; ++j) dc += dst[-1 + j * BPS];
      put16(dc >> 4, dst);
      break;
    case DC_NOLEFT:
      dc = 8;
      for (int i = 0; i < 16; ++i) dc += dst[i - BPS];
      put16(dc >> 4, dst);
      break;
    case DC_NOTOPLEFT:
      put16(0x80, dst);
      break;
    case B_TM_PRED:
      true_motion(dst, 16);
      break;
    case B_VE_PRED:
      for (int j = 0; j < 16; ++j) memcpy(dst + j * BPS, dst - BPS, 16);
      break;
    case B_HE_PRED:
      for (int j = 0; j < 16; ++j) memset(dst + j * BPS, dst[j * BPS - 1], 16);
      break;
    default:
      fail("VP8: 16x16 prediction mode %d", mode);
  }
}
void put8(int v, uint8_t* dst) {
  for (int j = 0; j < 8; ++j) memset(dst + j * BPS, v, 8);
}
void predict8(int mode, uint8_t* dst) {
  int dc;
  switch (mode) {
    case B_DC_PRED:
      dc = 8;
      for (int i = 0; i < 8; ++i) dc += dst[i - BPS] + dst[-1 + i * BPS];
      put8(dc >> 4, dst);
      break;
    case DC_NOTOP:
      dc = 4;
      for (int i = 0; i < 8; ++i) dc += dst[-1 + i * BPS];
      put8(dc >> 3, dst);
      break;
    case DC_NOLEFT:
      dc = 4;
      for (int i = 0; i < 8; ++i) dc += dst[i - BPS];
      put8(dc >> 3, dst);
      break;
    case DC_NOTOPLEFT:
      put8(0x80, dst);
      break;
    case B_TM_PRED:
      true_motion(dst, 8);
      break;
    case B_VE_PRED:
      for (int j = 0; j < 8; ++j) memcpy(dst + j * BPS, dst - BPS, 8);
      break;
    case B_HE_PRED:
      for (int j = 0; j < 8; ++j) memset(dst + j * BPS, dst[j * BPS - 1], 8);
      break;
    default:
      fail("VP8: chroma prediction mode %d", mode);
  }
}
inline uint8_t avg3(int a, int b, int c) { return static_cast<uint8_t>((a + 2 * b + c + 2) >> 2); }
inline uint8_t avg2(int a, int b) { return static_cast<uint8_t>((a + b + 1) >> 1); }
void predict4(int mode, uint8_t* dst) {
#define DST(x, y) dst[(x) + (y) * BPS]
  const uint8_t* top = dst - BPS;
  const int X = top[-1], A = top[0], B = top[1], C = top[2], D = top[3], E = top[4], F = top[5], G = top[6],
            H = top[7];
  const int I = dst[-1], J = dst[-1 + BPS], K = dst[-1 + 2 * BPS], L = dst[-1 + 3 * BPS];
  switch (mode) {
    case B_DC_PRED: {
      uint32_t dc = 4;
      for (int i = 0; i < 4; ++i) dc += dst[i - BPS] + dst[-1 + i * BPS];
      dc >>= 3;
      for (int i = 0; i < 4; ++i) memset(dst + i * BPS, static_cast<int>(dc), 4);
      break;
    }
    case B_TM_PRED:
      true_motion(dst, 4);
      break;
    case B_VE_PRED: {
      const uint8_t vals[4] = {avg3(X, A, B), avg3(A, B, C), avg3(B, C, D), avg3(C, D, E)};
      for (int i = 0; i < 4; ++i) memcpy(dst + i * BPS, vals, 4);
      break;
    }
    case B_HE_PRED:
      memset(dst + 0 * BPS, avg3(X, I, J), 4);
      memset(dst + 1 * BPS, avg3(I, J, K), 4);
      memset(dst + 2 * BPS, avg3(J, K, L), 4);
      memset(dst + 3 * BPS, avg3(K, L, L), 4);
      break;
    case B_RD_PRED:
      DST(0, 3) = avg3(J, K, L);
      DST(1, 3) = DST(0, 2) = avg3(I, J, K);
      DST(2, 3) = DST(1, 2) = DST(0, 1) = avg3(X, I, J);
      DST(3, 3) = DST(2, 2) = DST(1, 1) = DST(0, 0) = avg3(A, X, I);
      DST(3, 2) = DST(2, 1) = DST(1, 0) = avg3(B, A, X);
      DST(3, 1) = DST(2, 0) = avg3(C, B, A);
      DST(3, 0) = avg3(D, C, B);
      break;
    case B_LD_PRED:
      DST(0, 0) = avg3(A, B, C);
      DST(1, 0) = DST(0, 1) = avg3(B, C, D);
      DST(2, 0) = DST(1, 1) = DST(0, 2) = avg3(C, D, E);
      DST(3, 0) = DST(2, 1) = DST(1, 2) = DST(0, 3) = avg3(D, E, F);
      DST(3, 1) = DST(2, 2) = DST(1, 3) = avg3(E, F, G);
      DST(3, 2) = DST(2, 3) = avg3(F, G, H);
      DST(3, 3) = avg3(G, H, H);
      break;
    case B_VR_PRED:
      DST(0, 0) = DST(1, 2) = avg2(X, A);
      DST(1, 0) = DST(2, 2) = avg2(A, B);
      DST(2, 0) = DST(3, 2) = avg2(B, C);
      DST(3, 0) = avg2(C, D);
      DST(0, 3) = avg3(K, J, I);
      DST(0, 2) = avg3(J, I, X);
      DST(0, 1) = DST(1, 3) = avg3(I, X, A);
      DST(1, 1) = DST(2, 3) = avg3(X, A, B);
      DST(2, 1) = DST(3, 3) = avg3(A, B, C);
      DST(3, 1) = avg3(B, C, D);
      break;
    case B_VL_PRED:
      DST(0, 0) = avg2(A, B);
      DST(1, 0) = DST(0, 2) = avg2(B, C);
      DST(2, 0) = DST(1, 2) = avg2(C, D);
      DST(3, 0) = DST(2, 2) = avg2(D, E);
      DST(0, 1) = avg3(A, B, C);
      DST(1, 1) = DST(0, 3) = avg3(B, C, D);
      DST(2, 1) = DST(1, 3) = avg3(C, D, E);
      DST(3, 1) = DST(2, 3) = avg3(D, E, F);
      DST(3, 2) = avg3(E, F, G);
      DST(3, 3) = avg3(F, G, H);
      break;
    case B_HD_PRED:
      DST(0, 0) = DST(2, 1) = avg2(I, X);
      DST(0, 1) = DST(2, 2) = avg2(J, I);
      DST(0, 2) = DST(2, 3) = avg2(K, J);
      DST(0, 3) = avg2(L, K);
      DST(3, 0) = avg3(A, B, C);
      DST(2, 0) = avg3(X, A, B);
      DST(1, 0) = DST(3, 1) = avg3(I, X, A);
      DST(1, 1) = DST(3, 2) = avg3(J, I, X);
      DST(1, 2) = DST(3, 3) = avg3(K, J, I);
      DST(1, 3) = avg3(L, K, J);
      break;
    case B_HU_PRED:
      DST(0, 0) = avg2(I, J);
      DST(2, 0) = DST(0, 1) = avg2(J, K);
      DST(2, 1) = DST(0, 2) = avg2(K, L);
      DST(1, 0) = avg3(I, J, K);
      DST(3, 0) = DST(1, 1) = avg3(J, K, L);
      DST(3, 1) = DST(1, 2) = avg3(K, L, L);
      DST(3, 2) = DST(2, 2) = DST(0, 3) = DST(1, 3) = DST(2, 3) = DST(3, 3) = static_cast<uint8_t>(L);
      break;
    default:
      fail("VP8: 4x4 prediction mode %d", mode);
  }
#undef DST
}

// The inverse DCT of one 4x4 block added to the prediction, in two
// arithmetics, as libwebp's x86 build runs them: `transform` is the C
// TransformOne (32-bit ints, the sum clipped), which also gives the samples
// of its DC-only and three-coefficient variants; `transform_sse2` is
// Transform_SSE2, which libwebp runs for blocks with more coefficients
// (16-bit lanes that wrap, the sum saturated). The two agree on every
// block a valid stream holds; they differ only where a corrupt stream's
// coefficients overflow 16 bits.
inline int mul1(int a) { return ((a * 20091) >> 16) + a; }
inline int mul2(int a) { return (a * 35468) >> 16; }
void transform(const int16_t* in, uint8_t* dst) {
  int C[16];
  int* tmp = C;
  for (int i = 0; i < 4; ++i) {  // vertical pass
    const int a = in[0] + in[8];
    const int b = in[0] - in[8];
    const int c = mul2(in[4]) - mul1(in[12]);
    const int d = mul1(in[4]) + mul2(in[12]);
    tmp[0] = a + d;
    tmp[1] = b + c;
    tmp[2] = b - c;
    tmp[3] = a - d;
    tmp += 4;
    in++;
  }
  tmp = C;
  for (int i = 0; i < 4; ++i) {  // horizontal pass
    const int dc = tmp[0] + 4;
    const int a = dc + tmp[8];
    const int b = dc - tmp[8];
    const int c = mul2(tmp[4]) - mul1(tmp[12]);
    const int d = mul1(tmp[4]) + mul2(tmp[12]);
    dst[0] = clip8(dst[0] + ((a + d) >> 3));
    dst[1] = clip8(dst[1] + ((b + c) >> 3));
    dst[2] = clip8(dst[2] + ((b - c) >> 3));
    dst[3] = clip8(dst[3] + ((a - d) >> 3));
    tmp++;
    dst += BPS;
  }
}
inline int16_t w16(int v) { return static_cast<int16_t>(v); }
inline int16_t mulhi(int16_t x, int k) { return w16((static_cast<int32_t>(x) * k) >> 16); }
// one pass of Transform_SSE2 over four lanes: a column, or a row after the transpose
inline void sse2_pass(int16_t t0, int16_t t1, int16_t t2, int16_t t3, int16_t dc_round, int16_t out[4]) {
  const int k1 = 20091, k2 = -30068;  // 85627 and 35468, less 1 << 16
  const int16_t dc = w16(t0 + dc_round);
  const int16_t a = w16(dc + t2), b = w16(dc - t2);
  const int16_t c = w16(w16(t1 - t3) + w16(mulhi(t1, k2) - mulhi(t3, k1)));
  const int16_t d = w16(w16(t1 + t3) + w16(mulhi(t1, k1) + mulhi(t3, k2)));
  out[0] = w16(a + d);
  out[1] = w16(b + c);
  out[2] = w16(b - c);
  out[3] = w16(a - d);
}
void transform_sse2(const int16_t* in, uint8_t* dst) {
  int16_t C[4][4];  // C[column][row] after the vertical pass
  for (int i = 0; i < 4; ++i) sse2_pass(in[i], in[4 + i], in[8 + i], in[12 + i], 0, C[i]);
  for (int i = 0; i < 4; ++i) {  // output row i
    int16_t r[4];
    sse2_pass(C[0][i], C[1][i], C[2][i], C[3][i], 4, r);
    for (int x = 0; x < 4; ++x) {
      const int16_t v = w16(dst[x] + (r[x] >> 3));
      dst[x] = static_cast<uint8_t>(v < 0 ? 0 : v > 255 ? 255 : v);
    }
    dst += BPS;
  }
}
void transform_wht(const int16_t* in, int16_t* out) {
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    const int a0 = in[0 + i] + in[12 + i];
    const int a1 = in[4 + i] + in[8 + i];
    const int a2 = in[4 + i] - in[8 + i];
    const int a3 = in[0 + i] - in[12 + i];
    tmp[0 + i] = a0 + a1;
    tmp[8 + i] = a0 - a1;
    tmp[4 + i] = a3 + a2;
    tmp[12 + i] = a3 - a2;
  }
  for (int i = 0; i < 4; ++i) {
    const int dc = tmp[0 + i * 4] + 3;
    const int a0 = dc + tmp[3 + i * 4];
    const int a1 = tmp[1 + i * 4] + tmp[2 + i * 4];
    const int a2 = tmp[1 + i * 4] - tmp[2 + i * 4];
    const int a3 = dc - tmp[3 + i * 4];
    out[0] = static_cast<int16_t>((a0 + a1) >> 3);
    out[16] = static_cast<int16_t>((a3 + a2) >> 3);
    out[32] = static_cast<int16_t>((a0 - a1) >> 3);
    out[48] = static_cast<int16_t>((a3 - a2) >> 3);
    out += 64;
  }
}

// The loop filter's pieces (src/dsp/dec.c), on samples `step` apart.
inline void filter2(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
}
inline void filter4(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  const int a3 = (a1 + 1) >> 1;
  p[-2 * step] = clip8(p1 + a3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a3);
}
inline void filter6(uint8_t* p, int step) {
  const int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step];
  const int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
  const int a1 = (27 * a + 63) >> 7;
  const int a2 = (18 * a + 63) >> 7;
  const int a3 = (9 * a + 63) >> 7;
  p[-3 * step] = clip8(p2 + a3);
  p[-2 * step] = clip8(p1 + a2);
  p[-step] = clip8(p0 + a1);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a2);
  p[2 * step] = clip8(q2 - a3);
}
inline bool hev(const uint8_t* p, int step, int thresh) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return std::abs(p1 - p0) > thresh || std::abs(q1 - q0) > thresh;
}
inline bool needs_filter(const uint8_t* p, int step, int t) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return 4 * std::abs(p0 - q0) + std::abs(p1 - q1) <= t;
}
inline bool needs_filter2(const uint8_t* p, int step, int t, int it) {
  const int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step];
  const int p0 = p[-step], q0 = p[0];
  const int q1 = p[step], q2 = p[2 * step], q3 = p[3 * step];
  if (4 * std::abs(p0 - q0) + std::abs(p1 - q1) > t) return false;
  return std::abs(p3 - p2) <= it && std::abs(p2 - p1) <= it && std::abs(p1 - p0) <= it &&
         std::abs(q3 - q2) <= it && std::abs(q2 - q1) <= it && std::abs(q1 - q0) <= it;
}
void simple_filter(uint8_t* p, int hstride, int vstride, int thresh) {  // 16 samples along the edge
  const int thresh2 = 2 * thresh + 1;
  for (int i = 0; i < 16; ++i) {
    if (needs_filter(p + i * vstride, hstride, thresh2)) filter2(p + i * vstride, hstride);
  }
}
void filter_loop(uint8_t* p, int hstride, int vstride, int size, int thresh, int ithresh, int hev_t, bool edge) {
  const int thresh2 = 2 * thresh + 1;
  while (size-- > 0) {
    if (needs_filter2(p, hstride, thresh2, ithresh)) {
      if (hev(p, hstride, hev_t)) {
        filter2(p, hstride);
      } else if (edge) {
        filter6(p, hstride);
      } else {
        filter4(p, hstride);
      }
    }
    p += vstride;
  }
}

struct Vp8Decoder {
  int width = 0, height = 0, mb_w = 0, mb_h = 0;
  BoolReader br;
  std::vector<BoolReader> parts;
  int num_parts_minus_one = 0;
  // segment header
  int use_segment = 0, update_map = 0, absolute_delta = 1;
  int quantizer[4] = {0, 0, 0, 0}, filter_strength[4] = {0, 0, 0, 0};
  uint8_t seg_proba[3] = {255, 255, 255};
  // filter header
  int simple = 0, level = 0, sharpness = 0, use_lf_delta = 0;
  int ref_lf_delta[4] = {0, 0, 0, 0}, mode_lf_delta[4] = {0, 0, 0, 0};
  int filter_type = 0;
  Quant dqm[4];
  BandProbas bands[4][8];
  const BandProbas* bands_ptr[4][16 + 1];
  int use_skip_proba = 0, skip_p = 0;
  FInfo fstrengths[4][2];
  // per frame
  std::vector<uint8_t> intra_t;
  uint8_t intra_l[4];
  std::vector<MBContext> mb_info;  // [0] is the left neighbour
  std::vector<MBData> mb_data;
  std::vector<FInfo> f_info;
  std::vector<TopSamples> yuv_t;
  uint8_t yuv_b[YUV_SIZE];
  int y_stride = 0, uv_stride = 0;
  std::vector<uint8_t> Y, U, V;

  void parse_headers(const uint8_t* buf, size_t size) {
    if (size < 4) fail("VP8: truncated header");
    const uint32_t bits = buf[0] | (buf[1] << 8) | (buf[2] << 16);
    const int key_frame = !(bits & 1);
    const int profile = (bits >> 1) & 7;
    const int show = (bits >> 4) & 1;
    const uint32_t partition_length = bits >> 5;
    if (profile > 3) fail("VP8: incorrect keyframe parameters");
    if (!show) fail("VP8: frame not displayable");
    buf += 3;
    size -= 3;
    if (!key_frame) fail("VP8: not a key frame");
    if (size < 7) fail("VP8: cannot parse picture header");
    if (buf[0] != 0x9d || buf[1] != 0x01 || buf[2] != 0x2a) fail("VP8: bad code word");
    width = ((buf[4] << 8) | buf[3]) & 0x3fff;
    height = ((buf[6] << 8) | buf[5]) & 0x3fff;
    buf += 7;
    size -= 7;
    mb_w = (width + 15) >> 4;
    mb_h = (height + 15) >> 4;
    if (partition_length > size) fail("VP8: bad partition length");
    br.init(buf, partition_length);
    buf += partition_length;
    size -= partition_length;
    br.get(0x80);  // colour space
    br.get(0x80);  // clamping type
    // segment header
    use_segment = br.get(0x80);
    if (use_segment) {
      update_map = br.get(0x80);
      if (br.get(0x80)) {  // update data
        absolute_delta = br.get(0x80);
        for (int s = 0; s < 4; ++s) quantizer[s] = br.get(0x80) ? br.signed_literal(7) : 0;
        for (int s = 0; s < 4; ++s) filter_strength[s] = br.get(0x80) ? br.signed_literal(6) : 0;
      }
      if (update_map) {
        for (int s = 0; s < 3; ++s) seg_proba[s] = static_cast<uint8_t>(br.get(0x80) ? br.literal(8) : 255u);
      }
    } else {
      update_map = 0;
    }
    if (br.eof) fail("VP8: cannot parse segment header");
    // filter header
    simple = br.get(0x80);
    level = static_cast<int>(br.literal(6));
    sharpness = static_cast<int>(br.literal(3));
    use_lf_delta = br.get(0x80);
    if (use_lf_delta && br.get(0x80)) {
      for (int i = 0; i < 4; ++i) {
        if (br.get(0x80)) ref_lf_delta[i] = br.signed_literal(6);
      }
      for (int i = 0; i < 4; ++i) {
        if (br.get(0x80)) mode_lf_delta[i] = br.signed_literal(6);
      }
    }
    filter_type = (level == 0) ? 0 : simple ? 1 : 2;
    if (br.eof) fail("VP8: cannot parse filter header");
    // partitions
    const uint8_t* sz = buf;
    const uint8_t* buf_end = buf + size;
    num_parts_minus_one = (1 << br.literal(2)) - 1;
    const size_t last_part = static_cast<size_t>(num_parts_minus_one);
    if (size < 3 * last_part) fail("VP8: cannot parse partitions");
    const uint8_t* part_start = buf + last_part * 3;
    size_t size_left = size - last_part * 3;
    parts.assign(last_part + 1, BoolReader());
    for (size_t p = 0; p < last_part; ++p) {
      size_t psize = sz[0] | (sz[1] << 8) | (sz[2] << 16);
      if (psize > size_left) psize = size_left;
      parts[p].init(part_start, psize);
      part_start += psize;
      size_left -= psize;
      sz += 3;
    }
    parts[last_part].init(part_start, size_left);
    if (part_start >= buf_end) fail("VP8: cannot parse partitions (no data)");
    // quantisers
    const int base_q0 = static_cast<int>(br.literal(7));
    const int dqy1_dc = br.get(0x80) ? br.signed_literal(4) : 0;
    const int dqy2_dc = br.get(0x80) ? br.signed_literal(4) : 0;
    const int dqy2_ac = br.get(0x80) ? br.signed_literal(4) : 0;
    const int dquv_dc = br.get(0x80) ? br.signed_literal(4) : 0;
    const int dquv_ac = br.get(0x80) ? br.signed_literal(4) : 0;
    auto clip = [](int v, int m) { return v < 0 ? 0 : v > m ? m : v; };
    for (int i = 0; i < 4; ++i) {
      int q;
      if (use_segment) {
        q = quantizer[i];
        if (!absolute_delta) q += base_q0;
      } else {
        if (i > 0) {
          dqm[i] = dqm[0];
          continue;
        }
        q = base_q0;
      }
      Quant& m = dqm[i];
      m.y1[0] = kDcTable[clip(q + dqy1_dc, 127)];
      m.y1[1] = kAcTable[clip(q + 0, 127)];
      m.y2[0] = kDcTable[clip(q + dqy2_dc, 127)] * 2;
      m.y2[1] = (kAcTable[clip(q + dqy2_ac, 127)] * 101581) >> 16;
      if (m.y2[1] < 8) m.y2[1] = 8;
      m.uv[0] = kDcTable[clip(q + dquv_dc, 117)];
      m.uv[1] = kAcTable[clip(q + dquv_ac, 127)];
    }
    br.get(0x80);  // refresh entropy probabilities: ignored
    // coefficient probabilities
    for (int t = 0; t < 4; ++t) {
      for (int b = 0; b < 8; ++b) {
        for (int c = 0; c < 3; ++c) {
          for (int p = 0; p < 11; ++p) {
            const int i = ((t * 8 + b) * 3 + c) * 11 + p;
            bands[t][b].p[c][p] =
                static_cast<uint8_t>(br.get(kCoeffsUpdateProba[i]) ? br.literal(8) : kCoeffsProba0[i]);
          }
        }
      }
      for (int b = 0; b < 16 + 1; ++b) bands_ptr[t][b] = &bands[t][kBands[b]];
    }
    use_skip_proba = br.get(0x80);
    if (use_skip_proba) skip_p = static_cast<int>(br.literal(8));
  }

  void precompute_filter_strengths() {
    if (filter_type == 0) return;
    for (int s = 0; s < 4; ++s) {
      int base_level;
      if (use_segment) {
        base_level = filter_strength[s];
        if (!absolute_delta) base_level += level;
      } else {
        base_level = level;
      }
      for (int i4x4 = 0; i4x4 <= 1; ++i4x4) {
        FInfo& info = fstrengths[s][i4x4];
        int lv = base_level;
        if (use_lf_delta) {
          lv += ref_lf_delta[0];
          if (i4x4) lv += mode_lf_delta[0];
        }
        lv = (lv < 0) ? 0 : (lv > 63) ? 63 : lv;
        if (lv > 0) {
          int ilevel = lv;
          if (sharpness > 0) {
            if (sharpness > 4) {
              ilevel >>= 2;
            } else {
              ilevel >>= 1;
            }
            if (ilevel > 9 - sharpness) ilevel = 9 - sharpness;
          }
          if (ilevel < 1) ilevel = 1;
          info.ilevel = ilevel;
          info.limit = 2 * lv + ilevel;
          info.hev_thresh = (lv >= 40) ? 2 : (lv >= 15) ? 1 : 0;
        } else {
          info.limit = 0;
        }
        info.inner = i4x4;
      }
    }
  }

  void parse_intra_mode(int mb_x) {
    uint8_t* const top = &intra_t[4 * mb_x];
    uint8_t* const left = intra_l;
    MBData& block = mb_data[mb_x];
    if (update_map) {
      block.segment = static_cast<uint8_t>(!br.get(seg_proba[0]) ? br.get(seg_proba[1]) : br.get(seg_proba[2]) + 2);
    } else {
      block.segment = 0;
    }
    if (use_skip_proba) block.skip = static_cast<uint8_t>(br.get(skip_p));
    block.is_i4x4 = static_cast<uint8_t>(!br.get(145));
    if (!block.is_i4x4) {
      const int ymode = br.get(156) ? (br.get(128) ? TM_PRED : H_PRED) : (br.get(163) ? V_PRED : DC_PRED);
      block.imodes[0] = static_cast<uint8_t>(ymode);
      memset(top, ymode, 4);
      memset(left, ymode, 4);
    } else {
      uint8_t* modes = block.imodes;
      for (int y = 0; y < 4; ++y) {
        int ymode = left[y];
        for (int x = 0; x < 4; ++x) {
          const uint8_t* const prob = &kBModesProba[(top[x] * 10 + ymode) * 9];
          int i = kYModesIntra4[br.get(prob[0])];
          while (i > 0) i = kYModesIntra4[2 * i + br.get(prob[i])];
          ymode = -i;
          top[x] = static_cast<uint8_t>(ymode);
        }
        memcpy(modes, top, 4);
        modes += 4;
        left[y] = static_cast<uint8_t>(ymode);
      }
    }
    block.uvmode = static_cast<uint8_t>(!br.get(142) ? DC_PRED : !br.get(114) ? V_PRED : br.get(183) ? TM_PRED : H_PRED);
  }

  static int get_large_value(BoolReader& tbr, const uint8_t* p) {
    int v;
    if (!tbr.get(p[3])) {
      if (!tbr.get(p[4])) {
        v = 2;
      } else {
        v = 3 + tbr.get(p[5]);
      }
    } else {
      if (!tbr.get(p[6])) {
        if (!tbr.get(p[7])) {
          v = 5 + tbr.get(159);
        } else {
          v = 7 + 2 * tbr.get(165);
          v += tbr.get(145);
        }
      } else {
        const int bit1 = tbr.get(p[8]);
        const int bit0 = tbr.get(p[9 + bit1]);
        const int cat = 2 * bit1 + bit0;
        v = 0;
        for (const uint8_t* tab = kCat3456[cat]; *tab; ++tab) v += v + tbr.get(*tab);
        v += 3 + (8 << cat);
      }
    }
    return v;
  }

  static int get_coeffs(BoolReader& tbr, const BandProbas* const prob[], int ctx, const int dq[2], int n,
                        int16_t* out) {
    const uint8_t* p = prob[n]->p[ctx];
    for (; n < 16; ++n) {
      if (!tbr.get(p[0])) return n;
      while (!tbr.get(p[1])) {
        p = prob[++n]->p[0];
        if (n == 16) return 16;
      }
      const BandProbas* const p_ctx = prob[n + 1];
      int v;
      if (!tbr.get(p[2])) {
        v = 1;
        p = p_ctx->p[1];
      } else {
        v = get_large_value(tbr, p);
        p = p_ctx->p[2];
      }
      out[kZigzag[n]] = static_cast<int16_t>(tbr.get_signed(v) * dq[n > 0]);
    }
    return 16;
  }

  static uint32_t nz_code_bits(uint32_t nz_coeffs, int nz, int dc_nz) {
    nz_coeffs <<= 2;
    nz_coeffs |= (nz > 3) ? 3 : (nz > 1) ? 2 : dc_nz;
    return nz_coeffs;
  }

  int parse_residuals(int mb_x, BoolReader& tbr) {
    MBContext& left_mb = mb_info[0];
    MBContext& mb = mb_info[1 + mb_x];
    MBData& block = mb_data[mb_x];
    const Quant& q = dqm[block.segment];
    int16_t* dst = block.coeffs;
    uint32_t non_zero_y = 0, non_zero_uv = 0;
    const BandProbas* const* ac_proba;
    int first;
    memset(dst, 0, 384 * sizeof(*dst));
    if (!block.is_i4x4) {
      int16_t dc[16] = {0};
      const int ctx = mb.nz_dc + left_mb.nz_dc;
      const int nz = get_coeffs(tbr, bands_ptr[1], ctx, q.y2, 0, dc);
      mb.nz_dc = left_mb.nz_dc = static_cast<uint8_t>(nz > 0);
      if (nz > 1) {
        transform_wht(dc, dst);
      } else {
        const int dc0 = (dc[0] + 3) >> 3;
        for (int i = 0; i < 16 * 16; i += 16) dst[i] = static_cast<int16_t>(dc0);
      }
      first = 1;
      ac_proba = bands_ptr[0];
    } else {
      first = 0;
      ac_proba = bands_ptr[3];
    }
    uint8_t tnz = mb.nz & 0x0f;
    uint8_t lnz = left_mb.nz & 0x0f;
    for (int y = 0; y < 4; ++y) {
      int l = lnz & 1;
      uint32_t nz_coeffs = 0;
      for (int x = 0; x < 4; ++x) {
        const int ctx = l + (tnz & 1);
        const int nz = get_coeffs(tbr, ac_proba, ctx, q.y1, first, dst);
        l = (nz > first);
        tnz = static_cast<uint8_t>((tnz >> 1) | (l << 7));
        nz_coeffs = nz_code_bits(nz_coeffs, nz, dst[0] != 0);
        dst += 16;
      }
      tnz >>= 4;
      lnz = static_cast<uint8_t>((lnz >> 1) | (l << 7));
      non_zero_y = (non_zero_y << 8) | nz_coeffs;
    }
    uint32_t out_t_nz = tnz;
    uint32_t out_l_nz = lnz >> 4;
    for (int ch = 0; ch < 4; ch += 2) {
      uint32_t nz_coeffs = 0;
      tnz = static_cast<uint8_t>(mb.nz >> (4 + ch));
      lnz = static_cast<uint8_t>(left_mb.nz >> (4 + ch));
      for (int y = 0; y < 2; ++y) {
        int l = lnz & 1;
        for (int x = 0; x < 2; ++x) {
          const int ctx = l + (tnz & 1);
          const int nz = get_coeffs(tbr, bands_ptr[2], ctx, q.uv, 0, dst);
          l = (nz > 0);
          tnz = static_cast<uint8_t>((tnz >> 1) | (l << 3));
          nz_coeffs = nz_code_bits(nz_coeffs, nz, dst[0] != 0);
          dst += 16;
        }
        tnz >>= 2;
        lnz = static_cast<uint8_t>((lnz >> 1) | (l << 5));
      }
      non_zero_uv |= nz_coeffs << (4 * ch);
      out_t_nz |= static_cast<uint32_t>(tnz << 4) << ch;
      out_l_nz |= static_cast<uint32_t>(lnz & 0xf0) << ch;
    }
    mb.nz = static_cast<uint8_t>(out_t_nz);
    left_mb.nz = static_cast<uint8_t>(out_l_nz);
    block.non_zero_y = non_zero_y;
    block.non_zero_uv = non_zero_uv;
    return !(non_zero_y | non_zero_uv);
  }

  bool decode_mb(int mb_x, int mb_y, BoolReader& tbr) {
    MBContext& left = mb_info[0];
    MBContext& mb = mb_info[1 + mb_x];
    MBData& block = mb_data[mb_x];
    int skip = use_skip_proba ? block.skip : 0;
    if (!skip) {
      skip = parse_residuals(mb_x, tbr);
    } else {
      left.nz = mb.nz = 0;
      if (!block.is_i4x4) left.nz_dc = mb.nz_dc = 0;
      block.non_zero_y = 0;
      block.non_zero_uv = 0;
    }
    if (filter_type > 0) {
      FInfo f = fstrengths[block.segment][block.is_i4x4];
      f.inner |= !skip;
      f_info[static_cast<size_t>(mb_y) * mb_w + mb_x] = f;
    }
    return !tbr.eof;
  }

  static int check_mode(int mb_x, int mb_y, int mode) {
    if (mode == B_DC_PRED) {
      if (mb_x == 0) return (mb_y == 0) ? DC_NOTOPLEFT : DC_NOLEFT;
      return (mb_y == 0) ? DC_NOTOP : B_DC_PRED;
    }
    return mode;
  }

  // DoTransform and DoUVTransform: the block's code (3: coefficients past
  // the third, 2: up to the third, 1: DC only) picks libwebp's variant
  static void do_transform(uint32_t bits, const int16_t* src, uint8_t* dst) {
    if ((bits >> 30) == 3) {
      transform_sse2(src, dst);
    } else if (bits >> 30) {
      transform(src, dst);
    }
  }
  static void do_uv_transform(uint32_t bits, const int16_t* src, uint8_t* dst) {
    if (!(bits & 0xff)) return;
    for (int b = 0; b < 4; ++b) {
      uint8_t* const d = dst + (b & 1) * 4 + (b >> 1) * 4 * BPS;
      if (bits & 0xaa) {  // any AC coefficient: Transform_SSE2 on all four blocks
        transform_sse2(src + 16 * b, d);
      } else if (src[16 * b] != 0) {
        transform(src + 16 * b, d);
      }
    }
  }

  void reconstruct_row(int mb_y) {
    uint8_t* const y_dst = yuv_b + Y_OFF;
    uint8_t* const u_dst = yuv_b + U_OFF;
    uint8_t* const v_dst = yuv_b + V_OFF;
    for (int j = 0; j < 16; ++j) y_dst[j * BPS - 1] = 129;
    for (int j = 0; j < 8; ++j) {
      u_dst[j * BPS - 1] = 129;
      v_dst[j * BPS - 1] = 129;
    }
    if (mb_y > 0) {
      y_dst[-1 - BPS] = u_dst[-1 - BPS] = v_dst[-1 - BPS] = 129;
    } else {
      memset(y_dst - BPS - 1, 127, 16 + 4 + 1);
      memset(u_dst - BPS - 1, 127, 8 + 1);
      memset(v_dst - BPS - 1, 127, 8 + 1);
    }
    for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
      const MBData& block = mb_data[mb_x];
      if (mb_x > 0) {
        for (int j = -1; j < 16; ++j) memcpy(&y_dst[j * BPS - 4], &y_dst[j * BPS + 12], 4);
        for (int j = -1; j < 8; ++j) {
          memcpy(&u_dst[j * BPS - 4], &u_dst[j * BPS + 4], 4);
          memcpy(&v_dst[j * BPS - 4], &v_dst[j * BPS + 4], 4);
        }
      }
      TopSamples* const top_yuv = &yuv_t[mb_x];
      const int16_t* const coeffs = block.coeffs;
      uint32_t bits = block.non_zero_y;
      if (mb_y > 0) {
        memcpy(y_dst - BPS, top_yuv[0].y, 16);
        memcpy(u_dst - BPS, top_yuv[0].u, 8);
        memcpy(v_dst - BPS, top_yuv[0].v, 8);
      }
      if (block.is_i4x4) {
        uint8_t* const top_right = y_dst - BPS + 16;
        if (mb_y > 0) {
          if (mb_x >= mb_w - 1) {
            memset(top_right, top_yuv[0].y[15], 4);
          } else {
            memcpy(top_right, top_yuv[1].y, 4);
          }
        }
        // replicate the top-right samples below
        memcpy(top_right + 4 * BPS, top_right, 4);
        memcpy(top_right + 8 * BPS, top_right, 4);
        memcpy(top_right + 12 * BPS, top_right, 4);
        for (int n = 0; n < 16; ++n, bits <<= 2) {
          uint8_t* const dst = y_dst + kScan[n];
          predict4(block.imodes[n], dst);
          do_transform(bits, coeffs + n * 16, dst);
        }
      } else {
        predict16(check_mode(mb_x, mb_y, block.imodes[0]), y_dst);
        if (bits != 0) {
          for (int n = 0; n < 16; ++n, bits <<= 2) do_transform(bits, coeffs + n * 16, y_dst + kScan[n]);
        }
      }
      const uint32_t bits_uv = block.non_zero_uv;
      const int pred_func = check_mode(mb_x, mb_y, block.uvmode);
      predict8(pred_func, u_dst);
      predict8(pred_func, v_dst);
      do_uv_transform(bits_uv >> 0, coeffs + 16 * 16, u_dst);
      do_uv_transform(bits_uv >> 8, coeffs + 20 * 16, v_dst);
      if (mb_y < mb_h - 1) {
        memcpy(top_yuv[0].y, y_dst + 15 * BPS, 16);
        memcpy(top_yuv[0].u, u_dst + 7 * BPS, 8);
        memcpy(top_yuv[0].v, v_dst + 7 * BPS, 8);
      }
      uint8_t* const y_out = &Y[static_cast<size_t>(mb_y) * 16 * y_stride + mb_x * 16];
      uint8_t* const u_out = &U[static_cast<size_t>(mb_y) * 8 * uv_stride + mb_x * 8];
      uint8_t* const v_out = &V[static_cast<size_t>(mb_y) * 8 * uv_stride + mb_x * 8];
      for (int j = 0; j < 16; ++j) memcpy(y_out + static_cast<size_t>(j) * y_stride, y_dst + j * BPS, 16);
      for (int j = 0; j < 8; ++j) {
        memcpy(u_out + static_cast<size_t>(j) * uv_stride, u_dst + j * BPS, 8);
        memcpy(v_out + static_cast<size_t>(j) * uv_stride, v_dst + j * BPS, 8);
      }
    }
  }

  void filter_mb(int mb_x, int mb_y) {
    const FInfo& f = f_info[static_cast<size_t>(mb_y) * mb_w + mb_x];
    const int limit = f.limit;
    if (limit == 0) return;
    const int ys = y_stride, uvs = uv_stride;
    uint8_t* const y_dst = &Y[static_cast<size_t>(mb_y) * 16 * ys + mb_x * 16];
    if (filter_type == 1) {  // simple: luma only
      if (mb_x > 0) simple_filter(y_dst, 1, ys, limit + 4);
      if (f.inner) {
        for (int k = 1; k <= 3; ++k) simple_filter(y_dst + 4 * k, 1, ys, limit);
      }
      if (mb_y > 0) simple_filter(y_dst, ys, 1, limit + 4);
      if (f.inner) {
        for (int k = 1; k <= 3; ++k) simple_filter(y_dst + 4 * k * ys, ys, 1, limit);
      }
      return;
    }
    uint8_t* const u_dst = &U[static_cast<size_t>(mb_y) * 8 * uvs + mb_x * 8];
    uint8_t* const v_dst = &V[static_cast<size_t>(mb_y) * 8 * uvs + mb_x * 8];
    const int il = f.ilevel, hev_t = f.hev_thresh;
    if (mb_x > 0) {
      filter_loop(y_dst, 1, ys, 16, limit + 4, il, hev_t, true);
      filter_loop(u_dst, 1, uvs, 8, limit + 4, il, hev_t, true);
      filter_loop(v_dst, 1, uvs, 8, limit + 4, il, hev_t, true);
    }
    if (f.inner) {
      for (int k = 1; k <= 3; ++k) filter_loop(y_dst + 4 * k, 1, ys, 16, limit, il, hev_t, false);
      filter_loop(u_dst + 4, 1, uvs, 8, limit, il, hev_t, false);
      filter_loop(v_dst + 4, 1, uvs, 8, limit, il, hev_t, false);
    }
    if (mb_y > 0) {
      filter_loop(y_dst, ys, 1, 16, limit + 4, il, hev_t, true);
      filter_loop(u_dst, uvs, 1, 8, limit + 4, il, hev_t, true);
      filter_loop(v_dst, uvs, 1, 8, limit + 4, il, hev_t, true);
    }
    if (f.inner) {
      for (int k = 1; k <= 3; ++k) filter_loop(y_dst + 4 * k * ys, ys, 1, 16, limit, il, hev_t, false);
      filter_loop(u_dst + 4 * uvs, uvs, 1, 8, limit, il, hev_t, false);
      filter_loop(v_dst + 4 * uvs, uvs, 1, 8, limit, il, hev_t, false);
    }
  }

  void decode(const uint8_t* data, size_t size) {
    parse_headers(data, size);
    precompute_filter_strengths();
    intra_t.assign(4 * static_cast<size_t>(mb_w), B_DC_PRED);
    memset(intra_l, B_DC_PRED, sizeof intra_l);
    mb_info.assign(static_cast<size_t>(mb_w) + 1, MBContext());
    mb_data.assign(static_cast<size_t>(mb_w), MBData());
    if (filter_type > 0) f_info.assign(static_cast<size_t>(mb_w) * mb_h, FInfo());
    yuv_t.assign(static_cast<size_t>(mb_w), TopSamples());
    memset(yuv_b, 0, sizeof yuv_b);
    y_stride = mb_w * 16;
    uv_stride = mb_w * 8;
    Y.assign(static_cast<size_t>(y_stride) * mb_h * 16, 0);
    U.assign(static_cast<size_t>(uv_stride) * mb_h * 8, 0);
    V.assign(static_cast<size_t>(uv_stride) * mb_h * 8, 0);
    for (int mb_y = 0; mb_y < mb_h; ++mb_y) {
      BoolReader& tbr = parts[static_cast<size_t>(mb_y & num_parts_minus_one)];
      for (int mb_x = 0; mb_x < mb_w; ++mb_x) parse_intra_mode(mb_x);
      if (br.eof) fail("VP8: premature end of partition 0");
      for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
        if (!decode_mb(mb_x, mb_y, tbr)) fail("VP8: premature end of the token partition");
      }
      mb_info[0] = MBContext();
      memset(intra_l, B_DC_PRED, sizeof intra_l);
      reconstruct_row(mb_y);
    }
    if (filter_type > 0) {
      for (int mb_y = 0; mb_y < mb_h; ++mb_y) {
        for (int mb_x = 0; mb_x < mb_w; ++mb_x) filter_mb(mb_x, mb_y);
      }
    }
  }
};

// VP8YUVToR/G/B (src/dsp/yuv.h)
inline int mult_hi(int v, int coeff) { return (v * coeff) >> 8; }
inline uint8_t yuv_clip8(int v) { return static_cast<uint8_t>(((v & ~16383) == 0) ? (v >> 6) : (v < 0) ? 0 : 255); }
inline void yuv_to_rgb(int y, int u, int v, uint8_t* rgb) {
  rgb[0] = yuv_clip8(mult_hi(y, 19077) + mult_hi(v, 26149) - 14234);
  rgb[1] = yuv_clip8(mult_hi(y, 19077) - mult_hi(u, 6419) - mult_hi(v, 13320) + 8708);
  rgb[2] = yuv_clip8(mult_hi(y, 19077) + mult_hi(u, 33050) - 17685);
}

// UPSAMPLE_FUNC of src/dsp/upsampling.c: one or two output rows of RGB
// samples `cn` bytes apart from a pair of chroma rows, U and V packed in
// one word.
void upsample_pair(const uint8_t* top_y, const uint8_t* bottom_y, const uint8_t* top_u, const uint8_t* top_v,
                   const uint8_t* cur_u, const uint8_t* cur_v, uint8_t* top_dst, uint8_t* bottom_dst, int len, int cn) {
  auto load_uv = [](int u, int v) { return static_cast<uint32_t>(u) | (static_cast<uint32_t>(v) << 16); };
  const int last_pixel_pair = (len - 1) >> 1;
  uint32_t tl_uv = load_uv(top_u[0], top_v[0]);
  uint32_t l_uv = load_uv(cur_u[0], cur_v[0]);
  {
    const uint32_t uv0 = (3 * tl_uv + l_uv + 0x00020002u) >> 2;
    yuv_to_rgb(top_y[0], uv0 & 0xff, (uv0 >> 16), top_dst);
  }
  if (bottom_y != nullptr) {
    const uint32_t uv0 = (3 * l_uv + tl_uv + 0x00020002u) >> 2;
    yuv_to_rgb(bottom_y[0], uv0 & 0xff, (uv0 >> 16), bottom_dst);
  }
  for (int x = 1; x <= last_pixel_pair; ++x) {
    const uint32_t t_uv = load_uv(top_u[x], top_v[x]);
    const uint32_t uv = load_uv(cur_u[x], cur_v[x]);
    const uint32_t avg = tl_uv + t_uv + l_uv + uv + 0x00080008u;
    const uint32_t diag_12 = (avg + 2 * (t_uv + l_uv)) >> 3;
    const uint32_t diag_03 = (avg + 2 * (tl_uv + uv)) >> 3;
    {
      const uint32_t uv0 = (diag_12 + tl_uv) >> 1;
      const uint32_t uv1 = (diag_03 + t_uv) >> 1;
      yuv_to_rgb(top_y[2 * x - 1], uv0 & 0xff, (uv0 >> 16), top_dst + (2 * x - 1) * cn);
      yuv_to_rgb(top_y[2 * x - 0], uv1 & 0xff, (uv1 >> 16), top_dst + (2 * x - 0) * cn);
    }
    if (bottom_y != nullptr) {
      const uint32_t uv0 = (diag_03 + l_uv) >> 1;
      const uint32_t uv1 = (diag_12 + uv) >> 1;
      yuv_to_rgb(bottom_y[2 * x - 1], uv0 & 0xff, (uv0 >> 16), bottom_dst + (2 * x - 1) * cn);
      yuv_to_rgb(bottom_y[2 * x + 0], uv1 & 0xff, (uv1 >> 16), bottom_dst + (2 * x + 0) * cn);
    }
    tl_uv = t_uv;
    l_uv = uv;
  }
  if (!(len & 1)) {
    {
      const uint32_t uv0 = (3 * tl_uv + l_uv + 0x00020002u) >> 2;
      yuv_to_rgb(top_y[len - 1], uv0 & 0xff, (uv0 >> 16), top_dst + (len - 1) * cn);
    }
    if (bottom_y != nullptr) {
      const uint32_t uv0 = (3 * l_uv + tl_uv + 0x00020002u) >> 2;
      yuv_to_rgb(bottom_y[len - 1], uv0 & 0xff, (uv0 >> 16), bottom_dst + (len - 1) * cn);
    }
  }
}

// EmitFancyRGB over the whole frame: row 0 from chroma row 0 alone, rows
// 2k+1 and 2k+2 from chroma rows k and k+1, an even height's last row from
// the last chroma row alone.
void emit_rgb(const Vp8Decoder& d, uint8_t* out, ptrdiff_t stride, int cn) {
  const int w = d.width, h = d.height;
  const uint8_t* Y = d.Y.data();
  const uint8_t* U = d.U.data();
  const uint8_t* V = d.V.data();
  const size_t ys = static_cast<size_t>(d.y_stride), uvs = static_cast<size_t>(d.uv_stride);
  upsample_pair(Y, nullptr, U, V, U, V, out, nullptr, w, cn);
  int y = 0;
  for (; y + 2 < h; y += 2) {
    const size_t k = static_cast<size_t>(y / 2);
    upsample_pair(Y + (y + 1) * ys, Y + (y + 2) * ys, U + k * uvs, V + k * uvs, U + (k + 1) * uvs,
                  V + (k + 1) * uvs, out + (y + 1) * stride, out + (y + 2) * stride, w, cn);
  }
  if (!(h & 1)) {
    const size_t k = static_cast<size_t>(y / 2);
    upsample_pair(Y + (y + 1) * ys, nullptr, U + k * uvs, V + k * uvs, U + k * uvs, V + k * uvs,
                  out + (y + 1) * stride, nullptr, w, cn);
  }
}

// ---------------------------------------------------------------- VP8L

const int kCodeLengthCodeOrder[19] = {17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15};
const int kAlphabetSize[5] = {256 + 24, 256, 256, 256, 40};  // green + lengths, red, blue, alpha, distance
enum { GREEN = 0, RED = 1, BLUE = 2, ALPHA = 3, DIST = 4 };
enum { PREDICTOR_TRANSFORM = 0, CROSS_COLOR_TRANSFORM = 1, SUBTRACT_GREEN_TRANSFORM = 2, COLOR_INDEXING_TRANSFORM = 3 };
const int MAX_CACHE_BITS = 11;
const uint32_t ARGB_BLACK = 0xff000000u;

inline int subsample_size(int size, int bits) { return (size + (1 << bits) - 1) >> bits; }

// libwebp's VP8LBitReader: a 64-bit window, `bit_pos` bits of it consumed.
// The stream ends (eos) once every byte is in the window and more than 64
// of its bits are consumed, that is when more bits are read than the
// stream holds (or, under 8 bytes, more than 64).
struct LBitReader {
  uint64_t val = 0;
  const uint8_t* buf = nullptr;
  size_t len = 0, pos = 0;
  int bit_pos = 0;
  bool eos = false;

  void init(const uint8_t* start, size_t length) {
    len = length;
    val = 0;
    bit_pos = 0;
    eos = false;
    const size_t n = length > 8 ? 8 : length;
    for (size_t i = 0; i < n; ++i) val |= static_cast<uint64_t>(start[i]) << (8 * i);
    pos = n;
    buf = start;
  }
  bool end_of_stream() const { return eos || (pos == len && bit_pos > 64); }
  void set_end_of_stream() {
    eos = true;
    bit_pos = 0;
  }
  void shift_bytes() {
    while (bit_pos >= 8 && pos < len) {
      val >>= 8;
      val |= static_cast<uint64_t>(buf[pos]) << 56;
      ++pos;
      bit_pos -= 8;
    }
    if (end_of_stream()) set_end_of_stream();
  }
  uint32_t prefetch() const { return static_cast<uint32_t>(val >> (bit_pos & 63)); }
  uint32_t read(int n) {
    if (!eos && n <= 24) {
      const uint32_t v = prefetch() & ((1u << n) - 1);
      bit_pos += n;
      shift_bytes();
      return v;
    }
    set_end_of_stream();
    return 0;
  }
  void fill() {
    if (bit_pos >= 32) shift_bytes();
  }
};

// A canonical prefix code: codes of up to 8 bits from a 256-entry table
// of (bits << 12 | symbol), longer ones walked bit by bit. A code of one
// symbol takes no bits.
struct HuffTree {
  uint16_t root[256];
  uint16_t count[16];
  std::vector<uint16_t> sorted;
  bool single = true;  // one symbol, no bits

  // The code of `lengths` (0 = unused), or false where libwebp's
  // BuildHuffmanTable refuses it: no symbol, or two or more whose lengths
  // do not make a complete code.
  bool build(const int* lengths, int n) {
    memset(count, 0, sizeof count);
    for (int s = 0; s < n; ++s) ++count[lengths[s]];
    const int used = n - count[0];
    if (used == 0) return false;
    sorted.clear();
    for (int len = 1; len <= 15; ++len) {
      for (int s = 0; s < n; ++s) {
        if (lengths[s] == len) sorted.push_back(static_cast<uint16_t>(s));
      }
    }
    single = used == 1;
    if (single) {
      for (int i = 0; i < 256; ++i) root[i] = sorted[0];
      return true;
    }
    uint32_t kraft = 0;
    for (int len = 1; len <= 15; ++len) kraft += static_cast<uint32_t>(count[len]) << (15 - len);
    if (kraft != (1u << 15)) return false;
    for (int i = 0; i < 256; ++i) root[i] = 15u << 12;
    uint32_t code = 0;
    size_t k = 0;
    for (int len = 1; len <= 15; ++len) {
      for (int c = 0; c < count[len]; ++c, ++k, ++code) {
        if (len > 8) continue;
        uint32_t rev = 0;
        for (int b = 0; b < len; ++b) rev |= ((code >> b) & 1u) << (len - 1 - b);
        for (uint32_t i = rev; i < 256; i += 1u << len) root[i] = static_cast<uint16_t>((len << 12) | sorted[k]);
      }
      code <<= 1;
    }
    return true;
  }
  int read(LBitReader& br) const {
    const uint32_t val = br.prefetch();
    const uint16_t e = root[val & 255];
    if ((e >> 12) != 15) {
      br.bit_pos += e >> 12;
      return e & 0xfff;
    }
    int code = 0, first = 0, index = 0;
    for (int len = 1; len <= 15; ++len) {
      code |= (val >> (len - 1)) & 1;
      const int c = count[len];
      if (code - first < c) {
        br.bit_pos += len;
        return sorted[static_cast<size_t>(index + code - first)];
      }
      index += c;
      first += c;
      first <<= 1;
      code <<= 1;
    }
    return 0;  // not reached: the code is complete
  }
};

struct HTreeGroup {
  HuffTree t[5];
};

struct LTransform {
  int type = 0, bits = 0, xsize = 0, ysize = 0;
  std::vector<uint32_t> data;
};

struct LMeta {  // the prefix codes and colour cache of one image stream
  int cache_bits = 0;
  int huff_bits = 0, huff_xsize = 0;
  std::vector<uint32_t> huff_image;  // group index per tile
  std::vector<HTreeGroup> groups;
};

inline uint32_t add_pixels(uint32_t a, uint32_t b) {
  const uint32_t ag = (a & 0xff00ff00u) + (b & 0xff00ff00u);
  const uint32_t rb = (a & 0x00ff00ffu) + (b & 0x00ff00ffu);
  return (ag & 0xff00ff00u) | (rb & 0x00ff00ffu);
}
inline uint32_t average2(uint32_t a0, uint32_t a1) { return (((a0 ^ a1) & 0xfefefefeu) >> 1) + (a0 & a1); }
inline uint32_t clip255(uint32_t a) { return a < 256 ? a : ~a >> 24; }
inline int sub3(int a, int b, int c) { return std::abs(b - c) - std::abs(a - c); }
inline uint32_t select_pred(uint32_t a, uint32_t b, uint32_t c) {  // a = top, b = left, c = top-left
  const int pa_minus_pb = sub3(a >> 24, b >> 24, c >> 24) + sub3((a >> 16) & 0xff, (b >> 16) & 0xff, (c >> 16) & 0xff) +
                          sub3((a >> 8) & 0xff, (b >> 8) & 0xff, (c >> 8) & 0xff) + sub3(a & 0xff, b & 0xff, c & 0xff);
  return (pa_minus_pb <= 0) ? a : b;
}
inline uint32_t clamped_add_subtract_full(uint32_t c0, uint32_t c1, uint32_t c2) {
  uint32_t out = 0;
  for (int s = 0; s < 32; s += 8) {
    const int v = static_cast<int>((c0 >> s) & 0xff) + static_cast<int>((c1 >> s) & 0xff) - static_cast<int>((c2 >> s) & 0xff);
    out |= clip255(static_cast<uint32_t>(v)) << s;
  }
  return out;
}
inline uint32_t clamped_add_subtract_half(uint32_t c0, uint32_t c1, uint32_t c2) {
  const uint32_t ave = average2(c0, c1);
  uint32_t out = 0;
  for (int s = 0; s < 32; s += 8) {
    const int a = static_cast<int>((ave >> s) & 0xff), b = static_cast<int>((c2 >> s) & 0xff);
    out |= clip255(static_cast<uint32_t>(a + (a - b) / 2)) << s;
  }
  return out;
}
// predictor `mode` (0-13; 14 and 15 give black, as libwebp's table pads)
inline uint32_t predict(int mode, uint32_t left, const uint32_t* top) {
  switch (mode) {
    case 1: return left;
    case 2: return top[0];
    case 3: return top[1];
    case 4: return top[-1];
    case 5: return average2(average2(left, top[1]), top[0]);
    case 6: return average2(left, top[-1]);
    case 7: return average2(left, top[0]);
    case 8: return average2(top[-1], top[0]);
    case 9: return average2(top[0], top[1]);
    case 10: return average2(average2(left, top[-1]), average2(top[0], top[1]));
    case 11: return select_pred(top[0], left, top[-1]);
    case 12: return clamped_add_subtract_full(left, top[0], top[-1]);
    case 13: return clamped_add_subtract_half(left, top[0], top[-1]);
    default: return ARGB_BLACK;
  }
}

struct Vp8lDecoder {
  LBitReader br;
  unsigned transforms_seen = 0;
  std::vector<LTransform> transforms;
  LMeta hdr;  // level 0's codes, after decode_image_stream(level0)
  int width = 0, height = 0;  // of the coded (level-0) image, after colour indexing's bundling

  static int copy_distance(int sym, LBitReader& br) {
    if (sym < 4) return sym + 1;
    const int extra_bits = (sym - 2) >> 1;
    const int offset = (2 + (sym & 1)) << extra_bits;
    return offset + static_cast<int>(br.read(extra_bits)) + 1;
  }
  static int plane_code_to_distance(int xsize, int plane_code) {
    if (plane_code > 120) return plane_code - 120;
    const int dist_code = kCodeToPlane[plane_code - 1];
    const int yoffset = dist_code >> 4;
    const int xoffset = 8 - (dist_code & 0xf);
    const int dist = yoffset * xsize + xoffset;
    return (dist >= 1) ? dist : 1;
  }

  bool read_code_lengths(const int* cl_lengths, int num_symbols, int* lengths) {
    HuffTree t;
    if (!t.build(cl_lengths, 19)) return false;
    int max_symbol;
    if (br.read(1)) {
      const int length_nbits = 2 + 2 * static_cast<int>(br.read(3));
      max_symbol = 2 + static_cast<int>(br.read(length_nbits));
      if (max_symbol > num_symbols) return false;
    } else {
      max_symbol = num_symbols;
    }
    int prev_code_len = 8;
    int symbol = 0;
    while (symbol < num_symbols) {
      if (max_symbol-- == 0) break;
      br.fill();
      const int code_len = t.read(br);
      if (code_len < 16) {
        lengths[symbol++] = code_len;
        if (code_len != 0) prev_code_len = code_len;
      } else {
        static const int kExtraBits[3] = {2, 3, 7};
        static const int kRepeatOffsets[3] = {3, 3, 11};
        const int slot = code_len - 16;
        int repeat = static_cast<int>(br.read(kExtraBits[slot])) + kRepeatOffsets[slot];
        if (symbol + repeat > num_symbols) return false;
        const int length = (code_len == 16) ? prev_code_len : 0;
        while (repeat-- > 0) lengths[symbol++] = length;
      }
    }
    return true;
  }

  // ReadHuffmanCode: one prefix code of `alphabet` symbols into `tree`.
  bool read_code(int alphabet, HuffTree& tree) {
    std::vector<int> lengths(std::max(alphabet, 256), 0);
    bool ok;
    if (br.read(1)) {  // simple code: one or two symbols
      const int num_symbols = static_cast<int>(br.read(1)) + 1;
      const int first_symbol_len_code = static_cast<int>(br.read(1));
      int symbol = static_cast<int>(br.read(first_symbol_len_code == 0 ? 1 : 8));
      lengths[symbol] = 1;
      if (num_symbols == 2) {
        symbol = static_cast<int>(br.read(8));
        lengths[symbol] = 1;
      }
      ok = true;
    } else {
      int cl_lengths[19] = {0};
      const int num_codes = static_cast<int>(br.read(4)) + 4;
      for (int i = 0; i < num_codes; ++i) cl_lengths[kCodeLengthCodeOrder[i]] = static_cast<int>(br.read(3));
      ok = read_code_lengths(cl_lengths, alphabet, lengths.data());
    }
    ok = ok && !br.eos;
    return ok && tree.build(lengths.data(), alphabet);  // symbols past the alphabet are dropped
  }

  bool read_huffman_codes(int xsize, int ysize, int cache_bits, bool allow_recursion, LMeta& meta) {
    int num_groups_max = 1;
    meta.huff_bits = 0;
    meta.huff_image.clear();
    if (allow_recursion && br.read(1)) {
      const int precision = 2 + static_cast<int>(br.read(3));
      const int hx = subsample_size(xsize, precision), hy = subsample_size(ysize, precision);
      std::vector<uint32_t> img;
      if (!decode_image_stream(hx, hy, false, &img)) return false;
      meta.huff_bits = precision;
      meta.huff_xsize = hx;
      for (auto& v : img) {
        v = (v >> 8) & 0xffff;
        if (static_cast<int>(v) >= num_groups_max) num_groups_max = static_cast<int>(v) + 1;
      }
      meta.huff_image = std::move(img);
    }
    if (br.eos) return false;
    // as libwebp: when the largest index is over 1,000 or over the pixel
    // count, groups that no tile uses are read and checked but not kept
    std::vector<int> mapping(static_cast<size_t>(num_groups_max), -1);
    int num_groups = 0;
    if (num_groups_max > 1000 || num_groups_max > xsize * ysize) {
      for (auto& v : meta.huff_image) {
        int& m = mapping[v];
        if (m == -1) m = num_groups++;
        v = static_cast<uint32_t>(m);
      }
    } else {
      for (int i = 0; i < num_groups_max; ++i) mapping[static_cast<size_t>(i)] = num_groups++;
    }
    meta.groups.assign(static_cast<size_t>(num_groups), HTreeGroup());
    HuffTree scratch;
    for (int i = 0; i < num_groups_max; ++i) {
      for (int j = 0; j < 5; ++j) {
        int alphabet = kAlphabetSize[j];
        if (j == 0 && cache_bits > 0) alphabet += 1 << cache_bits;
        HuffTree& tree = mapping[i] == -1 ? scratch : meta.groups[mapping[i]].t[j];
        if (!read_code(alphabet, tree)) return false;
      }
    }
    return true;
  }

  bool read_transform(int* xsize, int ysize) {
    const int type = static_cast<int>(br.read(2));
    if (transforms_seen & (1u << type)) return false;
    transforms_seen |= 1u << type;
    LTransform t;
    t.type = type;
    t.xsize = *xsize;
    t.ysize = ysize;
    bool ok = true;
    switch (type) {
      case PREDICTOR_TRANSFORM:
      case CROSS_COLOR_TRANSFORM:
        t.bits = static_cast<int>(br.read(3)) + 2;
        ok = decode_image_stream(subsample_size(t.xsize, t.bits), subsample_size(t.ysize, t.bits), false, &t.data);
        break;
      case COLOR_INDEXING_TRANSFORM: {
        const int num_colors = static_cast<int>(br.read(8)) + 1;
        const int bits = (num_colors > 16) ? 0 : (num_colors > 4) ? 1 : (num_colors > 2) ? 2 : 3;
        *xsize = subsample_size(t.xsize, bits);
        t.bits = bits;
        std::vector<uint32_t> colors;
        ok = decode_image_stream(num_colors, 1, false, &colors);
        if (ok) {  // ExpandColorMap: deltas summed byte-wise, the rest transparent black
          const int final_num_colors = 1 << (8 >> bits);
          t.data.assign(static_cast<size_t>(final_num_colors), 0);
          t.data[0] = colors[0];
          for (int i = 1; i < num_colors; ++i) t.data[i] = add_pixels(colors[i], t.data[i - 1]);
        }
        break;
      }
      default:
        break;
    }
    transforms.push_back(std::move(t));
    return ok;
  }

  // DecodeImageStream: the transforms (level 0 only), the colour cache and
  // the prefix codes; then the pixels of a sub-image into *out, or, at
  // level 0, nothing yet (hdr keeps the codes).
  bool decode_image_stream(int xsize, int ysize, bool is_level0, std::vector<uint32_t>* out) {
    int tx = xsize;
    const int ty = ysize;
    bool ok = true;
    if (is_level0) {
      while (ok && br.read(1)) ok = read_transform(&tx, ty);
    }
    int cache_bits = 0;
    if (ok && br.read(1)) {
      cache_bits = static_cast<int>(br.read(4));
      ok = cache_bits >= 1 && cache_bits <= MAX_CACHE_BITS;
      if (!ok) return false;
    }
    LMeta meta;
    meta.cache_bits = cache_bits;
    ok = ok && read_huffman_codes(tx, ty, cache_bits, is_level0, meta);
    if (!ok) return false;
    if (is_level0) {
      hdr = std::move(meta);
      width = tx;
      height = ty;
      return true;
    }
    out->assign(static_cast<size_t>(tx) * ty, 0);
    return decode_pixels(meta, out->data(), tx, ty, false) && !br.eos;
  }

  // DecodeImageData (and, with `alpha8`, DecodeAlphaData's end rule).
  bool decode_pixels(const LMeta& meta, uint32_t* data, int w, int h, bool alpha8) {
    const size_t end = static_cast<size_t>(w) * h;
    const int cache_size = meta.cache_bits > 0 ? 1 << meta.cache_bits : 0;
    std::vector<uint32_t> cache(static_cast<size_t>(cache_size), 0);
    const int cache_shift = 32 - meta.cache_bits;
    const int len_code_limit = 256 + 24;
    const int color_cache_limit = len_code_limit + cache_size;
    size_t src = 0, last_cached = 0;
    int col = 0, row = 0;
    auto group_at = [&](int x, int y) -> const HTreeGroup& {
      if (meta.huff_bits == 0) return meta.groups[0];
      return meta.groups[meta.huff_image[static_cast<size_t>(y >> meta.huff_bits) * meta.huff_xsize +
                                         (x >> meta.huff_bits)]];
    };
    auto insert_cached = [&]() {
      if (cache_size == 0) return;
      while (last_cached < src) {
        const uint32_t argb = data[last_cached++];
        cache[(argb * 0x1e35a7bdu) >> cache_shift] = argb;
      }
    };
    bool stopped_at_eos = false;
    while (src < end) {
      const HTreeGroup& g = group_at(col, row);
      br.fill();
      const int code = g.t[GREEN].read(br);
      if (!alpha8 && br.end_of_stream()) {
        stopped_at_eos = true;
        break;
      }
      if (code < 256) {
        const int red = g.t[RED].read(br);
        br.fill();
        const int blue = g.t[BLUE].read(br);
        const int alpha = g.t[ALPHA].read(br);
        if (!alpha8 && br.end_of_stream()) {
          stopped_at_eos = true;
          break;
        }
        data[src] = (static_cast<uint32_t>(alpha) << 24) | (red << 16) | (code << 8) | blue;
        ++src;
        if (++col >= w) {
          col = 0;
          ++row;
        }
      } else if (code < len_code_limit) {
        const int length = copy_distance(code - 256, br);
        const int dist_symbol = g.t[DIST].read(br);
        br.fill();
        const int dist_code = copy_distance(dist_symbol, br);
        const size_t dist = static_cast<size_t>(plane_code_to_distance(w, dist_code));
        if (!alpha8 && br.end_of_stream()) {
          stopped_at_eos = true;
          break;
        }
        if (src < dist || end - src < static_cast<size_t>(length)) return false;
        for (int i = 0; i < length; ++i) data[src + i] = data[src + i - dist];
        src += static_cast<size_t>(length);
        col += length;
        while (col >= w) {
          col -= w;
          ++row;
        }
      } else if (code < color_cache_limit) {
        insert_cached();
        data[src] = cache[static_cast<size_t>(code - len_code_limit)];
        ++src;
        if (++col >= w) {
          col = 0;
          ++row;
        }
      } else {
        return false;
      }
      insert_cached();
      if (alpha8) {
        br.eos = br.end_of_stream();
        if (br.eos) break;
      }
    }
    br.eos = br.end_of_stream();
    if (alpha8) return !(br.eos && src < end);
    return !stopped_at_eos && !br.eos;
  }

  // The inverse transforms, last read first, over the decoded image: in
  // place but for colour indexing, whose output is wider.
  std::vector<uint32_t> inverse_transforms(std::vector<uint32_t> cur) {
    for (size_t k = transforms.size(); k-- > 0;) {
      const LTransform& t = transforms[k];
      const int w = t.xsize, h = t.ysize;
      std::vector<uint32_t>& out = cur;
      switch (t.type) {
        case SUBTRACT_GREEN_TRANSFORM:
          for (size_t i = 0; i < out.size(); ++i) {
            const uint32_t argb = cur[i];
            const uint32_t green = (argb >> 8) & 0xff;
            uint32_t red_blue = argb & 0x00ff00ffu;
            red_blue += (green << 16) | green;
            out[i] = (argb & 0xff00ff00u) | (red_blue & 0x00ff00ffu);
          }
          break;
        case PREDICTOR_TRANSFORM: {
          const int tiles_per_row = subsample_size(w, t.bits);
          for (int y = 0; y < h; ++y) {  // each prediction reads samples already added to
            uint32_t* o = &out[static_cast<size_t>(y) * w];
            const uint32_t* in = o;
            for (int x = 0; x < w; ++x) {
              uint32_t pred;
              if (y == 0) {
                pred = x == 0 ? ARGB_BLACK : o[x - 1];
              } else if (x == 0) {
                pred = o[-w];
              } else {
                const int mode = (t.data[static_cast<size_t>(y >> t.bits) * tiles_per_row + (x >> t.bits)] >> 8) & 0xf;
                pred = predict(mode, o[x - 1], o + x - w);
              }
              o[x] = add_pixels(in[x], pred);
            }
          }
          break;
        }
        case CROSS_COLOR_TRANSFORM: {
          const int tiles_per_row = subsample_size(w, t.bits);
          for (int y = 0; y < h; ++y) {
            for (int x = 0; x < w; ++x) {
              const uint32_t code = t.data[static_cast<size_t>(y >> t.bits) * tiles_per_row + (x >> t.bits)];
              const int8_t g2r = static_cast<int8_t>(code & 0xff);
              const int8_t g2b = static_cast<int8_t>((code >> 8) & 0xff);
              const int8_t r2b = static_cast<int8_t>((code >> 16) & 0xff);
              const size_t i = static_cast<size_t>(y) * w + x;
              const uint32_t argb = cur[i];
              const int8_t green = static_cast<int8_t>(argb >> 8);
              int new_red = (argb >> 16) & 0xff;
              int new_blue = argb & 0xff;
              new_red += (static_cast<int>(g2r) * green) >> 5;
              new_red &= 0xff;
              new_blue += (static_cast<int>(g2b) * green) >> 5;
              new_blue += (static_cast<int>(r2b) * static_cast<int8_t>(new_red)) >> 5;
              new_blue &= 0xff;
              out[i] = (argb & 0xff00ff00u) | (static_cast<uint32_t>(new_red) << 16) | static_cast<uint32_t>(new_blue);
            }
          }
          break;
        }
        case COLOR_INDEXING_TRANSFORM: {
          const int bits_per_pixel = 8 >> t.bits;
          const int count_mask = (1 << t.bits) - 1;
          const uint32_t bit_mask = (1u << bits_per_pixel) - 1;
          const int in_w = subsample_size(w, t.bits);
          std::vector<uint32_t> wide(static_cast<size_t>(w) * h);
          for (int y = 0; y < h; ++y) {
            const uint32_t* in = &cur[static_cast<size_t>(y) * in_w];
            uint32_t* o = &wide[static_cast<size_t>(y) * w];
            uint32_t packed = 0;
            for (int x = 0; x < w; ++x) {
              if ((x & count_mask) == 0) packed = (*in++ >> 8) & 0xff;
              o[x] = t.data[packed & bit_mask];
              packed >>= bits_per_pixel;
            }
          }
          cur = std::move(wide);
          break;
        }
      }
    }
    return cur;
  }

  // A VP8L image: its header, then the level-0 stream. Returns ARGB.
  std::vector<uint32_t> decode_image(const uint8_t* data, size_t size, int* w, int* h) {
    br.init(data, size);
    if (br.read(8) != 0x2f) fail("VP8L: invalid header");
    const int iw = static_cast<int>(br.read(14)) + 1;
    const int ih = static_cast<int>(br.read(14)) + 1;
    br.read(1);  // alpha is used: a hint
    if (br.read(3) != 0 || br.eos) fail("VP8L: invalid header");
    if (!decode_image_stream(iw, ih, true, nullptr)) fail("VP8L: bitstream error");
    std::vector<uint32_t> coded(static_cast<size_t>(width) * height, 0);
    if (!decode_pixels(hdr, coded.data(), width, height, false)) fail("VP8L: bitstream error");
    *w = iw;
    *h = ih;
    return inverse_transforms(std::move(coded));
  }

  // An ALPH chunk's VP8L stream (no header): the green channel of a
  // width x height image.
  void decode_alpha(const uint8_t* data, size_t size, int w, int h, uint8_t* alpha) {
    br.init(data, size);
    if (!decode_image_stream(w, h, true, nullptr)) fail("ALPH: lossless stream error");
    bool alpha8 = transforms.size() == 1 && transforms[0].type == COLOR_INDEXING_TRANSFORM && hdr.cache_bits == 0;
    for (const auto& g : hdr.groups) {
      alpha8 = alpha8 && g.t[RED].single && g.t[BLUE].single && g.t[ALPHA].single;
    }
    std::vector<uint32_t> coded(static_cast<size_t>(width) * height, 0);
    if (!decode_pixels(hdr, coded.data(), width, height, alpha8)) fail("ALPH: lossless stream error");
    const std::vector<uint32_t> argb = inverse_transforms(std::move(coded));
    for (size_t i = 0; i < argb.size(); ++i) alpha[i] = static_cast<uint8_t>(argb[i] >> 8);
  }
};

// ---------------------------------------------------------------- ALPH

void unfilter_row(int filter, const uint8_t* prev, uint8_t* row, int width) {
  if (filter == 1 || (prev == nullptr && filter != 0)) {  // horizontal (and the first row of each filter)
    uint8_t pred = (prev == nullptr) ? 0 : prev[0];
    for (int i = 0; i < width; ++i) {
      row[i] = static_cast<uint8_t>(pred + row[i]);
      pred = row[i];
    }
  } else if (filter == 2) {  // vertical
    for (int i = 0; i < width; ++i) row[i] = static_cast<uint8_t>(prev[i] + row[i]);
  } else if (filter == 3) {  // gradient
    uint8_t top = prev[0], top_left = top, left = top;
    for (int i = 0; i < width; ++i) {
      top = prev[i];
      const int g = left + top - top_left;
      const int pred = ((g & ~0xff) == 0) ? g : (g < 0) ? 0 : 255;
      left = static_cast<uint8_t>(row[i] + pred);
      top_left = top;
      row[i] = left;
    }
  }
}

// The alpha plane of an ALPH chunk's payload (header byte, then data).
void decode_alph(const uint8_t* data, size_t size, int w, int h, uint8_t* alpha) {
  if (size <= 1) fail("ALPH: chunk too short");
  const int method = data[0] & 0x03;
  const int filter = (data[0] >> 2) & 0x03;
  const int pre_processing = (data[0] >> 4) & 0x03;
  const int rsrv = (data[0] >> 6) & 0x03;
  if (method > 1 || pre_processing > 1 || rsrv != 0) fail("ALPH: invalid header byte 0x%02x", data[0]);
  const size_t n = static_cast<size_t>(w) * h;
  if (method == 0) {
    if (size - 1 < n) fail("ALPH: raw plane shorter than the frame");
    memcpy(alpha, data + 1, n);
  } else {
    Vp8lDecoder d;
    d.decode_alpha(data + 1, size - 1, w, h, alpha);
  }
  for (int y = 0; y < h; ++y) {
    unfilter_row(filter, y == 0 ? nullptr : alpha + static_cast<size_t>(y - 1) * w, alpha + static_cast<size_t>(y) * w, w);
  }
}

// ---------------------------------------------------------------- VP8L encoder

struct BitWriter {
  std::vector<uint8_t> buf;
  uint64_t acc = 0;
  int n = 0;
  void put(uint32_t v, int nb) {
    acc |= static_cast<uint64_t>(v) << n;
    n += nb;
    while (n >= 8) {
      buf.push_back(static_cast<uint8_t>(acc));
      acc >>= 8;
      n -= 8;
    }
  }
  void flush() {
    if (n > 0) buf.push_back(static_cast<uint8_t>(acc));
    acc = 0;
    n = 0;
  }
};

// Huffman code lengths of `freq`, at most `limit` bits: the counts are
// halved (rounding up) until the longest code fits.
std::vector<int> code_lengths(std::vector<uint64_t> freq, int limit) {
  const int n = static_cast<int>(freq.size());
  std::vector<int> lengths(static_cast<size_t>(n), 0);
  for (;;) {
    std::vector<int> used;
    for (int s = 0; s < n; ++s) {
      if (freq[s] > 0) used.push_back(s);
    }
    if (used.size() <= 1) {
      for (int s : used) lengths[s] = 1;
      return lengths;
    }
    // nodes: leaves 0..n-1, internal nodes after; ties broken by node index
    std::vector<int> parent(static_cast<size_t>(2 * n), -1);
    using Item = std::pair<uint64_t, int>;
    std::priority_queue<Item, std::vector<Item>, std::greater<Item>> heap;
    for (int s : used) heap.push({freq[s], s});
    int next = n;
    while (heap.size() > 1) {
      const Item a = heap.top();
      heap.pop();
      const Item b = heap.top();
      heap.pop();
      parent[a.second] = parent[b.second] = next;
      heap.push({a.first + b.first, next++});
    }
    int longest = 0;
    for (int s : used) {
      int d = 0;
      for (int v = s; parent[v] != -1; v = parent[v]) ++d;
      lengths[s] = d;
      longest = std::max(longest, d);
    }
    if (longest <= limit) return lengths;
    for (auto& f : freq) {
      if (f > 0) f = (f + 1) >> 1;
    }
    std::fill(lengths.begin(), lengths.end(), 0);
  }
}

// The canonical codes of `lengths`, bit-reversed for writing least
// significant bit first; a code of one symbol is written with no bits.
struct Code {
  std::vector<uint32_t> bits;
  std::vector<int> len;
};
Code canonical(const std::vector<int>& lengths) {
  Code c;
  c.bits.assign(lengths.size(), 0);
  c.len.assign(lengths.size(), 0);
  int used = 0;
  for (int l : lengths) used += l > 0;
  if (used <= 1) return c;
  uint32_t code = 0;
  for (int len = 1; len <= 15; ++len) {
    for (size_t s = 0; s < lengths.size(); ++s) {
      if (lengths[s] != len) continue;
      uint32_t rev = 0;
      for (int b = 0; b < len; ++b) rev |= ((code >> b) & 1u) << (len - 1 - b);
      c.bits[s] = rev;
      c.len[s] = len;
      ++code;
    }
    code <<= 1;
  }
  return c;
}

// Writes one prefix code for a histogram and returns the code to emit.
Code write_code(BitWriter& bw, const std::vector<uint64_t>& hist) {
  std::vector<int> used;
  for (size_t s = 0; s < hist.size(); ++s) {
    if (hist[s] > 0) used.push_back(static_cast<int>(s));
  }
  if (used.size() <= 2 && (used.empty() || used.back() < 256)) {  // a simple code
    if (used.empty()) used.push_back(0);
    bw.put(1, 1);
    bw.put(static_cast<uint32_t>(used.size() - 1), 1);
    if (used[0] < 2) {
      bw.put(0, 1);
      bw.put(static_cast<uint32_t>(used[0]), 1);
    } else {
      bw.put(1, 1);
      bw.put(static_cast<uint32_t>(used[0]), 8);
    }
    if (used.size() == 2) bw.put(static_cast<uint32_t>(used[1]), 8);
    std::vector<int> lengths(hist.size(), 0);
    for (int s : used) lengths[s] = 1;
    return canonical(lengths);
  }
  const std::vector<int> lengths = code_lengths(hist, 15);
  // the code lengths as code-length symbols: 0-15, 17 (3-10 zeros), 18 (11-138 zeros)
  std::vector<std::pair<int, int>> tokens;  // (symbol, extra bits value)
  for (size_t i = 0; i < lengths.size();) {
    if (lengths[i] != 0) {
      tokens.push_back({lengths[i], 0});
      ++i;
      continue;
    }
    size_t run = 0;
    while (i + run < lengths.size() && lengths[i + run] == 0) ++run;
    i += run;
    while (run > 0) {
      if (run >= 11) {
        const size_t r = std::min<size_t>(run, 138);
        tokens.push_back({18, static_cast<int>(r - 11)});
        run -= r;
      } else if (run >= 3) {
        tokens.push_back({17, static_cast<int>(run - 3)});
        run = 0;
      } else {
        tokens.push_back({0, 0});
        --run;
      }
    }
  }
  std::vector<uint64_t> cl_hist(19, 0);
  for (const auto& t : tokens) ++cl_hist[static_cast<size_t>(t.first)];
  const std::vector<int> cl_lengths = code_lengths(cl_hist, 7);
  int num_codes = 4;
  for (int i = 0; i < 19; ++i) {
    if (cl_lengths[static_cast<size_t>(kCodeLengthCodeOrder[i])] > 0) num_codes = std::max(num_codes, i + 1);
  }
  bw.put(0, 1);
  bw.put(static_cast<uint32_t>(num_codes - 4), 4);
  for (int i = 0; i < num_codes; ++i) bw.put(static_cast<uint32_t>(cl_lengths[static_cast<size_t>(kCodeLengthCodeOrder[i])]), 3);
  bw.put(0, 1);  // every symbol's length follows
  const Code cl = canonical(cl_lengths);
  for (const auto& t : tokens) {
    bw.put(cl.bits[static_cast<size_t>(t.first)], cl.len[static_cast<size_t>(t.first)]);
    if (t.first == 17) bw.put(static_cast<uint32_t>(t.second), 3);
    if (t.first == 18) bw.put(static_cast<uint32_t>(t.second), 7);
  }
  return canonical(lengths);
}

std::vector<uint8_t> encode_vp8l(const uint8_t* px, int w, int h, int channels, int use_alpha) {
  if (w < 1 || h < 1 || w > 16384 || h > 16384) fail("VP8L: cannot write a %d x %d image", w, h);
  if (channels != 3 && channels != 4) fail("VP8L: %d channels", channels);
  const size_t n = static_cast<size_t>(w) * h;
  std::vector<uint32_t> argb(n);
  std::vector<uint64_t> hist[5] = {std::vector<uint64_t>(280, 0), std::vector<uint64_t>(256, 0),
                                   std::vector<uint64_t>(256, 0), std::vector<uint64_t>(256, 0),
                                   std::vector<uint64_t>(40, 0)};
  for (size_t i = 0; i < n; ++i) {
    const uint8_t* p = px + i * channels;
    const uint32_t g = p[1];
    const uint32_t r = (p[0] - g) & 0xff, b = (p[2] - g) & 0xff;  // subtract green
    const uint32_t a = channels == 4 ? p[3] : 0xff;
    argb[i] = (a << 24) | (r << 16) | (g << 8) | b;
    ++hist[GREEN][g];
    ++hist[RED][r];
    ++hist[BLUE][b];
    ++hist[ALPHA][a];
  }
  BitWriter bw;
  bw.put(0x2f, 8);
  bw.put(static_cast<uint32_t>(w - 1), 14);
  bw.put(static_cast<uint32_t>(h - 1), 14);
  bw.put(use_alpha ? 1u : 0u, 1);
  bw.put(0, 3);  // version
  bw.put(1, 1);  // a transform: subtract green
  bw.put(SUBTRACT_GREEN_TRANSFORM, 2);
  bw.put(0, 1);  // no more transforms
  bw.put(0, 1);  // no colour cache
  bw.put(0, 1);  // no meta prefix codes
  Code codes[5];
  for (int j = 0; j < 5; ++j) codes[j] = write_code(bw, hist[j]);
  for (size_t i = 0; i < n; ++i) {
    const uint32_t v = argb[i];
    const uint32_t g = (v >> 8) & 0xff, r = (v >> 16) & 0xff, b = v & 0xff, a = v >> 24;
    bw.put(codes[GREEN].bits[g], codes[GREEN].len[g]);
    bw.put(codes[RED].bits[r], codes[RED].len[r]);
    bw.put(codes[BLUE].bits[b], codes[BLUE].len[b]);
    bw.put(codes[ALPHA].bits[a], codes[ALPHA].len[a]);
  }
  bw.flush();
  return std::move(bw.buf);
}

}  // namespace

extern "C" {

// Decode a VP8 frame (`data`: the chunk's payload to the end of the
// frame's data) of width x height into rows of RGB (channels 3) or RGBA
// (channels 4) `stride` bytes apart; with `has_alpha`, the ALPH chunk's
// payload (`alpha`, `alpha_size` bytes) gives the alpha bytes (decoded, and
// so checked, for RGB too), else alpha is 255. Returns 0, or 1 with a
// message.
int acz_webp_vp8(const uint8_t* data, size_t size, const uint8_t* alpha, size_t alpha_size, int has_alpha, int width,
                 int height, uint8_t* out, int64_t stride, int channels, char* err, int errlen) {
  try {
    Vp8Decoder d;
    d.decode(data, size);
    if (d.width != width || d.height != height) fail("VP8: frame of %d x %d, expected %d x %d", d.width, d.height, width, height);
    emit_rgb(d, out, static_cast<ptrdiff_t>(stride), channels);
    std::vector<uint8_t> plane;
    if (has_alpha) {
      plane.resize(static_cast<size_t>(width) * height);
      decode_alph(alpha, alpha_size, width, height, plane.data());
    }
    if (channels == 4) {
      for (int y = 0; y < height; ++y) {
        uint8_t* row = out + static_cast<ptrdiff_t>(y) * stride;
        for (int x = 0; x < width; ++x) row[4 * x + 3] = has_alpha ? plane[static_cast<size_t>(y) * width + x] : 0xff;
      }
    }
    return 0;
  } catch (const Error& e) {
    set_error(err, errlen, e.msg);
  } catch (const std::bad_alloc&) {
    set_error(err, errlen, "out of memory");
  }
  return 1;
}

// Decode a VP8L image (`data`: the chunk's payload to the end of the
// frame's data) of width x height into rows of RGB (channels 3) or RGBA
// (channels 4) `stride` bytes apart. Returns 0, or 1 with a message.
int acz_webp_vp8l(const uint8_t* data, size_t size, int width, int height, uint8_t* out, int64_t stride, int channels,
                  char* err, int errlen) {
  try {
    Vp8lDecoder d;
    int w = 0, h = 0;
    const std::vector<uint32_t> argb = d.decode_image(data, size, &w, &h);
    if (w != width || h != height) fail("VP8L: image of %d x %d, expected %d x %d", w, h, width, height);
    for (int y = 0; y < h; ++y) {
      uint8_t* row = out + static_cast<ptrdiff_t>(y) * stride;
      const uint32_t* src = &argb[static_cast<size_t>(y) * w];
      for (int x = 0; x < w; ++x, row += channels) {
        const uint32_t v = src[x];
        row[0] = static_cast<uint8_t>(v >> 16);
        row[1] = static_cast<uint8_t>(v >> 8);
        row[2] = static_cast<uint8_t>(v);
        if (channels == 4) row[3] = static_cast<uint8_t>(v >> 24);
      }
    }
    return 0;
  } catch (const Error& e) {
    set_error(err, errlen, e.msg);
  } catch (const std::bad_alloc&) {
    set_error(err, errlen, "out of memory");
  }
  return 1;
}

// A VP8L stream of an (h, w, channels) uint8 RGB or RGBA image, its
// alpha-is-used bit `use_alpha`, in a malloc'd buffer (*out, freed with
// acz_webp_free). Returns its size, or -1 with a message.
int64_t acz_webp_vp8l_encode(const uint8_t* px, int width, int height, int channels, int use_alpha, uint8_t** out,
                             char* err, int errlen) {
  try {
    const std::vector<uint8_t> bytes = encode_vp8l(px, width, height, channels, use_alpha);
    *out = static_cast<uint8_t*>(malloc(bytes.size()));
    if (*out == nullptr) fail("out of memory");
    memcpy(*out, bytes.data(), bytes.size());
    return static_cast<int64_t>(bytes.size());
  } catch (const Error& e) {
    set_error(err, errlen, e.msg);
  } catch (const std::bad_alloc&) {
    set_error(err, errlen, "out of memory");
  }
  return -1;
}

void acz_webp_free(void* p) { free(p); }

}  // extern "C"
