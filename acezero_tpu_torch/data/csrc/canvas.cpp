// Host canvas pass with a plain C interface, loaded with ctypes by
// acezero_tpu_torch/data/native.py and built by acezero_tpu_torch/ops/build.py.
//
// One image a call: uint8 gray or RGB becomes float32 ITU-R 601 luma,
// 0.299f * r + 0.587f * g + 0.114f * b in that order; the luma is resized
// to (out_h, out_w) with sy = in_h / out_h and sx = in_w / out_w in float32;
// each value gets +0.5f, is clamped to [0, 255] and truncated to uint8, and
// lands on the canvas at ((canvas_h - out_h) / 2, (canvas_w - out_w) / 2).
//
// When neither side grows (sy >= 1 and sx >= 1) the resize is an area
// average: output (y, x) covers [y sy, (y + 1) sy) x [x sx, (x + 1) sx);
// every input pixel under it counts with its overlap wy * wx, and the sum
// runs over the footprint's rows, then its columns, one tap at a time:
// total += px * wy * wx, weight += wy * wx, then total / weight. Otherwise
// it is bilinear at ((y + 0.5f) sy - 0.5f, (x + 0.5f) sx - 0.5f), clamped
// to the image. These are the JAX package's canvases, bit for bit.
//
// The footprints and overlaps are computed once for each output row and
// column, and the luma of an input row only when an output row needs it,
// so an image holds a few rows of floats instead of a float copy of
// itself. Every output's sum keeps the order above: the bits do not depend
// on these choices. data/images.py::gray_resize is the plain numpy version.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <new>
#include <vector>

namespace {

// One axis of the area average: for output o, `count[o]` input pixels from
// `first[o]` on, with overlaps w[o * k + t].
struct AreaAxis {
  std::vector<int> first, count;
  std::vector<float> w;
  int k = 0;
};

AreaAxis area_axis(int n_in, int n_out, float s) {
  AreaAxis a;
  a.first.resize(n_out);
  a.count.resize(n_out);
  for (int o = 0; o < n_out; ++o) {
    const float hi = static_cast<float>(o + 1) * s;
    const int i0 = std::max(0, static_cast<int>(std::floor(static_cast<float>(o) * s)));
    const int i1 = std::min(n_in, static_cast<int>(std::ceil(hi)));
    a.first[o] = i0;
    a.count[o] = std::max(0, i1 - i0);
    a.k = std::max(a.k, a.count[o]);
  }
  a.w.assign(static_cast<size_t>(n_out) * a.k, 0.f);
  for (int o = 0; o < n_out; ++o) {
    const float lo = static_cast<float>(o) * s, hi = static_cast<float>(o + 1) * s;
    for (int t = 0; t < a.count[o]; ++t) {
      const int i = a.first[o] + t;
      a.w[static_cast<size_t>(o) * a.k + t] = std::min<float>(i + 1.f, hi) - std::max<float>(static_cast<float>(i), lo);
    }
  }
  return a;
}

// One axis of the bilinear resize: the two input pixels of output o and
// their weights 1 - f and f.
struct BilinearAxis {
  std::vector<int> i0, i1;
  std::vector<float> f, g;  // f and 1 - f
};

BilinearAxis bilinear_axis(int n_in, int n_out, float s) {
  BilinearAxis b;
  b.i0.resize(n_out);
  b.i1.resize(n_out);
  b.f.resize(n_out);
  b.g.resize(n_out);
  for (int o = 0; o < n_out; ++o) {
    float c = (o + 0.5f) * s - 0.5f;
    c = std::min(std::max(c, 0.f), static_cast<float>(n_in - 1));
    const int i = static_cast<int>(c);
    b.i0[o] = i;
    b.i1[o] = std::min(i + 1, n_in - 1);
    b.f[o] = c - i;
    b.g[o] = 1 - b.f[o];
  }
  return b;
}

// luma of input row y into out[0, w)
void luma_row(const uint8_t* img, int w, int channels, int y, float* out) {
  const uint8_t* p = img + static_cast<size_t>(y) * w * channels;
  if (channels == 1) {
    for (int x = 0; x < w; ++x) out[x] = static_cast<float>(p[x]);
  } else {
    for (int x = 0; x < w; ++x, p += 3) out[x] = 0.299f * p[0] + 0.587f * p[1] + 0.114f * p[2];
  }
}

inline uint8_t to_u8(float v) { return static_cast<uint8_t>(std::min(std::max(v + 0.5f, 0.f), 255.f)); }

void area_resize(const uint8_t* img, int in_h, int in_w, int channels, float sy, float sx, uint8_t* dst,
                 int stride, int out_h, int out_w) {
  const AreaAxis ry = area_axis(in_h, out_h, sy), rx = area_axis(in_w, out_w, sx);
  std::vector<float> rows(static_cast<size_t>(ry.k) * in_w);
  for (int oy = 0; oy < out_h; ++oy, dst += stride) {
    const int ny = ry.count[oy];
    for (int t = 0; t < ny; ++t) luma_row(img, in_w, channels, ry.first[oy] + t, &rows[static_cast<size_t>(t) * in_w]);
    const float* wys = &ry.w[static_cast<size_t>(oy) * ry.k];
    for (int ox = 0; ox < out_w; ++ox) {
      const int x0 = rx.first[ox], nx = rx.count[ox];
      const float* wxs = &rx.w[static_cast<size_t>(ox) * rx.k];
      float total = 0.f, weight = 0.f;
      for (int t = 0; t < ny; ++t) {
        const float wy = wys[t];
        if (wy <= 0) continue;
        const float* row = &rows[static_cast<size_t>(t) * in_w + x0];
        for (int u = 0; u < nx; ++u) {
          const float wx = wxs[u];
          if (wx <= 0) continue;
          total += row[u] * wy * wx;
          weight += wy * wx;
        }
      }
      dst[ox] = to_u8(weight > 0 ? total / weight : 0.f);
    }
  }
}

void bilinear_resize(const uint8_t* img, int in_h, int in_w, int channels, float sy, float sx, uint8_t* dst,
                     int stride, int out_h, int out_w) {
  const BilinearAxis by = bilinear_axis(in_h, out_h, sy), bx = bilinear_axis(in_w, out_w, sx);
  std::vector<float> gray(static_cast<size_t>(in_h) * in_w);
  for (int y = 0; y < in_h; ++y) luma_row(img, in_w, channels, y, &gray[static_cast<size_t>(y) * in_w]);
  for (int oy = 0; oy < out_h; ++oy, dst += stride) {
    const float* r0 = &gray[static_cast<size_t>(by.i0[oy]) * in_w];
    const float* r1 = &gray[static_cast<size_t>(by.i1[oy]) * in_w];
    const float fy = by.f[oy], gy = by.g[oy];
    for (int ox = 0; ox < out_w; ++ox) {
      const int x0 = bx.i0[ox], x1 = bx.i1[ox];
      const float fx = bx.f[ox], gx = bx.g[ox];
      dst[ox] = to_u8(r0[x0] * gy * gx + r0[x1] * gy * fx + r1[x0] * fy * gx + r1[x1] * fy * fx);
    }
  }
}

}  // namespace

extern "C" {

// Resize one (in_h, in_w, channels) uint8 image, channels 1 (gray) or 3
// (RGB), to (out_h, out_w) luma and write it centred into the (canvas_h,
// canvas_w) uint8 canvas; the rest of the canvas is left as it is.
// Returns 0, 1 for sizes or channels out of range, 2 when memory ran out.
int acz_gray_resize_center(const uint8_t* img, int in_h, int in_w, int channels, uint8_t* canvas, int canvas_h,
                           int canvas_w, int out_h, int out_w) {
  if (in_h < 1 || in_w < 1 || out_h < 1 || out_w < 1 || out_h > canvas_h || out_w > canvas_w ||
      (channels != 1 && channels != 3))
    return 1;
  const float sy = static_cast<float>(in_h) / out_h;
  const float sx = static_cast<float>(in_w) / out_w;
  uint8_t* dst = canvas + static_cast<size_t>((canvas_h - out_h) / 2) * canvas_w + (canvas_w - out_w) / 2;
  try {
    if (sy >= 1.f && sx >= 1.f)
      area_resize(img, in_h, in_w, channels, sy, sx, dst, canvas_w, out_h, out_w);
    else
      bilinear_resize(img, in_h, in_w, channels, sy, sx, dst, canvas_w, out_h, out_w);
  } catch (const std::bad_alloc&) {
    return 2;
  }
  return 0;
}

}  // extern "C"
