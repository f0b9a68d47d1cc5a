"""Host-side image decode onto static grayscale canvases.

Counterpart of acezero_tpu/data/images.py, without PIL: PNG files decode
with `zlib` and numpy (8-bit gray, gray+alpha, RGB and RGBA, not
interlaced, all five row filters; anything else raises). Each image is
turned to ITU-R 601 luma, resized so its short side matches
`short_size`, and centred on a canvas shared by the whole set, rounded up
to a multiple of 8 — the same arithmetic as native/canvas.cpp: an area
average when shrinking, bilinear when enlarging, float32 luma, +0.5 and
truncation to uint8.
"""

from __future__ import annotations

import concurrent.futures as _futures
import math
import struct
import zlib
from dataclasses import dataclass

import numpy as np

# Grayscale normalization statistics (reference dataset.py:150-153).
GRAY_MEAN = 0.4
GRAY_STD = 0.25

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # colour type -> samples per pixel


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _unfilter(raw: bytes, h: int, w: int, bpp: int, path) -> np.ndarray:
    """Undo the per-row PNG filters: (h, w, bpp) uint8.

    None/Sub/Up rows decode a row at a time. Average and Paeth predict each
    byte from its left, upper and upper-left neighbours, so images that use
    them decode along anti-diagonals (every pixel of one diagonal depends
    only on the two diagonals before it), vectorised over each diagonal.
    """
    buf = np.frombuffer(raw, np.uint8)
    if buf.size != h * (w * bpp + 1):
        raise ValueError(f"{path}: PNG image data has {buf.size} bytes, expected {h * (w * bpp + 1)}")
    buf = buf.reshape(h, w * bpp + 1)
    ftype = buf[:, 0].astype(np.int64)
    if (ftype > 4).any():
        raise ValueError(f"{path}: unknown PNG filter type {int(ftype.max())}")
    filt = buf[:, 1:].reshape(h, w, bpp).astype(np.int32)
    if (ftype <= 2).all():
        out = np.zeros((h + 1, w, bpp), np.int32)  # one zero row on top
        for y in range(h):
            f, up = filt[y], out[y]
            if ftype[y] == 0:
                out[y + 1] = f
            elif ftype[y] == 1:
                out[y + 1] = np.cumsum(f, axis=0) & 255
            else:
                out[y + 1] = (f + up) & 255
        return out[1:].astype(np.uint8)
    # Sheared layout: pixel (y, x) sits at row y + 1, column y + x + 2, so the
    # anti-diagonal d = y + x is column d + 2 and its left, upper and
    # upper-left neighbours are plain slices of columns d + 1 and d. Cells
    # left of x = 0 and the row above y = 0 stay zero, as PNG defines them.
    rows = np.arange(h)[:, None]
    cols = rows + np.arange(w)[None, :] + 2
    sheared_f = np.zeros((h, h + w + 2, bpp), np.int32)
    sheared_f[rows, cols] = filt
    t = np.zeros((h + w + 2, h), np.int64)  # filter type per (column, row), 0 off-image
    t[cols.T, rows.T] = ftype[:, None].T
    s = np.zeros((h + 1, h + w + 2, bpp), np.int32)
    for d in range(h + w - 1):
        y0, y1 = max(0, d - w + 1), min(h - 1, d) + 1
        cd = d + 2
        a = s[y0 + 1 : y1 + 1, cd - 1]  # left
        b = s[y0:y1, cd - 1]  # up
        c = s[y0:y1, cd - 2]  # up-left
        kind = t[cd, y0:y1, None]
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = np.where(kind == 4, pred, np.where(kind == 3, (a + b) >> 1,
                        np.where(kind == 2, b, np.where(kind == 1, a, 0))))
        s[y0 + 1 : y1 + 1, cd] = (sheared_f[y0:y1, cd] + pred) & 255
    return s[rows + 1, cols].astype(np.uint8)


def read_png(path) -> np.ndarray:
    """Decode an 8-bit PNG: (h, w) for gray, (h, w, 2|3|4) for gray+alpha,
    RGB and RGBA, as uint8."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_PNG_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    pos = len(_PNG_SIGNATURE)
    header = None
    idat = []
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        kind = data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None or not idat:
        raise ValueError(f"{path}: PNG without IHDR or IDAT")
    w, h, depth, ctype, _compression, _filter, interlace = header
    if depth != 8 or ctype not in _CHANNELS or interlace != 0:
        raise ValueError(
            f"{path}: unsupported PNG (bit depth {depth}, colour type {ctype}, "
            f"interlace {interlace}); supported: 8-bit gray, gray+alpha, RGB, RGBA, "
            "not interlaced"
        )
    bpp = _CHANNELS[ctype]
    img = _unfilter(zlib.decompress(b"".join(idat)), h, w, bpp, path)
    return img[..., 0] if bpp == 1 else img


def _luma(img: np.ndarray) -> np.ndarray:
    """float32 ITU-R 601 luma as native/canvas.cpp computes it. Gray+alpha
    and RGBA drop alpha; gray+alpha goes through RGB with R = G = B."""
    if img.ndim == 2:
        return img.astype(np.float32)
    if img.shape[-1] == 2:
        img = np.repeat(img[..., :1], 3, axis=-1)
    r, g, b = (img[..., i].astype(np.float32) for i in range(3))
    return (np.float32(0.299) * r + np.float32(0.587) * g) + np.float32(0.114) * b


def _area_weights(n_in: int, n_out: int, scale: np.float32) -> np.ndarray:
    """(n_out, n_in) overlap of each output cell [o*s, (o+1)*s) with each
    input pixel [i, i+1)."""
    o = np.arange(n_out, dtype=np.float32)[:, None]
    i = np.arange(n_in, dtype=np.float32)[None, :]
    lo, hi = o * scale, (o + 1) * scale
    return np.clip(np.minimum(i + 1, hi) - np.maximum(i, lo), 0, None).astype(np.float64)


def _bilinear_taps(n_in: int, n_out: int, scale: np.float32):
    s = (np.arange(n_out, dtype=np.float32) + np.float32(0.5)) * scale - np.float32(0.5)
    s = np.clip(s, 0, n_in - 1).astype(np.float32)
    i0 = s.astype(np.int64)
    i1 = np.minimum(i0 + 1, n_in - 1)
    return i0, i1, (s - i0).astype(np.float32)


def gray_resize(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Luma, resized to (out_h, out_w), rounded to uint8."""
    gray = _luma(img)
    in_h, in_w = gray.shape
    sy = np.float32(in_h) / np.float32(out_h)
    sx = np.float32(in_w) / np.float32(out_w)
    if (in_h, in_w) == (out_h, out_w):
        v = gray  # each output cell covers exactly one input pixel
    elif sy >= 1 and sx >= 1:
        wy = _area_weights(in_h, out_h, sy)
        wx = _area_weights(in_w, out_w, sx)
        v = (wy @ gray.astype(np.float64) @ wx.T) / np.outer(wy.sum(1), wx.sum(1))
    else:
        y0, y1, fy = _bilinear_taps(in_h, out_h, sy)
        x0, x1, fx = _bilinear_taps(in_w, out_w, sx)
        fy, fx = fy[:, None], fx[None, :]
        r0, r1 = gray[y0], gray[y1]
        v = (r0[:, x0] * (1 - fy) * (1 - fx) + r0[:, x1] * (1 - fy) * fx
             + r1[:, x0] * fy * (1 - fx) + r1[:, x1] * fy * fx)
    return np.clip(v.astype(np.float32) + np.float32(0.5), 0, 255).astype(np.uint8)


@dataclass
class DecodedImages:
    """Static-canvas images.

    canvases: (N, Hc, Wc) uint8 grayscale, content centred.
    sizes: (N, 2) int32 (h, w) of the content after resize.
    orig_sizes: (N, 2) int32 (h, w) before resize.
    scale_factors: (N,) float32 short_size / original short side.
    """

    canvases: np.ndarray
    sizes: np.ndarray
    orig_sizes: np.ndarray
    scale_factors: np.ndarray

    @property
    def canvas_hw(self) -> tuple[int, int]:
        return self.canvases.shape[1], self.canvases.shape[2]


def decode_to_canvas(
    paths: list[str],
    short_size: int = 480,
    canvas_hw: tuple[int, int] | None = None,
    num_workers: int = 16,
) -> DecodedImages:
    """Decode all images and centre them on one shared canvas (by default the
    largest resized extent, rounded up to a multiple of 8)."""
    with _futures.ThreadPoolExecutor(max_workers=max(1, num_workers)) as ex:
        raws = list(ex.map(read_png, paths))
    orig_sizes = np.array([r.shape[:2] for r in raws], np.int32).reshape(-1, 2)
    scales = short_size / orig_sizes.min(axis=1).astype(np.float32)
    sizes = np.round(orig_sizes * scales[:, None]).astype(np.int32)
    if canvas_hw is None:
        hc = _round_up(int(sizes[:, 0].max()), 8)
        wc = _round_up(int(sizes[:, 1].max()), 8)
    else:
        hc, wc = canvas_hw
    if (sizes[:, 0] > hc).any() or (sizes[:, 1] > wc).any():
        raise ValueError(f"resized content {sizes.max(axis=0).tolist()} exceeds the canvas {(hc, wc)}")

    canvases = np.zeros((len(paths), hc, wc), np.uint8)

    def place(i):
        h, w = (int(s) for s in sizes[i])
        y0, x0 = (hc - h) // 2, (wc - w) // 2
        canvases[i, y0 : y0 + h, x0 : x0 + w] = gray_resize(raws[i], h, w)

    with _futures.ThreadPoolExecutor(max_workers=max(1, num_workers)) as ex:
        list(ex.map(place, range(len(paths))))
    return DecodedImages(canvases=canvases, sizes=sizes, orig_sizes=orig_sizes, scale_factors=scales)


def heuristic_focal_length(orig_h: int, orig_w: int) -> float:
    """70% of the image diagonal, in original pixels."""
    return math.sqrt(orig_h**2 + orig_w**2) * 0.7
