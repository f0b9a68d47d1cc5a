"""Host-side image decode onto static grayscale canvases.

Counterpart of acezero_tpu/data/images.py, without PIL. `read_image`
decodes an image file by its signature to the pixels
`np.asarray(Image.open(path))` gives. PNG files decode with `zlib` and
numpy: gray at bit depths 1, 2, 4, 8 and 16, palette, gray+alpha, RGB and
RGBA, all five row filters, Adam7 interlacing; 2- and 4-bit gray is scaled
to 8 bits as PIL's modes give it (`read_png` also turns a palette image to
RGB and 1-bit gray to 0/255). JPEG files decode in io/csrc/jpeg.cpp
(io/jpeg.py) to PIL's own pixels; a four-component JPEG comes back as a
`CmykImage`, so its mode travels with it. WebP files decode in
io/csrc/webp.cpp (io/webp.py) to PIL's RGB or RGBA array of the first
frame. GIF files decode in io/csrc/gif.cpp (io/gif.py) to PIL's frame 0,
a `ModeImage` of mode P (the indices, the palette and the transparency
index) or L (the grey levels and the transparency index, which an array
cannot carry; and the global palette that PIL keeps under a local grey
ramp, which its `convert("RGB")` goes through while its `convert("L")` is
a copy of the grey levels and its BILINEAR `resize` raises). JPEG 2000
files decode in io/csrc/jpeg2000.cpp (io/jpeg2000.py) to PIL's L, I;16,
LA, RGB, RGBA, a `CmykImage`, or a `ModeImage` of mode P or PA (the
indices, with the alpha band for PA, and the palette's RGB colours). PNG, TIFF
(io/tiff.py), BMP (io/bmp.py) and Netpbm/PFM (io/pnm.py) files decode to
an array whose
dtype tells PIL's mode (bool 1, uint8 L, LA, RGB or RGBA, uint16 I;16,
int32 I, float32 F), a `CmykImage`, or a `ModeImage` where it does not (P
with its palette, I;16B). Anything else raises ValueError naming the
file.

Each image is turned to ITU-R 601 luma, resized so its short side matches
`short_size`, and centred on a canvas shared by the whole set, rounded up
to a multiple of 8, by the host canvas pass (data/csrc/canvas.cpp through
data/native.py): float32 luma, an area average when shrinking, bilinear
when enlarging, +0.5 and truncation to uint8 — the JAX package's canvases
bit for bit. The pass takes what `canvas_input` makes of the decoded
image, which is what the JAX package's `_load_raw` hands to its own: modes
1, I, I;16 and F through `convert("L")` (clipped to 0-255, F truncated),
every other mode but L and RGB through `convert("RGB")` (16-bit colour as
its high bytes, I;16B clipped and replicated, P through its palette, alpha
dropped, CMYK as Pillow's cmyk2rgb). `gray_resize` is the pass's plain
numpy version, for the tests.
`decode_to_canvas` reads the sizes from the files' headers, fixes the
canvas, then decodes, resizes and places each image in one worker task, so
at most `num_workers` decoded images are held at once (the JAX package
decodes all of them before placing any). When an explicit canvas is
smaller than any resized image, every image takes the JAX package's PIL
path instead: `pil_luma_u8`, `pil_resize_bilinear` and a centre crop.

The colour paths that the JAX package runs through PIL are reproduced
exactly: `read_rgb` and `pil_rgb` (`convert("RGB")`, CMYK included),
`pil_luma_u8` (`convert("L")`, Pillow's integer luma) and
`pil_resize_bilinear` (`resize(BILINEAR)`, also of modes I and F).

`decode_to_canvas(cache_dir=...)` keeps decoded canvases in a cache keyed
by the files' path, size and mtime_ns and the decode parameters, as the JAX
package does, with three differences on purpose: the directory must be
owned by the current user and writable by nobody else (it is created with
mode 0700; otherwise the cache is not used), and its size is bounded by
`CACHE_MAX_BYTES`, the least recently used entries evicted first.
"""

from __future__ import annotations

import concurrent.futures as _futures
import hashlib
import logging
import math
import os
import shutil
import stat
import struct
import tempfile
import zlib
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from acezero_tpu_torch.data import native
from acezero_tpu_torch.io import bmp, dcx, formats, gif, jpeg2000, pcx, pnm, qoi, sgi, sun, tga, tiff, webp
from acezero_tpu_torch.io.formats import PNG_SIGNATURE as _PNG_SIGNATURE
from acezero_tpu_torch.io.formats import image_size
from acezero_tpu_torch.io.jpeg import read_jpeg

# Grayscale normalization statistics (reference dataset.py:150-153).
GRAY_MEAN = 0.4
GRAY_STD = 0.25

_logger = logging.getLogger(__name__)

_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # colour type -> samples per pixel
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}  # bit depths PNG allows
_GRAY_SCALE = {2: 85, 4: 17}  # PIL's raw modes L;2 and L;4
# Adam7 passes: first column, first row, column step, row step
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


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


def _samples(raw: bytes, h: int, w: int, depth: int, channels: int, path) -> np.ndarray:
    """Unfilter one (sub)image of h rows of w pixels: (h, w, channels)
    samples, uint8 up to bit depth 8 (packed samples unpacked, not scaled),
    uint16 at 16 (big-endian, filtered byte by byte)."""
    bits = depth * channels
    if bits < 8:  # packed rows: the filters work on whole bytes
        row_bytes = (w * bits + 7) // 8
        packed = _unfilter(raw, h, row_bytes, 1, path).reshape(h, row_bytes)
        per_byte = 8 // depth
        shifts = (8 - depth * (1 + np.arange(per_byte))).astype(np.uint8)
        vals = (packed[:, :, None] >> shifts) & ((1 << depth) - 1)
        return vals.reshape(h, row_bytes * per_byte)[:, :w, None].astype(np.uint8)
    nbytes = depth // 8
    img = _unfilter(raw, h, w, channels * nbytes, path)
    if nbytes == 2:
        pairs = img.reshape(h, w, channels, 2).astype(np.uint16)
        return (pairs[..., 0] << 8) | pairs[..., 1]
    return img


def read_png(path) -> np.ndarray:
    """Decode a PNG: (h, w) for gray, (h, w, 2|3|4) for gray+alpha, RGB and
    RGBA; uint8 at bit depth 8 or less, uint16 at 16. A palette image comes
    out as (h, w, 3) RGB (its transparency dropped), and 1-, 2- and 4-bit
    gray scaled to 8 bits (0/255, x85, x17), as PIL's modes give them."""
    img, palette = _read_png_samples(path)
    if palette is not None:
        return palette_rgb(ModeImage(img, "P", palette))
    return np.where(img, 255, 0).astype(np.uint8) if img.dtype == bool else img


def _read_png_samples(path) -> tuple[np.ndarray, np.ndarray | None]:
    """Decode a PNG to `np.asarray(Image.open(path))` and its palette: a
    palette image's (h, w) uint8 indices and its (n, 3) uint8 PLTE colours,
    1-bit gray as bool, 2- and 4-bit gray scaled to 8 bits (x85, x17);
    every other kind as `read_png` gives it, palette None."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_PNG_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    pos = len(_PNG_SIGNATURE)
    header = palette = None
    idat = []
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        kind = data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = body
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None or not idat:
        raise ValueError(f"{path}: PNG without IHDR or IDAT")
    w, h, depth, ctype, _compression, _filter, interlace = header
    if ctype not in _DEPTHS or depth not in _DEPTHS[ctype] or interlace not in (0, 1):
        raise ValueError(
            f"{path}: unsupported PNG (bit depth {depth}, colour type {ctype}, interlace {interlace}); "
            "supported: the bit depths PNG allows for each colour type, not interlaced or Adam7"
        )
    if ctype == 3 and palette is None:
        raise ValueError(f"{path}: palette PNG without PLTE")
    channels = _CHANNELS[ctype]
    raw = zlib.decompress(b"".join(idat))
    if interlace == 0:
        img = _samples(raw, h, w, depth, channels, path)
    else:
        img = np.zeros((h, w, channels), np.uint16 if depth == 16 else np.uint8)
        off = 0
        for x0, y0, dx, dy in _ADAM7:
            ph, pw = (h - y0 + dy - 1) // dy, (w - x0 + dx - 1) // dx
            if ph <= 0 or pw <= 0:
                continue
            n = ph * (1 + (pw * depth * channels + 7) // 8)
            img[y0::dy, x0::dx] = _samples(raw[off : off + n], ph, pw, depth, channels, path)
            off += n
        if off != len(raw):
            raise ValueError(f"{path}: PNG image data has {len(raw)} bytes, expected {off}")
    if ctype == 3:
        return img[..., 0], np.frombuffer(palette[: len(palette) // 3 * 3], np.uint8).reshape(-1, 3)[:256]
    if ctype == 0 and depth == 1:
        return img[..., 0] != 0, None
    if ctype == 0 and depth < 8:
        return (img[..., 0] * _GRAY_SCALE[depth]).astype(np.uint8), None
    return (img[..., 0] if channels == 1 else img), None


@dataclass(frozen=True, eq=False)
class CmykImage:
    """A four-component JPEG as PIL opens it, mode "CMYK": `pixels` is
    `np.asarray(Image.open(path))`, (h, w, 4) uint8. It is not an array, so
    it cannot be taken for an RGBA image of the same shape; `pil_rgb`,
    `pil_luma_u8` and `gray_resize` convert it as PIL does."""

    pixels: np.ndarray
    mode = "CMYK"

    @property
    def shape(self) -> tuple[int, int, int]:
        return self.pixels.shape


@dataclass(frozen=True, eq=False)
class ModeImage:
    """A decoded image whose PIL mode its array does not tell: mode "P"
    (`pixels` the (h, w) uint8 palette indices, `palette` the (n, 3) uint8
    colours; an index past the palette is black, as Pillow makes it), "PA"
    (`pixels` the (h, w, 2) indices and alpha, `palette` as for P),
    "I;16B" (`pixels` the (h, w) uint16 values, which `np.asarray` of PIL's
    image gives as big-endian uint16), a GIF's or TGA's "L" (`pixels` the
    (h, w) uint8 grey levels; `palette` the global palette PIL keeps under a
    GIF's local grey ramp, or a TGA's colour map, or None), or a TGA's "LA"
    with a colour map under it (`pixels` the (h, w, 2) values; PIL's
    conversions take the first band as indices into the map, as for PA).
    `transparency` is a GIF's transparency index (PIL's
    `info["transparency"]`), which the Nerfstudio runner writes back."""

    pixels: np.ndarray
    mode: str
    palette: np.ndarray | None = None
    transparency: int | None = None

    @property
    def shape(self) -> tuple[int, ...]:
        return self.pixels.shape


_READERS = {"tiff": tiff.read_tiff, "bmp": bmp.read_bmp, "pnm": pnm.read_pnm, "webp": webp.read_webp,
            "jpeg2000": jpeg2000.read_jpeg2000, "tga": tga.read_tga, "sgi": sgi.read_sgi, "pcx": pcx.read_pcx,
            "dcx": dcx.read_dcx, "sun": sun.read_sun, "qoi": qoi.read_qoi}


def read_image(path) -> "np.ndarray | CmykImage | ModeImage":
    """Decode a PNG (`read_png`), JPEG (io/jpeg.py::read_jpeg), TIFF, BMP,
    Netpbm/PFM, WebP, GIF, JPEG 2000, TGA, SGI, PCX, DCX, Sun raster or QOI
    file, told apart as PIL tells them apart (io/formats.py::kind; module
    note). Anything else raises ValueError."""
    kind = formats.file_kind(path)
    if kind == "png":
        img, palette = _read_png_samples(path)
        return img if palette is None else ModeImage(img, "P", palette)
    if kind == "jpeg":
        img = read_jpeg(path)
        return CmykImage(img) if img.ndim == 3 and img.shape[2] == 4 else img
    if kind == "gif":
        r = gif.read_gif(path)
        return ModeImage(r.pixels, r.mode, r.palette, r.transparency)
    if kind in _READERS:
        r = _READERS[kind](path)
        if r.mode == "CMYK":
            return CmykImage(r.pixels)
        if r.mode in ("P", "PA", "I;16B") or r.palette is not None:
            return ModeImage(r.pixels, r.mode, r.palette)
        return r.pixels
    raise ValueError(formats.refusal(path))


def pil_array(img) -> np.ndarray:
    """`np.asarray` of the PIL image a decoded image stands for: the array
    itself, a `CmykImage`'s pixels, a mode-P image's indices, an I;16B
    image's values as big-endian uint16."""
    if isinstance(img, CmykImage):
        return img.pixels
    if isinstance(img, ModeImage):
        return img.pixels.astype(">u2") if img.mode == "I;16B" else img.pixels
    return np.asarray(img)


def palette_rgb(img: ModeImage) -> np.ndarray:
    """(h, w, 3) uint8: a mode-P (or PA, or LA over a colour map) image
    through its palette (PIL's `convert("RGB")`), indices past the palette
    black."""
    lut = np.zeros((256, 3), np.uint8)
    pal = np.asarray(img.palette, np.uint8).reshape(-1, 3)[:256]
    lut[: len(pal)] = pal
    idx = img.pixels[..., 0] if img.pixels.ndim == 3 else img.pixels
    return np.take(lut, idx, axis=0)  # a gather: faster than lut[pixels]


def pil_uint8(img):
    """The 8-bit image PIL's conversions work from: 16-bit gray (I;16 and
    I;16B), I (int32) and F (float32) clipped to 0-255 (F truncated), as
    `convert("L")` makes them; mode 1 as 0 and 255; 16-bit colour (a PNG's)
    as each sample's high byte, as PIL opens it; modes P and PA, and LA with
    a colour map under it, through the palette (`palette_rgb`); mode L with
    a palette under it as its grey levels. 8-bit images and `CmykImage`s
    come back as they are."""
    if isinstance(img, ModeImage):
        if img.mode in ("P", "PA") or (img.mode == "LA" and img.palette is not None):
            return palette_rgb(img)
        return np.minimum(img.pixels, 255).astype(np.uint8)
    if isinstance(img, CmykImage) or img.dtype == np.uint8:
        return img
    if img.dtype == bool:
        return np.where(img, 255, 0).astype(np.uint8)
    if img.ndim == 2:
        return np.clip(img, 0, 255).astype(np.uint8)
    return (img >> 8).astype(np.uint8)


def _muldiv255(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    t = a * b + 128
    return ((t >> 8) + t) >> 8


def pil_rgb(img) -> np.ndarray:
    """PIL's `convert("RGB")` of an 8-bit image: gray is replicated,
    gray+alpha and RGBA drop alpha (no compositing), and CMYK becomes
    Pillow's cmyk2rgb: R = (255 - K) - C (255 - K) / 255, the product
    rounded as its MULDIV255 rounds it, G and B likewise from M and Y. A
    `ModeImage` with a palette (P, or a GIF's L with the palette kept under
    it) goes through its palette."""
    if isinstance(img, ModeImage):
        return palette_rgb(img) if img.palette is not None else pil_rgb(pil_uint8(img))
    if isinstance(img, CmykImage):
        px = img.pixels.astype(np.int32)
        nk = 255 - px[..., 3:]
        return np.clip(nk - _muldiv255(px[..., :3], nk), 0, 255).astype(np.uint8)
    img = np.asarray(img)
    if img.ndim == 2:
        return np.repeat(img[..., None], 3, axis=-1)
    if img.shape[-1] == 2:
        return np.repeat(img[..., :1], 3, axis=-1)
    return np.ascontiguousarray(img[..., :3])


def read_rgb(path) -> np.ndarray:
    """(h, w, 3) uint8, as PIL's `Image.open(path).convert("RGB")`
    (`pil_rgb` of `pil_uint8`, of a `ModeImage` itself), of any file
    `read_image` reads."""
    img = read_image(path)
    return pil_rgb(img if isinstance(img, ModeImage) else pil_uint8(img))


def pil_luma_u8(img) -> np.ndarray:
    """PIL's `convert("L")` of a decoded image: Pillow's integer ITU-R 601
    luma (R 19595 + G 38470 + B 7471 + 0x8000) >> 16 for RGB(A) and P, the
    gray channel for gray(+alpha), `pil_uint8` of the numeric gray modes,
    the luma of `pil_rgb` for CMYK (which is what Pillow gives)."""
    img = pil_rgb(img) if isinstance(img, CmykImage) else pil_uint8(img)
    if img.ndim == 2:
        return img
    if img.shape[-1] == 2:
        return np.ascontiguousarray(img[..., 0])
    r, g, b = (img[..., i].astype(np.uint32) for i in range(3))
    return ((r * 19595 + g * 38470 + b * 7471 + 0x8000) >> 16).astype(np.uint8)


_PRECISION_BITS = 32 - 8 - 2  # Pillow's fixed-point coefficients for 8-bit images


def _pil_bilinear_weights(n_in: int, n_out: int):
    """Pillow's `precompute_coeffs` for the triangle filter: (first tap
    (n_out,), float64 weights (n_out, ksize)). The support widens by the
    shrink factor; the weights are normalised in double, their sum taken tap
    by tap as Pillow does."""
    scale = n_in / n_out
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = (np.arange(n_out) + 0.5) * scale
    xmin = np.maximum(np.trunc(center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum(np.trunc(center + support + 0.5).astype(np.int64), n_in) - xmin
    taps = np.arange(ksize)
    w = 1.0 - np.abs((taps[None, :] + xmin[:, None] - center[:, None] + 0.5) * (1.0 / filterscale))
    w = np.where((w > 0) & (taps[None, :] < xmax[:, None]), w, 0.0)
    ww = np.zeros(n_out)
    for x in range(ksize):
        ww = ww + w[:, x]
    return xmin, np.where(ww[:, None] != 0.0, w / np.where(ww == 0.0, 1.0, ww)[:, None], w)


def _pil_resample_axis0(img: np.ndarray, n_out: int) -> np.ndarray:
    """One pass of Pillow's resample along axis 0: for 8-bit samples the
    weights in fixed point (`normalize_coeffs_8bpc`) and an integer sum,
    for 16-bit gray (modes I;16, I;16B) a double sum rounded half up, each
    byte clipped as Pillow stores it, for modes I (int32) and F (float32) a
    double sum, rounded half away from zero for I (ROUND_UP), cast to
    float32 for F."""
    xmin, w = _pil_bilinear_weights(img.shape[0], n_out)
    src = np.minimum(xmin[:, None] + np.arange(w.shape[1])[None, :], img.shape[0] - 1)  # zero weight past the end
    shape = (-1,) + (1,) * (img.ndim - 1)
    if img.dtype in (np.uint16, np.int32, np.float32):
        acc = np.zeros((n_out,) + img.shape[1:])
        for x in range(w.shape[1]):
            acc += img[src[:, x]] * w[:, x].reshape(shape)
        if img.dtype == np.float32:
            return acc.astype(np.float32)
        v = np.where(acc >= 0, np.floor(acc + 0.5), -np.floor(np.abs(acc) + 0.5)).astype(np.int64)
        if img.dtype == np.int32:
            return v.astype(np.int32)
        return (np.minimum(v >> 8, 255) << 8 | (v & 255)).astype(np.uint16)  # each byte clipped, as Pillow stores it
    k = np.where(w < 0, np.trunc(-0.5 + w * (1 << _PRECISION_BITS)), np.trunc(0.5 + w * (1 << _PRECISION_BITS)))
    k = k.astype(np.int64)
    acc = np.full((n_out,) + img.shape[1:], 1 << (_PRECISION_BITS - 1), np.int64)
    for x in range(k.shape[1]):
        acc += img[src[:, x]].astype(np.int64) * k[:, x].reshape(shape)
    return np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)


def pil_resize_bilinear(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """PIL's `Image.fromarray(img).resize((out_w, out_h), BILINEAR)` of an
    8-bit (h, w) or (h, w, c) image, each channel on its own, or of a
    16-bit gray (mode I;16 or I;16B), int32 (mode I) or float32 (mode F)
    (h, w) image: a horizontal pass into rows of the image's type, then a
    vertical pass, each a triangle filter; the same size is a copy."""
    out = np.asarray(img)
    if not (out.dtype == np.uint8 or (out.dtype in (np.uint16, np.int32, np.float32) and out.ndim == 2)):
        raise ValueError(f"pil_resize_bilinear takes uint8 images or uint16, int32 or float32 (h, w), "
                         f"got {out.dtype} {out.shape}")
    h, w = out.shape[:2]
    if w != out_w:
        out = _pil_resample_axis0(out.swapaxes(0, 1), out_w).swapaxes(0, 1)
    if h != out_h:
        out = _pil_resample_axis0(out, out_h)
    return np.ascontiguousarray(out)


def pil_premultiply(img: np.ndarray) -> np.ndarray:
    """PIL's `convert("RGBa")` of RGBA and `convert("La")` of gray+alpha
    (h, w, 2): each colour sample times alpha / 255, rounded as Pillow's
    MULDIV255 rounds it; alpha as it is."""
    a = img[..., -1:].astype(np.int32)
    return np.concatenate([_muldiv255(img[..., :-1].astype(np.int32), a).astype(np.uint8), img[..., -1:]], -1)


def pil_unpremultiply(img: np.ndarray) -> np.ndarray:
    """PIL's `convert("RGBA")` of RGBa and `convert("LA")` of La: each colour
    sample times 255 / alpha, truncated and clipped at 255; where alpha is 0
    or 255 the sample stays as it is."""
    a = img[..., -1:].astype(np.int32)
    c = img[..., :-1].astype(np.int32)
    c = np.where((a == 0) | (a == 255), c, np.minimum(255 * c // np.maximum(a, 1), 255))
    return np.concatenate([c.astype(np.uint8), img[..., -1:]], -1)


def _pil_nearest_index(n_in: int, n_out: int) -> np.ndarray:
    """Pillow's nearest-neighbour source index of each output pixel on one
    axis (`ImagingScaleAffine`): the coordinate starts at half the step and
    grows by the step (in_size / out_size, double) one addition at a time;
    the last one, n_in - step / 2 give or take the additions' rounding, lies
    inside the image."""
    step = n_in / n_out
    coords = np.empty(n_out)
    c = step * 0.5
    for o in range(n_out):
        coords[o] = c
        c += step
    return coords.astype(np.int64)


def pil_resize_nearest(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """PIL's `resize((out_w, out_h), NEAREST)` (what `resize` does to modes
    P and 1 whatever filter is asked for) of an (h, w) or (h, w, c) image."""
    h, w = img.shape[:2]
    return np.ascontiguousarray(img[_pil_nearest_index(h, out_h)[:, None], _pil_nearest_index(w, out_w)[None, :]])


def canvas_input(img) -> np.ndarray:
    """The uint8 gray (h, w) or RGB (h, w, 3) image that the canvas pass
    takes, as the JAX package's `_load_raw` hands it over: modes 1, I, I;16
    and F gray through `convert("L")` (`pil_uint8`); every other mode but L
    and RGB through `convert("RGB")`: 16-bit colour as its high bytes,
    I;16B clipped and replicated, P through its palette, gray+alpha and
    RGBA with alpha dropped, CMYK through `pil_rgb`; gray and RGB as they
    are."""
    if isinstance(img, ModeImage) and img.mode == "I;16B":
        return pil_rgb(pil_uint8(img))
    img = pil_uint8(img)
    if isinstance(img, CmykImage) or (img.ndim == 3 and img.shape[2] != 3):
        return pil_rgb(img)
    return img


def _luma(img: np.ndarray) -> np.ndarray:
    """float32 ITU-R 601 luma of `canvas_input`'s image, as canvas.cpp
    computes it: (0.299 r + 0.587 g) + 0.114 b."""
    if img.ndim == 2:
        return img.astype(np.float32)
    r, g, b = (img[..., i].astype(np.float32) for i in range(3))
    return (np.float32(0.299) * r + np.float32(0.587) * g) + np.float32(0.114) * b


def _area_taps(n_in: int, n_out: int, s: np.float32):
    """Each output cell's footprint [o s, (o + 1) s) on one axis, as
    canvas.cpp computes it: input pixel (n_out, k), overlap (n_out, k)
    float32, and whether the tap is summed (inside the footprint, overlap
    above 0), k the widest footprint."""
    o = np.arange(n_out, dtype=np.float32)
    lo, hi = o * s, (o + 1) * s
    first = np.maximum(np.floor(lo).astype(np.int64), 0)
    count = np.maximum(np.minimum(np.ceil(hi).astype(np.int64), n_in) - first, 0)
    t = np.arange(int(count.max()))[None, :]
    i = first[:, None] + t
    fi = i.astype(np.float32)
    w = np.minimum(fi + 1, hi[:, None]) - np.maximum(fi, lo[:, None])
    return np.minimum(i, n_in - 1), w, (t < count[:, None]) & (w > 0)


def _bilinear_taps(n_in: int, n_out: int, s: np.float32):
    c = (np.arange(n_out, dtype=np.float32) + np.float32(0.5)) * s - np.float32(0.5)
    c = np.minimum(np.maximum(c, np.float32(0)), np.float32(n_in - 1))
    i0 = c.astype(np.int64)
    f = c - i0.astype(np.float32)
    return i0, np.minimum(i0 + 1, n_in - 1), f, np.float32(1) - f


def gray_resize(img, out_h: int, out_w: int) -> np.ndarray:
    """The plain version of the canvas pass (data/native.py): luma of
    `canvas_input(img)`, resized to (out_h, out_w), rounded to uint8, with
    canvas.cpp's float32 arithmetic in its order, vectorised over the
    outputs. An area average sums each output's footprint one tap at a time,
    rows outer; bit-equal to the library. Used by the tests and the card's
    smoke test, not on the run path."""
    gray = _luma(canvas_input(img))
    in_h, in_w = gray.shape
    sy = np.float32(in_h) / np.float32(out_h)
    sx = np.float32(in_w) / np.float32(out_w)
    if sy >= 1 and sx >= 1:
        ry, wy, uy = _area_taps(in_h, out_h, sy)
        rx, wx, ux = _area_taps(in_w, out_w, sx)
        total = np.zeros((out_h, out_w), np.float32)
        weight = np.zeros((out_h, out_w), np.float32)
        for t in range(ry.shape[1]):
            rows, wyt = gray[ry[:, t]], wy[:, t, None]
            for u in range(rx.shape[1]):
                use = uy[:, t, None] & ux[None, :, u]
                wxu = wx[None, :, u]
                total = np.where(use, total + rows[:, rx[:, u]] * wyt * wxu, total)
                weight = np.where(use, weight + wyt * wxu, weight)
        v = np.where(weight > 0, total / np.where(weight > 0, weight, np.float32(1)), np.float32(0))
    else:
        y0, y1, fy, gy = _bilinear_taps(in_h, out_h, sy)
        x0, x1, fx, gx = _bilinear_taps(in_w, out_w, sx)
        fy, gy, r0, r1 = fy[:, None], gy[:, None], gray[y0], gray[y1]
        v = r0[:, x0] * gy * gx + r0[:, x1] * gy * fx + r1[:, x0] * fy * gx + r1[:, x1] * fy * fx
    return np.minimum(np.maximum(v + np.float32(0.5), np.float32(0)), np.float32(255)).astype(np.uint8)


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
    # a subset made without copying its canvases (SceneData.subset with
    # copy_canvases=False): `canvases` is an all-zero stub of no memory and
    # the content is root[root_indices]; read it through `content`
    root: np.ndarray | None = None
    root_indices: np.ndarray | None = None

    @property
    def canvas_hw(self) -> tuple[int, int]:
        return self.canvases.shape[1], self.canvases.shape[2]

    def content(self, idx=None) -> np.ndarray:
        """The canvases, or those of frames `idx`, read through the root
        canvases when this is a stub."""
        if self.root is None:
            return self.canvases if idx is None else self.canvases[idx]
        return self.root[self.root_indices if idx is None else self.root_indices[idx]]


CACHE_MAX_BYTES = 4 << 30  # the decode cache's bound: 4 GiB, least recently used entries evicted first
_CACHE_ARRAYS = ("canvases", "sizes", "orig_sizes", "scale_factors")


def _cache_key(paths: list[str], short_size: int, canvas_hw) -> str:
    """The JAX package's content key: each file's path, size and mtime_ns,
    and the decode parameters; no image is read."""
    h = hashlib.sha1()
    h.update(f"{short_size}|{canvas_hw}|v1".encode())
    for p in paths:
        st = os.stat(p)
        h.update(f"{p}|{st.st_size}|{st.st_mtime_ns}\n".encode())
    return h.hexdigest()


def _trusted_cache_dir(cache_dir) -> Path | None:
    """The cache directory, created with mode 0700, when it is a real
    directory owned by the current user and not group- or world-writable;
    None (and a warning) otherwise, and the caller decodes without it."""
    d = Path(cache_dir)
    try:
        d.mkdir(mode=0o700, parents=True, exist_ok=True)
        st = os.lstat(d)
    except OSError as exc:
        _logger.warning("Decode cache %s unusable (%s); decoding without it.", d, exc)
        return None
    if not stat.S_ISDIR(st.st_mode) or st.st_uid != os.getuid() or st.st_mode & 0o022:
        _logger.warning("Decode cache %s is not a directory owned by this user and writable only by it; "
                        "decoding without it.", d)
        return None
    return d


def _entry_bytes(entry: Path) -> int:
    return sum(f.stat().st_size for f in entry.iterdir())


def _cache_load(d: Path, key: str, n: int) -> "DecodedImages | None":
    entry = d / key
    if not (entry / "ok").exists():
        return None
    try:
        # copy-on-write maps: the arrays are writable and the files stay as they are
        arrays = {k: np.load(entry / f"{k}.npy", mmap_mode="c") for k in _CACHE_ARRAYS}
        os.utime(entry)  # most recently used
    except (OSError, ValueError):
        return None  # a damaged entry decodes anew
    if len(arrays["canvases"]) != n:
        return None
    return DecodedImages(**arrays)


def _cache_store(d: Path, key: str, imgs: "DecodedImages") -> None:
    """Publish an entry atomically (written under a temporary name, then
    renamed), then evict the least recently used entries while the cache is
    over CACHE_MAX_BYTES. An entry larger than the bound is not stored."""
    max_bytes = CACHE_MAX_BYTES
    size = sum(getattr(imgs, k).nbytes for k in _CACHE_ARRAYS)
    if size > max_bytes:
        return
    tmp = Path(tempfile.mkdtemp(dir=d, prefix=f".{key[:12]}_"))
    try:
        for k in _CACHE_ARRAYS:
            np.save(tmp / f"{k}.npy", getattr(imgs, k))
        (tmp / "ok").touch()
        os.replace(tmp, d / key)
    except OSError:
        shutil.rmtree(tmp, ignore_errors=True)  # e.g. another process published the same key first
        return
    entries = []
    for e in d.iterdir():
        if not e.name.startswith(".") and (e / "ok").exists():
            entries.append((e.stat().st_mtime_ns, e, _entry_bytes(e)))
    total = sum(b for _, _, b in entries)
    for _, e, b in sorted(entries, key=lambda t: t[0]):
        if total <= max_bytes:
            break
        if e.name != key:
            shutil.rmtree(e, ignore_errors=True)
            total -= b


def decode_to_canvas(
    paths: list[str],
    short_size: int = 480,
    canvas_hw: tuple[int, int] | None = None,
    num_workers: int = 16,
    cache_dir=None,
) -> DecodedImages:
    """Decode all images (any file `read_image` reads) and centre them on one shared canvas
    (by default the largest resized extent, rounded up to a multiple of 8);
    at most `num_workers` decoded images are held at once. With `cache_dir`
    the canvases are read from, or written to, the decode cache (module
    note); a cache that cannot be trusted or used is skipped."""
    d = key = None
    if cache_dir is not None:
        d = _trusted_cache_dir(cache_dir)
        if d is not None:
            try:
                key = _cache_key(paths, short_size, canvas_hw)
            except OSError:
                d = None
    if d is not None:
        cached = _cache_load(d, key, len(paths))
        if cached is not None:
            return cached

    orig_sizes = np.array([image_size(p)[::-1] for p in paths], np.int32).reshape(-1, 2)  # (h, w) from headers
    scales = short_size / orig_sizes.min(axis=1).astype(np.float32)
    sizes = np.round(orig_sizes * scales[:, None]).astype(np.int32)
    if canvas_hw is None:
        hc = _round_up(int(sizes[:, 0].max()), 8)
        wc = _round_up(int(sizes[:, 1].max()), 8)
    else:
        hc, wc = canvas_hw
    # Content larger than the canvas sends the whole set down the JAX
    # package's PIL path: PIL's luma, a BILINEAR resize to sizes rounded
    # from a float64 scale, and a centre crop to the canvas (`sizes` become
    # the cropped extents).
    oversize = bool((sizes[:, 0] > hc).any() or (sizes[:, 1] > wc).any())
    if oversize:
        scale64 = [short_size / min(int(h0), int(w0)) for h0, w0 in orig_sizes]
        scales = np.array(scale64, np.float32)
        sizes = np.array([(round(int(h0) * s), round(int(w0) * s)) for (h0, w0), s in zip(orig_sizes, scale64)],
                         np.int32).reshape(-1, 2)

    canvases = np.zeros((len(paths), hc, wc), np.uint8)

    def place(i):  # decode, resize and place one image; its pixels are dropped on return
        raw = read_image(paths[i])
        if raw.shape[:2] != tuple(orig_sizes[i]):
            raise ValueError(f"{paths[i]}: decoded {raw.shape[:2]}, its header says {tuple(orig_sizes[i])}")
        h, w = (int(s) for s in sizes[i])
        if oversize:
            if isinstance(raw, ModeImage) and raw.mode == "L" and raw.palette is not None:
                # convert("L") copies it as mode P, which resize takes NEAREST
                img = pil_resize_nearest(raw.pixels, h, w)
            else:
                img = pil_resize_bilinear(pil_luma_u8(raw), h, w)
            top, left = max(0, (h - hc) // 2), max(0, (w - wc) // 2)
            img = img[top : top + min(h, hc), left : left + min(w, wc)]
            h, w = img.shape
            sizes[i] = (h, w)
            y0, x0 = (hc - h) // 2, (wc - w) // 2
            canvases[i, y0 : y0 + h, x0 : x0 + w] = img
        else:
            native.gray_resize_center(canvas_input(raw), canvases[i], h, w, paths[i])

    with _futures.ThreadPoolExecutor(max_workers=max(1, num_workers)) as ex:
        list(ex.map(place, range(len(paths))))
    out = DecodedImages(canvases=canvases, sizes=sizes, orig_sizes=orig_sizes, scale_factors=scales)
    if d is not None:
        _cache_store(d, key, out)
    return out


def heuristic_focal_length(orig_h: int, orig_w: int) -> float:
    """70% of the image diagonal, in original pixels."""
    return math.sqrt(orig_h**2 + orig_w**2) * 0.7
