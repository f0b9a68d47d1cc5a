#!/usr/bin/env python3
"""Write the TIFF, BMP and Netpbm/PFM fixtures that hold the port's
decoders to PIL's where there is no PIL (the card's machine): small files
under tests/data/formats/, one for each kind the port reads, and
tests/data/formats/pil_digests.json with

- "files": for each fixture, PIL's mode, the shape, dtype and sha256 of
  `np.asarray(Image.open(path))`, and the sha256 of its `convert("RGB")`;
- "canvas": for each of CANVAS_CHECKS, the digest (chip_smoke.canvas_digest)
  of the JAX package's decode_to_canvas over every image fixture;
- "depth": for each depth fixture (DEPTH), the sha256 of the JAX package's
  `load_depth_file` (float64).

    python3 scripts/make_format_fixtures.py

PIL writes the kinds Pillow's `save` writes (uncompressed, LZW, Deflate,
PackBits and JPEG TIFFs, BMP, binary PNM, PFM). Numpy writers make the
others: `tiff_bytes` of scripts/tiff_encode.py (any byte order, strips or
tiles, planar 1 or 2, PackBits, LZW or Deflate, predictors 2 and 3, fill
order 2, palettes, orientation), and below `bmp_bytes` (OS/2 v1, V4/V5,
top-down, bitfields, RLE8 and RLE4, delta escapes, gray palettes of any
size) and `pnm_bytes` (the plain formats, any maxval, PFM of either byte
order, Pillow's own kinds). Their bytes are nobody's in particular; PIL
decodes them. The
tests import this module to make more such files.

tests/test_torch_formats.py checks the digests against PIL and the JAX
package on every run, so the file cannot go stale; chip_smoke.py's phase
formats checks the port against them on the card.
"""

from __future__ import annotations

import io
import json
import struct
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402
from tiff_encode import lzw_encode, packbits_encode, tiff_bytes  # noqa: E402,F401

OUT = chip_smoke.FORMAT_FIXTURES

# ---------------------------------------------------------------- TIFF


def pil_tiff(arr: np.ndarray, mode: str | None = None, **opts) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    img = Image.fromarray(arr) if mode is None else Image.fromarray(arr).convert(mode)
    img.save(buf, format="TIFF", **opts)
    return buf.getvalue()


# ---------------------------------------------------------------- BMP


def rle_encode(rows: np.ndarray, rle4: bool) -> bytes:
    """RLE8 / RLE4 of (h, w) indices, rows bottom-up: encoded runs of equal
    pixels, absolute runs (3 or more pixels, word-aligned) of the rest, an
    end of line after each row and an end of bitmap."""
    out = bytearray()
    for row in rows[::-1]:
        row = [int(v) for v in row]
        i, n = 0, len(row)
        while i < n:
            j = i
            while j < n and j - i < 255 and row[j] == row[i]:
                j += 1
            if j - i >= 2 or n - i < 3:
                count = j - i if j - i >= 2 else 1
                out += bytes([count, (row[i] << 4 | row[i]) if rle4 else row[i]])
                i += count
                continue
            j = i
            while j < n and j - i < 254 and not (j + 1 < n and row[j] == row[j + 1]):
                j += 1
            count = j - i
            if rle4 and count % 2:  # Pillow reads count // 2 bytes of an RLE4 absolute run
                count -= 1
            if count < 3:
                out += bytes([1, (row[i] << 4 | row[i]) if rle4 else row[i]])
                i += 1
                continue
            run = row[i: i + count]
            if rle4:
                body = bytes((run[k] << 4) | run[k + 1] for k in range(0, count, 2))
            else:
                body = bytes(run)
            out += bytes([0, count]) + body
            if len(body) % 2:
                out += b"\x00"
            i += count
        out += b"\x00\x00"
    return bytes(out + b"\x00\x01")


def rle_with_deltas(rows: np.ndarray, rle4: bool, every: int = 3) -> bytes:
    """RLE8 / RLE4 of (h, w) indices, rows bottom-up as `rle_encode` writes
    them, but every `every`-th row ends in a delta escape in place of its
    end of line: 00 02, two bytes Pillow skips, and (right, up) = (3, k % 2)
    that it reads after them."""
    out = bytearray()
    for k, row in enumerate(rows[::-1]):
        seg = rle_encode(row[None, :], rle4)[:-2]  # the row and its end of line
        if k % every == every - 1:
            seg = seg[:-2] + bytes([0, 2, 0, 0, 3, k % 2])
        out += seg
    return bytes(out + b"\x00\x01")


def bmp_bytes(pixels: np.ndarray, *, bits: int, header: int = 40, palette=None, compression: int = 0,
              masks=None, top_down: bool = False, rle: bytes | None = None) -> bytes:
    """A BMP of `pixels`: (h, w) indices for 1, 4 and 8 bits (`palette` (n,
    3) RGB), (h, w) uint16 words for 16, (h, w, 3) BGR or (h, w, 4) bytes
    for 24 and 32 as they are stored. `header` 12 (OS/2 v1), 40, 108 (V4)
    or 124 (V5); `masks` the bitfields of compression 3; `rle` the RLE data
    of compression 1 or 2 as it is (else `rle_encode`'s)."""
    h, w = pixels.shape[:2]
    if compression in (1, 2):
        data = rle if rle is not None else rle_encode(pixels, compression == 2)
    else:
        stride = ((w * bits + 31) >> 3) & ~3
        if bits < 8:
            per = 8 // bits
            cols = -(-w // per) * per
            padded = np.zeros((h, cols), np.uint8)
            padded[:, :w] = pixels
            shifts = (8 - bits * (1 + np.arange(per))).astype(np.uint8)
            rows = (padded.reshape(h, -1, per) << shifts).sum(-1).astype(np.uint8)
        elif bits == 16:
            rows = pixels.astype("<u2").view(np.uint8).reshape(h, -1)
        else:
            rows = pixels.astype(np.uint8).reshape(h, -1)
        body = np.zeros((h, stride), np.uint8)
        body[:, : rows.shape[1]] = rows
        data = (body if top_down else body[::-1]).tobytes()
    pal = b""
    if palette is not None:
        pad = b"" if header == 12 else b"\x00"
        pal = b"".join(bytes([b, g, r]) + pad for r, g, b in np.asarray(palette, np.uint8))
    if header == 12:
        info = struct.pack("<IHHHH", 12, w, h, 1, bits)
    else:
        n_colors = 0 if palette is None else len(palette)
        info = struct.pack("<IiiHHIIiiII", header, w, -h if top_down else h, 1, bits, compression, len(data),
                           2835, 2835, n_colors, 0)
        if header >= 108:
            m = (list(masks) + [0] * 4)[:4] if masks else [0] * 4
            info += struct.pack("<4I", *m) + b"BGRs" + b"\x00" * (header - 56)
        elif masks is not None:  # BITMAPINFOHEADER: the three masks follow it
            info += struct.pack("<3I", *masks[:3])
    offset = 14 + len(info) + len(pal)
    return b"BM" + struct.pack("<IHHI", offset + len(data), 0, 0, offset) + info + pal + data


# ---------------------------------------------------------------- Netpbm and PFM


def pnm_bytes(magic: str, pixels: np.ndarray, maxval: int = 255, scale: float = -1.0, comment: bool = True) -> bytes:
    """A Netpbm file of `pixels` (values as stored; booleans 1 = black for
    P1/P4) under `magic` (P1-P6, Pf), with a comment in the header."""
    h, w = pixels.shape[:2]
    head = magic.encode() + (b"\n# written by scripts/make_format_fixtures.py\n" if comment else b"\n")
    head += b"%d %d\n" % (w, h)
    if magic in ("P1", "P4"):
        if magic == "P1":
            rows = [" ".join("1" if v else "0" for v in row) for row in pixels]
            return head + ("\n".join(rows) + "\n").encode()
        return head + np.packbits(pixels.astype(bool), axis=1).tobytes()
    if magic == "Pf":
        e = "<" if scale < 0 else ">"
        return head + (b"%r\n" % scale) + np.ascontiguousarray(pixels[::-1], f"{e}f4").tobytes()
    head += b"%d\n" % maxval
    if magic in ("P2", "P3"):
        vals = pixels.reshape(h, -1)
        return head + ("\n".join(" ".join(str(int(v)) for v in row) for row in vals) + "\n").encode()
    dt = np.uint8 if maxval < 256 else np.dtype(">u2")
    return head + np.ascontiguousarray(pixels, dt).tobytes()


# ---------------------------------------------------------------- the fixtures


def _rgb(h: int, w: int, seed: int) -> np.ndarray:
    """A smooth ramp plus noise, from a seed."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w]
    base = np.stack([xx * 255 / max(w - 1, 1), yy * 255 / max(h - 1, 1), (xx + yy) * 127 / max(h + w - 2, 1)], -1)
    return np.clip(base + rng.normal(0, 20, (h, w, 3)), 0, 255).astype(np.uint8)


def _gray(h: int, w: int, seed: int) -> np.ndarray:
    return _rgb(h, w, seed)[..., 1]


def _alpha(h: int, w: int) -> np.ndarray:
    yy, xx = np.mgrid[:h, :w]
    return np.clip((xx * 7 + yy * 13) % 383 - 64, 0, 255).astype(np.uint8)


def _depth_mm(h: int, w: int, seed: int) -> np.ndarray:
    """A depth map in millimetres: a slanted plane plus noise, 800-4,500."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w]
    return np.clip(1500 + xx * 40 + yy * 25 + rng.normal(0, 30, (h, w)), 800, 4500).astype(np.uint16)


def _premultiplied(rgba: np.ndarray) -> np.ndarray:
    a = rgba[..., 3:].astype(np.int32)
    return np.concatenate([(rgba[..., :3] * a // 255).astype(np.uint8), rgba[..., 3:]], -1)


H, W = 29, 37  # odd sizes: partial tiles, short last strips, padded BMP rows
PALETTE = [(i * 37 % 256, i * 91 % 256, 255 - i * 16) for i in range(16)]
COLORMAP16 = [c * 257 for ch in zip(*PALETTE) for c in ch]  # 16 entries, 16-bit R, G, B
COLORMAP256 = [c * 256 for ch in zip(*[(i, 255 - i, i * 7 % 256) for i in range(256)]) for c in ch]


def _fixtures() -> dict:
    """name -> a callable giving the file's bytes."""
    rgb, gray = _rgb(H, W, 1), _gray(H, W, 2)
    rgba = np.concatenate([_rgb(H, W, 3), _alpha(H, W)[..., None]], -1)
    idx16 = ((np.mgrid[:H, :W][1] // 3 + np.mgrid[:H, :W][0] // 2) % 16).astype(np.uint8)
    bilevel = (np.mgrid[:H, :W][1] // 3 + np.mgrid[:H, :W][0] // 4) % 3 == 0
    depth = _depth_mm(H, W, 4)
    rgb16 = rgb.astype(np.uint16) * 257 + np.arange(W, dtype=np.uint16)[None, :, None]
    f32 = (depth.astype(np.float32) / 7.3 - 40.5).astype(np.float32)  # gray levels with fractions, some clipped
    i32 = depth.astype(np.int32) * 3 - 4000
    cmyk = np.concatenate([255 - rgb, _alpha(H, W)[..., None] // 2], -1)
    t = tiff_bytes
    return {
        # TIFF: PIL's own writer and libtiff's (through Pillow)
        "rgb_raw.tif": lambda: pil_tiff(rgb),
        "rgb_lzw.tif": lambda: pil_tiff(rgb, compression="tiff_lzw"),
        "rgb_deflate.tif": lambda: pil_tiff(rgb, compression="tiff_adobe_deflate"),
        "rgb_packbits.tif": lambda: pil_tiff(rgb, compression="packbits"),
        "rgb_jpeg.tif": lambda: pil_tiff(_rgb(40, 48, 5), compression="jpeg", quality=90),
        "gray_jpeg.tif": lambda: pil_tiff(_gray(40, 48, 6), compression="jpeg"),
        "gray_raw.tif": lambda: pil_tiff(gray),
        "rgba_raw.tif": lambda: pil_tiff(rgba),
        "la_deflate.tif": lambda: pil_tiff(np.stack([gray, _alpha(H, W)], -1), "LA", compression="tiff_adobe_deflate"),
        "bilevel_raw.tif": lambda: pil_tiff(bilevel, "1"),
        "cmyk_lzw.tif": lambda: pil_tiff(cmyk, "CMYK", compression="tiff_lzw"),
        "depth16_raw.tif": lambda: pil_tiff(depth),
        "depth16_lzw.tif": lambda: pil_tiff(depth, compression="tiff_lzw"),
        "depth16_mm_raw.tif": lambda: t(depth, bits=(16,), photometric=1, big=True, rows_per_strip=9),
        "float_raw.tif": lambda: pil_tiff(f32),
        "int32_deflate.tif": lambda: pil_tiff(i32, compression="tiff_adobe_deflate"),
        # TIFF: the numpy writer
        "rgb_mm_lzw_pred2.tif": lambda: t(rgb, bits=(8,) * 3, photometric=2, big=True, compression=5, predictor=2,
                                          rows_per_strip=4),
        "rgb_tiled_deflate_pred2.tif": lambda: t(rgb, bits=(8,) * 3, photometric=2, compression=8, predictor=2,
                                                 tile=(16, 16)),
        "rgb_planar_packbits.tif": lambda: t(rgb, bits=(8,) * 3, photometric=2, planar=2, compression=32773,
                                             rows_per_strip=7),
        "rgb_planar_raw_mm.tif": lambda: t(rgb, bits=(8,) * 3, photometric=2, planar=2, big=True, rows_per_strip=5),
        "rgb_tiled_planar_lzw.tif": lambda: t(rgb, bits=(8,) * 3, photometric=2, planar=2, compression=5,
                                              tile=(16, 32)),
        "rgb_raw_tiled.tif": lambda: t(rgb, bits=(8,) * 3, photometric=2, tile=(32, 16)),
        "rgb_fill2_lzw.tif": lambda: t(rgb, bits=(8,) * 3, photometric=2, compression=5, fillorder=2,
                                       rows_per_strip=9),
        "rgb16_deflate_pred2.tif": lambda: t(rgb16, bits=(16,) * 3, photometric=2, compression=32946, predictor=2,
                                             rows_per_strip=6),
        "rgb16_mm_raw.tif": lambda: t(rgb16, bits=(16,) * 3, photometric=2, big=True),
        "rgba_assoc_lzw.tif": lambda: t(_premultiplied(rgba), bits=(8,) * 4, photometric=2, extra=(1,),
                                        compression=5),
        "rgba_unassoc_tiled.tif": lambda: t(rgba, bits=(8,) * 4, photometric=2, extra=(2,), tile=(16, 16),
                                            compression=32773),
        "rgbx_raw.tif": lambda: t(rgba, bits=(8,) * 4, photometric=2, extra=(0,)),
        "gray_miniswhite_lzw.tif": lambda: t(gray, bits=(8,), photometric=0, compression=5, rows_per_strip=10),
        "gray4_raw.tif": lambda: t(gray >> 4, bits=(4,), photometric=1, rows_per_strip=8),
        "gray2_miniswhite.tif": lambda: t(gray >> 6, bits=(2,), photometric=0),
        "bilevel_miniswhite_packbits.tif": lambda: t(bilevel.astype(np.uint8), bits=(1,), photometric=0,
                                                     compression=32773, rows_per_strip=11),
        "bilevel_fill2_raw.tif": lambda: t(bilevel.astype(np.uint8), bits=(1,), photometric=1, fillorder=2),
        "palette4_lzw.tif": lambda: t(idx16, bits=(4,), photometric=3, compression=5, colormap=COLORMAP16),
        "palette8_tiled.tif": lambda: t(gray, bits=(8,), photometric=3, tile=(16, 16), colormap=COLORMAP256),
        "depth16_mm_deflate_pred2.tif": lambda: t(depth, bits=(16,), photometric=1, big=True, compression=8,
                                                  predictor=2, rows_per_strip=8),
        "depth16s_raw.tif": lambda: t(depth.astype(np.int16) - 2000, bits=(16,), photometric=1, sample_format=(2,)),
        "float_pred3_deflate.tif": lambda: t(f32, bits=(32,), photometric=1, sample_format=(3,), compression=8,
                                             predictor=3, rows_per_strip=10),
        "float_pred3_lzw_tiled.tif": lambda: t(f32, bits=(32,), photometric=1, sample_format=(3,), compression=5,
                                               predictor=3, tile=(16, 16)),
        "float_mm_raw.tif": lambda: t(f32, bits=(32,), photometric=1, big=True, sample_format=(3,),
                                      rows_per_strip=7),
        "cmyk16_raw.tif": lambda: t(cmyk.astype(np.uint16) * 257, bits=(16,) * 4, photometric=5),
        "rgb_orient6.tif": lambda: t(rgb, bits=(8,) * 3, photometric=2, orientation=6, compression=5),
        "gray_orient3_tiled.tif": lambda: t(gray, bits=(8,), photometric=1, orientation=3, tile=(16, 16)),
        # BMP
        "rgb24.bmp": lambda: _pil_save(rgb, "BMP"),
        "gray8.bmp": lambda: _pil_save(gray, "BMP"),
        "bilevel.bmp": lambda: _pil_save(bilevel, "BMP", "1"),
        "palette8.bmp": lambda: _pil_save(idx16, "BMP", "P", palette=PALETTE),
        "palette4.bmp": lambda: bmp_bytes(idx16, bits=4, palette=PALETTE),
        "palette1.bmp": lambda: bmp_bytes(bilevel.astype(np.uint8), bits=1, palette=PALETTE[3:5]),
        "os2v1_palette8.bmp": lambda: bmp_bytes(idx16, bits=8, header=12, palette=PALETTE),
        "os2v1_rgb24.bmp": lambda: bmp_bytes(rgb[..., ::-1], bits=24, header=12),
        "topdown_rgb24.bmp": lambda: bmp_bytes(rgb[..., ::-1], bits=24, top_down=True),
        "rgb555.bmp": lambda: bmp_bytes(_words555(rgb), bits=16),
        "rgb565_bitfields.bmp": lambda: bmp_bytes(_words565(rgb), bits=16, compression=3,
                                                  masks=(0xF800, 0x7E0, 0x1F)),
        "bgrx32.bmp": lambda: bmp_bytes(np.concatenate([rgb[..., ::-1], _alpha(H, W)[..., None]], -1), bits=32),
        "bgra32_v5.bmp": lambda: bmp_bytes(np.concatenate([rgba[..., 2::-1], rgba[..., 3:]], -1), bits=32,
                                           header=124, compression=3, masks=(0xFF0000, 0xFF00, 0xFF, 0xFF000000)),
        "rgb24_v4.bmp": lambda: bmp_bytes(rgb[..., ::-1], bits=24, header=108),
        "rle8.bmp": lambda: bmp_bytes(_runs(idx16), bits=8, compression=1, palette=PALETTE),
        "rle4.bmp": lambda: bmp_bytes(_runs(idx16), bits=4, compression=2, palette=PALETTE),
        "rle8_gray.bmp": lambda: bmp_bytes(_runs(gray // 64 * 64), bits=8, compression=1,
                                           palette=[(i, i, i) for i in range(256)]),
        "rle8_delta.bmp": lambda: bmp_bytes(idx16, bits=8, compression=1, palette=PALETTE,
                                            rle=rle_with_deltas(_runs(idx16), False)),
        "rle4_delta.bmp": lambda: bmp_bytes(idx16, bits=4, compression=2, palette=PALETTE,
                                            rle=rle_with_deltas(_runs(idx16), True, every=4)),
        # gray palettes PIL reads at the new mode's rawmode whatever the bit
        # depth: 16 levels of 4 bits as L (a byte a pixel, rows mapped from the
        # file 20 bytes apart), 2 levels of 8 bits as 1 (a bit a pixel), 4
        # levels of 1 bit as L
        "gray4_palette.bmp": lambda: bmp_bytes(gray >> 4, bits=4, palette=[(i, i, i) for i in range(16)]),
        "gray8_two_levels.bmp": lambda: bmp_bytes(bilevel.astype(np.uint8), bits=8, palette=[(0, 0, 0), (255,) * 3]),
        "gray1_four_levels.bmp": lambda: bmp_bytes(bilevel.astype(np.uint8), bits=1,
                                                   palette=[(i, i, i) for i in range(4)]),
        # Netpbm and PFM
        "bilevel_plain.pbm": lambda: pnm_bytes("P1", bilevel),
        "bilevel.pbm": lambda: _pil_save(bilevel, "PPM", "1"),
        "gray_plain.pgm": lambda: pnm_bytes("P2", gray),
        "gray.pgm": lambda: _pil_save(gray, "PPM"),
        "gray_maxval100.pgm": lambda: pnm_bytes("P5", (gray.astype(np.int32) * 100 // 255).astype(np.uint8), 100),
        "depth16.pgm": lambda: _pil_save(depth.astype(np.int32), "PPM"),
        "depth_maxval4095.pgm": lambda: pnm_bytes("P5", (depth // 2).astype(np.uint16), 4095),
        "depth_plain_maxval5000.pgm": lambda: pnm_bytes("P2", depth, 5000),
        "rgb_plain.ppm": lambda: pnm_bytes("P3", rgb),
        "rgb.ppm": lambda: _pil_save(rgb, "PPM"),
        "rgb_maxval1023.ppm": lambda: pnm_bytes("P6", rgb.astype(np.uint16) * 4, 1023),
        "float_le.pfm": lambda: _pil_save(f32, "PPM"),
        "float_be.pfm": lambda: pnm_bytes("Pf", f32, scale=2.0),
        # Pillow's own PPM kinds
        "cmyk.ppm": lambda: pnm_bytes("P0CMYK", cmyk),
        "pillow_p.ppm": lambda: pnm_bytes("PyP", idx16),
        "pillow_rgba.ppm": lambda: pnm_bytes("PyRGBA", rgba),
        "pillow_cmyk_maxval1000.ppm": lambda: pnm_bytes("PyCMYK", (cmyk.astype(np.uint16) * 4), 1000),
    }


def _pil_save(arr: np.ndarray, fmt: str, mode: str | None = None, palette=None) -> bytes:
    from PIL import Image

    img = Image.fromarray(arr)
    if mode == "P":
        img = Image.fromarray(arr.astype(np.uint8), "L").convert("P")
        img.putpalette([c for rgb in palette for c in rgb])
    elif mode is not None:
        img = img.convert(mode)
    buf = io.BytesIO()
    img.save(buf, format=fmt)
    return buf.getvalue()


def _words555(rgb: np.ndarray) -> np.ndarray:
    r, g, b = (rgb[..., i].astype(np.uint16) >> 3 for i in range(3))
    return (r << 10) | (g << 5) | b


def _words565(rgb: np.ndarray) -> np.ndarray:
    r, b = (rgb[..., i].astype(np.uint16) >> 3 for i in (0, 2))
    g = rgb[..., 1].astype(np.uint16) >> 2
    return (r << 11) | (g << 5) | b


def _runs(idx: np.ndarray) -> np.ndarray:
    """Indices with runs for RLE: each 4 columns share a value, and every
    third row is left as it is (absolute runs)."""
    out = idx.copy()
    out[::3] = np.repeat(out[::3, ::4], 4, axis=1)[:, : idx.shape[1]]
    return out


FIXTURES = _fixtures()
# the fixtures the depth check reads: 16-bit TIFF, float TIFF, PGM, PFM
DEPTH = ("depth16_raw.tif", "depth16_mm_raw.tif", "depth16_mm_deflate_pred2.tif", "float_raw.tif",
         "float_pred3_deflate.tif", "depth16.pgm", "depth_maxval4095.pgm", "float_le.pfm")
# decode_to_canvas over every image fixture: (short side, explicit canvas or None)
CANVAS_CHECKS = ((48, None), (24, (16, 24)))


def fixture_paths() -> list[str]:
    return sorted(str(OUT / name) for name in FIXTURES)


def jax_canvas(short_size: int, canvas_hw) -> str:
    """chip_smoke.canvas_digest of the JAX package's decode_to_canvas over
    every fixture."""
    from acezero_tpu.data import images as jimg

    return chip_smoke.canvas_digest(jimg.decode_to_canvas(fixture_paths(), short_size=short_size,
                                                          canvas_hw=canvas_hw, num_workers=2))


def digests() -> dict:
    from PIL import Image

    from acezero_tpu.data.depth import load_depth_file

    files = {}
    for path in fixture_paths():
        with Image.open(path) as im:
            arr = np.asarray(im)
            files[Path(path).name] = {"mode": im.mode, "shape": list(arr.shape), "dtype": arr.dtype.str,
                                      "sha256": chip_smoke.array_digest(arr),
                                      "rgb_sha256": chip_smoke.array_digest(np.asarray(im.convert("RGB")))}
    canvas = [{"short_size": s, "canvas_hw": None if c is None else list(c), "sha256": jax_canvas(s, c)}
              for s, c in CANVAS_CHECKS]
    depth = {name: chip_smoke.array_digest(load_depth_file(str(OUT / name))) for name in DEPTH}
    return {"files": files, "canvas": canvas, "depth": depth}


def main() -> None:
    OUT.mkdir(parents=True, exist_ok=True)
    for name, make in FIXTURES.items():
        (OUT / name).write_bytes(make())
    (OUT / "pil_digests.json").write_text(json.dumps(digests(), indent=1) + "\n")
    total = sum(p.stat().st_size for p in OUT.iterdir())
    print(f"wrote {len(FIXTURES)} fixtures and pil_digests.json to {OUT} ({total} bytes)")


if __name__ == "__main__":
    main()
