#!/usr/bin/env python3
"""Write the TGA, SGI, PCX, DCX, Sun raster and QOI fixtures that hold the
port's readers (io/tga.py, io/sgi.py, io/pcx.py, io/dcx.py, io/sun.py,
io/qoi.py, io/csrc/raster.cpp) to PIL's where there is no PIL (the card's
machine): small files under tests/data/raster/, and
tests/data/raster/pil_digests.json with

- "files": for each fixture, what PIL makes of it: its mode and size as
  `Image.open` gives them, the shape, dtype and sha256 of
  `np.asarray(Image.open(path))`, the palette (`getpalette()`: its number
  of colours and the sha256 of its bytes), the sha256 of its
  `convert("RGB")` and of its `convert("L")`; where the load raises,
  `"raises": true` beside the mode and size that PIL's open gives;
- "canvas": for each of CANVAS_CHECKS, the digest (chip_smoke.canvas_digest)
  of the JAX package's decode_to_canvas over every fixture PIL decodes;
- "depth": for each of DEPTH, the sha256 of the JAX package's
  `load_depth_file` (float64).

    python3 scripts/make_raster_fixtures.py

PIL writes what Pillow's `save` writes: TGA in each mode raw and
run-length, from the top and from the bottom, with an ID section; PCX in
modes 1, L, P and RGB; QOI in RGB and RGBA (images whose stream uses every
op); SGI in L, RGB and RGBA at 1 and 2 bytes a sample. The writers below
make the rest, each kept only because PIL opens it (`main` checks): TGA
mirrored (descriptor bits 4 and 5), with 16-, 24- and 32-bit colour maps
that start past entry 0, 16-bit colour raw and run-length, literal packets
across rows, a colour map under a gray image, and the kinds PIL opens but
cannot load; SGI run-length at 8 and 16 bits in each mode and verbatim
with 16-bit samples; Sun rasters of depths 1, 4, 8, 24 and 32, each type,
with and without a colour map; a DCX of two PCX pages; PCX of 2 and 4 bit
planes; and a PCX header Pillow gives up on, which PIL then opens as TGA.
Their bytes are nobody's in particular; PIL decodes them. The tests import
this module to make more such files (`tga_bytes`, `sgi_raw_bytes`,
`sgi_rle_bytes`, `depth_mm`).

tests/test_torch_raster.py checks the digests against PIL and the JAX
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

OUT = chip_smoke.RASTER_FIXTURES

# ---------------------------------------------------------------- the images


def photo(h: int, w: int, seed: int) -> np.ndarray:
    """A smooth RGB ramp plus noise, from a seed."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w]
    base = np.stack([xx * 255 / max(w - 1, 1), yy * 255 / max(h - 1, 1), (xx + yy) * 127 / max(h + w - 2, 1)], -1)
    return np.clip(base + rng.normal(0, 20, (h, w, 3)), 0, 255).astype(np.uint8)


def flat(h: int, w: int, seed: int, levels: int = 4) -> np.ndarray:
    """(h, w) uint8 of a few levels in bands, so run-length coders find
    runs."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w]
    base = ((xx // 5 + yy // 3) % levels) * (255 // max(levels - 1, 1))
    return np.where(rng.random((h, w)) < 0.1, rng.integers(0, 256, (h, w)), base).astype(np.uint8)


def alpha(h: int, w: int) -> np.ndarray:
    yy, xx = np.mgrid[:h, :w]
    return np.clip((xx * 9 + yy * 7) % 383 - 64, 0, 255).astype(np.uint8)


def palette(n: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (n, 3)).astype(np.uint8)


def depth_mm(h: int, w: int, seed: int) -> np.ndarray:
    """A depth map in millimetres (uint16, 500-4,500 mm)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w]
    return (500 + xx * 4000 // max(w - 1, 1) + yy * 3 + rng.integers(0, 50, (h, w))).astype(np.uint16)


# ---------------------------------------------------------------- TGA


def tga_bytes(width: int, height: int, body: bytes, *, imagetype: int, depth: int, flags: int = 0,
              id_section: bytes = b"", colormap: tuple[int, bytes, int] | None = None) -> bytes:
    """A TGA: the header, the ID section, the colour map (start, entry
    bytes, entry bits) and `body` as it is."""
    start, entries, mapdepth = colormap or (0, b"", 0)
    count = len(entries) // max(mapdepth // 8, 1) if colormap else 0
    head = bytes([len(id_section), int(colormap is not None), imagetype]) + struct.pack(
        "<HHBHHHHBB", start, count, mapdepth, 0, 0, width, height, depth, flags)
    return head + id_section + entries + body


def tga_packets(pixels: np.ndarray, pixel: int, width: int, seed: int, literal_max: int = 128) -> bytes:
    """Run-length packets of a flat pixel stream ((n * pixel) uint8): runs
    where pixels repeat, never across a row's end (PIL refuses those), and
    literals of random length that do cross rows."""
    rng = np.random.default_rng(seed)
    px = np.asarray(pixels, np.uint8).reshape(-1, pixel)
    n, out, i = len(px), bytearray(), 0
    while i < n:
        room = width - i % width
        k = 1
        while k < min(128, room) and i + k < n and np.array_equal(px[i + k], px[i]):
            k += 1
        if k >= 2:
            out += bytes([0x80 | (k - 1)]) + px[i].tobytes()
        else:
            k = int(min(rng.integers(1, literal_max + 1), n - i))
            out += bytes([k - 1]) + px[i: i + k].tobytes()
        i += k
    return bytes(out)


def _bgra15(rgb: np.ndarray, transparent: np.ndarray | None = None) -> np.ndarray:
    """16-bit little-endian BGRA;15Z words of (..., 3) uint8 colours."""
    r, g, b = (rgb[..., i].astype(np.uint16) >> 3 for i in range(3))
    v = (r << 10) | (g << 5) | b
    if transparent is not None:
        v |= transparent.astype(np.uint16) << 15
    return v.astype("<u2")


def _tga_written() -> dict:
    h, w = 21, 27
    rgb = photo(h, w, 70)
    gray = flat(h, w, 71, 6)
    idx = flat(h, w, 72, 12) % 12 + 3
    pal16 = palette(15, 73)
    bgra = np.concatenate([rgb[..., ::-1], alpha(h, w)[..., None]], -1)
    words = _bgra15(rgb, (alpha(h, w) > 128))
    return {
        "tga_mirrored_bottom_up.tga": lambda: tga_bytes(w, h, rgb[::-1, :, ::-1].tobytes(), imagetype=2, depth=24,
                                                        flags=0x10),
        "tga_mirrored_top_down.tga": lambda: tga_bytes(w, h, bgra.tobytes(), imagetype=2, depth=32, flags=0x38),
        "tga_colormap16_start3.tga": lambda: tga_bytes(w, h, idx.tobytes(), imagetype=1, depth=8,
                                                       colormap=(3, _bgra15(pal16).tobytes(), 16)),
        "tga_colormap24_start3_rle.tga": lambda: tga_bytes(
            w, h, tga_packets(idx[::-1], 1, w, 74), imagetype=9, depth=8,
            colormap=(3, pal16[:, ::-1].tobytes(), 24)),
        "tga_colormap32.tga": lambda: tga_bytes(w, h, idx.tobytes(), imagetype=1, depth=8,
                                                colormap=(2, np.concatenate([pal16, pal16[:, :1]], 1).tobytes(), 32)),
        "tga_rgb16.tga": lambda: tga_bytes(w, h, words[::-1].tobytes(), imagetype=2, depth=16),
        "tga_rgb16_rle.tga": lambda: tga_bytes(w, h, tga_packets(words.view(np.uint8), 2, w, 75), imagetype=10,
                                               depth=16, flags=0x20),
        "tga_literals_across_rows.tga": lambda: tga_bytes(w, h, tga_packets(gray[::-1], 1, w, 76, 300 // 3),
                                                          imagetype=11, depth=8, id_section=b"acezero"),
        "tga_rgb_rle_across_rows.tga": lambda: tga_bytes(w, h, tga_packets(rgb[:, :, ::-1], 3, w, 77), imagetype=10,
                                                         depth=24, flags=0x20),
        "tga_gray_under_colormap.tga": lambda: tga_bytes(w, h, (gray % 15).tobytes(), imagetype=3, depth=8,
                                                         colormap=(0, pal16[:, ::-1].tobytes(), 24)),
        "tga_gray_alpha_under_colormap.tga": lambda: tga_bytes(
            w, h, np.stack([gray % 15, alpha(h, w)], -1).tobytes(), imagetype=3, depth=16,
            colormap=(0, pal16[:, ::-1].tobytes(), 24)),
        "tga_depth_gray_alpha.tga": lambda: tga_bytes(w, h, np.stack([gray, alpha(h, w)], -1).tobytes(),
                                                      imagetype=3, depth=16),
        # PIL opens these (mode and size) and its load raises
        "tga_cannot_load_gray32.tga": lambda: tga_bytes(w, h, bytes(4 * w * h), imagetype=3, depth=32),
        "tga_colormapped_without_map.tga": lambda: tga_bytes(w, h, idx.tobytes(), imagetype=1, depth=8),
        "tga_run_across_rows.tga": lambda: tga_bytes(w, h, bytes([0x80 | (w + 2), 7]) + bytes(w * h), imagetype=11,
                                                     depth=8),
        "tga_bilevel_rle.tga": lambda: tga_bytes(w, h, bytes([0x80 | 127, 0xFF]) * 40, imagetype=11, depth=1),
        "tga_truncated.tga": lambda: tga_bytes(w, h, rgb[::-1, :, ::-1].tobytes()[: w * h], imagetype=2, depth=24),
    }


def _pil_tga() -> dict:
    from PIL import Image

    h, w = 24, 32
    rgb = photo(h, w, 80)
    rgb[:, :9] = rgb[0, 0]  # runs for the run-length coder
    a = alpha(h, w)
    images = {"1": Image.fromarray(flat(h, w, 81, 2) > 100), "L": Image.fromarray(rgb[..., 1]),
              "LA": Image.fromarray(np.stack([rgb[..., 1], a], -1), "LA"), "P": Image.fromarray(rgb).quantize(37),
              "RGB": Image.fromarray(rgb), "RGBA": Image.fromarray(np.concatenate([rgb, a[..., None]], -1))}

    def save(mode, rle, orientation, id_section=b""):
        buf = io.BytesIO()
        images[mode].save(buf, format="TGA", rle=rle, orientation=orientation, id_section=id_section)
        return buf.getvalue()

    out = {}
    for mode in images:
        for rle in (False, True):
            if rle and mode == "1":
                continue  # Pillow's encoder reads past the rows of a mode-1 image
            for orientation in (1, -1):
                name = f"pil_{mode.lower()}_{'rle' if rle else 'raw'}_{'top' if orientation > 0 else 'bottom'}.tga"
                out[name] = (lambda m=mode, r=rle, o=orientation: save(m, r, o, b"ID" if r else b""))
    return out


# ---------------------------------------------------------------- SGI


def sgi_header(width: int, height: int, channels: int, *, bpc: int = 1, rle: bool = False, dimension=None) -> bytes:
    dim = dimension if dimension is not None else (3 if channels > 1 else 2)
    return struct.pack(">hBBHHHHll4s80sl404s", 474, int(rle), bpc, dim, width, height, channels, 0,
                       255 if bpc == 1 else 65535, b"", b"raster fixture", 0, b"")


def sgi_rle_row(values: np.ndarray, bpc: int, seed: int) -> bytes:
    """SGI run-length packets of one row's samples, ended by a 0 packet."""
    rng = np.random.default_rng(seed)
    out, i, n = bytearray(), 0, len(values)

    def word(c):
        return bytes([0, c]) if bpc == 2 else bytes([c])

    while i < n:
        k = 1
        while k < min(127, n - i) and values[i + k] == values[i]:
            k += 1
        if k >= 3:
            out += word(k) + int(values[i]).to_bytes(bpc, "big")
        else:
            k = int(min(rng.integers(1, 40), n - i))
            out += word(0x80 | k) + b"".join(int(v).to_bytes(bpc, "big") for v in values[i: i + k])
        i += k
    return bytes(out + word(0))


def sgi_rle_bytes(img: np.ndarray, bpc: int, seed: int) -> bytes:
    """A run-length SGI of (h, w) or (h, w, c) samples (uint8, or uint16 at
    bpc 2), rows from the bottom, one channel after another."""
    planes = img[None] if img.ndim == 2 else img.transpose(2, 0, 1)
    c, h, w = planes.shape
    rows = [sgi_rle_row(planes[ch, h - 1 - r], bpc, seed + ch * h + r) for ch in range(c) for r in range(h)]
    start = 512 + 8 * c * h
    offsets = np.cumsum([0] + [len(r) for r in rows[:-1]]) + start
    tables = struct.pack(f">{c * h}I", *offsets.tolist()) + struct.pack(f">{c * h}I", *[len(r) for r in rows])
    return sgi_header(w, h, c, bpc=bpc, rle=True) + tables + b"".join(rows)


def sgi_raw_bytes(img: np.ndarray, bpc: int) -> bytes:
    planes = img[None] if img.ndim == 2 else img.transpose(2, 0, 1)
    c, h, w = planes.shape
    body = np.ascontiguousarray(planes[:, ::-1]).astype(">u2" if bpc == 2 else np.uint8)
    return sgi_header(w, h, c, bpc=bpc) + body.tobytes()


def _sgi_written() -> dict:
    h, w = 19, 25
    rgb = photo(h, w, 90)
    rgb[:, :7] = rgb[0, 0]
    rgba = np.concatenate([rgb, alpha(h, w)[..., None]], -1)
    wide = (rgba.astype(np.uint16) * 257) ^ np.random.default_rng(91).integers(0, 256, rgba.shape).astype(np.uint16)
    out = {}
    for mode, img8, img16 in (("l", rgb[..., 1], wide[..., 1]), ("rgb", rgb, wide[..., :3]), ("rgba", rgba, wide)):
        out[f"sgi_rle8_{mode}.sgi"] = lambda a=img8, m=mode: sgi_rle_bytes(a, 1, 92 + len(m))
        out[f"sgi_rle16_{mode}.sgi"] = lambda a=img16, m=mode: sgi_rle_bytes(a, 2, 95 + len(m))
        out[f"sgi_raw16_{mode}.sgi"] = lambda a=img16: sgi_raw_bytes(a, 2)
    out["sgi_depth16.sgi"] = lambda: sgi_raw_bytes(depth_mm(h, w, 98), 2)
    out["sgi_rle_short_row.sgi"] = lambda: _sgi_short_row(rgb[..., 0])
    return out


def _sgi_short_row(gray: np.ndarray) -> bytes:
    """A run-length SGI whose first row (the bottom one) stops after 5
    samples: the rest of that row keeps the row buffer's zeros, and later
    short rows keep the row before."""
    h, w = gray.shape
    rows = [bytes([5]) + bytes([gray[h - 1 - r, 0]]) + bytes([0]) if r % 4 == 0
            else sgi_rle_row(gray[h - 1 - r], 1, 99 + r) for r in range(h)]
    offsets = np.cumsum([0] + [len(r) for r in rows[:-1]]) + 512 + 8 * h
    return (sgi_header(w, h, 1, rle=True) + struct.pack(f">{h}I", *offsets.tolist())
            + struct.pack(f">{h}I", *[len(r) for r in rows]) + b"".join(rows))


def _pil_sgi() -> dict:
    from PIL import Image

    h, w = 22, 30
    rgb = photo(h, w, 100)
    images = {"l": Image.fromarray(rgb[..., 0]), "rgb": Image.fromarray(rgb),
              "rgba": Image.fromarray(np.concatenate([rgb, alpha(h, w)[..., None]], -1))}

    def save(key, bpc):
        buf = io.BytesIO()
        images[key].save(buf, format="SGI", bpc=bpc)
        return buf.getvalue()

    return {f"pil_{k}_bpc{b}.sgi": (lambda k=k, b=b: save(k, b)) for k in images for b in (1, 2)}


# ---------------------------------------------------------------- PCX and DCX


def pcx_rle(data: bytes) -> bytes:
    """PCX run-length bytes of one plane's line (runs of up to 63)."""
    out, i = bytearray(), 0
    while i < len(data):
        k = 1
        while k < 63 and i + k < len(data) and data[i + k] == data[i]:
            k += 1
        if k == 1 and data[i] < 0xC0:
            out.append(data[i])
        else:
            out += bytes([0xC0 | k, data[i]])
        i += k
    return bytes(out)


def pcx_bytes(lines: list[list[bytes]], width: int, height: int, *, bits: int, planes: int, version: int = 5,
              header_palette: bytes = b"", stride: int | None = None, tail: bytes = b"") -> bytes:
    """A PCX of `lines` (each a list of its planes' bytes, padded to the
    stride) with a 16-colour header palette and `tail` after the body."""
    stride = stride if stride is not None else len(lines[0][0])
    head = struct.pack("<BBBBHHHHHH", 10, version, 1, bits, 0, 0, width - 1, height - 1, 72, 72)
    head += header_palette.ljust(48, b"\0") + b"\0" + struct.pack("<BHH", planes, stride, 1) + b"\0" * 58
    return head + b"".join(pcx_rle(p) for line in lines for p in line) + tail


def _bit_planes(idx: np.ndarray, planes: int) -> list[list[bytes]]:
    s = (idx.shape[1] + 7) // 8
    stride = s + s % 2
    return [[np.packbits((row >> k) & 1).tobytes().ljust(stride, b"\0") for k in range(planes)] for row in idx]


def _pcx_written() -> dict:
    h, w = 17, 29
    idx16, idx4 = flat(h, w, 110, 16) % 16, flat(h, w, 111, 4) % 4
    pal = palette(16, 112).tobytes()
    gray = flat(h, w, 113, 5)
    page2 = photo(13, 20, 114)

    def dcx():
        p1 = pcx_bytes([[bytes(r) + b"\0"] for r in gray], w, h, bits=8, planes=1)
        p2 = pcx_bytes([[bytes(page2[y, :, c]) for c in range(3)] for y in range(13)], 20, 13, bits=8, planes=3)
        table = struct.pack("<3I", 16, 16 + len(p1), 0)
        return struct.pack("<I", 0x3ADE68B1) + table + p1 + p2

    def falls_through_to_tga():
        # PCX version 0 with xmax < xmin: PcxImageFile gives up, and the
        # header reads as a TGA of ID length 10, type 3 (the PCX encoding
        # byte), 40 x 30 pixels (the DPI fields) at depth 8 (the header
        # palette's first byte)
        head = struct.pack("<BBBBHHHHHH", 10, 0, 3, 8, 5, 0, 2, 9, 40, 30) + bytes([8, 0]) + bytes(10)
        return head + flat(30, 40, 115, 7).tobytes()

    return {
        "pcx_planes4.pcx": lambda: pcx_bytes(_bit_planes(idx16, 4), w, h, bits=1, planes=4, header_palette=pal),
        "pcx_planes2.pcx": lambda: pcx_bytes(_bit_planes(idx4, 2), w, h, bits=1, planes=2, header_palette=pal),
        "pcx_gray_no_palette.pcx": lambda: pcx_bytes([[bytes(r) + b"\0"] for r in gray], w, h, bits=8, planes=1,
                                                     tail=bytes(800)),
        "pcx_gray_ramp_palette.pcx": lambda: pcx_bytes([[bytes(r) + b"\0"] for r in gray], w, h, bits=8, planes=1,
                                                       tail=b"\x0c" + np.repeat(np.arange(256, dtype=np.uint8), 3)
                                                       .tobytes()),
        "pcx_rgb_odd_width.pcx": lambda: pcx_bytes([[bytes(photo(h, w, 116)[y, :, c]) + b"\0" for c in range(3)]
                                                    for y in range(h)], w, h, bits=8, planes=3),
        "pcx_header_stride_odd.pcx": lambda: pcx_bytes([[bytes(r)] for r in gray], w, h, bits=8, planes=1,
                                                       tail=b"\x0c" + palette(256, 117).tobytes()),
        "dcx_two_pages.dcx": dcx,
        "pcx_falls_through_to_tga.pcx": falls_through_to_tga,
    }


def _pil_pcx() -> dict:
    from PIL import Image

    h, w = 23, 33
    rgb = photo(h, w, 120)
    rgb[:, :8] = 200
    images = {"1": Image.fromarray(flat(h, w, 121, 2) > 100), "l": Image.fromarray(rgb[..., 2]),
              "p": Image.fromarray(rgb).quantize(100), "rgb": Image.fromarray(rgb)}

    def save(k):
        buf = io.BytesIO()
        images[k].save(buf, format="PCX")
        return buf.getvalue()

    return {f"pil_{k}.pcx": (lambda k=k: save(k)) for k in images}


# ---------------------------------------------------------------- Sun raster


def sun_rle(data: bytes) -> bytes:
    """Sun run-length bytes: runs of 3 or more (up to 256) as 0x80 n v,
    0x80 as 0x80 0, anything else as itself."""
    out, i = bytearray(), 0
    while i < len(data):
        k = 1
        while k < 256 and i + k < len(data) and data[i + k] == data[i]:
            k += 1
        if k >= 3:
            out += bytes([0x80, k - 1, data[i]])
        else:
            k = 1
            out += b"\x80\x00" if data[i] == 0x80 else bytes([data[i]])
        i += k
    return bytes(out)


def sun_bytes(width: int, height: int, depth: int, rows: np.ndarray, *, file_type: int = 1,
              colormap: np.ndarray | None = None) -> bytes:
    """A Sun raster of (h, row bytes) uint8 `rows` (no padding): raw rows
    padded to 16 bits, or one run-length stream for type 2; the colour map
    ((n, 3) uint8) stored as reds, greens, blues."""
    rows = np.asarray(rows, np.uint8)
    cmap = b"" if colormap is None else np.ascontiguousarray(np.asarray(colormap, np.uint8).T).tobytes()
    if file_type == 2:
        body = sun_rle(rows.tobytes())
    else:
        stride = (width * depth + 15) // 16 * 2
        padded = np.zeros((height, stride), np.uint8)
        padded[:, : rows.shape[1]] = rows
        body = padded.tobytes()
    head = struct.pack(">8I", 0x59A66A95, width, height, depth, len(body), file_type, 1 if len(cmap) else 0,
                       len(cmap))
    return head + cmap + body


def _sun_written() -> dict:
    h, w = 15, 23
    rgb = photo(h, w, 130)
    rgb[:, :6] = 0x80
    gray = flat(h, w, 131, 3)
    gray[2, 3:9] = 0x80
    nib = np.pad(flat(h, w, 132, 16) % 16, ((0, 0), (0, w % 2)))
    rows4 = (nib[:, 0::2] << 4 | nib[:, 1::2]).astype(np.uint8)
    bilevel = np.packbits(flat(h, w, 133, 2) > 100, axis=1)
    bgrx = np.concatenate([rgb[..., ::-1], np.full((h, w, 1), 9, np.uint8)], -1).reshape(h, -1)
    rgbx = np.concatenate([rgb, np.full((h, w, 1), 9, np.uint8)], -1).reshape(h, -1)
    pal = palette(200, 134)
    out = {}
    for t in (0, 1, 2, 3, 4, 5):
        out[f"sun_gray8_type{t}.ras"] = lambda t=t: sun_bytes(w, h, 8, gray, file_type=t)
    for t in (1, 2):
        out[f"sun_bilevel_type{t}.ras"] = lambda t=t: sun_bytes(w, h, 1, bilevel, file_type=t)
        out[f"sun_gray4_type{t}.ras"] = lambda t=t: sun_bytes(w, h, 4, rows4, file_type=t)
        out[f"sun_palette8_type{t}.ras"] = lambda t=t: sun_bytes(w, h, 8, gray % 200, file_type=t, colormap=pal)
        out[f"sun_palette4_type{t}.ras"] = lambda t=t: sun_bytes(w, h, 4, rows4, file_type=t, colormap=pal[:16])
        out[f"sun_bgr24_type{t}.ras"] = lambda t=t: sun_bytes(w, h, 24, rgb[..., ::-1].reshape(h, -1), file_type=t)
        out[f"sun_bgrx32_type{t}.ras"] = lambda t=t: sun_bytes(w, h, 32, bgrx, file_type=t)
    out["sun_rgb24_type3.ras"] = lambda: sun_bytes(w, h, 24, rgb.reshape(h, -1), file_type=3)
    out["sun_rgbx32_type3.ras"] = lambda: sun_bytes(w, h, 32, rgbx, file_type=3)
    out["sun_rgb_under_colormap.ras"] = lambda: sun_bytes(w, h, 24, rgb.reshape(h, -1), colormap=pal[:4])
    return out


# ---------------------------------------------------------------- QOI


def _pil_qoi() -> dict:
    from PIL import Image

    h, w = 30, 40
    rgb = photo(h, w, 140)
    rgb[:5] = 77  # runs, longer than 62
    rgb[5, :20] = np.arange(20)[:, None] * [1, 1, 1]  # diffs
    rgb[6, :20] = np.arange(20)[:, None] * [9, 12, 7]  # lumas
    rgb[7] = rgb[2]  # the index
    a = alpha(h, w)
    a[:, 20:] = 255

    def save(img):
        buf = io.BytesIO()
        img.save(buf, format="QOI")
        return buf.getvalue()

    return {"pil_rgb.qoi": lambda: save(Image.fromarray(rgb)),
            "pil_rgba.qoi": lambda: save(Image.fromarray(np.concatenate([rgb, a[..., None]], -1)))}


def _fixtures() -> dict:
    return {**_pil_tga(), **_tga_written(), **_pil_sgi(), **_sgi_written(), **_pil_pcx(), **_pcx_written(),
            **_sun_written(), **_pil_qoi()}


FIXTURES = _fixtures()
# the fixtures the depth check reads (np.asarray of PIL's image over 1,000)
DEPTH = ("pil_l_raw_bottom.tga", "pil_la_rle_top.tga", "tga_depth_gray_alpha.tga", "pil_l.pcx", "sgi_depth16.sgi",
         "sgi_raw16_l.sgi", "sun_palette8_type2.ras", "pil_rgb.qoi")
# decode_to_canvas over every fixture PIL decodes: (short side, explicit canvas or None)
CANVAS_CHECKS = ((40, None), (16, (16, 24)))


def palette_digest(palette) -> list | None:
    return chip_smoke.palette_digest(np, palette)


def digest(path: Path) -> dict:
    """What PIL makes of a file (module note)."""
    import warnings

    from PIL import Image

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        try:
            im = Image.open(path)
        except Exception:
            return {"raises": True, "opens": False}
        with im:
            opened = {"mode": im.mode, "size": list(im.size), "format": im.format}
            try:
                arr = np.asarray(im)
                return {**opened, "shape": list(arr.shape), "dtype": arr.dtype.str,
                        "sha256": chip_smoke.array_digest(arr), "palette": palette_digest(im.getpalette()),
                        "rgb_sha256": chip_smoke.array_digest(np.asarray(im.convert("RGB"))),
                        "l_sha256": chip_smoke.array_digest(np.asarray(im.convert("L")))}
            except Exception:
                return {**opened, "raises": True, "opens": True}


def fixture_paths(decoded_only: bool = True) -> list[str]:
    names = sorted(FIXTURES)
    if decoded_only:
        digests = json.loads((OUT / "pil_digests.json").read_text())["files"]
        names = [n for n in names if not digests[n].get("raises")]
    return [str(OUT / n) for n in names]


def jax_canvas(paths: list[str], short_size: int, canvas_hw) -> str:
    from acezero_tpu.data import images as jimg

    return chip_smoke.canvas_digest(jimg.decode_to_canvas(paths, short_size=short_size, canvas_hw=canvas_hw,
                                                          num_workers=2))


def digests() -> dict:
    from acezero_tpu.data.depth import load_depth_file

    files = {name: digest(OUT / name) for name in sorted(FIXTURES)}
    paths = [str(OUT / n) for n in sorted(FIXTURES) if not files[n].get("raises")]
    canvas = [{"short_size": s, "canvas_hw": None if c is None else list(c), "sha256": jax_canvas(paths, s, c)}
              for s, c in CANVAS_CHECKS]
    depth = {name: chip_smoke.array_digest(load_depth_file(str(OUT / name))) for name in DEPTH}
    return {"files": files, "canvas": canvas, "depth": depth}


def main() -> None:
    OUT.mkdir(parents=True, exist_ok=True)
    for name, make in FIXTURES.items():
        (OUT / name).write_bytes(make())
    d = digests()
    not_opened = sorted(n for n, v in d["files"].items() if not v.get("opens", True))
    if not_opened:
        raise SystemExit(f"PIL does not open {not_opened}")
    (OUT / "pil_digests.json").write_text(json.dumps(d, indent=1) + "\n")
    total = sum(p.stat().st_size for p in OUT.iterdir())
    print(f"wrote {len(FIXTURES)} fixtures and pil_digests.json to {OUT} ({total} bytes)")


if __name__ == "__main__":
    main()
