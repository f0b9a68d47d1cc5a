"""TGA (Targa) files without an image library, read as Pillow's
TgaImagePlugin reads them and written as its `save` writes them; the
run-length packets in io/csrc/raster.cpp through ctypes (io/raster.py).

Pillow has no signature test for TGA: `Image.open` tries it after every
other plugin that comes before it (io/formats.py::kind keeps that order),
and takes a file whose 18-byte header passes `_open`'s checks: a colour-map
type of 0 or 1, a nonzero width and height, a depth of 1, 8, 16, 24 or 32,
an image type of 1-3 or 9-11, and a colour map of 16, 24 or 32 bits where
it has one (`is_tga`). What PIL makes of such a file:
  - the mode by image type: gray (3, 11) "L", "1" at depth 1, "LA" at 16;
    colour-mapped (1, 9) "P" with a colour map, else "L"; true colour (2,
    10) "RGB" at depth 24, else "RGBA";
  - the pixels where Pillow has a rawmode for (type, depth): P, 1, L, LA,
    BGRA;15Z (16-bit colour, 5 bits a channel, alpha set where the top bit
    is clear), BGR and BGRA; where it has none the file opens (its mode and
    size are answered) and `load` raises "cannot load this image";
  - raw bodies and run-length ones (types 9-11; io/csrc/raster.cpp), the
    rows from the bottom unless the descriptor's bit 5 is set, mirrored
    where its bit 4 is (`load_end`); a run-length image of depth 1 never
    fills (Pillow's pixel is depth // 8 bytes), so its load raises;
  - the colour map after the ID section: `start` zero entries, then the
    map's 16-bit (BGRA;15Z), 24-bit (BGR) or 32-bit entries; PIL loads a
    32-bit map with a rawmode it does not know, or more than 256 entries,
    and raises; a map on a gray "L" or "LA" image stays under it (the
    image keeps its mode and values, its `convert("RGB")` goes through the
    map), on a "1", "RGB" or "RGBA" image `load` raises; a colour-mapped
    type without a map has no rawmode for mode L, and raises.
`info` (`tga_header(path).info`) is what PIL's `info` carries through a
resize into `save`: "compression" ("tga_rle" for types 9-11), "orientation"
(1 for rows from the top, -1 from the bottom) and "id_section".

`write_tga(path, img, mode, palette, compression, orientation,
id_section)` writes PIL's bytes for modes 1, L, LA, P, RGB and RGBA, raw
or run-length, with the ID section (trimmed to 255 bytes) and the TGA 2.0
footer. PIL's run-length encoder reads past the row of a mode-1 image, so
that one case raises OSError.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import NamedTuple

import numpy as np

from acezero_tpu_torch.io import raster
from acezero_tpu_torch.io.formats import Raster, check_size

SOURCE = raster.SOURCE
SUFFIXES = (".tga", ".icb", ".vda", ".vst")
# Pillow's MODES: (image type & 7, depth) -> rawmode
RAWMODES = {(1, 8): "P", (3, 1): "1", (3, 8): "L", (3, 16): "LA", (2, 16): "BGRA;15Z", (2, 24): "BGR", (2, 32): "BGRA"}
# Pillow's SAVE: mode -> (bits, colour-map type, image type)
SAVE = {"1": (1, 0, 3), "L": (8, 0, 3), "LA": (16, 0, 3), "P": (8, 1, 1), "RGB": (24, 0, 2), "RGBA": (32, 0, 2)}
FOOTER = b"\0" * 8 + b"TRUEVISION-XFILE.\0"


class TgaHeader(NamedTuple):
    """What PIL's open makes of a TGA: its size and mode, the rawmode of
    its body (None: PIL cannot load it), whether it is run-length coded,
    the row order, the mirror, the depth, the colour map ((n, 3) uint8, or
    None) or why PIL's load refuses it, where the body starts, and `info`."""

    width: int
    height: int
    mode: str
    rawmode: str | None
    rle: bool
    flip: bool
    depth: int
    palette: np.ndarray | None
    palette_fault: str | None
    offset: int
    info: dict


def is_tga(head: bytes) -> bool:
    """TgaImageFile._open's checks of the 18-byte header: colour-map type
    0 or 1, nonzero size, a depth of 1, 8, 16, 24 or 32, a known image type
    (every orientation is known) and, with a colour map, a map depth of 16,
    24 or 32."""
    if len(head) < 18:
        return False
    w, h = struct.unpack_from("<HH", head, 12)
    return (head[1] in (0, 1) and w > 0 and h > 0 and head[16] in (1, 8, 16, 24, 32)
            and head[2] in (1, 2, 3, 9, 10, 11) and (head[1] == 0 or head[7] in (16, 24, 32)))


def _mode(imagetype: int, colormaptype: int, depth: int) -> str:
    if imagetype in (3, 11):
        return {1: "1", 16: "LA"}.get(depth, "L")
    if imagetype in (1, 9):
        return "P" if colormaptype else "L"
    return "RGB" if depth == 24 else "RGBA"


def tga_open(b, path) -> TgaHeader:
    """TgaImageFile._open, statement by statement; ValueError where it gives
    up (PIL then identifies no image: no plugin after TGA takes a file that
    starts as one)."""
    s = bytes(b[:18])
    if not is_tga(s):
        raise ValueError(f"{path}: PIL does not open it as a TGA file")
    id_len, colormaptype, imagetype = s[0], s[1], s[2]
    depth, flags = s[16], s[17]
    width, height = struct.unpack_from("<HH", s, 12)
    mode = _mode(imagetype, colormaptype, depth)
    orientation = flags & 0x30
    info: dict = {"orientation": 1 if orientation in (0x20, 0x30) else -1}
    if imagetype & 8:
        info["compression"] = "tga_rle"
    pos = min(18 + id_len, len(b))
    if id_len:
        info["id_section"] = bytes(b[18:pos])
    palette = fault = None
    if colormaptype:
        start, size, mapdepth = struct.unpack_from("<HHB", s, 3)
        entry = {16: 2, 24: 3, 32: 4}[mapdepth]  # is_tga has checked it
        raw = np.frombuffer(bytes(b[pos: pos + entry * size]), np.uint8)
        pos = min(pos + entry * size, len(b))
        n = start + len(raw) // entry
        if mapdepth == 32:
            fault = "a 32-bit colour map (PIL: unrecognized raw mode)"
        elif n > 256:
            fault = f"a colour map of {n} entries (PIL: invalid palette size)"
        elif mode not in ("L", "LA", "P"):
            fault = f"a colour map on a mode-{mode} image (PIL: unrecognized image mode)"
        else:
            rows = np.concatenate([np.zeros(start * entry, np.uint8), raw[: len(raw) // entry * entry]])
            rows = rows.reshape(1, -1)
            palette = (raster.bgra15z(rows, n)[0, :, :3] if entry == 2 else raster.channels(rows, n, "BGR")[0])
    rawmode = RAWMODES.get((imagetype & 7, depth))
    if rawmode == "P" and mode == "L":
        fault = fault or "a colour-mapped image without a colour map (PIL: unknown raw mode for mode L)"
    check_size(width, height, path)
    return TgaHeader(width, height, mode, rawmode, bool(imagetype & 8), orientation in (0x10, 0x30), depth,
                     palette, fault, pos, info)


def tga_header(path) -> TgaHeader:
    """What PIL's open makes of a TGA file (module note); ValueError where
    PIL's open raises."""
    return raster.read_mapped(path, lambda b: tga_open(b, path))


def _rows(b, hdr: TgaHeader, path) -> np.ndarray:
    """The body's rows from the top, as (h, row bytes) uint8."""
    row_bytes = (hdr.width * hdr.depth + 7) // 8
    if hdr.rle:
        out = np.empty((hdr.height, row_bytes), np.uint8)
        src = np.frombuffer(b, np.uint8)[hdr.offset:]
        raster.decode("tga_rle", src, hdr.depth // 8, row_bytes, hdr.height, out=out, path=path, kind="TGA")
    else:
        out = raster.need(b, hdr.offset, row_bytes * hdr.height, path, "TGA").reshape(hdr.height, row_bytes)
    return out if hdr.info["orientation"] > 0 else out[::-1]


def read_tga(path) -> Raster:
    """The pixels PIL gives for a TGA file (module note): a `Raster` of mode
    1 (bool), L, LA, P (indices and palette), RGB or RGBA; a gray image
    keeps its colour map as `palette`. ValueError naming the file where
    PIL's open or load raises."""
    return raster.read_mapped(path, lambda b: _read(b, path))


def _read(b, path) -> Raster:
    hdr = tga_open(b, path)
    if hdr.rawmode is None:
        raise ValueError(f"{path}: a TGA of type {b[2]} and depth {hdr.depth} (PIL: cannot load this image)")
    if hdr.rle and hdr.depth == 1:
        raise ValueError(f"{path}: a run-length TGA of depth 1 (PIL's decoder never fills it: truncated)")
    rows = _rows(b, hdr, path)
    w = hdr.width
    if hdr.rawmode == "1":
        px = raster.bits(rows, w)
    elif hdr.rawmode in ("P", "L"):
        px = rows[:, :w].copy()
    elif hdr.rawmode == "BGRA;15Z":
        px = raster.bgra15z(rows, w)
    else:
        px = raster.channels(rows, w, hdr.rawmode)
    if hdr.palette_fault:
        raise ValueError(f"{path}: TGA with {hdr.palette_fault}")
    if hdr.flip:
        px = px[:, ::-1]
    return Raster(np.ascontiguousarray(px), hdr.mode, hdr.palette)


# ---------------------------------------------------------------- writing


def encode_tga(img: np.ndarray, mode: str, palette: np.ndarray | None = None, compression: str | None = None,
               orientation: int = -1, id_section: bytes = b"") -> bytes:
    """PIL's TGA bytes of `img` in `mode` (module note): bool or uint8 (h,
    w) for 1, uint8 (h, w) for L and P (indices into `palette`, (n, 3)
    uint8), (h, w, 2) LA, (h, w, 3) RGB, (h, w, 4) RGBA."""
    if mode not in SAVE:
        raise OSError(f"cannot write mode {mode} as TGA")
    bits, colormaptype, imagetype = SAVE[mode]
    rle = compression == "tga_rle"
    if rle and mode == "1":
        raise OSError("PIL's TGA run-length encoder reads past the rows of a mode-1 image; the port does not write it")
    if rle:
        imagetype += 8
    id_section = bytes(id_section or b"")[:255]
    img = np.asarray(img)
    h, w = img.shape[:2]
    cmap = b""
    if colormaptype:
        pal = np.asarray(palette if palette is not None else np.zeros((0, 3)), np.uint8).reshape(-1, 3)
        cmap = pal[:, ::-1].tobytes()
    flags = 8 if mode in ("LA", "RGBA") else 0
    if orientation > 0:
        flags |= 0x20
    out = bytearray(bytes([len(id_section), colormaptype, imagetype]))
    out += struct.pack("<HHBHHHHBB", 0, len(cmap) // 3, 24 if colormaptype else 0, 0, 0, w, h, bits, flags)
    out += id_section + cmap
    if mode == "1":
        rows = np.packbits(img.astype(bool), axis=1)
    elif mode in ("RGB", "RGBA"):
        rows = img.astype(np.uint8)[..., [2, 1, 0, 3][: img.shape[2]]].reshape(h, -1)
    else:
        rows = img.astype(np.uint8).reshape(h, -1)
    rows = rows if orientation > 0 else rows[::-1]
    if rle:
        out += raster.encode("tga_rle", rows, w, h, bits // 8)
    else:
        out += np.ascontiguousarray(rows).tobytes()
    return bytes(out + FOOTER)


def write_tga(path, img: np.ndarray, mode: str, palette: np.ndarray | None = None, compression: str | None = None,
              orientation: int = -1, id_section: bytes = b"") -> None:
    """Write `img` as PIL's `img.save(path)` writes a TGA of `mode` whose
    `info` holds `compression`, `orientation` and `id_section`."""
    Path(path).write_bytes(encode_tga(img, mode, palette, compression, orientation, id_section))
