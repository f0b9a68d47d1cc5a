"""Sun raster files (.ras) without an image library, read as Pillow's
SunImagePlugin reads them; the run-length body in io/csrc/raster.cpp
through ctypes (io/raster.py). PIL writes no Sun raster, and neither does
the port.

What PIL makes of a file that starts with the big-endian magic
0x59A66A95:
  - the 32-byte header: width, height, depth, type, colour-map type and
    length (the data length is ignored);
  - the mode by depth: 1 "1" (a clear bit white, rawmode 1;I), 4 "L" (each
    nibble times 17), 8 "L", 24 and 32 "RGB" (BGR and BGRX, or RGB and
    RGBX for type 3); another depth makes Pillow try the later plugins,
    none of which opens it;
  - a colour map (type 1, at most 1,024 bytes; another type, or a longer
    map, gives up as above): its length / 3 colours, stored as all the
    reds, then the greens, then the blues; it turns a gray image into "P"
    (the nibbles or bytes its indices); PIL's load raises for a map of
    more than 256 colours, or on a "1" or "RGB" image;
  - the body after the header and the map's declared length: types 0, 1,
    3, 4 and 5 raw, rows padded to 16 bits (the last row's padding may be
    missing); type 2 run-length (io/csrc/raster.cpp), rows without
    padding; any other type gives up as above.
"""

from __future__ import annotations

import struct
from typing import NamedTuple

import numpy as np

from acezero_tpu_torch.io import raster
from acezero_tpu_torch.io.formats import Raster, check_size

MAGIC = 0x59A66A95
HEADER = 32


class SunHeader(NamedTuple):
    width: int
    height: int
    mode: str
    depth: int
    rawmode: str
    rle: bool
    palette: np.ndarray | None
    palette_fault: str | None
    offset: int


def is_sun(head: bytes) -> bool:
    """Pillow's _accept: the magic."""
    return len(head) >= 4 and struct.unpack_from(">I", head)[0] == MAGIC


def sun_open(b, path) -> SunHeader:
    """SunImageFile._open: ValueError where PIL identifies no image (every
    refusal of this plugin lets Image.open try the later plugins, none of
    which opens a Sun raster)."""
    s = bytes(b[:HEADER])
    if not is_sun(s) or len(s) < HEADER:
        raise ValueError(f"{path}: Sun raster header cut short (PIL identifies no image)")
    width, height, depth, _, file_type, palette_type, palette_length = struct.unpack_from(">7I", s, 4)
    if depth == 1:
        mode, rawmode = "1", "1;I"
    elif depth == 4:
        mode, rawmode = "L", "L;4"
    elif depth == 8:
        mode = rawmode = "L"
    elif depth in (24, 32):
        mode, rawmode = "RGB", ("RGB" if file_type == 3 else "BGR") + ("X" if depth == 32 else "")
    else:
        raise ValueError(f"{path}: Sun raster of depth {depth} (PIL identifies no image)")
    offset = HEADER
    palette = fault = None
    if palette_length:
        if palette_length > 1024 or palette_type != 1:
            raise ValueError(f"{path}: Sun raster colour map of type {palette_type}, {palette_length} bytes "
                             "(PIL identifies no image)")
        offset += palette_length
        raw = np.frombuffer(bytes(b[HEADER: HEADER + palette_length]), np.uint8)
        n = len(raw) // 3
        if mode == "L":
            mode, rawmode = "P", rawmode.replace("L", "P")
        if n > 256:
            fault = f"a colour map of {n} entries (PIL: invalid palette size)"
        elif mode != "P":
            fault = f"a colour map on a mode-{mode} image (PIL: unrecognized image mode)"
        else:
            palette = np.ascontiguousarray(raw[: 3 * n].reshape(3, n).T)
    if file_type not in (0, 1, 2, 3, 4, 5):
        raise ValueError(f"{path}: Sun raster of type {file_type} (PIL identifies no image)")
    if width == 0 or height == 0:
        raise ValueError(f"{path}: Sun raster of {width} x {height} pixels (PIL identifies no image)")
    check_size(width, height, path)
    return SunHeader(width, height, mode, depth, rawmode, file_type == 2, palette, fault, offset)


def sun_header(path) -> SunHeader:
    return raster.read_mapped(path, lambda b: sun_open(b, path))


def read_sun(path) -> Raster:
    """The pixels PIL gives for a Sun raster file (module note): a `Raster`
    of mode 1 (bool), L, P (indices and palette) or RGB. ValueError naming
    the file where PIL's open or load raises."""
    return raster.read_mapped(path, lambda b: _read(b, path))


def _read(b, path) -> Raster:
    hdr = sun_open(b, path)
    w, h = hdr.width, hdr.height
    row_bytes = (w * hdr.depth + 7) // 8
    if hdr.rle:
        rows = np.empty((h, row_bytes), np.uint8)
        src = np.frombuffer(b, np.uint8)[min(hdr.offset, len(b)):]
        raster.decode("sun_rle", src, h * row_bytes, out=rows, path=path, kind="Sun raster")
    else:
        stride = (w * hdr.depth + 15) // 16 * 2
        body = raster.need(b, hdr.offset, stride * (h - 1) + row_bytes, path, "Sun raster")
        rows = np.lib.stride_tricks.as_strided(body, (h, row_bytes), (stride, 1))
    if hdr.rawmode == "1;I":
        px = raster.bits(rows, w, invert=True)
    elif hdr.rawmode in ("L;4", "P;4"):
        px = raster.nibbles(rows, w, 17 if hdr.mode == "L" else 1)
    elif hdr.rawmode in ("L", "P"):
        px = rows[:, :w].copy()
    else:
        px = raster.channels(rows, w, hdr.rawmode)
    if hdr.palette_fault:
        raise ValueError(f"{path}: Sun raster with {hdr.palette_fault}")
    return Raster(np.ascontiguousarray(px), hdr.mode, hdr.palette)
