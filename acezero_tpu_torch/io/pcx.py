"""PCX (Paintbrush) files without an image library, read as Pillow's
PcxImagePlugin reads them and written as its `save` writes them; the
run-length lines in io/csrc/raster.cpp through ctypes (io/raster.py).
io/dcx.py reads the first page of a DCX through `pcx_open` and `decode`.

What PIL makes of a file that starts with 10 and a version of 0, 2, 3 or 5:
  - the 128-byte header: the window (xmin, ymin, xmax, ymax), which must
    give a positive size, bits a plane, planes and the bytes a line;
  - the mode: "1" for 1 bit in 1 plane; "P" for 1 bit in 2 or 4 planes,
    with the 16-colour palette of the header; for version 5, "L" for 8
    bits in 1 plane, or "P" with the 256 colours after the 0x0C byte 769
    bytes from the end of the file (of the DCX, for a DCX page) where they
    are not the grey ramp, and "RGB" for 8 bits in 3 planes; any other
    layout raises OSError in PIL's open, and so does an 8-bit file shorter
    than 769 bytes (Pillow seeks before its start);
  - the line: each plane (w * bits + 7) // 8 bytes, one more where that is
    odd and the header says otherwise (Pillow does not trust the header's
    count), decoded as io/csrc/raster.cpp sets out, the planes unpacked
    by rawmode 1, P;2L, P;4L, L, P or RGB;L.
A header cut short or a window of no pixels makes Pillow try the later
plugins (a PCX of version 0 may then open as TGA: io/formats.py::kind).

`write_pcx(path, img, mode, palette)` writes PIL's bytes for modes 1, L, P
and RGB; another mode raises ValueError, as PIL's save does.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import NamedTuple

import numpy as np

from acezero_tpu_torch.io import raster
from acezero_tpu_torch.io.formats import Raster, check_size

HEADER = 128
_GREY = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, axis=1)
_BITS = {"1": 1, "P;2L": 2, "P;4L": 4, "L": 8, "P": 8, "RGB;L": 24}  # the unpackers' bits a pixel
# Pillow's SAVE: mode -> (version, bits, planes)
SAVE = {"1": (2, 1, 1), "L": (5, 8, 1), "P": (5, 8, 1), "RGB": (5, 8, 3)}


class PcxHeader(NamedTuple):
    width: int
    height: int
    mode: str
    rawmode: str
    palette: np.ndarray | None
    line_bytes: int
    offset: int


def is_pcx(head: bytes) -> bool:
    """Pillow's _accept: 10, then a version of 0, 2, 3 or 5."""
    return len(head) >= 2 and head[0] == 10 and head[1] in (0, 2, 3, 5)


def falls_through(s: bytes) -> bool:
    """Whether PcxImageFile._open gives up on the 68 bytes `s` (a header cut
    short or a window of no pixels), so that Image.open tries the plugins
    after it."""
    if not is_pcx(s) or len(s) < 68:
        return True
    x0, y0, x1, y1 = struct.unpack_from("<HHHH", s, 4)
    return x1 + 1 <= x0 or y1 + 1 <= y0


def pcx_open(b, at: int, path, kind: str = "PCX") -> PcxHeader:
    """PcxImageFile._open of the page at byte `at`: ValueError where it
    raises or gives up (where io/formats.py::kind sends a file PcxImageFile
    gives up on to the later kinds, a DCX page's goes nowhere)."""
    s = bytes(b[at: at + 68])
    if falls_through(s):
        raise ValueError(f"{path}: PIL does not open it as a {kind} file (no PCX page at byte {at})")
    x0, y0, x1, y1 = struct.unpack_from("<HHHH", s, 4)
    version, bits, planes = s[1], s[3], s[65]
    (provided,) = struct.unpack_from("<H", s, 66)
    palette = None
    if bits == 1 and planes == 1:
        mode = rawmode = "1"
    elif bits == 1 and planes in (2, 4):
        mode, rawmode = "P", f"P;{planes}L"
        palette = np.frombuffer(s[16:64], np.uint8).reshape(16, 3).copy()
    elif version == 5 and bits == 8 and planes == 1:
        mode = rawmode = "L"
        if len(b) < 769:
            raise ValueError(f"{path}: an 8-bit PCX of {len(b)} bytes (PIL seeks 769 bytes before its end)")
        tail = bytes(b[-769:])
        if tail[0] == 12:
            colours = np.frombuffer(tail[1:], np.uint8).reshape(256, 3)
            if not np.array_equal(colours, _GREY):
                mode = rawmode = "P"
                palette = colours.copy()
    elif version == 5 and bits == 8 and planes == 3:
        mode, rawmode = "RGB", "RGB;L"
    else:
        raise ValueError(f"{path}: unknown PCX mode (version {version}, {bits} bits, {planes} planes)")
    width, height = x1 + 1 - x0, y1 + 1 - y0
    check_size(width, height, path)
    stride = (width * bits + 7) // 8
    if provided != stride:
        stride += stride % 2
    return PcxHeader(width, height, mode, rawmode, palette, planes * stride, at + HEADER)


def decode(b, hdr: PcxHeader, path, kind: str = "PCX") -> np.ndarray:
    """The pixels of a PCX page: bool (h, w) for mode 1, uint8 (h, w) for L
    and P, (h, w, 3) for RGB."""
    lines = np.empty((hdr.height, hdr.line_bytes), np.uint8)
    src = np.frombuffer(b, np.uint8)[hdr.offset:]
    raster.decode("pcx", src, hdr.width, hdr.height, hdr.line_bytes, _BITS[hdr.rawmode], out=lines, path=path,
                  kind=kind)
    w = hdr.width
    if hdr.rawmode == "1":
        return raster.bits(lines, w)
    if hdr.rawmode in ("P;2L", "P;4L"):
        return raster.bit_planes(lines, w, int(hdr.rawmode[2]))
    if hdr.rawmode == "RGB;L":
        return np.ascontiguousarray(lines[:, : 3 * w].reshape(hdr.height, 3, w).transpose(0, 2, 1))
    return np.ascontiguousarray(lines[:, :w])


def pcx_header(path) -> PcxHeader:
    return raster.read_mapped(path, lambda b: pcx_open(b, 0, path))


def read_pcx(path) -> Raster:
    """The pixels PIL gives for a PCX file (module note): a `Raster` of mode
    1 (bool), L, P (indices and palette) or RGB. ValueError naming the file
    where PIL's open or load raises."""

    def read(b):
        hdr = pcx_open(b, 0, path)
        return Raster(decode(b, hdr, path), hdr.mode, hdr.palette)

    return raster.read_mapped(path, read)


def encode_pcx(img: np.ndarray, mode: str, palette: np.ndarray | None = None) -> bytes:
    """PIL's PCX bytes of `img` in `mode`: bool or uint8 (h, w) for 1, uint8
    (h, w) for L and P (indices into `palette`, (n, 3) uint8), (h, w, 3)
    RGB."""
    if mode not in SAVE:
        raise ValueError(f"Cannot save {mode} images as PCX")
    version, bits, planes = SAVE[mode]
    img = np.asarray(img)
    h, w = img.shape[:2]
    plane_bytes = (w * bits + 7) // 8
    stride = plane_bytes + plane_bytes % 2
    head = struct.pack("<BBBBHHHHHH", 10, version, 1, bits, 0, 0, w - 1, h - 1, 100, 100)
    head += b"\0" * 24 + b"\xff" * 24 + b"\0" + struct.pack("<BHHHH", planes, stride, 1, w, h) + b"\0" * 54
    if mode == "1":
        lines = np.packbits(img.astype(bool), axis=1)
    elif mode == "RGB":
        lines = np.ascontiguousarray(np.asarray(img, np.uint8).transpose(0, 2, 1)).reshape(h, -1)
    else:
        lines = np.asarray(img, np.uint8)
    body = raster.encode("pcx", lines, h, planes, plane_bytes, stride - plane_bytes)
    tail = b""
    if mode == "P":
        pal = np.asarray(palette if palette is not None else np.zeros((0, 3)), np.uint8).reshape(-1, 3)[:256]
        tail = b"\x0c" + pal.tobytes().ljust(768, b"\0")
    elif mode == "L":
        tail = b"\x0c" + _GREY.tobytes()
    return head + body + tail


def write_pcx(path, img: np.ndarray, mode: str, palette: np.ndarray | None = None) -> None:
    """Write `img` as PIL's `img.save(path)` writes a PCX of `mode`."""
    Path(path).write_bytes(encode_pcx(img, mode, palette))
