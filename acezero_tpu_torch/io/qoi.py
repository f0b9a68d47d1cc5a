"""QOI ("Quite OK Image") files without an image library, read as Pillow's
QoiImagePlugin reads them and written as its `save` writes them; the op
stream in io/csrc/raster.cpp through ctypes (io/raster.py).

What PIL makes of a file that starts with "qoif": the big-endian width and
height, "RGB" for 3 channels and "RGBA" for any other count, the
colourspace byte skipped, and the op stream from byte 14 decoded as
Pillow's QoiDecoder decodes it (io/csrc/raster.cpp); a stream that ends
before the last pixel raises. The end marker is not read.

`write_qoi(path, img, mode)` writes PIL's bytes for modes RGB and RGBA
(colourspace 1, as PIL's save writes by default); another mode raises
ValueError, as PIL's save does.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import NamedTuple

import numpy as np

from acezero_tpu_torch.io import raster
from acezero_tpu_torch.io.formats import Raster, check_size

SIGNATURE = b"qoif"
HEADER = 14


class QoiHeader(NamedTuple):
    width: int
    height: int
    mode: str


def is_qoi(head: bytes) -> bool:
    """Pillow's _accept."""
    return head.startswith(SIGNATURE)


def qoi_open(b, path) -> QoiHeader:
    """QoiImageFile._open: ValueError where PIL identifies no image (a
    header cut short, a size of 0)."""
    s = bytes(b[:13])
    if not is_qoi(s) or len(s) < 13:
        raise ValueError(f"{path}: QOI header cut short (PIL identifies no image)")
    width, height = struct.unpack_from(">II", s, 4)
    if width == 0 or height == 0:
        raise ValueError(f"{path}: QOI of {width} x {height} pixels (PIL identifies no image)")
    check_size(width, height, path)
    return QoiHeader(width, height, "RGB" if s[12] == 3 else "RGBA")


def qoi_header(path) -> QoiHeader:
    return raster.read_mapped(path, lambda b: qoi_open(b, path))


def read_qoi(path) -> Raster:
    """The pixels PIL gives for a QOI file: a `Raster` of mode RGB or RGBA.
    ValueError naming the file where PIL's open or load raises."""

    def read(b):
        hdr = qoi_open(b, path)
        bands = len(hdr.mode)
        px = np.empty((hdr.height, hdr.width, bands), np.uint8)
        src = np.frombuffer(b, np.uint8)[min(HEADER, len(b)):]
        raster.decode("qoi", src, hdr.width, hdr.height, bands, out=px, path=path, kind="QOI")
        return Raster(px, hdr.mode)

    return raster.read_mapped(path, read)


def encode_qoi(img: np.ndarray, mode: str) -> bytes:
    """PIL's QOI bytes of an (h, w, 3) RGB or (h, w, 4) RGBA uint8 image."""
    if mode not in ("RGB", "RGBA"):
        raise ValueError("Unsupported QOI image mode")
    img = np.asarray(img, np.uint8)
    h, w = img.shape[:2]
    head = SIGNATURE + struct.pack(">IIBB", w, h, len(mode), 1)
    return head + raster.encode("qoi", img, w, h, len(mode))


def write_qoi(path, img: np.ndarray, mode: str) -> None:
    """Write `img` as PIL's `img.save(path)` writes a QOI of `mode`."""
    Path(path).write_bytes(encode_qoi(img, mode))
