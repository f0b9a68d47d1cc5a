"""SGI image files (.rgb .rgba .bw .sgi) without an image library, read as
Pillow's SgiImagePlugin reads them and written as its `save` writes them;
the run-length rows in io/csrc/raster.cpp through ctypes (io/raster.py).

What PIL makes of a file that starts with the big-endian magic 474:
  - the 512-byte header's compression, bytes a channel (`bpc`), dimension,
    width, height and channel count; the mode from Pillow's MODES by (bpc,
    dimension, channels): "L" for one channel of dimension 1 or 2, "RGB"
    and "RGBA" for 3 and 4 of dimension 3; any other combination raises
    ValueError in PIL's open (no other plugin is tried);
  - verbatim bodies (compression 0): the channels one after another, rows
    from the bottom; 16-bit samples (bpc 2) keep their high byte, as
    Pillow's SGI16Decoder reads them into an 8-bit image;
  - run-length bodies (compression 1): io/csrc/raster.cpp;
  - any other compression: the file opens and `load` raises.
A 16-bit SGI is thus 8-bit in PIL; a depth map in millimetres reaches the
JAX package as its high byte over 1,000, and the port gives the same.

`write_sgi(path, img, mode)` writes PIL's bytes for modes L, RGB and RGBA
(verbatim, bpc 1; the image name is the file name's stem, as PIL takes
it); another mode raises ValueError, as PIL's save does.
"""

from __future__ import annotations

import os
import struct
from pathlib import Path
from typing import NamedTuple

import numpy as np

from acezero_tpu_torch.io import raster
from acezero_tpu_torch.io.formats import Raster, check_size

SUFFIXES = (".sgi", ".rgb", ".rgba", ".bw")
MAGIC = 474
HEADER = 512
# Pillow's MODES: (bpc, dimension, channels) -> mode
MODES = {(1, 1, 1): "L", (1, 2, 1): "L", (2, 1, 1): "L", (2, 2, 1): "L", (1, 3, 3): "RGB", (2, 3, 3): "RGB",
         (1, 3, 4): "RGBA", (2, 3, 4): "RGBA"}


class SgiHeader(NamedTuple):
    width: int
    height: int
    mode: str
    compression: int
    bpc: int


def is_sgi(head: bytes) -> bool:
    """Pillow's _accept: the big-endian magic 474."""
    return len(head) >= 2 and head[0] == 1 and head[1] == 0xDA


def sgi_open(b, path) -> SgiHeader:
    """SgiImageFile._open: ValueError where it raises, and where it gives up
    (a header cut short, a size of 0: no later plugin takes the file)."""
    s = bytes(b[:HEADER])
    if not is_sgi(s):
        raise ValueError(f"{path}: not an SGI image file")
    if len(s) < 12:
        raise ValueError(f"{path}: SGI header cut short (PIL identifies no image)")
    compression, bpc = s[2], s[3]
    dimension, width, height, zsize = struct.unpack_from(">HHHH", s, 4)
    mode = MODES.get((bpc, dimension, zsize))
    if mode is None:
        raise ValueError(f"{path}: unsupported SGI image mode (bpc {bpc}, dimension {dimension}, {zsize} channels)")
    if width == 0 or height == 0:
        raise ValueError(f"{path}: an SGI of {width} x {height} pixels (PIL identifies no image)")
    check_size(width, height, path)
    return SgiHeader(width, height, mode, compression, bpc)


def sgi_header(path) -> SgiHeader:
    return raster.read_mapped(path, lambda b: sgi_open(b, path))


def read_sgi(path) -> Raster:
    """The pixels PIL gives for an SGI file (module note): a `Raster` of
    mode L, RGB or RGBA, uint8. ValueError naming the file where PIL's open
    or load raises."""
    return raster.read_mapped(path, lambda b: _read(b, path))


def _read(b, path) -> Raster:
    hdr = sgi_open(b, path)
    w, h, bands = hdr.width, hdr.height, len(hdr.mode)
    if hdr.compression == 0:
        page = w * h * hdr.bpc
        body = raster.need(b, HEADER, page * bands, path, "SGI").reshape(bands, h, w * hdr.bpc)
        px = np.ascontiguousarray(body[:, ::-1, :: hdr.bpc].transpose(1, 2, 0))
    elif hdr.compression == 1:
        px = np.zeros((h, w, bands), np.uint8)
        src = np.frombuffer(b, np.uint8)[HEADER:]
        raster.decode("sgi_rle", src, w, h, bands, hdr.bpc, out=px, path=path, kind="SGI")
    else:
        raise ValueError(f"{path}: SGI compression {hdr.compression} (PIL: cannot load this image)")
    return Raster(px[..., 0] if bands == 1 else px, hdr.mode)


def encode_sgi(img: np.ndarray, mode: str, name: str = "") -> bytes:
    """PIL's SGI bytes of `img` in mode L ((h, w) uint8), RGB or RGBA, with
    the image name `name`."""
    if mode not in ("L", "RGB", "RGBA"):
        raise ValueError("Unsupported SGI image mode")
    img = np.asarray(img, np.uint8)
    h, w = img.shape[:2]
    dimension = (1 if h == 1 else 2) if mode == "L" else 3
    planes = img[None] if img.ndim == 2 else img.transpose(2, 0, 1)
    head = struct.pack(">hBBHHHHll4s79ssl404s", MAGIC, 0, 1, dimension, w, h, len(mode), 0, 255, b"",
                       name.encode("ascii", "ignore"), b"", 0, b"")
    return head + np.ascontiguousarray(planes[:, ::-1]).tobytes()


def write_sgi(path, img: np.ndarray, mode: str) -> None:
    """Write `img` as PIL's `img.save(path)` writes an SGI of `mode`."""
    Path(path).write_bytes(encode_sgi(img, mode, os.path.splitext(os.path.basename(str(path)))[0]))
