"""PNG writing without an image library.

`write_png` writes gray (h, w), gray+alpha (h, w, 2), RGB (h, w, 3) and
RGBA (h, w, 4) images of 8 or 16 bits, a bool (h, w) image as 1-bit gray
(PIL's mode 1) and (h, w) uint8 indices with a palette as a palette image
(mode P): one IHDR, a PLTE for a palette, one IDAT (every row with filter
0, zlib at level 6, PIL's default) and IEND. Under PIL they open in the
mode and with the pixels of PIL's own save of the same image (modes 1, L,
P, LA, RGB, RGBA, I;16); the bytes differ, since PIL picks its filters row
by row and its bit depth of a palette by its size. 16-bit colour, which
PIL cannot hold, opens as 8-bit (io/formats.py::pil_mode).

PNG decoding is data/images.py::read_png.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

from acezero_tpu_torch.io.formats import PNG_SIGNATURE as _PNG_SIGNATURE

ZLIB_LEVEL = 6
_COLOUR_TYPES = {1: 0, 2: 4, 3: 2, 4: 6}  # channels -> PNG colour type


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF)


def write_png(path: str | Path, img: np.ndarray, palette: np.ndarray | None = None) -> None:
    """Write a uint8 or uint16 (h, w), (h, w, 2), (h, w, 3) or (h, w, 4)
    image (gray, gray+alpha, RGB, RGBA) as a PNG of 8 or 16 bits, a bool
    (h, w) image as 1-bit gray, or (h, w) uint8 indices into `palette`
    ((n, 3) uint8, at most 256 colours) as an 8-bit palette image."""
    img = np.asarray(img)
    channels = 1 if img.ndim == 2 else img.shape[-1]
    h, w = img.shape[:2]
    plte = b""
    if palette is not None:
        colours = np.asarray(palette, np.uint8).reshape(-1, 3)
        if img.dtype != np.uint8 or img.ndim != 2 or not 0 < len(colours) <= 256:
            raise ValueError(f"write_png takes uint8 (h, w) indices and 1-256 colours, got {img.dtype} {img.shape}, "
                             f"{len(colours)} colours")
        plte = _chunk(b"PLTE", colours.tobytes())
        samples, depth, ctype = img, 8, 3
    elif img.dtype == bool and img.ndim == 2:
        samples, depth, ctype = np.packbits(img, axis=1), 1, 0
    elif img.dtype in (np.uint8, np.uint16) and (img.ndim == 2 or (img.ndim == 3 and channels in _COLOUR_TYPES)):
        samples = img.astype(">u2").view(np.uint8) if img.dtype == np.uint16 else img  # 16-bit samples big-endian
        depth, ctype = 8 * img.itemsize, _COLOUR_TYPES[channels]
    else:
        raise ValueError(f"write_png takes uint8 or uint16 (h, w) or (h, w, 2|3|4), or bool (h, w), "
                         f"got {img.dtype} {img.shape}")
    row = samples.reshape(h, -1)
    rows = np.zeros((h, 1 + row.shape[1]), np.uint8)  # a 0 filter byte, then the row
    rows[:, 1:] = row
    header = struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, 0)
    data = _PNG_SIGNATURE + _chunk(b"IHDR", header) + plte \
        + _chunk(b"IDAT", zlib.compress(rows.tobytes(), ZLIB_LEVEL)) + _chunk(b"IEND", b"")
    Path(path).write_bytes(data)
