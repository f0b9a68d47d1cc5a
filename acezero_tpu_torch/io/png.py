"""PNG writing and PNG/JPEG size probing without an image library.

`write_png` writes 8-bit gray (h, w) or RGB (h, w, 3) images: one IHDR,
one IDAT (every row with filter 0, zlib at level 6, PIL's default) and
IEND. The pixels decode as PIL's `Image.fromarray(img).save(path)` would
give them; the bytes differ, since PIL picks its filters row by row.

`image_size` returns (width, height), as PIL's `Image.open(path).size`,
read from a PNG's IHDR or a JPEG's start-of-frame marker; anything else
raises ValueError. PNG decoding is data/images.py::read_png; JPEG reading
and writing is io/jpeg.py.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
ZLIB_LEVEL = 6
# JPEG start-of-frame markers: 0xC0-0xCF but DHT (0xC4), JPG (0xC8) and DAC (0xCC)
_SOF_MARKERS = frozenset(range(0xC0, 0xD0)) - {0xC4, 0xC8, 0xCC}


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF)


def write_png(path: str | Path, img_u8: np.ndarray) -> None:
    """Write an 8-bit gray (h, w) or RGB (h, w, 3) image as a PNG."""
    img = np.asarray(img_u8)
    if img.dtype != np.uint8 or not (img.ndim == 2 or (img.ndim == 3 and img.shape[2] == 3)):
        raise ValueError(f"write_png takes uint8 (h, w) or (h, w, 3), got {img.dtype} {img.shape}")
    h, w = img.shape[:2]
    rows = np.zeros((h, 1 + w * (1 if img.ndim == 2 else 3)), np.uint8)  # a 0 filter byte, then the row
    rows[:, 1:] = img.reshape(h, -1)
    header = struct.pack(">IIBBBBB", w, h, 8, 0 if img.ndim == 2 else 2, 0, 0, 0)
    data = _PNG_SIGNATURE + _chunk(b"IHDR", header) + _chunk(b"IDAT", zlib.compress(rows.tobytes(), ZLIB_LEVEL)) \
        + _chunk(b"IEND", b"")
    Path(path).write_bytes(data)


def _jpeg_size(f, path) -> tuple[int, int]:
    """Walk the JPEG's marker segments (after SOI) to its start of frame."""
    f.seek(2)
    while True:
        byte = f.read(1)
        if byte != b"\xff":
            raise ValueError(f"{path}: corrupt JPEG (no marker where one was expected)")
        while byte == b"\xff":  # fill bytes before the marker code
            byte = f.read(1)
        if not byte or byte == b"\xd9":  # end of file or EOI
            break
        m = byte[0]
        if m == 0x01 or 0xD0 <= m <= 0xD8:  # TEM, RSTn, SOI: no length
            continue
        seg = f.read(7)
        if len(seg) < 2:
            break
        (n,) = struct.unpack(">H", seg[:2])
        if m in _SOF_MARKERS and len(seg) == 7:
            height, width = struct.unpack(">HH", seg[3:7])  # after the length and the sample precision
            return width, height
        f.seek(n - len(seg), 1)
    raise ValueError(f"{path}: JPEG without a start-of-frame marker")


def image_size(path: str | Path) -> tuple[int, int]:
    """(width, height) of a PNG or JPEG file."""
    with open(path, "rb") as f:
        head = f.read(24)
        if head.startswith(_PNG_SIGNATURE) and head[12:16] == b"IHDR":
            return struct.unpack(">II", head[16:24])
        if head.startswith(b"\xff\xd8"):
            return _jpeg_size(f, path)
    raise ValueError(f"{path}: neither a PNG nor a JPEG file")
