"""PNG writing and PNG/JPEG size probing without an image library.

`write_png` writes gray (h, w), gray+alpha (h, w, 2), RGB (h, w, 3) and
RGBA (h, w, 4) images of 8 or 16 bits: one IHDR, one IDAT (every row with
filter 0, zlib at level 6, PIL's default) and IEND. Under PIL the 8-bit
ones and 16-bit gray open in the mode and with the pixels of PIL's own
save of the same image (modes L, LA, RGB, RGBA, I;16); the bytes differ,
since PIL picks its filters row by row. 16-bit colour, which PIL cannot
hold, opens as 8-bit (`pil_mode`).

`image_size` returns (width, height), as PIL's `Image.open(path).size`,
and `pil_mode` the mode PIL opens the file in, both read from a PNG's IHDR
or a JPEG's start-of-frame marker; anything else raises ValueError. PNG
decoding is data/images.py::read_png; JPEG reading and writing is
io/jpeg.py.
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
# the mode PIL opens a PNG in, by (bit depth, colour type), as PngImagePlugin's table gives it
_PNG_MODES = {(1, 0): "1", (2, 0): "L", (4, 0): "L", (8, 0): "L", (16, 0): "I;16", (8, 2): "RGB", (16, 2): "RGB",
              (1, 3): "P", (2, 3): "P", (4, 3): "P", (8, 3): "P", (8, 4): "LA", (16, 4): "RGBA", (8, 6): "RGBA",
              (16, 6): "RGBA"}
_JPEG_MODES = {1: "L", 3: "RGB", 4: "CMYK"}  # by component count
_COLOUR_TYPES = {1: 0, 2: 4, 3: 2, 4: 6}  # channels -> PNG colour type


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF)


def write_png(path: str | Path, img: np.ndarray) -> None:
    """Write a uint8 or uint16 (h, w), (h, w, 2), (h, w, 3) or (h, w, 4)
    image (gray, gray+alpha, RGB, RGBA) as a PNG of 8 or 16 bits."""
    img = np.asarray(img)
    channels = 1 if img.ndim == 2 else img.shape[-1]
    if img.dtype not in (np.uint8, np.uint16) or not (img.ndim == 2 or (img.ndim == 3 and channels in _COLOUR_TYPES)):
        raise ValueError(f"write_png takes uint8 or uint16 (h, w) or (h, w, 2|3|4), got {img.dtype} {img.shape}")
    h, w = img.shape[:2]
    samples = img.astype(">u2").view(np.uint8) if img.dtype == np.uint16 else img  # 16-bit samples big-endian
    rows = np.zeros((h, 1 + w * channels * img.itemsize), np.uint8)  # a 0 filter byte, then the row
    rows[:, 1:] = samples.reshape(h, -1)
    header = struct.pack(">IIBBBBB", w, h, 8 * img.itemsize, _COLOUR_TYPES[channels], 0, 0, 0)
    data = _PNG_SIGNATURE + _chunk(b"IHDR", header) + _chunk(b"IDAT", zlib.compress(rows.tobytes(), ZLIB_LEVEL)) \
        + _chunk(b"IEND", b"")
    Path(path).write_bytes(data)


def _jpeg_frame(f, path) -> tuple[int, int, int]:
    """(width, height, components): walk the JPEG's marker segments (after
    SOI) to its start of frame."""
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
        seg = f.read(8)
        if len(seg) < 2:
            break
        (n,) = struct.unpack(">H", seg[:2])
        if m in _SOF_MARKERS and len(seg) == 8:
            height, width, components = struct.unpack(">HHB", seg[3:8])  # after the length and the sample precision
            return width, height, components
        f.seek(n - len(seg), 1)
    raise ValueError(f"{path}: JPEG without a start-of-frame marker")


def _header(path) -> tuple[int, int, tuple]:
    """(width, height, kind) of a PNG or JPEG file: kind is ("png", bit
    depth, colour type) or ("jpeg", components)."""
    with open(path, "rb") as f:
        head = f.read(26)
        if head.startswith(_PNG_SIGNATURE) and head[12:16] == b"IHDR" and len(head) == 26:
            width, height, depth, ctype = struct.unpack(">IIBB", head[16:26])
            return width, height, ("png", depth, ctype)
        if head.startswith(b"\xff\xd8"):
            width, height, components = _jpeg_frame(f, path)
            return width, height, ("jpeg", components)
    raise ValueError(f"{path}: neither a PNG nor a JPEG file")


def image_size(path: str | Path) -> tuple[int, int]:
    """(width, height) of a PNG or JPEG file."""
    return _header(path)[:2]


def pil_mode(path: str | Path) -> str:
    """The mode PIL opens a PNG or JPEG file in: "1", "L", "I;16", "RGB",
    "P", "LA" or "RGBA" for a PNG (16-bit gray+alpha opens as RGBA), "L",
    "RGB" or "CMYK" for a JPEG of 1, 3 or 4 components. A file PIL does not
    open raises ValueError."""
    kind = _header(path)[2]
    mode = _PNG_MODES.get(kind[1:]) if kind[0] == "png" else _JPEG_MODES.get(kind[1])
    if mode is None:
        raise ValueError(f"{path}: no PIL mode for a {kind[0].upper()} of {kind[1:]} "
                         "(bit depth, colour type or components)")
    return mode
