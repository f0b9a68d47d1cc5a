"""Image file kinds, told apart by their signatures, and what PIL makes of
them without decoding: `image_size` (PIL's `Image.open(path).size`) and
`pil_mode` (the mode PIL opens the file in), read from the headers of PNG,
JPEG, TIFF (io/tiff.py), BMP (io/bmp.py), Netpbm/PFM (io/pnm.py), WebP
(io/webp.py, after the container checks libwebp makes when PIL opens it),
GIF (io/gif.py, PIL's frame 0) and JPEG 2000 (io/jpeg2000.py: a bare
codestream or a JP2 file) files. A file PIL does not open, or
opens as a kind the port does not read yet, raises ValueError naming the
file and the kind.

`Raster` is what the TIFF, BMP, PNM, WebP, GIF and JPEG 2000 readers
return: the pixels of `np.asarray(Image.open(path))` (for modes P and PA
the palette indices, for I;16B the values as native uint16), PIL's mode,
for modes P and PA the palette, and a GIF's transparency index (PIL's
`info["transparency"]`).
data/images.py::read_image turns it into the port's image types.
"""

from __future__ import annotations

import contextlib
import mmap
import os
import struct
from pathlib import Path
from typing import NamedTuple

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
JPEG_SIGNATURE = b"\xff\xd8"
# JPEG start-of-frame markers: 0xC0-0xCF but DHT (0xC4), JPG (0xC8) and DAC (0xCC)
_SOF_MARKERS = frozenset(range(0xC0, 0xD0)) - {0xC4, 0xC8, 0xCC}
# the mode PIL opens a PNG in, by (bit depth, colour type), as PngImagePlugin's table gives it
_PNG_MODES = {(1, 0): "1", (2, 0): "L", (4, 0): "L", (8, 0): "L", (16, 0): "I;16", (8, 2): "RGB", (16, 2): "RGB",
              (1, 3): "P", (2, 3): "P", (4, 3): "P", (8, 3): "P", (8, 4): "LA", (16, 4): "RGBA", (8, 6): "RGBA",
              (16, 6): "RGBA"}
_JPEG_MODES = {1: "L", 3: "RGB", 4: "CMYK"}  # by component count
# signatures of formats PIL opens that the port does not read yet (ROADMAP.md's queue)
_QUEUED = ((b"8BPS", 0, b"", "PSD"), (b"qoif", 0, b"", "QOI"), (b"DDS ", 0, b"", "DDS"),
           (b"\x00\x00\x01\x00", 0, b"", "ICO"), (b"icns", 0, b"", "ICNS"), (b"SIMPLE  =", 0, b"", "FITS"))


# PIL's Image.MAX_IMAGE_PIXELS: Image.open refuses more than twice as many
# pixels (a decompression bomb), and so do the TIFF, BMP, PNM, WebP, GIF and JPEG 2000 readers
MAX_IMAGE_PIXELS = 1024 * 1024 * 1024 // 4 // 3


def check_size(width: int, height: int, path) -> None:
    """Refuse what PIL's Image.open refuses: more than 2 * MAX_IMAGE_PIXELS
    pixels."""
    if width * height > 2 * MAX_IMAGE_PIXELS:
        raise ValueError(f"{path}: PIL does not open an image of {width} x {height} pixels (a decompression bomb)")


@contextlib.contextmanager
def mapped(path):
    """The file's bytes, memory-mapped (an empty file as b""); no view of
    them may outlive the `with`."""
    with open(path, "rb") as f:
        if os.fstat(f.fileno()).st_size == 0:
            yield b""
            return
        with mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ) as m:
            yield m


class Raster(NamedTuple):
    """A decoded TIFF, BMP, PNM, WebP, GIF or JPEG 2000 image: `pixels` as
    `np.asarray` of PIL's image gives them (I;16B as native uint16), PIL's
    `mode`, the (n, 3) uint8 `palette` of a mode-P or PA image (None
    otherwise), and a GIF's `transparency` index (None otherwise)."""

    pixels: np.ndarray
    mode: str
    palette: np.ndarray | None = None
    transparency: int | None = None


def kind(head: bytes) -> str | None:
    """The file kind its first bytes show: "png", "jpeg", "tiff", "bmp",
    "pnm", "webp" (RIFF, WEBP and a VP8, VP8L or VP8X chunk: Pillow's
    test), "gif" (GIF87a or GIF89a), "jpeg2000" (a codestream's SOC and
    SIZ, or the JP2 signature box), or None."""
    from acezero_tpu_torch.io import bmp, gif, jpeg2000, pnm, tiff, webp

    if head.startswith(PNG_SIGNATURE):
        return "png"
    if head.startswith(JPEG_SIGNATURE):
        return "jpeg"
    if tiff.is_tiff(head):
        return "tiff"
    if bmp.is_bmp(head):
        return "bmp"
    if pnm.is_pnm(head):
        return "pnm"
    if webp.is_webp(head):
        return "webp"
    if gif.is_gif(head):
        return "gif"
    if jpeg2000.is_jpeg2000(head):
        return "jpeg2000"
    return None


def file_kind(path) -> str | None:
    with open(path, "rb") as f:
        return kind(f.read(16))


def refusal(path) -> str:
    """The message for a file of no kind the port reads: what it is not,
    and the format when its signature shows one PIL opens."""
    with open(path, "rb") as f:
        head = f.read(16)
    for sig, at, sub, name in _QUEUED:
        if head.startswith(sig) and head[at: at + len(sub)] == sub:
            return (f"{path}: neither a PNG nor a JPEG, TIFF, BMP, Netpbm, PFM, WebP, GIF or JPEG 2000 file: "
                    f"{name}, not read yet")
    return f"{path}: neither a PNG nor a JPEG, TIFF, BMP, Netpbm, PFM, WebP, GIF or JPEG 2000 file"


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


def header(path) -> tuple[int, int, str]:
    """(width, height, PIL's mode) of an image file, from its header."""
    from acezero_tpu_torch.io import bmp, gif, jpeg2000, pnm, tiff, webp

    with open(path, "rb") as f:
        head = f.read(26)
        k = kind(head)
        if k == "png" and head[12:16] == b"IHDR" and len(head) == 26:
            width, height, depth, ctype = struct.unpack(">IIBB", head[16:26])
            mode = _PNG_MODES.get((depth, ctype))
            if mode is None:
                raise ValueError(f"{path}: no PIL mode for a PNG of bit depth {depth}, colour type {ctype}")
            return width, height, mode
        if k == "jpeg":
            width, height, components = _jpeg_frame(f, path)
            if components not in _JPEG_MODES:
                raise ValueError(f"{path}: no PIL mode for a JPEG of {components} components")
            return width, height, _JPEG_MODES[components]
    if k == "tiff":
        return tiff.tiff_header(path)
    if k == "bmp":
        return bmp.bmp_header(path)
    if k == "pnm":
        return pnm.pnm_header(path)
    if k == "webp":
        return webp.webp_header(path)
    if k == "gif":
        return gif.gif_header(path)[:3]
    if k == "jpeg2000":
        return jpeg2000.jpeg2000_header(path)
    raise ValueError(refusal(path))


def image_size(path: str | Path) -> tuple[int, int]:
    """(width, height) of an image file, as PIL's `Image.open(path).size`."""
    return header(path)[:2]


def pil_mode(path: str | Path) -> str:
    """The mode PIL opens an image file in: for a PNG "1", "L", "I;16",
    "RGB", "P", "LA" or "RGBA" (16-bit gray+alpha opens as RGBA), for a JPEG
    "L", "RGB" or "CMYK"; for a WebP "RGB" or "RGBA"; for a GIF "P" or "L";
    for a JPEG 2000 "L", "I;16", "LA", "RGB", "RGBA", "CMYK", "P" or "PA";
    for TIFF, BMP and PNM files what their readers give. A file PIL does not open raises ValueError."""
    return header(path)[2]
