"""Image file kinds, told apart as PIL's `Image.open` tells them apart,
and what PIL makes of them without decoding: `image_size` (PIL's
`Image.open(path).size`) and `pil_mode` (the mode PIL opens the file in),
read from the headers of PNG, JPEG, TIFF (io/tiff.py), BMP (io/bmp.py),
Netpbm/PFM (io/pnm.py), WebP (io/webp.py, after the container checks
libwebp makes when PIL opens it), GIF (io/gif.py, PIL's frame 0), JPEG 2000
(io/jpeg2000.py: a bare codestream or a JP2 file), TGA (io/tga.py), SGI
(io/sgi.py), PCX (io/pcx.py), DCX (io/dcx.py, its first page), Sun raster
(io/sun.py) and QOI (io/qoi.py) files. A file PIL does not open, or opens
as a kind the port does not read yet, raises ValueError naming the file
and the kind.

TGA has no signature: Pillow tries it after every plugin before it in its
order and takes a file whose header passes its checks. `kind` does the
same: it claims TGA only for a file that no kind before it claims, where a
PCX whose header Pillow gives up on (`pcx.falls_through`) goes on to the
later kinds as Pillow goes on to the later plugins, and where no plugin
that Pillow tries first and the port does not read would take the file
(`_pil_first`, and the queued kinds, refused by their own names).

`Raster` is what the TIFF, BMP, PNM, WebP, GIF, JPEG 2000, TGA, SGI, PCX,
DCX, Sun raster and QOI readers return: the pixels of
`np.asarray(Image.open(path))` (for modes P and PA the palette indices, for
I;16B the values as native uint16), PIL's mode, for modes P and PA the
palette (and for a TGA's L and LA the colour map PIL keeps under them),
and a GIF's transparency index (PIL's `info["transparency"]`).
data/images.py::read_image turns it into the port's image types.
"""

from __future__ import annotations

import contextlib
import math
import mmap
import os
import re
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
_QUEUED = ((b"8BPS", 0, b"", "PSD"), (b"DDS ", 0, b"", "DDS"), (b"\x00\x00\x01\x00", 0, b"", "ICO"),
           (b"\x00\x00\x02\x00", 0, b"", "CUR"), (b"icns", 0, b"", "ICNS"), (b"SIMPLE  =", 0, b"", "FITS"))
_READ = ("a PNG nor a JPEG, TIFF, BMP, Netpbm, PFM, WebP, GIF or JPEG 2000 file, nor a TGA, SGI, PCX, DCX, "
         "Sun raster or QOI file")
# Pillow's SPIDER header test: the header values that must be integers
_SPIDER_INTS = (1, 2, 5, 12, 13, 22, 23)
_IM_LINE = re.compile(rb"^([A-Za-z][^:]*):[ \t]*(.*)[ \t]*$")


# PIL's Image.MAX_IMAGE_PIXELS: Image.open refuses more than twice as many
# pixels (a decompression bomb), and so do the port's readers
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
    """A decoded image: `pixels` as `np.asarray` of PIL's image gives them
    (I;16B as native uint16), PIL's `mode`, the (n, 3) uint8 `palette` of a
    mode-P or PA image (and the colour map under a TGA's L or LA; None
    otherwise), and a GIF's `transparency` index (None otherwise)."""

    pixels: np.ndarray
    mode: str
    palette: np.ndarray | None = None
    transparency: int | None = None


def kind(head: bytes) -> str | None:
    """The file kind its first bytes show (all of a file of up to 2,052
    bytes, or its first 2,052): "png", "jpeg", "tiff", "bmp", "pnm", "webp"
    (RIFF, WEBP and a VP8, VP8L or VP8X chunk: Pillow's test), "gif" (GIF87a
    or GIF89a), "jpeg2000" (a codestream's SOC and SIZ, or the JP2
    signature box), "sgi", "sun", "qoi", "dcx", "pcx" (a header Pillow's
    plugin keeps), "tga" (module note), or None."""
    from acezero_tpu_torch.io import bmp, dcx, gif, jpeg2000, pcx, pnm, qoi, sgi, sun, tga, tiff, webp

    if head.startswith(PNG_SIGNATURE):
        return "png"
    if head.startswith(JPEG_SIGNATURE):
        return "jpeg"
    for name, test in (("tiff", tiff.is_tiff), ("bmp", bmp.is_bmp), ("pnm", pnm.is_pnm), ("webp", webp.is_webp),
                       ("gif", gif.is_gif), ("jpeg2000", jpeg2000.is_jpeg2000), ("sgi", sgi.is_sgi),
                       ("sun", sun.is_sun), ("qoi", qoi.is_qoi), ("dcx", dcx.is_dcx)):
        if test(head):
            return name
    if pcx.is_pcx(head) and not pcx.falls_through(head[:68]):
        return "pcx"
    if _queued(head) or _pil_first(head):
        return None
    if tga.is_tga(head):
        return "tga"
    return None


def _queued(head: bytes) -> str | None:
    """The queued format whose signature `head` shows. An ICO or CUR
    directory of no entries makes Pillow's plugin give up (so an RGB TGA,
    which starts as a CUR does, goes on to TGA)."""
    for sig, at, sub, name in _QUEUED:
        if head.startswith(sig) and head[at: at + len(sub)] == sub:
            if name in ("ICO", "CUR") and (len(head) < 6 or struct.unpack_from("<H", head, 4)[0] == 0):
                continue
            return name
    return None


def _spider(head: bytes) -> bool:
    """SpiderImagePlugin's header test, either byte order, of a 2-D image."""
    if len(head) < 108:
        return False
    for order in ">", "<":
        h = (99.0, *struct.unpack(order + "27f", head[:108]))
        if not all(math.isfinite(h[i]) and h[i] == int(h[i]) for i in _SPIDER_INTS):
            continue
        if int(h[5]) not in (1, 3, -11, -12, -21, -22) or int(h[22]) != int(h[13]) * int(h[23]):
            continue
        return int(h[5]) == 1
    return False


def _im_first_line(head: bytes) -> bool:
    """Whether the first line ImImagePlugin reads passes its syntax check
    (a CR before it is skipped, a line of over 100 bytes refused)."""
    if b"\n" not in head[:100]:
        return False
    line = head.lstrip(b"\r").split(b"\n", 1)[0]
    if not line or line[:1] in (b"\0", b"\x1a") or len(line) + 1 > 100:
        return False
    return _IM_LINE.match(line.rstrip(b"\r")) is not None


def _pil_first(head: bytes) -> str | None:
    """The plugin that Pillow tries before TGA, and that the port does not
    read, which would take a header TGA's checks also pass: AVIF, FLI,
    MPEG, IM, IPTC, PCD or SPIDER (their `_accept` tests and the first
    checks of their `_open`). GBR's colour depth field is TGA's depth byte
    followed by three more, never 1 or 4, so it takes no TGA."""
    if head[4:8] == b"ftyp" and head[8:12] in (b"avif", b"avis", b"mif1", b"msf1"):
        return "AVIF"
    if (len(head) >= 128 and struct.unpack_from("<H", head, 4)[0] in (0xAF11, 0xAF12)
            and struct.unpack_from("<H", head, 14)[0] in (0, 3) and not any(head[20:22] + head[42:80] + head[88:128])
            and all(struct.unpack_from("<HH", head, 8))):
        return "FLI"
    if head.startswith(b"\x00\x00\x01\xb3") and len(head) >= 7 and head[4] << 4 | head[5] >> 4 \
            and (head[5] & 15) << 8 | head[6]:
        return "MPEG"
    if _im_first_line(head):
        return "IM"
    if len(head) >= 2 and head[0] == 0x1C and head[1] in (1, 2, 3, 4, 5, 6, 7, 8, 9, 240):
        return "IPTC"
    if head[2048:2052] == b"PCD_":
        return "PCD"
    if _spider(head):
        return "SPIDER"
    return None


HEAD_BYTES = 2052


def file_kind(path) -> str | None:
    with open(path, "rb") as f:
        return kind(f.read(HEAD_BYTES))


def refusal(path) -> str:
    """The message for a file of no kind the port reads: what it is not,
    and the format when its signature shows one PIL opens."""
    with open(path, "rb") as f:
        head = f.read(HEAD_BYTES)
    name = _queued(head) or _pil_first(head)
    if name:
        return f"{path}: neither {_READ}: {name}, not read yet"
    return f"{path}: neither {_READ}"


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
    from acezero_tpu_torch.io import bmp, dcx, gif, jpeg2000, pcx, pnm, qoi, sgi, sun, tga, tiff, webp

    k = file_kind(path)
    if k in ("png", "jpeg"):
        with open(path, "rb") as f:
            head = f.read(26)
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
    readers = {"tiff": tiff.tiff_header, "bmp": bmp.bmp_header, "pnm": pnm.pnm_header, "webp": webp.webp_header,
               "gif": gif.gif_header, "jpeg2000": jpeg2000.jpeg2000_header, "tga": tga.tga_header,
               "sgi": sgi.sgi_header, "pcx": pcx.pcx_header, "dcx": dcx.dcx_header, "sun": sun.sun_header,
               "qoi": qoi.qoi_header}
    if k in readers:
        return tuple(readers[k](path)[:3])
    raise ValueError(refusal(path))


def image_size(path: str | Path) -> tuple[int, int]:
    """(width, height) of an image file, as PIL's `Image.open(path).size`."""
    return header(path)[:2]


def pil_mode(path: str | Path) -> str:
    """The mode PIL opens an image file in: for a PNG "1", "L", "I;16",
    "RGB", "P", "LA" or "RGBA" (16-bit gray+alpha opens as RGBA), for a JPEG
    "L", "RGB" or "CMYK"; for a WebP "RGB" or "RGBA"; for a GIF "P" or "L";
    for a JPEG 2000 "L", "I;16", "LA", "RGB", "RGBA", "CMYK", "P" or "PA";
    for TIFF, BMP, PNM, TGA, SGI, PCX, DCX, Sun raster and QOI files what
    their readers give. A file PIL does not open raises ValueError."""
    return header(path)[2]
