"""JPEG 2000 files without an image library: the JP2 boxes here, the
codestream in io/csrc/jpeg2000.cpp through ctypes; read as PIL reads them
(Pillow's Jpeg2KImagePlugin over openjpeg 2.5) and written for the
Nerfstudio runner.

`read_jpeg2000(path)` gives a `Raster` (io/formats.py) of
`np.asarray(Image.open(path))`. PIL opens a bare codestream (`FF 4F FF 51`)
or a JP2 file (its 12-byte signature box) and takes its size and mode from
the headers alone:
  - a codestream: the size of SIZ's image area; one component is L, or
    I;16 above 8 bits, two LA, three RGB, four RGBA;
  - a JP2 file: the first `jp2h` box, in which `ihdr` gives the size and
    the mode as above (but I;16 only from 10 bits: its test is on the bit
    depth byte), a `colr` box of enumerated colour space 12 makes four
    components CMYK, and a `pclr` box of at most 8-bit columns makes L
    and LA the palette modes P and PA, with the palette's colours in the
    order they first occur (ImagePalette.getcolor: a repeated colour is
    not added again, and the indices are not remapped). Its `res ` box is
    read for the resolution only.
openjpeg then decodes the codestream, whose own boxes it walks first
(`_walk_boxes`: signature, file type and header boxes in order, the
header's `ihdr`, `colr`, `bpcc`, `pclr`, `cmap` and `cdef` checked as it
checks them), tile by tile, and PIL unpacks each component sample into its
mode as Pillow's Jpeg2KDecode.c does (`_unpack`): the samples of more
than 8 bits (16 for I;16) shifted down with rounding, of fewer shifted
up, signed ones offset to unsigned, each truncated to the mode's bytes;
the colour space (sRGB, grey, sYCC or CMYK from `colr`; by the component
count for a bare codestream) picks the unpacker, and an sYCC image goes
through Pillow's YCbCr to RGB conversion. A codestream whose image is
not of PIL's size (a JP2's `ihdr` box) is refused, as Pillow's decoder
refuses it. Where PIL's open or load raises, the port raises
ValueError naming the file; the codestream features Pillow's encoder
cannot write are refused by name (io/csrc/jpeg2000.cpp).

`jpeg2000_header(path)` gives (width, height, PIL's mode) from the boxes
and the main header. `write_jpeg2000(path, img, mode)` writes a lossless
5/3 file, one tile and one layer, in the modes PIL saves (L, LA, RGB,
RGBA, CMYK, I;16): a bare codestream for a name ending `.j2k`, JP2 boxes
for any other name, as Pillow's `_save` picks; PIL reads it back to its
read-back of its own save of the same pixels. Its bytes are the port's
own.
"""

from __future__ import annotations

import ctypes
import functools
import os
import struct
from pathlib import Path
from typing import NamedTuple

import numpy as np

from acezero_tpu_torch.io.formats import Raster, check_size, mapped
from acezero_tpu_torch.ops import build

SOURCE = Path(__file__).resolve().parent / "csrc" / "jpeg2000.cpp"
CODESTREAM_SIGNATURE = b"\xff\x4f\xff\x51"
JP2_SIGNATURE = b"\x00\x00\x00\x0cjP  \x0d\x0a\x87\x0a"
_ERR_BYTES = 512
_MAX_COMPS = 4  # PIL's decoder takes one to four components
# openjpeg's colour spaces (opj_jp2_read_header, by the colr box's enumerated space)
UNSPECIFIED, SRGB, GRAY, SYCC, EYCC, CMYK = "unspecified", "srgb", "gray", "sycc", "eycc", "cmyk"
_ENUMCS = {16: SRGB, 17: GRAY, 18: SYCC, 24: EYCC, 12: CMYK}
# Pillow's j2k_unpackers: (mode, colour space, components) -> unpacker
_UNPACKERS = {
    ("L", GRAY, 1): "gray_l", ("P", SRGB, 1): "gray_l", ("PA", SRGB, 2): "graya_la",
    ("I;16", GRAY, 1): "gray_i", ("LA", GRAY, 2): "graya_la",
    ("RGB", GRAY, 1): "gray_rgb", ("RGB", GRAY, 2): "gray_rgb",
    ("RGB", SRGB, 3): "srgb_rgb", ("RGB", SYCC, 3): "sycc_rgb", ("RGB", SRGB, 4): "srgb_rgb",
    ("RGB", SYCC, 4): "sycc_rgb", ("RGBA", GRAY, 1): "gray_rgb", ("RGBA", GRAY, 2): "graya_la",
    ("RGBA", SRGB, 3): "srgb_rgb", ("RGBA", SYCC, 3): "sycc_rgb", ("RGBA", SRGB, 4): "srgba_rgba",
    ("RGBA", SYCC, 4): "sycca_rgba", ("CMYK", CMYK, 4): "srgba_rgba",
}
SAVE_MODES = ("L", "LA", "RGB", "RGBA", "CMYK", "I;16")  # the modes PIL saves (as written)
_SAVE_ENUMCS = {"L": 17, "LA": 17, "I;16": 17, "RGB": 16, "RGBA": 16, "CMYK": 12}


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load_host(SOURCE)
    p, n, err, i, i64 = ctypes.c_void_p, ctypes.c_size_t, ctypes.c_char_p, ctypes.c_int, ctypes.c_int64
    lib.acz_j2k_info.argtypes = [p, n, p, i, err, i]
    lib.acz_j2k_info.restype = i
    lib.acz_j2k_decode.argtypes = [p, n, p, i64, err, i]
    lib.acz_j2k_decode.restype = i
    lib.acz_j2k_encode.argtypes = [p, i, i, i, i, ctypes.POINTER(ctypes.c_void_p), err, i]
    lib.acz_j2k_encode.restype = i64
    lib.acz_j2k_free.argtypes = [p]
    lib.acz_j2k_free.restype = None
    return lib


def is_jpeg2000(head: bytes) -> bool:
    """Pillow's _accept: a codestream's SOC and SIZ, or the JP2 signature box."""
    return head.startswith(CODESTREAM_SIGNATURE) or head.startswith(JP2_SIGNATURE)


class _Refused(Exception):
    """Where PIL's open or load raises."""


class _Reader:
    """A file object over bytes (or a memory map)."""

    def __init__(self, b):
        self.b, self.pos, self.end = b, 0, len(b)

    def read(self, n: int) -> bytes:
        n = max(0, min(n, self.end - self.pos))
        out = bytes(self.b[self.pos: self.pos + n])
        self.pos += n
        return out

    def seek_cur(self, n: int) -> None:
        if self.pos + n < 0:
            raise _Refused("a seek before the start of the file")
        self.pos += n


class _BoxReader:
    """Pillow's BoxReader, on a _Reader whose `end` is the box's."""

    def __init__(self, fp: _Reader, length: int = -1):
        self.fp, self.has_length, self.length = fp, length >= 0, length
        self.remaining_in_box = -1

    def _can_read(self, n: int) -> bool:
        if self.has_length and self.fp.pos + n > self.length:
            return False
        if self.remaining_in_box >= 0:
            return n <= self.remaining_in_box
        return True

    def _read_bytes(self, n: int) -> bytes:
        if not self._can_read(n):
            raise _Refused("not enough data in a JP2 header box")
        data = self.fp.read(n)
        if len(data) < n:
            raise _Refused("a JP2 box cut short")
        if self.remaining_in_box > 0:
            self.remaining_in_box -= n
        return data

    def read_fields(self, fmt: str) -> tuple:
        return struct.unpack(fmt, self._read_bytes(struct.calcsize(fmt)))

    def read_boxes(self) -> "_BoxReader":
        size = self.remaining_in_box
        data = self._read_bytes(size)
        return _BoxReader(_Reader(data), size)

    def has_next_box(self) -> bool:
        if self.has_length:
            return self.fp.pos + self.remaining_in_box < self.length
        return True

    def next_box_type(self) -> bytes:
        if self.remaining_in_box > 0:
            self.fp.seek_cur(self.remaining_in_box)
        self.remaining_in_box = -1
        lbox, tbox = self.read_fields(">I4s")
        if lbox == 1:
            lbox = self.read_fields(">Q")[0]
            hlen = 16
        else:
            hlen = 8
        if lbox < hlen or not self._can_read(lbox - hlen):
            raise _Refused("invalid JP2 box length")
        self.remaining_in_box = lbox - hlen
        return tbox


class Jp2Header(NamedTuple):
    """What PIL's open makes of a JPEG 2000 file: its size and mode, the
    palette of P and PA ((n, 3) uint8), openjpeg's colour space, and where
    the codestream starts."""

    width: int
    height: int
    mode: str
    palette: np.ndarray | None
    color_space: str
    codestream: int


def _i16be(b: bytes) -> int:
    if len(b) < 2:
        raise _Refused("a marker segment cut short")
    return (b[0] << 8) | b[1]


def _parse_codestream(fp: _Reader) -> tuple[tuple[int, int], str]:
    """Pillow's _parse_codestream: the size and mode from SIZ."""
    hdr = fp.read(2)
    lsiz = _i16be(hdr)
    siz = hdr + fp.read(lsiz - 2)
    if len(siz) < 38:
        raise _Refused("SIZ cut short")
    _, _, xsiz, ysiz, xosiz, yosiz, _, _, _, _, csiz = struct.unpack_from(">HHIIIIIIIIH", siz)
    size = (xsiz - xosiz, ysiz - yosiz)
    if csiz == 1:
        if len(siz) < 39:
            raise _Refused("SIZ cut short")
        mode = "I;16" if (siz[38] & 0x7F) + 1 > 8 else "L"
    elif csiz in (2, 3, 4):
        mode = {2: "LA", 3: "RGB", 4: "RGBA"}[csiz]
    else:
        raise _Refused("unable to determine J2K image mode")
    return size, mode


def _parse_comment(fp: _Reader) -> None:
    """Pillow's _parse_comment, for the errors it raises (the comment is not
    kept)."""
    while True:
        marker = fp.read(2)
        if not marker:
            break
        if len(marker) < 2:
            raise _Refused("a marker cut short")
        if marker[1] in (0x90, 0xD9):
            break
        length = _i16be(fp.read(2))
        if marker[1] == 0x64:
            fp.read(length - 2)
            break
        fp.seek_cur(length - 2)


def _palette(header: _BoxReader) -> np.ndarray | None:
    """A pclr box as Pillow reads it: None where a column is deeper than 8
    bits, else the colours as ImagePalette.getcolor adds them ((n, 3)
    uint8: an RGBA palette's alpha, which no conversion the port makes
    reads, dropped after the repeats are)."""
    ne, npc = header.read_fields(">HB")
    depths = header.read_fields(">" + "B" * npc)
    if max(depths, default=0) > 8:
        return None
    if npc not in (3, 4):
        raise _Refused("a pclr palette of %d columns, not read yet" % npc)
    colors: dict[tuple, int] = {}
    for _ in range(ne):
        color = header.read_fields(">" + "B" * npc)
        if color not in colors:
            if len(colors) >= 256:
                raise _Refused("cannot allocate more than 256 colors")
            colors[color] = len(colors)
    return np.array(list(colors), np.uint8).reshape(-1, npc)[:, :3]


def _parse_jp2_header(fp: _Reader):
    """Pillow's _parse_jp2_header: (size, mode, palette)."""
    reader = _BoxReader(fp)
    header = None
    while reader.has_next_box():
        tbox = reader.next_box_type()
        if tbox == b"jp2h":
            header = reader.read_boxes()
            break
        if tbox == b"ftyp":
            reader.read_fields(">4s")
    if header is None:
        raise _Refused("no jp2h box (PIL's assertion)")
    size = mode = nc = None
    palette = None
    while header.has_next_box():
        tbox = header.next_box_type()
        if tbox == b"ihdr":
            height, width, nc, bpc = header.read_fields(">IIHB")
            size = (width, height)
            if nc == 1 and (bpc & 0x7F) > 8:
                mode = "I;16"
            elif nc in (1, 2, 3, 4):
                mode = {1: "L", 2: "LA", 3: "RGB", 4: "RGBA"}[nc]
        elif tbox == b"colr" and nc == 4:
            meth, _, _, enumcs = header.read_fields(">BBBI")
            if meth == 1 and enumcs == 12:
                mode = "CMYK"
        elif tbox == b"pclr" and mode in ("L", "LA"):
            pal = _palette(header)
            if pal is not None:
                palette = pal
                mode = "P" if mode == "L" else "PA"
        elif tbox == b"res ":
            res = header.read_boxes()
            while res.has_next_box():
                if res.next_box_type() == b"resc":
                    res.read_fields(">HHHHBB")
                    break
    if size is None or mode is None:
        raise _Refused("malformed JP2 header")
    return size, mode, palette


def _u32(b: bytes, at: int) -> int:
    return struct.unpack_from(">I", b, at)[0]


def _walk_boxes(b, path) -> tuple[int, str]:
    """openjpeg's walk of the JP2 boxes up to the codestream box
    (opj_jp2_read_header_procedure and the header box's handlers):
    (where the codestream starts, the colour space of the first colr box)."""
    pos, n = 0, len(b)
    state = set()
    enumcs = None
    has_colr = False
    numcomps = pclr_columns = 0
    has_pclr = has_cmap = has_cdef = False
    while True:
        if pos + 8 > n:
            raise _Refused("no codestream box")
        length, tbox = _u32(b, pos), bytes(b[pos + 4: pos + 8])
        hlen = 8
        if length == 1:
            if pos + 16 > n:
                raise _Refused("a box header cut short")
            if _u32(b, pos + 8) != 0:
                raise _Refused("a box of more than 2^32 bytes")
            length, hlen = _u32(b, pos + 12), 16
        elif length == 0:
            length = n - pos
        if tbox == b"jp2c":
            if "header" not in state:
                raise _Refused("a codestream box before the header box")
            return pos + hlen, _ENUMCS.get(enumcs, UNSPECIFIED)
        if length < hlen:
            raise _Refused("invalid JP2 box size")
        body = pos + hlen
        size = length - hlen
        if tbox in (b"jP  ", b"ftyp", b"jp2h"):
            if size > n - body:
                raise _Refused("a JP2 box past the end of the file")
            data = bytes(b[body: body + size])
            if tbox == b"jP  ":
                if state:
                    raise _Refused("the signature box is not the first")
                if size != 4 or _u32(data, 0) != 0x0D0A870A:
                    raise _Refused("a bad signature box")
                state.add("signature")
            elif tbox == b"ftyp":
                if state != {"signature"}:
                    raise _Refused("the file type box is not the second")
                if size < 8 or (size - 8) % 4:
                    raise _Refused("a bad file type box")
                state.add("ftyp")
            else:
                if "ftyp" not in state:
                    raise _Refused("the header box before the file type box")
                at, seen_ihdr = 0, False
                while at < size:
                    if size - at < 8:
                        raise _Refused("a header box cut short")
                    blen, btype = _u32(data, at), data[at + 4: at + 8]
                    bh = 8
                    if blen == 1:
                        if size - at < 16 or _u32(data, at + 8) != 0:
                            raise _Refused("a bad header box")
                        blen, bh = _u32(data, at + 12), 16
                    elif blen == 0:
                        raise _Refused("a header box of no length")
                    if blen < bh or blen > size - at:
                        raise _Refused("a header box past the end of the header")
                    d = data[at + bh: at + blen]
                    if btype == b"ihdr":
                        if len(d) != 14:
                            raise _Refused("a bad ihdr box")
                        numcomps = struct.unpack_from(">H", d, 8)[0]
                        if numcomps == 0 or struct.unpack_from(">I", d, 0)[0] == 0 or _u32(d, 4) == 0:
                            raise _Refused("an empty image in ihdr")
                        seen_ihdr = True
                    elif btype == b"colr":
                        if len(d) < 3:
                            raise _Refused("a bad colr box")
                        if not has_colr:
                            meth = d[0]
                            if meth == 1:
                                if len(d) < 7:
                                    raise _Refused("a bad colr box")
                                enumcs = _u32(d, 3)
                                has_colr = True
                            elif meth == 2:
                                enumcs = None
                                has_colr = True
                    elif btype == b"bpcc":
                        if len(d) != numcomps:
                            raise _Refused("a bad bpcc box")
                    elif btype == b"pclr":
                        if has_pclr or len(d) < 3:
                            raise _Refused("a bad pclr box")
                        ne, npc = struct.unpack_from(">HB", d)
                        if ne == 0 or ne > 1024 or npc == 0 or len(d) < 3 + npc:
                            raise _Refused("a bad pclr box")
                        need = 3 + npc + ne * sum(min(((x & 0x7F) + 8) // 8, 4) for x in d[3: 3 + npc])
                        if len(d) < need:
                            raise _Refused("a pclr box cut short")
                        has_pclr = True
                        pclr_columns = npc
                    elif btype == b"cmap":
                        if not has_pclr or has_cmap or len(d) < 4 * pclr_columns:
                            raise _Refused("a bad cmap box")
                        has_cmap = True
                    elif btype == b"cdef":
                        if has_cdef or len(d) < 2:
                            raise _Refused("a bad cdef box")
                        count = struct.unpack_from(">H", d)[0]
                        if count == 0 or len(d) < 2 + 6 * count:
                            raise _Refused("a bad cdef box")
                        has_cdef = True
                    at += blen
                if not seen_ihdr:
                    raise _Refused("a header box without ihdr")
                state.add("header")
        else:
            if "signature" not in state or "ftyp" not in state:
                raise _Refused("a JP2 file without its signature and file type boxes first")
            if size > n - body:
                raise _Refused("a JP2 box past the end of the file")
        pos = body + size


def _open(b, path) -> Jp2Header:
    """Jpeg2KImageFile._open, then openjpeg's walk to the codestream."""
    fp = _Reader(b)
    sig = fp.read(4)
    if sig == CODESTREAM_SIGNATURE:
        (width, height), mode = _parse_codestream(fp)
        _parse_comment(fp)
        palette, color_space, start = None, UNSPECIFIED, 0
    else:
        sig += fp.read(8)
        if sig != JP2_SIGNATURE:
            raise _Refused("not a JPEG 2000 file")
        (width, height), mode, palette = _parse_jp2_header(fp)
        if fp.read(12).endswith(b"jp2c\xff\x4f\xff\x51"):
            length = _i16be(fp.read(2))
            fp.seek_cur(length - 2)
            _parse_comment(fp)
        start, color_space = _walk_boxes(b, path)
    if width <= 0 or height <= 0:
        raise _Refused(f"an image of {width} x {height} pixels")
    check_size(width, height, path)
    return Jp2Header(width, height, mode, palette, color_space, start)


def _error(path, msg: str) -> ValueError:
    """ValueError naming the file: a feature not read yet by its name, else
    what makes the file corrupt."""
    return ValueError(f"{path}: {msg}" if msg.endswith("not read yet") else f"{path}: corrupt JPEG 2000 ({msg})")


def jpeg2000_header(path) -> tuple[int, int, str]:
    """(width, height, PIL's mode) of a JPEG 2000 file, from its boxes and
    main header."""
    with mapped(path) as b:
        try:
            h = _open(b, path)
            return h.width, h.height, h.mode
        except _Refused as e:
            msg = str(e)
    raise _error(path, msg)


def _codestream_info(data: np.ndarray):
    """(x0, y0, x1, y1, [(prec, signed)] * components) of a codestream's SIZ."""
    info = np.zeros(5 + 4 * _MAX_COMPS, np.int64)
    err = ctypes.create_string_buffer(_ERR_BYTES)
    if _lib().acz_j2k_info(data.ctypes.data, data.size, info.ctypes.data, _MAX_COMPS, err, _ERR_BYTES):
        raise _Refused(err.value.decode(errors="replace"))
    x0, y0, x1, y1, nc = (int(v) for v in info[:5])
    comps = [(int(info[5 + 4 * c]), bool(info[6 + 4 * c])) for c in range(min(nc, _MAX_COMPS))]
    return x0, y0, x1, y1, nc, comps


def _unpack_component(samples: np.ndarray, prec: int, signed: bool, bits: int) -> np.ndarray:
    """Pillow's j2ku_shift of one component's samples into `bits` bits: the
    sample as openjpeg stores it (1, 2 or 4 bytes by its precision),
    offset to unsigned, shifted to `bits` with rounding, truncated."""
    dtype = np.uint16 if bits == 16 else np.uint8
    if not signed and prec == bits:  # the samples are clamped to the range already
        return samples.astype(dtype)
    csiz = (prec + 7) >> 3
    mask = {1: 0xFF, 2: 0xFFFF}.get(csiz, 0xFFFFFFFF)
    word = samples.astype(np.int64) & mask
    shift = bits - prec
    offset = (1 << (prec - 1)) if signed else 0
    if shift < 0:
        offset += 1 << (-shift - 1)
    x = (word + offset) & 0xFFFFFFFF
    x = (x >> -shift) if shift < 0 else ((x << shift) & 0xFFFFFFFF)
    return (x & ((1 << bits) - 1)).astype(dtype)


@functools.cache
def _ycbcr_tables():
    """Pillow's ConvertYCbCr.c tables, in units of 1/64, each entry C's
    `(int)(c * 64 * (i - 128) + 0.5)`: R from Cr, G from Cb and Cr, B from
    Cb (equal to PIL's convert over all 2^24 inputs)."""
    i = np.arange(256, dtype=np.float64) - 128
    return tuple(np.trunc(c * 64 * i + 0.5).astype(np.int64) for c in (1.402, -0.34414, -0.71414, 1.772))


def ycbcr_to_rgb(ycc: np.ndarray) -> np.ndarray:
    """Pillow's ImagingConvertYCbCr2RGB of (..., 3) uint8."""
    r_cr, g_cb, g_cr, b_cb = _ycbcr_tables()
    y = ycc[..., 0].astype(np.int64)
    cb, cr = ycc[..., 1], ycc[..., 2]
    r = y + (r_cr[cr] >> 6)
    g = y + ((g_cb[cb] + g_cr[cr]) >> 6)
    b = y + (b_cb[cb] >> 6)
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)


def _unpack(planes: np.ndarray, comps, mode: str, unpacker: str) -> np.ndarray:
    """PIL's image of `mode` from openjpeg's component planes ((n, h, w)
    int32), as Pillow's unpacker writes its four bytes a pixel: gray
    replicated into R, G and B, alpha 255 where no component gives it, an
    sYCC image converted to RGB; then the bands of `mode`."""
    if unpacker == "gray_i":
        return _unpack_component(planes[0], *comps[0], 16)
    u8 = [_unpack_component(planes[c], *comps[c], 8) for c in range(len(comps))]
    if unpacker == "gray_l":
        px = [u8[0]]
    elif unpacker == "graya_la":
        px = [u8[0], u8[0], u8[0], u8[1]]
    elif unpacker == "gray_rgb":
        px = [u8[0], u8[0], u8[0], None]
    elif unpacker in ("srgba_rgba", "sycca_rgba"):
        px = u8[:4]
    else:
        px = [*u8[:3], None]
    if unpacker.startswith("sycc"):
        px[:3] = np.moveaxis(ycbcr_to_rgb(np.stack(px[:3], axis=-1)), -1, 0)
    if mode in ("L", "P"):
        return px[0]
    bands = {"LA": (0, 3), "PA": (0, 3), "RGB": (0, 1, 2)}.get(mode, (0, 1, 2, 3))
    full = np.full(px[0].shape, 255, np.uint8)
    return np.stack([full if px[i] is None else px[i] for i in bands], axis=-1)


def _decode(b, path) -> Raster:
    """The file's image; _Refused where PIL's open or load raises."""
    h = _open(b, path)
    data = np.frombuffer(b, np.uint8)[h.codestream:]
    try:
        x0, y0, x1, y1, nc, comps = _codestream_info(data)
        if not 1 <= nc <= _MAX_COMPS:
            raise _Refused(f"{nc} components (PIL's decoder takes 1 to {_MAX_COMPS})")
        space = h.color_space
        if space == UNSPECIFIED:
            space = GRAY if nc <= 2 else SRGB
        unpacker = _UNPACKERS.get((h.mode, space, nc))
        if unpacker is None:
            raise _Refused(f"mode {h.mode} from {nc} components in colour space {space} (no unpacker in PIL)")
        if x1 - x0 != h.width or y1 - y0 != h.height:
            raise _Refused(f"a codestream of {x1 - x0} x {y1 - y0} in an image of {h.width} x {h.height}")
        planes = np.empty((nc, y1 - y0, x1 - x0), np.int32)
        err = ctypes.create_string_buffer(_ERR_BYTES)
        rc = _lib().acz_j2k_decode(data.ctypes.data, data.size, planes.ctypes.data, planes.size, err, _ERR_BYTES)
        if rc:
            raise _Refused(err.value.decode(errors="replace"))
    finally:
        del data  # no view of the mapped file outlives the call
    return Raster(_unpack(planes, comps, h.mode, unpacker), h.mode, h.palette)


def read_jpeg2000(path) -> Raster:
    """A JPEG 2000 file as PIL gives it (module note): PIL's pixels and mode,
    and the palette of modes P and PA."""
    _lib()  # built before the file is mapped
    with mapped(path) as b:
        try:
            return _decode(b, path)
        except _Refused as e:
            msg = str(e)
    raise _error(path, msg)


# ---------------------------------------------------------------- writing


def encode_jpeg2000(img: np.ndarray, mode: str, jp2: bool) -> bytes:
    """A lossless file of an image of `mode` (SAVE_MODES; (h, w) or (h, w, n)
    uint8, uint16 for I;16): the codestream alone, or in JP2 boxes."""
    if mode not in SAVE_MODES:
        raise OSError(f"cannot write mode {mode} as JPEG 2000")
    a = np.asarray(img)
    prec = 16 if mode == "I;16" else 8
    nc = {"L": 1, "I;16": 1, "LA": 2, "RGB": 3, "RGBA": 4, "CMYK": 4}[mode]
    if a.dtype != (np.uint16 if prec == 16 else np.uint8) or a.shape[2:] != ((nc,) if nc > 1 else ()) or a.ndim < 2:
        raise ValueError(f"a mode-{mode} image takes ({'h, w' if nc == 1 else f'h, w, {nc}'}) "
                         f"{'uint16' if prec == 16 else 'uint8'} samples, got {a.shape} {a.dtype}")
    planes = np.ascontiguousarray(a[None] if nc == 1 else np.moveaxis(a, -1, 0), np.int32)
    _, h, w = planes.shape
    out = ctypes.c_void_p()
    err = ctypes.create_string_buffer(_ERR_BYTES)
    n = _lib().acz_j2k_encode(planes.ctypes.data, w, h, nc, prec, ctypes.byref(out), err, _ERR_BYTES)
    if n < 0:
        raise OSError(err.value.decode(errors="replace"))
    try:
        codestream = ctypes.string_at(out, n)
    finally:
        _lib().acz_j2k_free(out)
    if not jp2:
        return codestream
    ihdr = struct.pack(">IIHBBBB", h, w, nc, prec - 1, 7, 0, 0)
    colr = struct.pack(">BBBI", 1, 0, 0, _SAVE_ENUMCS[mode])
    jp2h = _box(b"ihdr", ihdr) + _box(b"colr", colr)
    return (JP2_SIGNATURE + _box(b"ftyp", b"jp2 " + b"\x00\x00\x00\x00" + b"jp2 ") + _box(b"jp2h", jp2h)
            + _box(b"jp2c", codestream))


def _box(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", 8 + len(body)) + kind + body


def write_jpeg2000(path, img: np.ndarray, mode: str) -> None:
    """Write an image of `mode` as Pillow's `img.save(path)` picks the
    container: a bare codestream for a name ending `.j2k`, JP2 boxes
    otherwise (module note)."""
    data = encode_jpeg2000(img, mode, jp2=not os.fspath(path).endswith(".j2k"))
    Path(path).write_bytes(data)
