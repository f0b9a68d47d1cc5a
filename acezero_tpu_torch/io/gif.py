"""GIF files without an image library: the container here, the LZW code
stream in io/csrc/gif.cpp through ctypes; read as Pillow's GifImagePlugin
reads them and written as its `save` writes them.

`read_gif(path)` gives a `Raster` (io/formats.py) of the first frame as
`np.asarray(Image.open(path))` gives it. PIL reads only frame 0 of a GIF
when it opens and loads it (`LOADING_STRATEGY` RGB_AFTER_FIRST), and this
is what it makes of it:
  - the logical screen's size, enlarged to hold the frame where the frame
    reaches past it;
  - the extension blocks before the image, in Pillow's order and with its
    quirks: a graphic control extension's transparency index (its flag
    set; a later one without the flag keeps the earlier index), comments,
    application extensions, any other label skipped by its sub-blocks; an
    extension whose first sub-block is empty, or a NETSCAPE2.0 extension
    whose loop sub-block is the terminator, skips the bytes after it as
    more sub-blocks; a stray byte between blocks is skipped;
  - the palette: the local one where the frame has one, else the global
    one; a palette that is the identity grey ramp (entry i the grey level i)
    is no palette, so the frame opens as mode L, its indices the grey
    levels; any other gives mode P with that palette (the palette's own
    size, 2, 4, ... 256 entries, shorter where the file ends in it). A local
    grey ramp under a global palette that is not one gives mode L with the
    global palette kept underneath: PIL's `getpalette()` returns it and its
    `convert("RGB")` goes through it (`Raster.palette` of mode L);
  - the pixels outside the frame's extent: the transparency index where
    there is one, else 0 (`load_prepare`); the frame's indices are written
    over them whole (frame 0 is decoded without transparency);
  - `transparency`, PIL's `info["transparency"]`, kept in either mode.
Where PIL's `open` or `load` raises (no image in the frame, a header or
block cut short, a decompression bomb, an LZW stream that is corrupt or
ends before the frame is full), the port raises ValueError naming the file.

`gif_header(path)` gives (width, height, PIL's mode, transparency) from the
container alone. `write_gif(path, img, mode, palette, transparency)` writes
a mode-P or mode-L image as PIL's `img.save(path)` does, so that PIL reads
it back to PIL's read-back of its own save: `_normalize_palette` and
`_get_optimize` with `optimize` on (PIL's default): an L image's palette
becomes the grey levels it uses; a P image of fewer than 512 x 512 pixels
loses the entries it does not use where its indices have holes, or where
that halves its table; the transparency index is remapped, or dropped
where its entry goes; the table is padded with black to a power of two
(at least 2 entries, 4 for up to 2 colours), and the frame is interlaced
when both sides are 16 pixels or more. The bytes differ from PIL's (the
LZW codes are the port's own).
"""

from __future__ import annotations

import ctypes
import functools
import math
import struct
from pathlib import Path
from typing import NamedTuple

import numpy as np

from acezero_tpu_torch.io.formats import Raster, check_size, mapped
from acezero_tpu_torch.ops import build

SOURCE = Path(__file__).resolve().parent / "csrc" / "gif.cpp"
SIGNATURES = (b"GIF87a", b"GIF89a")
_ERR_BYTES = 512
_GREY_RAMP = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, axis=1)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load_host(SOURCE)
    p, n, err, i, i64 = ctypes.c_void_p, ctypes.c_size_t, ctypes.c_char_p, ctypes.c_int, ctypes.c_int64
    lib.acz_gif_decode.argtypes = [p, n, n, i, i, i, i, i, i, p, i64, i64, err, i]
    lib.acz_gif_decode.restype = i
    lib.acz_gif_encode.argtypes = [p, i64, ctypes.POINTER(ctypes.c_void_p), err, i]
    lib.acz_gif_encode.restype = i64
    lib.acz_gif_free.argtypes = [p]
    lib.acz_gif_free.restype = None
    return lib


def is_gif(head: bytes) -> bool:
    """Pillow's _accept: GIF87a or GIF89a."""
    return head[:6] in SIGNATURES


class _Short(Exception):
    """A read that Pillow's struct or index access would fail on."""


class _Reader:
    """A file object over bytes (or a memory map), as GifImageFile reads
    it."""

    def __init__(self, b):
        self.b, self.pos = b, 0

    def read(self, n: int) -> bytes:
        out = self.b[self.pos: self.pos + n]
        self.pos += len(out)
        return out

    def data(self) -> bytes | None:
        """GifImageFile.data: a sub-block, None for a zero length (or at the
        end of the file), short where the file ends inside it."""
        s = self.read(1)
        if s and s[0]:
            return self.read(s[0])
        return None


def _i16(b: bytes, at: int) -> int:
    if len(b) < at + 2:
        raise _Short
    return b[at] | (b[at + 1] << 8)


def _byte(b: bytes, at: int) -> int:
    if len(b) <= at:
        raise _Short
    return b[at]


def _palette_needed(p: bytes) -> bool:
    """GifImageFile._is_palette_needed: any entry that is not the grey
    level of its index (an entry cut short by the file's end fails on its
    first missing byte, as Pillow's chained comparison does)."""
    for i in range(0, len(p), 3):
        if i // 3 != p[i]:
            return True
        if p[i] != _byte(p, i + 1):
            return True
        if p[i + 1] != _byte(p, i + 2):
            return True
    return False


class GifFrame(NamedTuple):
    """What PIL's open makes of a GIF: the image's size, its mode, the
    palette of mode P ((n, 3) uint8), the transparency index, and frame 0's
    extent, interlacing, minimum code size and where its data starts."""

    width: int
    height: int
    mode: str
    palette: np.ndarray | None
    transparency: int | None
    extent: tuple[int, int, int, int]
    interlace: bool
    bits: int
    offset: int


def _open(b, path) -> GifFrame:
    """GifImageFile._open and _seek(0), statement by statement."""
    try:
        return _open_frame0(b, path)
    except _Short:
        raise ValueError(f"{path}: corrupt GIF (a header or block cut short)") from None


def _open_frame0(b, path) -> GifFrame:
    fp = _Reader(b)
    s = fp.read(13)
    if not is_gif(s):
        raise ValueError(f"{path}: not a GIF file")
    size = [_i16(s, 6), _i16(s, 8)]
    flags = _byte(s, 10)
    bits = (flags & 7) + 1
    global_palette = None
    if flags & 128:
        _byte(s, 11)  # the background index
        p = fp.read(3 << bits)
        if _palette_needed(p):
            global_palette = p
    # _seek(0)
    s = fp.read(1)
    if not s or s == b";":
        raise ValueError(f"{path}: no image in the GIF file")
    palette: bytes | bool | None = None
    transparency = None
    interlace = None
    extent = (0, 0, 0, 0)
    code_bits = offset = 0
    while True:
        if not s:
            s = fp.read(1)
        if not s or s == b";":
            break
        if s == b"!":
            s = fp.read(1)
            block = fp.data()
            label = _byte(s, 0)
            if label == 249 and block is not None:  # graphic control extension
                gflags = _byte(block, 0)
                if gflags & 1:
                    transparency = _byte(block, 3)
                _i16(block, 1)  # the duration
            elif label == 254:  # comment: its sub-blocks up to the terminator
                while block:
                    block = fp.data()
                s = b""
                continue
            elif label == 255 and block is not None:  # application extension
                if block.startswith(b"NETSCAPE2.0"):
                    fp.data()  # the loop count's sub-block
            while fp.data():
                pass
        elif s == b",":  # the image descriptor
            s = fp.read(9)
            x0, y0 = _i16(s, 0), _i16(s, 2)
            x1, y1 = x0 + _i16(s, 4), y0 + _i16(s, 6)
            if x1 > size[0] or y1 > size[1]:
                size = [max(x1, size[0]), max(y1, size[1])]
                check_size(*size, path)
            extent = (x0, y0, x1, y1)
            lflags = _byte(s, 8)
            interlace = (lflags & 64) != 0
            if lflags & 128:
                p = fp.read(3 << ((lflags & 7) + 1))
                palette = p if _palette_needed(p) else False
            code_bits = _byte(fp.read(1), 0)
            offset = fp.pos
            break
        s = b""
    if interlace is None:
        raise ValueError(f"{path}: image not found in the GIF frame")
    if size[0] <= 0 or size[1] <= 0:
        raise ValueError(f"{path}: a GIF of {size[0]} x {size[1]} pixels (PIL identifies no image)")
    check_size(*size, path)
    mode = "P" if (palette if palette is not None else global_palette) else "L"
    # the image keeps the global palette under a local grey ramp: mode L, but
    # its convert("RGB") goes through that palette
    kept = palette or global_palette
    pal = None if not kept else np.frombuffer(kept[: len(kept) // 3 * 3], np.uint8).reshape(-1, 3).copy()
    return GifFrame(size[0], size[1], mode, pal, transparency, extent, interlace, code_bits, offset)


def gif_header(path) -> tuple[int, int, str, int | None]:
    """(width, height, PIL's mode, transparency index or None) of a GIF
    file, from its container."""
    with mapped(path) as b:
        f = _open(b, path)
    return f.width, f.height, f.mode, f.transparency


def read_gif(path) -> Raster:
    """Frame 0 of a GIF file as PIL gives it (module note)."""
    with mapped(path) as b:
        f, pixels, rc, err = _decode(b, path)
    if rc:
        raise ValueError(f"{path}: corrupt GIF ({err.value.decode(errors='replace')})")
    return Raster(pixels, f.mode, f.palette, f.transparency)


def _decode(b, path):
    """(the container's frame 0, its pixels, the codec's return code, its
    message) of the mapped file `b`; no view of `b` outlives the call."""
    f = _open(b, path)
    pixels = np.full((f.height, f.width), f.transparency or 0, np.uint8)
    data = np.frombuffer(b, np.uint8)
    err = ctypes.create_string_buffer(_ERR_BYTES)
    rc = _lib().acz_gif_decode(data.ctypes.data, data.size, f.offset, f.bits, int(f.interlace), *f.extent,
                               pixels.ctypes.data, f.width, f.height, err, _ERR_BYTES)
    return f, pixels, rc, err


# ---------------------------------------------------------------- writing


def _lzw(indices: np.ndarray) -> bytes:
    """The LZW code stream of uint8 indices (io/csrc/gif.cpp), minimum code
    size 8."""
    flat = np.ascontiguousarray(indices, np.uint8).reshape(-1)
    out = ctypes.c_void_p()
    err = ctypes.create_string_buffer(_ERR_BYTES)
    n = _lib().acz_gif_encode(flat.ctypes.data, flat.size, ctypes.byref(out), err, _ERR_BYTES)
    if n < 0:
        raise ValueError(err.value.decode(errors="replace"))
    try:
        return ctypes.string_at(out, n)
    finally:
        _lib().acz_gif_free(out)


def _sub_blocks(data: bytes) -> bytes:
    out = bytearray()
    for i in range(0, len(data), 255):
        chunk = data[i: i + 255]
        out += bytes([len(chunk)]) + chunk
    return bytes(out + b"\x00")


def _table_size(n_colours: int) -> int:
    """Pillow's `_get_color_table_size` of a palette of n colours: the
    table holds 2 << size entries."""
    if n_colours == 0:
        return 0
    if 3 * n_colours < 9:
        return 1
    return math.ceil(math.log(n_colours, 2)) - 1


def _interlaced_rows(h: int) -> np.ndarray:
    """The order GIF's four passes store an image's rows in."""
    return np.concatenate([np.arange(0, h, 8), np.arange(4, h, 8), np.arange(2, h, 4), np.arange(1, h, 2)])


def encode_gif(indices: np.ndarray, palette: np.ndarray, transparency: int | None = None) -> bytes:
    """A one-frame GIF of (h, w) uint8 `indices` into `palette` ((n, 3)
    uint8, at most 256 colours; the table padded with black to 2 << size
    entries as Pillow pads it), with a graphic control extension for
    `transparency`; interlaced when both sides are 16 pixels or more, as
    Pillow's `get_interlace` has it."""
    idx = np.ascontiguousarray(indices, np.uint8)
    if idx.ndim != 2:
        raise ValueError(f"a GIF frame takes (h, w) indices, got {idx.shape}")
    h, w = idx.shape
    if not (0 < h < 65536 and 0 < w < 65536):
        raise ValueError(f"cannot write a {w} x {h} image as GIF")
    pal = np.asarray(palette, np.uint8).reshape(-1, 3)
    if len(pal) > 256:
        raise ValueError(f"a GIF palette holds at most 256 colours, got {len(pal)}")
    size = _table_size(len(pal))
    table = np.zeros((2 << size, 3), np.uint8)
    table[: len(pal)] = pal
    interlace = min(h, w) >= 16
    out = bytearray(b"GIF89a" if transparency is not None else b"GIF87a")
    out += struct.pack("<HHBBB", w, h, 128 | size, 0, 0) + table.tobytes()
    if transparency is not None:
        out += b"!\xf9\x04" + bytes([1, 0, 0, transparency, 0])
    out += b"," + struct.pack("<HHHHB", 0, 0, w, h, 64 if interlace else 0) + b"\x08"
    out += _sub_blocks(_lzw(idx[_interlaced_rows(h)] if interlace else idx))
    return bytes(out + b";")


def _used(idx: np.ndarray) -> list[int]:
    return np.flatnonzero(np.bincount(idx.reshape(-1), minlength=256)).tolist()


def _normalized(img: np.ndarray, mode: str, palette: np.ndarray | None,
                transparency: int | None) -> tuple[np.ndarray, np.ndarray, int | None]:
    """What PIL's GIF save writes for an image of mode P (`img` the
    indices, `palette` its (n, 3) colours) or L: (indices, palette,
    transparency) after `_normalize_palette` and `_get_optimize` (module
    note)."""
    idx = np.ascontiguousarray(img, np.uint8)
    if mode == "L":
        source = _GREY_RAMP
        used = _used(idx)
    elif mode == "P":
        source = np.asarray(palette if palette is not None else np.zeros((0, 3)), np.uint8).reshape(-1, 3)
        used = None
        if idx.shape[0] * idx.shape[1] < 512 * 512:
            used = _used(idx)
            if max(used) < len(used):  # no holes: remap only where the table halves
                current = 1 << (len(source) - 1).bit_length()
                if not (len(used) <= current // 2 and current > 2):
                    used = None
    else:
        raise OSError(f"cannot write mode {mode} as GIF")
    if used is None:
        return idx, source, transparency
    new_positions = np.zeros(256, np.uint8)
    new_positions[used] = np.arange(len(used), dtype=np.uint8)
    kept = [u for u in used if u < len(source)]  # entries past the palette add no colour
    if transparency is not None:
        transparency = used.index(transparency) if transparency in used else None
    return new_positions[idx], source[kept], transparency


def write_gif(path, img: np.ndarray, mode: str, palette: np.ndarray | None = None,
              transparency: int | None = None) -> None:
    """Write `img` as PIL's `img.save(path)` writes a GIF of mode P or L
    with `info["transparency"]` = `transparency` (module note); other modes
    raise OSError."""
    idx, pal, t = _normalized(img, mode, palette, transparency)
    Path(path).write_bytes(encode_gif(idx, pal, t))
