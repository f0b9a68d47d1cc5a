"""TIFF files without an image library: the first IFD, decoded as PIL
opens it, and the uncompressed TIFF that PIL's `save` writes.

`read_tiff(path)` gives a `Raster` (io/formats.py): the pixels of
`np.asarray(PIL.Image.open(path))` and PIL's mode, chosen as
TiffImagePlugin's OPEN_INFO table chooses it from the byte order, the
photometric interpretation, the sample format, the fill order, the bits
and the extra samples. What it reads:
  - byte orders II and MM; strips (the last one short) and tiles (cropped
    at the edges); PlanarConfiguration 1 and 2; FillOrder 2;
  - compressions none, PackBits, LZW (io/csrc/tiff.cpp, through ctypes),
    Deflate (8 and 32946; inflated by Python's zlib, which releases the
    GIL) and JPEG (7, with JPEGTables; each strip or tile decoded by
    io/csrc/jpeg.cpp, YCbCr converted to RGB as libtiff's
    JPEGCOLORMODE_RGB does for PIL, RGB and gray samples as they are);
  - Predictor 2 at 8, 16 and 32 bits and Predictor 3 (floating point),
    applied after LZW and Deflate only, as libtiff applies them (PIL reads
    uncompressed files itself and ignores the tag);
  - modes 1 (min-is-white and min-is-black), L (2, 4 and 8 bits, either
    photometric), P (1, 2, 4 and 8 bits, the ColorMap's high bytes), LA,
    RGB (also from 16-bit samples, their high bytes, and with unspecified
    extra samples dropped), RGBA (unassociated alpha, or associated alpha
    divided out as Pillow's "RGBa" does), I;16 (II) and I;16B (MM), I
    (signed 16-bit, 32-bit), F (32-bit float), CMYK (8 and 16 bits);
  - the Orientation tag, applied as PIL's TIFF loader applies
    `ImageOps.exif_transpose` (and `image_size` swaps for 5-8).
What PIL refuses raises ValueError naming the file, and so does every kind
PIL opens that the port does not read yet (CCITT fax, old-style JPEG (6),
YCbCr without JPEG compression, LAB, PA, 12-bit gray, 16-bit associated
alpha, other compressions, BigTIFF, and big-endian F, I and signed 16-bit
samples under a compression, which PIL byte-swaps); ROADMAP.md queues
them.

`write_tiff(path, img, mode)` writes what PIL's `img.save(path)` writes
for modes 1, L, LA, P, I;16, I;16B, I, F, RGB, RGBA and CMYK: no
compression, one strip, the byte order and tags of Pillow's SAVE_INFO.
PIL reads it back to the same mode and pixels; the bytes differ (Pillow
writes more tags and strips of 64 KiB).
"""

from __future__ import annotations

import ctypes
import functools
import struct
import zlib
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from acezero_tpu_torch.io.formats import Raster, check_size
from acezero_tpu_torch.ops import build

SOURCE = Path(__file__).resolve().parent / "csrc" / "tiff.cpp"
_ERR_BYTES = 512
_SIGNATURES = (b"MM\x00\x2a", b"II\x2a\x00", b"MM\x2a\x00", b"II\x00\x2a")  # Pillow's PREFIXES, BigTIFF apart
_BIGTIFF = (b"MM\x00\x2b", b"II\x2b\x00")

# tags
WIDTH, HEIGHT, BITS, COMPRESSION, PHOTOMETRIC, FILLORDER = 256, 257, 258, 259, 262, 266
STRIP_OFFSETS, ORIENTATION, SAMPLES, ROWS_PER_STRIP, STRIP_COUNTS = 273, 274, 277, 278, 279
PLANAR, PREDICTOR, COLORMAP, TILE_WIDTH, TILE_LENGTH, TILE_OFFSETS, TILE_COUNTS = 284, 317, 320, 322, 323, 324, 325
EXTRA_SAMPLES, SAMPLE_FORMAT, JPEG_TABLES = 338, 339, 347

# field type -> (struct code, bytes)
_TYPES = {1: ("B", 1), 2: ("B", 1), 3: ("H", 2), 4: ("I", 4), 5: ("I", 4), 6: ("b", 1), 7: ("B", 1), 8: ("h", 2),
          9: ("i", 4), 10: ("i", 4), 11: ("f", 4), 12: ("d", 8), 13: ("I", 4), 16: ("Q", 8)}
_RATIONAL = (5, 10)  # two longs a value

NONE, LZW, JPEG, PACKBITS = 1, 5, 7, 32773
DEFLATE = (8, 32946)
# the compressions PIL opens through libtiff that the port does not read yet
_QUEUED = {2: "CCITT modified Huffman (2)", 3: "CCITT group 3 fax (3)", 4: "CCITT group 4 fax (4)",
           6: "old-style JPEG (6)"}

# OPEN_INFO, the kinds the port reads: (photometric, sample format, bits,
# extra samples) -> (mode, rawmode), the rawmode without its byte order.
# Fill order 2 reverses the stored bits first and is otherwise the same
# kind.
_KINDS = {
    (0, (1,), (1,), ()): ("1", "1;I"),
    (1, (1,), (1,), ()): ("1", "1"),
    (0, (1,), (2,), ()): ("L", "L;2I"),
    (1, (1,), (2,), ()): ("L", "L;2"),
    (0, (1,), (4,), ()): ("L", "L;4I"),
    (1, (1,), (4,), ()): ("L", "L;4"),
    (0, (1,), (8,), ()): ("L", "L;I"),
    (1, (1,), (8,), ()): ("L", "L"),
    (1, (2,), (8,), ()): ("L", "L"),
    (1, (2,), (16,), ()): ("I", "I;16S"),
    (0, (3,), (32,), ()): ("F", "F"),
    (1, (2,), (32,), ()): ("I", "I;32S"),
    (1, (3,), (32,), ()): ("F", "F"),
    (1, (1,), (8, 8), (2,)): ("LA", "LA"),
    (2, (1,), (8, 8, 8), ()): ("RGB", "RGB"),
    (2, (1,), (8, 8, 8, 8), ()): ("RGBA", "RGBA"),
    (2, (1,), (8, 8, 8, 8), (0,)): ("RGB", "RGBX"),
    (2, (1,), (8, 8, 8, 8, 8), (0, 0)): ("RGB", "RGBXX"),
    (2, (1,), (8, 8, 8, 8, 8, 8), (0, 0, 0)): ("RGB", "RGBXXX"),
    (2, (1,), (8, 8, 8, 8), (1,)): ("RGBA", "RGBa"),
    (2, (1,), (8, 8, 8, 8, 8), (1, 0)): ("RGBA", "RGBaX"),
    (2, (1,), (8, 8, 8, 8, 8, 8), (1, 0, 0)): ("RGBA", "RGBaXX"),
    (2, (1,), (8, 8, 8, 8), (2,)): ("RGBA", "RGBA"),
    (2, (1,), (8, 8, 8, 8, 8), (2, 0)): ("RGBA", "RGBAX"),
    (2, (1,), (8, 8, 8, 8, 8, 8), (2, 0, 0)): ("RGBA", "RGBAXX"),
    (2, (1,), (8, 8, 8, 8), (999,)): ("RGBA", "RGBA"),
    (2, (1,), (16, 16, 16), ()): ("RGB", "RGB;16"),
    (2, (1,), (16, 16, 16, 16), ()): ("RGBA", "RGBA;16"),
    (2, (1,), (16, 16, 16, 16), (0,)): ("RGB", "RGBX;16"),
    (2, (1,), (16, 16, 16, 16), (2,)): ("RGBA", "RGBA;16"),
    (3, (1,), (1,), ()): ("P", "P;1"),
    (3, (1,), (2,), ()): ("P", "P;2"),
    (3, (1,), (4,), ()): ("P", "P;4"),
    (3, (1,), (8,), ()): ("P", "P"),
    (3, (1,), (8, 8), (0,)): ("P", "PX"),
    (5, (1,), (8, 8, 8, 8), ()): ("CMYK", "CMYK"),
    (5, (1,), (8, 8, 8, 8, 8), (0,)): ("CMYK", "CMYKX"),
    (5, (1,), (8, 8, 8, 8, 8, 8), (0, 0)): ("CMYK", "CMYKXX"),
    (5, (1,), (16, 16, 16, 16), ()): ("CMYK", "CMYK;16"),
    (6, (1,), (8, 8, 8), ()): ("RGB", "YCbCr"),  # JPEG compression only (libtiff's JPEGCOLORMODE_RGB)
}
# kinds whose entry depends on the byte order (OPEN_INFO lists them for one only)
_ORDERED = {
    ("II", 0, (1,), (16,), ()): ("I;16", "I;16"),
    ("II", 1, (1,), (16,), ()): ("I;16", "I;16"),
    ("MM", 1, (1,), (16,), ()): ("I;16B", "I;16"),
    ("II", 1, (1,), (32,), ()): ("I", "I;32S"),
}
_ORDERED_KINDS = frozenset(k[1:] for k in _ORDERED)
# the kinds OPEN_INFO also lists with fill order 2
_FILL2 = frozenset({(p, (1,), (b,), ()) for p in (0, 1) for b in (1, 2, 4, 8)}
                   | {(3, (1,), (b,), ()) for b in (1, 2, 4, 8)} | {(2, (1,), (8, 8, 8), ())})
# kinds PIL opens that the port does not read yet, by what tells them apart
_QUEUED_KINDS = {(1, (1,), (12,), ()): "12-bit gray (I;12)", (8, (1,), (8, 8, 8), ()): "LAB",
                 (3, (1,), (8, 8), (2,)): "palette with alpha (PA)", (6, (1,), (8,), ()): "one-sample YCbCr",
                 (2, (1,), (16, 16, 16, 16), (1,)): "16-bit RGB with associated alpha (RGBa;16)"}
_MODE_BANDS = {"1": 1, "L": 1, "P": 1, "I": 1, "F": 1, "I;16": 1, "I;16B": 1, "LA": 2, "RGB": 3, "RGBA": 4,
               "CMYK": 4}


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load_host(SOURCE)
    p, n, err, i = ctypes.c_void_p, ctypes.c_size_t, ctypes.c_char_p, ctypes.c_int
    lib.acz_tiff_chunks.argtypes = [p, n, p, p, i, i, i, i, i, i, i, i, i, i, i, i, i, p, n, err, i]
    lib.acz_tiff_chunks.restype = i
    lib.acz_bmp_rle.argtypes = [p, n, n, i, ctypes.c_int64, p, n, err, i]
    lib.acz_bmp_rle.restype = ctypes.c_int64
    return lib


def bmp_rle(data: np.ndarray, start: int, rle4: bool, width: int, height: int, path) -> np.ndarray:
    """Pillow's RLE8 or RLE4 decode of a BMP's pixel data (`data` the whole
    file as uint8, the data at `start`): (height, width) uint8 indices, rows
    as stored (bottom-up). Short data raises, as PIL's `set_as_raw` does."""
    cap = width * height
    out = np.zeros(cap, np.uint8)
    err = ctypes.create_string_buffer(_ERR_BYTES)
    n = _lib().acz_bmp_rle(data.ctypes.data, data.size, start, int(rle4), width, out.ctypes.data, cap, err,
                           _ERR_BYTES)
    if n < 0:
        raise ValueError(f"{path}: {err.value.decode(errors='replace')}")
    if n < cap:
        raise ValueError(f"{path}: truncated BMP RLE data ({n} of {cap} pixels)")
    return out.reshape(height, width)


def is_tiff(head: bytes) -> bool:
    return head[:4] in _SIGNATURES or head[:4] in _BIGTIFF


def _ifd(read, path) -> tuple[dict, bool, bool]:
    """The first IFD's fields as Pillow's ImageFileDirectory_v2 loads them,
    and whether the file is big-endian; `read(offset, n)` gives the file's
    bytes there. A field of an unknown type or of no values is skipped;
    an entry or a field's data cut short by the file's end ends the IFD,
    the fields read before it kept. Values: bytes for UNDEFINED, the first
    value for BYTE (Pillow's quirk), a tuple of numbers otherwise; and
    whether libtiff would read the IFD whole."""
    head = read(0, 8)
    if head[:4] in _BIGTIFF:
        raise ValueError(f"{path}: BigTIFF is not read yet")
    if head[:4] not in _SIGNATURES or len(head) < 8:
        raise ValueError(f"{path}: not a TIFF file")
    big = head[:2] == b"MM"
    e = ">" if big else "<"
    (ifd,) = struct.unpack(e + "I", head[4:8])
    raw = read(ifd, 2)
    n = struct.unpack(e + "H", raw)[0] if len(raw) == 2 else 0
    tags = {}
    for k in range(n):
        entry = read(ifd + 2 + 12 * k, 12)
        if len(entry) < 12:
            break
        tag, typ, count = struct.unpack(e + "HHI", entry[:8])
        if typ not in _TYPES:
            continue
        code, size = _TYPES[typ]
        per = 2 if typ in _RATIONAL else 1
        width = size * count * per
        data = entry[8:12]
        if width > 4:
            (off,) = struct.unpack(e + "I", data)
            data = read(off, width)
            if len(data) < width:
                break
        data = data[:width]
        if not data:
            continue
        if typ in (2, 7):  # ASCII and UNDEFINED: no numbers
            tags[tag] = bytes(data)
            continue
        vals = struct.unpack(e + code * (count * per), data)
        if typ in _RATIONAL:
            vals = tuple(a / b if b else float("nan") for a, b in zip(vals[::2], vals[1::2]))
        tags[tag] = vals[0] if typ == 1 else vals
    # libtiff, which decodes a compressed TIFF for PIL, reads the IFD again and
    # refuses one of over 4,096 entries or one the file cuts short
    fits = n <= 4096 and len(read(ifd + 2, 12 * n + 4)) == 12 * n + 4
    return tags, big, fits


def _ints(tags, tag, default, path) -> tuple:
    """A field of any number of integers (Pillow's variable-length tags)."""
    v = tags.get(tag, default)
    if isinstance(v, bytes) or not isinstance(v, tuple) or not all(isinstance(x, int) for x in v):
        raise ValueError(f"{path}: PIL does not open this TIFF (tag {tag} is not a list of integers)")
    return v


def _one(tags, tag, default, path) -> int:
    """A field of one integer (Pillow's length-1 tags take the first value)."""
    v = tags.get(tag)
    if v is None:
        return default
    v = v[0] if isinstance(v, tuple) else v
    if not isinstance(v, int):
        raise ValueError(f"{path}: PIL does not open this TIFF (tag {tag} is not an integer)")
    return v


@dataclass
class _Layout:
    mode: str
    rawmode: str
    width: int
    height: int
    bits: tuple
    samples: int
    planar: int
    compression: int
    photometric: int
    predictor: int
    fillorder: int
    orientation: int
    big: bool


def _layout(tags: dict, big: bool, fits: bool, path) -> _Layout:
    """The image's kind and mode, as TiffImagePlugin._setup picks them."""
    if 0xBC01 in tags:
        raise ValueError(f"{path}: PIL does not open Windows Media Photo TIFFs")
    compression = _one(tags, COMPRESSION, 1, path)
    photometric = _one(tags, PHOTOMETRIC, 0, path)
    if compression == 6:
        photometric = 6
    planar = _one(tags, PLANAR, 1, path)
    fillorder = _one(tags, FILLORDER, 1, path)
    if WIDTH not in tags or HEIGHT not in tags:
        raise ValueError(f"{path}: PIL does not open a TIFF without its dimensions")
    width, height = _one(tags, WIDTH, 0, path), _one(tags, HEIGHT, 0, path)
    check_size(width, height, path)
    sample_format = _ints(tags, SAMPLE_FORMAT, (1,), path)
    if len(sample_format) > 1 and max(sample_format) == min(sample_format) == 1:
        sample_format = (1,)
    bits = _ints(tags, BITS, (1,), path)
    extra = _ints(tags, EXTRA_SAMPLES, (), path)
    samples = _one(tags, SAMPLES, 3 if compression == 6 and photometric in (2, 6) else 1, path)
    if samples < len(bits):
        bits = bits[:samples]
    elif samples > len(bits) and len(bits) == 1:
        bits = bits * samples
    if len(bits) != samples:
        raise ValueError(f"{path}: PIL does not open this TIFF (unknown data organization)")
    if compression in _QUEUED:
        raise ValueError(f"{path}: TIFF compression {_QUEUED[compression]} is not read yet")
    if compression not in (NONE, LZW, JPEG, PACKBITS, *DEFLATE):
        raise ValueError(f"{path}: TIFF compression {compression} is not read yet")
    if compression != NONE and not fits:
        raise ValueError(f"{path}: PIL does not open this TIFF (libtiff, which decodes it for PIL, refuses an IFD "
                         "cut short or of over 4,096 entries)")
    key = (photometric, sample_format, bits, extra)
    order = "MM" if big else "II"
    if (order, *key) in _ORDERED:
        found = _ORDERED[(order, *key)]
    else:
        found = None if key in _ORDERED_KINDS else _KINDS.get(key)
    if fillorder not in (1, 2) or (fillorder == 2 and key not in _FILL2):
        found = None
    if found is None and key in _QUEUED_KINDS:
        raise ValueError(f"{path}: TIFF kind {_QUEUED_KINDS[key]} is not read yet")
    if found is None:
        raise ValueError(f"{path}: PIL does not open this TIFF ({order}, photometric {photometric}, sample format "
                         f"{sample_format}, fill order {fillorder}, bits {bits}, extra samples {extra}: "
                         "unknown pixel mode)")
    mode, rawmode = found
    if big and compression != NONE and rawmode in ("F", "I;32S", "I;16S"):
        # libtiff hands these samples over in the host's byte order and PIL
        # swaps them again: PIL's values are not the file's
        raise ValueError(f"{path}: TIFF kind big-endian compressed {mode} ({rawmode}) is not read yet "
                         "(PIL byte-swaps its samples)")
    if photometric == 6 and compression != JPEG:
        raise ValueError(f"{path}: TIFF kind YCbCr without JPEG compression is not read yet")
    if compression == JPEG and (planar != 1 or photometric not in (1, 2, 6) or bits[0] != 8):
        raise ValueError(f"{path}: TIFF kind JPEG-compressed photometric {photometric}, planar {planar} "
                         "is not read yet")
    if planar == 2 and samples > 1 and compression == NONE and (bits[0] != 8 or not _plane_rawmode(rawmode)):
        raise ValueError(f"{path}: TIFF kind uncompressed planar {rawmode} is not read yet")
    if planar not in (1, 2):
        raise ValueError(f"{path}: TIFF planar configuration {planar} is not read yet")
    return _Layout(mode, rawmode, width, height, bits, samples, planar, compression, photometric,
                   _one(tags, PREDICTOR, 1, path), fillorder, _one(tags, ORIENTATION, 1, path), big)


def _plane_rawmode(rawmode: str) -> bool:
    """Whether PIL's raw decoder reads this rawmode one plane a band (it
    takes rawmode[band] as the plane's rawmode)."""
    return rawmode in ("LA", "RGB", "RGBA", "CMYK")


def _file_layout(path) -> _Layout:
    with open(path, "rb") as f:
        def read(off, n):
            f.seek(off)
            return f.read(n)

        tags, big, fits = _ifd(read, path)
    return _layout(tags, big, fits, path)


def tiff_compression(path) -> int:
    """The first IFD's compression (1 none, 5 LZW, 7 JPEG, 8 or 32946
    Deflate, 32773 PackBits); PIL's `save` of an image it opened keeps it."""
    return _file_layout(path).compression


def tiff_header(path) -> tuple[int, int, str]:
    """(width, height, mode) as PIL opens the TIFF file, from its first IFD
    (width and height swapped for orientations 5-8, as PIL's size is)."""
    lay = _file_layout(path)
    w, h = lay.width, lay.height
    return (h, w, lay.mode) if lay.orientation in (5, 6, 7, 8) else (w, h, lay.mode)


def _jpeg_chunks(data: np.ndarray, tags: dict, lay: _Layout, offsets, counts, cw: int, ch: int, path) -> np.ndarray:
    """Each JPEG strip or tile decoded (JPEGTables before it) and placed:
    (h, w, samples) uint8."""
    from acezero_tpu_torch.io.jpeg import decode_jpeg

    tables = tags.get(JPEG_TABLES)
    if tables is not None and not isinstance(tables, bytes):
        raise ValueError(f"{path}: TIFF kind JPEGTables of a numeric field type is not read yet")
    prefix = np.frombuffer(tables[:-2], np.uint8) if tables and len(tables) > 4 else None
    w, h, spp = lay.width, lay.height, lay.samples
    out = np.zeros((h, w, spp), np.uint8)
    across = -(-w // cw)
    space3 = {6: 1, 2: 0}.get(lay.photometric, -1)
    for c, (off, n) in enumerate(zip(offsets, counts)):
        y0, x0 = (c // across) * ch, (c % across) * cw
        if y0 >= h:
            break
        chunk = data[off: off + n]
        if len(chunk) < n or n < 4:
            raise ValueError(f"{path}: truncated TIFF (JPEG chunk {c})")
        if prefix is not None:
            chunk = np.concatenate([prefix, chunk[2:]])
        px = decode_jpeg(np.ascontiguousarray(chunk), path, space3)
        px = px.reshape(px.shape[0], px.shape[1], -1)
        if px.shape[2] != spp:
            raise ValueError(f"{path}: a JPEG chunk of {px.shape[2]} components in a TIFF of {spp} samples")
        rows, cols = min(px.shape[0], h - y0), min(px.shape[1], w - x0)
        out[y0: y0 + rows, x0: x0 + cols] = px[:rows, :cols]
    return out


def _samples(data: np.ndarray, tags: dict, lay: _Layout, path) -> np.ndarray:
    """The stored samples: (planes, h, row bytes) uint8 in the file's byte
    order, or (1, h, w, samples) uint8 for JPEG compression."""
    w, h, bps = lay.width, lay.height, lay.bits[0]
    tiled = TILE_OFFSETS in tags
    if tiled:
        offsets, counts = _ints(tags, TILE_OFFSETS, (), path), _ints(tags, TILE_COUNTS, (), path)
        cw, ch = _one(tags, TILE_WIDTH, 0, path), _one(tags, TILE_LENGTH, 0, path)
        if cw <= 0 or ch <= 0:
            raise ValueError(f"{path}: PIL does not open this TIFF (invalid tile dimensions)")
    elif STRIP_OFFSETS in tags:
        offsets, counts = _ints(tags, STRIP_OFFSETS, (), path), _ints(tags, STRIP_COUNTS, (), path)
        cw, ch = w, min(_one(tags, ROWS_PER_STRIP, h, path) or h, h)  # 0 rows a strip: one strip, as libtiff takes it
    else:
        raise ValueError(f"{path}: PIL does not open this TIFF (no strips or tiles)")
    if lay.compression == JPEG:
        return _jpeg_chunks(data, tags, lay, offsets, counts, cw, ch, path)[None]
    planes = lay.samples if lay.planar == 2 else 1
    spp = 1 if lay.planar == 2 else lay.samples
    per_plane = -(-w // cw) * -(-h // ch)
    offsets = list(offsets)
    if lay.compression == NONE:
        # PIL reads an uncompressed chunk from its offset on, whatever its byte count says
        if not tiled and cw == w and ch >= h and lay.planar != 2:
            offsets = offsets[-1:]
        counts = [max(0, data.size - o) for o in offsets]
    elif len(counts) != len(offsets):
        raise ValueError(f"{path}: TIFF with {len(offsets)} chunks and {len(counts)} byte counts")
    if len(offsets) < per_plane * planes:
        raise ValueError(f"{path}: TIFF with {len(offsets)} chunks for {per_plane * planes}")
    offsets, counts = offsets[: per_plane * planes], list(counts)[: per_plane * planes]
    compression, inflated, buf = lay.compression, 0, data
    row = (w * spp * bps + 7) // 8
    chunk_bytes = max((cw * spp * bps + 7) // 8 * ch, 1)
    if compression in DEFLATE:
        parts = []
        for c, (off, n) in enumerate(zip(offsets, counts)):
            if off + n > data.size:
                raise ValueError(f"{path}: truncated TIFF (Deflate chunk {c} runs past the file's end)")
            chunk = data[off: off + n]
            if lay.fillorder == 2:
                chunk = _REVERSED[chunk]
            try:  # one output buffer of the chunk's size: zlib runs without the GIL, in one piece
                parts.append(np.frombuffer(zlib.decompress(chunk, bufsize=chunk_bytes), np.uint8))
            except zlib.error as exc:
                raise ValueError(f"{path}: corrupt Deflate data in TIFF chunk {c} ({exc})") from None
        sizes = [p_.size for p_ in parts]
        buf = np.concatenate(parts) if parts else np.zeros(0, np.uint8)
        offsets = list(np.cumsum([0] + sizes[:-1]))
        counts = sizes
        compression, inflated = NONE, 1
    out = np.empty((planes, h, row), np.uint8)
    err = ctypes.create_string_buffer(_ERR_BYTES)
    offs = np.asarray(offsets, np.int64)
    cnts = np.asarray(counts, np.int64)
    buf = np.ascontiguousarray(buf)
    rc = _lib().acz_tiff_chunks(buf.ctypes.data, buf.size, offs.ctypes.data, cnts.ctypes.data, len(offs), compression,
                                inflated, int(lay.fillorder == 2 and not inflated), lay.predictor, int(lay.big), bps,
                                spp, cw, ch, w, h, planes, out.ctypes.data, out.nbytes, err, _ERR_BYTES)
    if rc:
        raise ValueError(f"{path}: {err.value.decode(errors='replace')}")
    return out


_REVERSED = np.array([int(f"{b:08b}"[::-1], 2) for b in range(256)], np.uint8)


def _unpack_bits(rows: np.ndarray, w: int, bits: int) -> np.ndarray:
    """(h, row bytes) of packed samples, most significant bits first -> (h, w)
    uint8 sample values."""
    per = 8 // bits
    shifts = (8 - bits * (1 + np.arange(per))).astype(np.uint8)
    vals = (rows[:, :, None] >> shifts) & ((1 << bits) - 1)
    return vals.reshape(rows.shape[0], -1)[:, :w].astype(np.uint8)


def _pixels(stored: np.ndarray, lay: _Layout) -> np.ndarray:
    """PIL's pixels of `lay.mode` from the stored samples, by rawmode."""
    w, h, bps, raw = lay.width, lay.height, lay.bits[0], lay.rawmode
    if stored.ndim == 4:  # JPEG: decoded samples
        px = stored[0]
    elif bps < 8:
        px = _unpack_bits(stored[0], w, bps)
        if raw in ("1", "1;I"):
            return px == (1 if raw == "1" else 0)
        if raw.startswith("L;"):
            px = px * (85 if bps == 2 else 17)
            return (255 - px if raw.endswith("I") else px).astype(np.uint8)
        return px  # palette indices
    else:  # whole-byte samples, viewed in the file's byte order without a copy
        kind = "f" if raw == "F" else "i" if raw in ("I;16S", "I;32S") else "u"
        dt = np.dtype(f"{'>' if lay.big else '<'}{kind}{bps // 8}")
        if stored.shape[0] > 1:  # planar: one plane a sample
            px = np.stack([p_[:, : w * (bps // 8)].view(dt) for p_ in stored], -1)
        else:
            px = stored[0][:, : w * lay.samples * (bps // 8)].view(dt).reshape(h, w, lay.samples)
    if raw == "F":
        return px[..., 0].astype(np.float32)
    if raw in ("I;16S", "I;32S"):
        return px[..., 0].astype(np.int32)
    if raw == "I;16":
        return px[..., 0].astype(np.uint16)
    if raw.endswith(";16"):  # 16-bit colour: each sample's high byte
        return (px[..., : _MODE_BANDS[lay.mode]] >> 8).astype(np.uint8)
    px = px.astype(np.uint8, copy=False)
    if raw == "L;I":
        return 255 - px[..., 0]
    if raw in ("L", "P", "PX"):
        return np.ascontiguousarray(px[..., 0])
    if raw.startswith("RGBa"):
        c, a = px[..., :3].astype(np.int32), px[..., 3:4].astype(np.int32)
        c = np.where(a == 255, c, np.minimum(c * 255 // np.maximum(a, 1), 255))
        return np.where(a == 0, 0, np.concatenate([c, a], -1)).astype(np.uint8)
    return np.ascontiguousarray(px[..., : _MODE_BANDS[lay.mode]])


def _palette(tags: dict, path) -> np.ndarray:
    """Pillow's palette from ColorMap: 2^bits red, green and blue values, each
    divided by 256; the rest of the 256 entries black."""
    if COLORMAP not in tags:
        raise ValueError(f"{path}: PIL does not open a palette TIFF without a ColorMap")
    cmap = _ints(tags, COLORMAP, (), path)
    n = len(cmap) // 3
    vals = (np.asarray(cmap[: 3 * n], np.int64) // 256).astype(np.uint8).reshape(3, n).T
    pal = np.zeros((256, 3), np.uint8)
    pal[: min(n, 256)] = vals[:256]
    return pal


_TRANSPOSE = {
    2: lambda a: a[:, ::-1],
    3: lambda a: a[::-1, ::-1],
    4: lambda a: a[::-1],
    5: lambda a: a.swapaxes(0, 1),
    6: lambda a: np.rot90(a, -1),
    7: lambda a: a.swapaxes(0, 1)[::-1, ::-1],
    8: lambda a: np.rot90(a, 1),
}


def _orient(px: np.ndarray, orientation: int) -> np.ndarray:
    """PIL's `ImageOps.exif_transpose` of pixels under an Orientation tag."""
    fn = _TRANSPOSE.get(orientation)
    return px if fn is None else np.ascontiguousarray(fn(px))


def read_tiff(path) -> Raster:
    """Decode the first image of a TIFF file as PIL opens it (module note)."""
    data = np.fromfile(path, np.uint8)
    tags, big, fits = _ifd(lambda off, n: data[off: off + n].tobytes(), path)
    lay = _layout(tags, big, fits, path)
    px = _pixels(_samples(data, tags, lay, path), lay)
    palette = _palette(tags, path) if lay.mode == "P" else None
    return Raster(_orient(px, lay.orientation), lay.mode, palette)


# Pillow's SAVE_INFO: mode -> (big-endian, photometric, sample format, bits, extra samples)
_SAVE = {"1": (False, 1, 1, (1,), None), "L": (False, 1, 1, (8,), None), "LA": (False, 1, 1, (8, 8), 2),
         "P": (False, 3, 1, (8,), None), "I": (False, 1, 2, (32,), None), "I;16": (False, 1, 1, (16,), None),
         "F": (False, 1, 3, (32,), None), "RGB": (False, 2, 1, (8, 8, 8), None),
         "RGBA": (False, 2, 1, (8, 8, 8, 8), 2), "CMYK": (False, 5, 1, (8, 8, 8, 8), None),
         "I;16B": (True, 1, 1, (16,), None)}


def encode_tiff(img: np.ndarray, mode: str, palette: np.ndarray | None = None) -> bytes:
    """Uncompressed TIFF bytes of `img` in PIL's `mode` (module note): bool
    or uint8 (h, w) for 1, uint8 for L, LA, P (indices; `palette` (n, 3)
    uint8), RGB, RGBA and CMYK, uint16 for I;16 and I;16B, int32 for I,
    float32 for F."""
    if mode not in _SAVE:
        raise OSError(f"cannot write mode {mode} as TIFF")
    big, photometric, fmt, bits, extra = _SAVE[mode]
    e = ">" if big else "<"
    img = np.asarray(img)
    h, w = img.shape[:2]
    if mode == "1":
        data = np.packbits(img.astype(bool), axis=1).tobytes()
    elif mode in ("I;16", "I;16B"):
        data = img.astype(f"{e}u2").tobytes()
    elif mode == "I":
        data = img.astype(f"{e}i4").tobytes()
    elif mode == "F":
        data = img.astype(f"{e}f4").tobytes()
    else:
        data = np.ascontiguousarray(img, np.uint8).tobytes()
    entries = [(WIDTH, 4, [w]), (HEIGHT, 4, [h]), (BITS, 3, list(bits)), (COMPRESSION, 3, [1]),
               (PHOTOMETRIC, 3, [photometric]), (STRIP_OFFSETS, 4, [0]), (SAMPLES, 3, [len(bits)]),
               (ROWS_PER_STRIP, 4, [h]), (STRIP_COUNTS, 4, [len(data)]), (PLANAR, 3, [1])]
    if mode == "P":
        pal = np.zeros((256, 3), np.int64)
        if palette is not None:
            pal[: len(palette)] = np.asarray(palette)[:256]
        entries.append((COLORMAP, 3, list((pal.T * 256).reshape(-1))))
    if extra is not None:
        entries.append((EXTRA_SAMPLES, 3, [extra]))
    if fmt != 1:
        entries.append((SAMPLE_FORMAT, 3, [fmt] * len(bits)))
    entries.sort()
    ifd_at = 8
    n = len(entries)
    blobs_at = ifd_at + 2 + 12 * n + 4
    blobs, body = b"", []
    for tag, typ, vals in entries:
        code, size = _TYPES[typ]
        packed = struct.pack(e + code * len(vals), *vals)
        body.append((tag, typ, len(vals), packed))
        if len(packed) > 4:
            blobs += packed + b"\x00" * (len(packed) % 2)
    data_at = blobs_at + len(blobs)
    ifd = struct.pack(e + "H", n)
    blob_off = blobs_at
    for tag, typ, count, packed in body:
        if tag == STRIP_OFFSETS:
            packed = struct.pack(e + "I", data_at)
        if len(packed) > 4:
            ifd += struct.pack(e + "HHII", tag, typ, count, blob_off)
            blob_off += len(packed) + len(packed) % 2
        else:
            ifd += struct.pack(e + "HHI", tag, typ, count) + packed.ljust(4, b"\x00")
    prefix = b"MM\x00\x2a" if big else b"II\x2a\x00"
    return prefix + struct.pack(e + "I", ifd_at) + ifd + struct.pack(e + "I", 0) + blobs + data


def write_tiff(path, img: np.ndarray, mode: str, palette: np.ndarray | None = None) -> None:
    """Write `img` as PIL's `img.save(path)` writes a TIFF of `mode`
    (`encode_tiff`)."""
    Path(path).write_bytes(encode_tiff(img, mode, palette))
