"""BMP files without an image library, read as Pillow's BmpImagePlugin
reads them and written as its `save` writes them.

`read_bmp(path)` gives a `Raster` (io/formats.py): PIL's mode and the
pixels of `np.asarray(Image.open(path))`. It reads the headers PIL reads
(OS/2 v1's 12 bytes, BITMAPINFOHEADER's 40, the 52-, 56- and 64-byte
ones, V4's 108 and V5's 124), top-down and bottom-up rows, 1, 4 and 8 bits
through a palette, 16 bits (5-5-5, or 5-6-5 under BI_BITFIELDS), 24 bits,
32 bits (its fourth byte ignored, as PIL does, unless BI_BITFIELDS gives
an alpha mask: then RGBA), and RLE8 and RLE4 (io/csrc/tiff.cpp's
acz_bmp_rle, Pillow's decoder step for step, its delta escape included:
Pillow skips the two bytes after the escape and takes the next two as the
offsets). A palette of gray levels makes mode 1 (two entries, black and
white) or L (entry i gray level i), as PIL ditches such palettes; any
other makes mode P. PIL then reads the rows with the rawmode of the new
mode whatever the bit depth: mode 1 one bit a pixel from each row's first
bytes, mode L one byte a pixel; an L image's rows are mapped from the file
(`ImageFile.load`'s mmap path) at the bit depth's row stride, so a row of
more bytes than the stride runs into the next one, and past the file's end
into zeros; where the file is shorter than its rows, PIL's raw decoder
refuses such rows. Uncompressed data is decoded in numpy. What PIL refuses
raises ValueError naming the file.

`write_bmp(path, img, mode)` writes PIL's bytes for modes 1, L, P, RGB and
RGBA (BITMAPINFOHEADER, 96 dpi, bottom-up rows padded to 4 bytes; RGBA as
32-bit BGRA, which PIL reads back as RGB).
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

from acezero_tpu_torch.io.formats import Raster, check_size
from acezero_tpu_torch.io.tiff import bmp_rle

BIT2MODE = {1: ("P", "P;1"), 4: ("P", "P;4"), 8: ("P", "P"), 16: ("RGB", "BGR;15"), 24: ("RGB", "BGR"),
            32: ("RGB", "BGRX")}
RAW, RLE8, RLE4, BITFIELDS = 0, 1, 2, 3
# BI_BITFIELDS masks Pillow takes, by bits: (masks) -> rawmode
MASK_MODES = {
    (32, (0xFF0000, 0xFF00, 0xFF, 0x0)): "BGRX",
    (32, (0xFF000000, 0xFF0000, 0xFF00, 0x0)): "XBGR",
    (32, (0xFF000000, 0xFF00, 0xFF, 0x0)): "BGXR",
    (32, (0xFF000000, 0xFF0000, 0xFF00, 0xFF)): "ABGR",
    (32, (0xFF, 0xFF00, 0xFF0000, 0xFF000000)): "RGBA",
    (32, (0xFF0000, 0xFF00, 0xFF, 0xFF000000)): "BGRA",
    (32, (0xFF000000, 0xFF00, 0xFF, 0xFF0000)): "BGAR",
    (32, (0x0, 0x0, 0x0, 0x0)): "BGRA",
    (24, (0xFF0000, 0xFF00, 0xFF)): "BGR",
    (16, (0xF800, 0x7E0, 0x1F)): "BGR;16",
    (16, (0x7C00, 0x3E0, 0x1F)): "BGR;15",
}


def is_bmp(head: bytes) -> bool:
    return head[:2] == b"BM"


def _info(f, path) -> dict:
    """BmpImagePlugin._bitmap: the geometry, PIL's mode and rawmode, the
    palette of mode P and where the pixels start."""
    head = f.read(14)
    if len(head) < 14 or not is_bmp(head):
        raise ValueError(f"{path}: not a BMP file")
    (offset,) = struct.unpack("<I", head[10:14])
    raw = f.read(4)
    if len(raw) < 4:
        raise ValueError(f"{path}: truncated BMP header")
    (size,) = struct.unpack("<I", raw)
    hd = f.read(max(size - 4, 0))
    if len(hd) < size - 4:
        raise ValueError(f"{path}: truncated BMP header")
    info = {"header_size": size, "direction": -1}
    if size == 12:
        w, h, _planes, bits = struct.unpack("<HHHH", hd[:8])
        info.update(width=w, height=h, bits=bits, compression=RAW, padding=3, colors=0)
    elif size in (40, 52, 56, 64, 108, 124):
        y_flip = hd[7] == 0xFF
        w, h = struct.unpack("<II", hd[:8])
        if y_flip:
            h = 2**32 - h
            info["direction"] = 1
        _planes, bits, compression, _data_size, _ppx, _ppy, colors = struct.unpack("<HHIIIII", hd[8:32])
        info.update(width=w, height=h, bits=bits, compression=compression, padding=4, colors=colors)
        if compression == BITFIELDS:
            if len(hd) >= 48:
                n_masks = 4 if len(hd) >= 52 else 3
                masks = struct.unpack(f"<{n_masks}I", hd[36: 36 + 4 * n_masks])
                masks = masks if n_masks == 4 else (*masks, 0)
            else:
                raw = f.read(12)
                if len(raw) < 12:
                    raise ValueError(f"{path}: truncated BMP bitfield masks")
                masks = (*struct.unpack("<3I", raw), 0)
            info["masks"] = masks
    else:
        raise ValueError(f"{path}: PIL does not open a BMP with a {size}-byte header")
    check_size(info["width"], info["height"], path)
    bits = info["bits"]
    info["colors"] = info["colors"] or (1 << bits)
    if offset == 14 + size and bits <= 8:
        offset += 4 * info["colors"]
    info["offset"] = offset
    if bits not in BIT2MODE:
        raise ValueError(f"{path}: PIL does not open a BMP of {bits} bits a pixel")
    mode, rawmode = BIT2MODE[bits]
    compression = info["compression"]
    if compression == BITFIELDS:
        masks = info["masks"]
        if bits == 32 and (32, masks) in MASK_MODES:
            rawmode = MASK_MODES[(32, masks)]
            mode = "RGBA" if "A" in rawmode else mode
        elif bits in (24, 16) and (bits, masks[:3]) in MASK_MODES:
            rawmode = MASK_MODES[(bits, masks[:3])]
        else:
            raise ValueError(f"{path}: PIL does not open this BMP bitfields layout ({bits} bits, masks {masks})")
    elif compression in (RLE8, RLE4):
        if (compression, bits) not in ((RLE8, 8), (RLE4, 4)):
            raise ValueError(f"{path}: BMP kind RLE{8 if compression == RLE8 else 4} at {bits} bits is not read yet")
        rawmode = "rle"
    elif compression != RAW:
        raise ValueError(f"{path}: PIL does not open BMP compression {compression}")
    if mode == "P":
        colors, pad = info["colors"], info["padding"]
        if not 0 < colors <= 256:  # Pillow's gray check fails on a level above 255
            raise ValueError(f"{path}: PIL does not open a BMP palette of {colors} colours")
        pal = f.read(pad * colors)
        levels = (0, 255) if colors == 2 else range(colors)
        if all(pal[i * pad: i * pad + 3] == bytes([v]) * 3 for i, v in enumerate(levels)):
            mode = "1" if colors == 2 else "L"  # PIL ditches a palette of gray levels
            if rawmode == "rle" and mode == "1":
                raise ValueError(f"{path}: PIL does not load an RLE BMP of two gray levels (unknown raw mode)")
            if rawmode != "rle":
                rawmode = mode  # read at one bit (1) or one byte (L) a pixel, whatever the bit depth
        else:
            entries = np.frombuffer(pal[: len(pal) // pad * pad], np.uint8).reshape(-1, pad)
            info["palette"] = np.ascontiguousarray(entries[:, 2::-1])  # BGR(X) -> RGB
    info.update(mode=mode, rawmode=rawmode)
    return info


def bmp_header(path) -> tuple[int, int, str]:
    """(width, height, mode) as PIL opens the BMP file."""
    with open(path, "rb") as f:
        info = _info(f, path)
    return info["width"], info["height"], info["mode"]


def _expand(v: np.ndarray, bits: int) -> np.ndarray:
    return (v.astype(np.int32) * 255 // ((1 << bits) - 1)).astype(np.uint8)


def read_bmp(path) -> Raster:
    """Decode a BMP file as PIL opens it (module note)."""
    with open(path, "rb") as f:
        info = _info(f, path)
    data = np.fromfile(path, np.uint8)
    w, h, bits, rawmode = info["width"], info["height"], info["bits"], info["rawmode"]
    start = info["offset"]
    stride = ((w * bits + 31) >> 3) & ~3
    if rawmode == "rle":
        px = bmp_rle(data, start, info["compression"] == RLE4, w, h, path)
    elif rawmode == "L" and data.size >= start + stride * h:  # mapped rows of w bytes, `stride` apart
        padded = data if w <= stride else np.concatenate([data, np.zeros(w - stride, np.uint8)])
        px = np.lib.stride_tricks.as_strided(padded[start:], shape=(h, w), strides=(stride, 1), writeable=False)
    else:  # the raw decoder: rows of `row` bytes, `stride` apart
        row = (w * {"1": 1, "L": 8}.get(rawmode, bits) + 7) // 8
        if row > stride:
            raise ValueError(f"{path}: PIL's raw decoder refuses rows of {row} bytes in a stride of {stride}")
        if data.size < start + stride * (h - 1) + row:
            raise ValueError(f"{path}: truncated BMP ({data.size} bytes, the pixels need {start + stride * (h - 1) + row})")
        if data.size < start + stride * h:  # the last row's padding is not needed
            data = np.concatenate([data, np.zeros(stride, np.uint8)])
        rows = data[start: start + stride * h].reshape(h, stride)
        if rawmode == "1":
            px = np.unpackbits(rows[:, :row], axis=1)[:, :w]
        elif rawmode == "L" or bits == 8:
            px = rows[:, :w]
        elif bits < 8:
            per = 8 // bits
            shifts = (8 - bits * (1 + np.arange(per))).astype(np.uint8)
            px = ((rows[:, :, None] >> shifts) & ((1 << bits) - 1)).reshape(h, -1)[:, :w].astype(np.uint8)
        elif bits == 16:
            v = rows[:, : 2 * w].copy().view("<u2").reshape(h, w).astype(np.int32)
            if rawmode == "BGR;16":
                px = np.stack([_expand(v >> 11 & 31, 5), _expand(v >> 5 & 63, 6), _expand(v & 31, 5)], -1)
            else:
                px = np.stack([_expand(v >> 10 & 31, 5), _expand(v >> 5 & 31, 5), _expand(v & 31, 5)], -1)
        else:
            b = rows[:, : w * bits // 8].reshape(h, w, bits // 8)
            bands = "RGBA" if info["mode"] == "RGBA" else "RGB"
            px = np.stack([b[..., rawmode.index(c)] for c in bands], -1)
    if info["mode"] == "1":
        px = px != 0
    if info["direction"] == -1:
        px = px[::-1]
    px = np.ascontiguousarray(px)
    return Raster(px, info["mode"], info.get("palette"))


SAVE = {"1": (1, 2), "L": (8, 256), "P": (8, 256), "RGB": (24, 0), "RGBA": (32, 0)}


def encode_bmp(img: np.ndarray, mode: str, palette: np.ndarray | None = None) -> bytes:
    """PIL's BMP bytes of `img` in `mode`: bool or uint8 (h, w) for 1, uint8
    (h, w) for L and P (indices; `palette` (n, 3) uint8), (h, w, 3) RGB,
    (h, w, 4) RGBA."""
    if mode not in SAVE:
        raise OSError(f"cannot write mode {mode} as BMP")
    bits, colors = SAVE[mode]
    img = np.asarray(img)
    h, w = img.shape[:2]
    stride = ((w * bits + 7) // 8 + 3) & ~3
    if mode == "1":
        pal = b"".join(bytes([i, i, i, 0]) for i in (0, 255))
        rows = np.packbits(img.astype(bool), axis=1)
    elif mode == "L":
        pal = b"".join(bytes([i, i, i, 0]) for i in range(256))
        rows = img.astype(np.uint8)
    elif mode == "P":
        p_ = np.asarray(palette if palette is not None else np.zeros((256, 3)), np.uint8)
        pal = np.concatenate([p_[:, ::-1], np.zeros((len(p_), 1), np.uint8)], 1).tobytes()
        colors = len(p_)
        rows = img.astype(np.uint8)
    else:
        pal = b""
        rows = img.astype(np.uint8)[..., [2, 1, 0, 3][: img.shape[2]]].reshape(h, -1)
    body = np.zeros((h, stride), np.uint8)
    body[:, : rows.shape[1]] = rows
    image = stride * h
    offset = 14 + 40 + colors * 4
    ppm = int(96 * 39.3701 + 0.5)
    head = b"BM" + struct.pack("<IIII", offset + image, 0, offset, 40)
    head += struct.pack("<iiHHIIiiII", w, h, 1, bits, 0, image, ppm, ppm, colors, colors)
    return head + pal + body[::-1].tobytes()


def write_bmp(path, img: np.ndarray, mode: str, palette: np.ndarray | None = None) -> None:
    """Write `img` as PIL's `img.save(path)` writes a BMP of `mode`."""
    Path(path).write_bytes(encode_bmp(img, mode, palette))
