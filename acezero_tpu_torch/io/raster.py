"""What the readers of the simple raster formats share (io/tga.py,
io/sgi.py, io/pcx.py, io/dcx.py, io/sun.py, io/qoi.py): the host codec
io/csrc/raster.cpp through ctypes (built on first use, the GIL released
while it runs), and Pillow's unpackers of the raw modes those formats use,
in numpy.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import numpy as np

from acezero_tpu_torch.io.formats import mapped
from acezero_tpu_torch.ops import build

SOURCE = Path(__file__).resolve().parent / "csrc" / "raster.cpp"
_ERR_BYTES = 256


@functools.cache
def lib() -> ctypes.CDLL:
    lib = build.load_host(SOURCE)
    p, n, err, i, i64 = ctypes.c_void_p, ctypes.c_size_t, ctypes.c_char_p, ctypes.c_int, ctypes.c_int64
    out = ctypes.POINTER(ctypes.c_void_p)
    for name, args in (("acz_tga_rle_decode", [p, n, i, i64, i64, p, err, i]),
                       ("acz_sgi_rle_decode", [p, n, i64, i64, i, i, p, err, i]),
                       ("acz_pcx_decode", [p, n, i64, i64, i64, i, p, err, i]),
                       ("acz_sun_rle_decode", [p, n, i64, p, err, i]),
                       ("acz_qoi_decode", [p, n, i64, i64, i, p, err, i])):
        getattr(lib, name).argtypes = args
        getattr(lib, name).restype = i
    for name, args in (("acz_tga_rle_encode", [p, i64, i64, i, out, err, i]),
                       ("acz_pcx_encode", [p, i64, i, i64, i, out, err, i]),
                       ("acz_qoi_encode", [p, i64, i64, i, out, err, i])):
        getattr(lib, name).argtypes = args
        getattr(lib, name).restype = i64
    lib.acz_raster_free.argtypes = [p]
    lib.acz_raster_free.restype = None
    return lib


def read_mapped(path, fn):
    """`fn(b)` of the file's bytes `b`, memory-mapped; what it returns must
    not be a view of `b`. Its ValueError is raised again once the map is
    closed (a traceback that holds a view of the map would keep it open)."""
    with mapped(path) as b:
        try:
            return fn(b)
        except ValueError as e:
            message = str(e)
    raise ValueError(message)


def decode(name: str, src: np.ndarray, *args, out: np.ndarray, path, kind: str) -> np.ndarray:
    """Run the decoder `acz_<name>_decode` on the uint8 array `src` and
    `args` into `out`; its refusal raises ValueError naming the file."""
    err = ctypes.create_string_buffer(_ERR_BYTES)
    rc = getattr(lib(), f"acz_{name}_decode")(src.ctypes.data, src.size, *args, out.ctypes.data, err, _ERR_BYTES)
    if rc:
        raise ValueError(f"{path}: corrupt {kind} ({err.value.decode(errors='replace')})")
    return out


def encode(name: str, data: np.ndarray, *args) -> bytes:
    """The bytes of the encoder `acz_<name>_encode` of `data`."""
    src = np.ascontiguousarray(data, np.uint8)
    out = ctypes.c_void_p()
    err = ctypes.create_string_buffer(_ERR_BYTES)
    n = getattr(lib(), f"acz_{name}_encode")(src.ctypes.data, *args, ctypes.byref(out), err, _ERR_BYTES)
    if n < 0:
        raise ValueError(err.value.decode(errors="replace"))
    try:
        return ctypes.string_at(out, n)
    finally:
        lib().acz_raster_free(out)


def need(data, start: int, size: int, path, kind: str):
    """`size` bytes of `data` from `start`, or ValueError where the file
    ends first (PIL: image file is truncated)."""
    if start + size > len(data):
        raise ValueError(f"{path}: truncated {kind} ({len(data) - start} of {size} image bytes)")
    return np.frombuffer(data, np.uint8, size, start)


# ---------------------------------------------------------------- unpackers


def bits(rows: np.ndarray, width: int, invert: bool = False) -> np.ndarray:
    """Rawmodes "1" and "1;I": bits from the most significant, a set bit
    True ("1;I": False)."""
    px = np.unpackbits(rows, axis=1)[:, :width].astype(bool)
    return ~px if invert else px


def nibbles(rows: np.ndarray, width: int, scale: int = 1) -> np.ndarray:
    """Rawmodes "P;4" and "L;4" (`scale` 17): two pixels a byte, the high
    nibble first."""
    px = np.stack([rows >> 4, rows & 15], -1).reshape(rows.shape[0], -1)[:, :width]
    return (px * scale).astype(np.uint8)


def bit_planes(rows: np.ndarray, width: int, planes: int) -> np.ndarray:
    """Rawmodes "P;2L" and "P;4L": `planes` planes of (width + 7) // 8
    bytes, plane k giving bit k of the index."""
    s = (width + 7) // 8
    out = np.zeros((rows.shape[0], width), np.uint8)
    for k in range(planes):
        out |= np.unpackbits(rows[:, k * s:(k + 1) * s], axis=1)[:, :width] << k
    return out


def channels(rows: np.ndarray, width: int, order: str) -> np.ndarray:
    """Rawmodes of whole bytes a channel ("BGR", "BGRX", "RGBX", "LA",
    "BGRA" ...): (h, width, n) uint8 in RGB(A) / LA order."""
    px = rows[:, : width * len(order)].reshape(rows.shape[0], width, len(order))
    want = "LA" if order == "LA" else "RGBA" if "A" in order else "RGB"
    return np.ascontiguousarray(np.stack([px[..., order.index(c)] for c in want], -1))


def bgra15z(rows: np.ndarray, width: int) -> np.ndarray:
    """Rawmode "BGRA;15Z": 16-bit little-endian pixels, 5 bits a channel
    widened as v * 255 // 31, alpha 255 where the top bit is clear and 0
    where it is set."""
    v = rows[:, : 2 * width].copy().view("<u2").astype(np.int32)
    ch = [((v >> s) & 31) * 255 // 31 for s in (10, 5, 0)]
    return np.stack([*ch, np.where(v >> 15, 0, 255)], -1).astype(np.uint8)
