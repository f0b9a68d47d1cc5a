"""JPEG files without an image library: io/csrc/jpeg.cpp through ctypes.

`read_jpeg(path)` gives the pixels of `np.asarray(PIL.Image.open(path))`
for every 8-bit JPEG that PIL decodes: Huffman or arithmetic coding;
baseline, extended sequential, progressive or lossless frames; gray, three
or four components at any sampling factors libjpeg takes; restart
intervals; any size. It reproduces libjpeg-turbo's default decompression,
which PIL runs: the islow IDCT, jdsample.c's upsampling and the
fixed-point colour tables. What PIL refuses (12-bit samples, hierarchical
frames, lossless arithmetic coding, a DNL height, two components) and
truncated or corrupt data raise ValueError naming the file.

`write_jpeg(path, img, quality=75, subsampling="4:2:0")` writes baseline
JPEG byte for byte as PIL's `Image.fromarray(img).save(path, quality=...)`
does; an (h, w, 4) image is CMYK, as `read_jpeg` returns it, and is
written as PIL saves mode CMYK (Adobe APP14, no JFIF, 1 x 1 sampling).

The library is built from source on first use (ops/build.py::load_host).
ctypes releases the GIL for the length of each call, so a thread pool
decodes files in parallel.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import numpy as np

from acezero_tpu_torch.ops import build

SOURCE = Path(__file__).resolve().parent / "csrc" / "jpeg.cpp"
SUBSAMPLING = {"4:4:4": 0, "4:2:0": 1}
_ERR_BYTES = 512


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load_host(SOURCE)
    p, n, err, i = ctypes.c_void_p, ctypes.c_size_t, ctypes.c_char_p, ctypes.c_int
    lib.acz_jpeg_header.argtypes = [p, n, p, err, i]
    lib.acz_jpeg_header.restype = i
    lib.acz_jpeg_decode_space.argtypes = [p, n, i, p, n, err, i]
    lib.acz_jpeg_decode_space.restype = i
    lib.acz_jpeg_encode.argtypes = [p, i, i, i, i, i, p, n, err, i]
    lib.acz_jpeg_encode.restype = ctypes.c_int64
    return lib


def jpeg_shape(data: np.ndarray, path) -> tuple[int, ...]:
    """(h, w), (h, w, 3) or (h, w, 4) of the JPEG held in `data` (uint8),
    from its start-of-frame marker."""
    hwc = np.zeros(3, np.int32)
    err = ctypes.create_string_buffer(_ERR_BYTES)
    if _lib().acz_jpeg_header(data.ctypes.data, data.size, hwc.ctypes.data, err, _ERR_BYTES):
        raise ValueError(f"{path}: {err.value.decode(errors='replace')}")
    h, w, c = (int(v) for v in hwc)
    return (h, w) if c == 1 else (h, w, c)


def decode_jpeg(data: np.ndarray, path, space3: int = -1) -> np.ndarray:
    """Decode the JPEG held in `data` (uint8) as `read_jpeg` does; `path`
    names it in errors. For three components `space3` overrides libjpeg's
    colour-space guess: 0 takes the samples as RGB, 1 as YCbCr (a TIFF's
    photometric interpretation decides it, io/tiff.py)."""
    out = np.empty(jpeg_shape(data, path), np.uint8)
    err = ctypes.create_string_buffer(_ERR_BYTES)
    if _lib().acz_jpeg_decode_space(data.ctypes.data, data.size, int(space3), out.ctypes.data, out.nbytes, err,
                                    _ERR_BYTES):
        raise ValueError(f"{path}: {err.value.decode(errors='replace')}")
    return out


def read_jpeg(path) -> np.ndarray:
    """Decode a JPEG file as PIL opens it: (h, w) uint8 for mode L (one
    component), (h, w, 3) uint8 for mode RGB (three, YCbCr or RGB), (h, w, 4)
    uint8 for mode CMYK (four, CMYK or YCCK; Adobe's inverted convention
    undone, as PIL's "CMYK;I" does). data/images.py::read_image keeps the
    last apart from RGBA."""
    return decode_jpeg(np.fromfile(path, np.uint8), path)


def encode_jpeg(img: np.ndarray, quality: int = 75, subsampling: str = "4:2:0") -> bytes:
    """Baseline JPEG bytes of an 8-bit gray (h, w), RGB (h, w, 3) or CMYK
    (h, w, 4) image; `subsampling` applies to RGB and is "4:2:0" or
    "4:4:4"."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or not (img.ndim == 2 or (img.ndim == 3 and img.shape[2] in (3, 4))):
        raise ValueError(f"write_jpeg takes uint8 (h, w), (h, w, 3) or (h, w, 4), got {img.dtype} {img.shape}")
    if subsampling not in SUBSAMPLING:
        raise ValueError(f"subsampling must be one of {sorted(SUBSAMPLING)}, got {subsampling!r}")
    h, w = img.shape[:2]
    c = 1 if img.ndim == 2 else img.shape[2]
    lib = _lib()
    err = ctypes.create_string_buffer(_ERR_BYTES)
    cap = 2 * img.size + 4096
    for _ in range(2):
        out = np.empty(cap, np.uint8)
        n = lib.acz_jpeg_encode(img.ctypes.data, h, w, c, int(quality), SUBSAMPLING[subsampling],
                                out.ctypes.data, cap, err, _ERR_BYTES)
        if n < 0:
            raise ValueError(err.value.decode(errors="replace"))
        if n <= cap:
            return out[:n].tobytes()
        cap = n
    raise RuntimeError("JPEG encoder reported two different lengths")


def write_jpeg(path, img: np.ndarray, quality: int = 75, subsampling: str = "4:2:0") -> None:
    """Write `img` as PIL's `Image.fromarray(img).save(path, quality=quality,
    subsampling=subsampling)` would; a gray or CMYK (h, w, 4) image as PIL's
    save without the subsampling option, which no caller passes for one (PIL
    then writes 2 x 2 sampling factors on the single gray component, 1 x 1
    on each of the four)."""
    Path(path).write_bytes(encode_jpeg(img, quality, subsampling))
