"""The host canvas pass (data/csrc/canvas.cpp) through ctypes.

Counterpart of acezero_tpu/data/native.py. `gray_resize_center` turns one
uint8 gray (h, w) or RGB (h, w, 3) image into ITU-R 601 luma, resizes it
(an area average when shrinking, bilinear otherwise) and writes it centred
into a uint8 canvas, in place: the JAX package's canvases, bit for bit.
data/images.py::gray_resize is its plain numpy version.

The library is built from source on first use (ops/build.py::load_host).
There is no fallback: a failed build raises with the compiler's output, and
a call the library refuses raises ValueError naming the file. ctypes
releases the GIL for the length of each call, so a thread pool resizes
images in parallel; the pass itself is single-threaded.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import numpy as np

from acezero_tpu_torch.ops import build

SOURCE = Path(__file__).resolve().parent / "csrc" / "canvas.cpp"


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load_host(SOURCE)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.acz_gray_resize_center.argtypes = [p, i, i, i, p, i, i, i, i]
    lib.acz_gray_resize_center.restype = i
    return lib


def gray_resize_center(img: np.ndarray, canvas: np.ndarray, out_h: int, out_w: int, path=None) -> None:
    """Write the luma of `img` (uint8 (h, w) or (h, w, 3)), resized to
    (out_h, out_w), into the middle of `canvas` (uint8 (H, W), C-contiguous):
    rows from (H - out_h) // 2, columns from (W - out_w) // 2. `path` names
    the image in errors."""
    if img.dtype != np.uint8 or not (img.ndim == 2 or (img.ndim == 3 and img.shape[2] == 3)):
        raise ValueError(f"{path}: the canvas pass takes uint8 (h, w) or (h, w, 3), got {img.dtype} {img.shape}")
    if canvas.dtype != np.uint8 or canvas.ndim != 2 or not canvas.flags.c_contiguous or not canvas.flags.writeable:
        raise ValueError(f"{path}: the canvas must be a writable C-contiguous uint8 (H, W) array, "
                         f"got {canvas.dtype} {canvas.shape}")
    img = np.ascontiguousarray(img)
    channels = 1 if img.ndim == 2 else 3
    rc = _lib().acz_gray_resize_center(img.ctypes.data, img.shape[0], img.shape[1], channels, canvas.ctypes.data,
                                       canvas.shape[0], canvas.shape[1], int(out_h), int(out_w))
    if rc != 0:
        why = "out of memory" if rc == 2 else "sizes out of range"
        raise ValueError(f"{path}: canvas pass of a {img.shape} image to {(out_h, out_w)} on a {canvas.shape} "
                         f"canvas failed ({why}, code {rc})")
