"""True-f32 matmuls for pose algebra.

Counterpart of acezero_tpu/utils/precision.py. On the card a float32 matmul
may run in TF32 (cuBLAS) and a float32 convolution does by default (cuDNN);
TF32 keeps about three decimal digits, which breaks P3P, LM and the pose
compositions. `f32_matmul` turns both off for the duration of a call and
restores the caller's settings afterwards.
"""

from __future__ import annotations

import contextlib
import functools

import torch


@contextlib.contextmanager
def no_tf32():
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def f32_matmul(fn):
    """Decorator: run the function with TF32 off."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with no_tf32():
            return fn(*args, **kwargs)

    return wrapped
