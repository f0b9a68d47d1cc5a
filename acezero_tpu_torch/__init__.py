"""PyTorch/CUDA port of acezero_tpu for NVIDIA Hopper.

The JAX package `acezero_tpu` is the reference; this package never imports
it, nor JAX. Entry points run on `cuda` unless the caller passes
`device="cpu"`.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`cuda` by default; raises if CUDA is absent and the CPU was not asked for."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the port on the CPU"
        )
    return dev
