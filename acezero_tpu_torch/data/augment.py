"""Image normalisation (the augmentation pipeline is not ported yet)."""

from __future__ import annotations

import torch

from acezero_tpu_torch.data.images import GRAY_MEAN, GRAY_STD


def normalize_images(images_u8: torch.Tensor) -> torch.Tensor:
    """uint8 (N, H, W) -> normalized float32 (N, H, W, 1)."""
    x = images_u8.to(torch.float32) / 255.0
    x = (x - GRAY_MEAN) / GRAY_STD
    return x[..., None]
