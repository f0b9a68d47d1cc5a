"""SE(3) helpers, batched over leading dimensions."""

from __future__ import annotations

import torch

from acezero_tpu_torch.utils.precision import f32_matmul


def make_se3(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """4x4 transforms from (..., 3, 3) rotations and (..., 3) translations."""
    top = torch.cat([R, t[..., :, None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=R.dtype, device=R.device)
    bottom = bottom.expand(R.shape[:-2] + (1, 4))
    return torch.cat([top, bottom], dim=-2)


@f32_matmul
def invert_se3(T: torch.Tensor) -> torch.Tensor:
    """[R t]^-1 = [R^T, -R^T t] for (..., 4, 4) rigid transforms."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = R.transpose(-1, -2)
    return make_se3(Rt, -(Rt @ t[..., None])[..., 0])


def compose_se3(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """A @ B with broadcasting."""
    return A @ B


def to_homogeneous(x: torch.Tensor) -> torch.Tensor:
    """(..., n) -> (..., n + 1) with a trailing 1."""
    return torch.cat([x, torch.ones(x.shape[:-1] + (1,), dtype=x.dtype, device=x.device)], dim=-1)
