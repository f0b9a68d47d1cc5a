"""Shared layers: bf16 convolutions and dense layers with JAX's rounding.

Parameters are plain dicts of tensors: convolutions {"w": (cout, cin, kh,
kw), "b": (cout,)}, dense layers {"w": (cin, cout), "b": (cout,)}. The
rounding points follow acezero_tpu/models/common.py: a convolution rounds
its output to the compute type and then adds the bias in that type; a dense
layer accumulates in f32, adds the bias in f32 and then rounds.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def conv2d(x_nchw: torch.Tensor, p: dict, stride: int = 1, compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Convolution with symmetric padding (k - 1) // 2, then the bias added
    in `compute_dtype` (no fused bias: that would round once, not twice)."""
    kh, kw = p["w"].shape[2:]
    out = F.conv2d(
        x_nchw.to(compute_dtype),
        p["w"].to(compute_dtype),
        None,
        stride=stride,
        padding=((kh - 1) // 2, (kw - 1) // 2),
    )
    return out + p["b"].to(compute_dtype).view(1, -1, 1, 1)


def dense(x: torch.Tensor, p: dict, compute_dtype=torch.bfloat16) -> torch.Tensor:
    """(..., cin) @ (cin, cout) + b: operands rounded to `compute_dtype`,
    products accumulated in f32 (exact for bf16 operands), bias in f32, then
    the result rounded to `compute_dtype`."""
    xc = x.to(compute_dtype).float()
    wc = p["w"].to(compute_dtype).float()
    return (torch.matmul(xc, wc) + p["b"].float()).to(compute_dtype)


def init_dense(generator: torch.Generator, cin: int, cout: int, device="cpu") -> dict:
    """Dense layer (== 1x1 conv) params, torch-default initialised:
    U(-1/sqrt(cin), 1/sqrt(cin)) for weight and bias."""
    bound = 1.0 / cin**0.5
    w = torch.rand((cin, cout), generator=generator) * 2 * bound - bound
    b = torch.rand((cout,), generator=generator) * 2 * bound - bound
    return {"w": w.to(device), "b": b.to(device)}


def relu(x: torch.Tensor) -> torch.Tensor:
    return torch.relu(x)
