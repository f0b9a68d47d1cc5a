"""Monocular seed-depth head on top of the frozen feature encoder.

Counterpart of acezero_tpu/models/depthnet.py: four convolutions on the
encoder's stride-8 features predict log-depth per cell, the resolution the
seed targets consume. When d_conv1 takes twice the feature width (the
global-context variant, e.g. `weights/tpu_depth_v4.pt`), each cell's
features are concatenated with the image-mean feature. The convolutions run
on cuDNN through `models.common.conv2d` with the JAX package's bf16
rounding points; the JAX package computes them in XLA, not in a Pallas
kernel. The two training losses are here for the pretraining port.
"""

from __future__ import annotations

import torch

from acezero_tpu_torch.models.common import conv2d, relu


def _layers(width_mult: int = 1):
    """(name, kh, kw, cin, cout) of the head; d_conv1 takes the local and
    the image-mean features."""
    m = max(1, int(width_mult))
    return [
        ("d_conv1", 3, 3, 1024, 256 * m),
        ("d_conv2", 3, 3, 256 * m, 128 * m),
        ("d_conv3", 1, 1, 128 * m, 64 * m),
        ("d_conv4", 1, 1, 64 * m, 1),
    ]


def init_depth_head_params(generator: torch.Generator, width_mult: int = 1, device="cpu") -> dict:
    """Torch-default (kaiming-uniform, a=sqrt(5)) depth-head weights, OIHW;
    `width_mult` scales the hidden widths (the stored shapes carry the
    architecture, so apply infers it)."""
    params = {}
    for name, kh, kw, cin, cout in _layers(width_mult):
        bound = 1.0 / (cin * kh * kw) ** 0.5
        w = torch.rand((cout, cin, kh, kw), generator=generator) * 2 * bound - bound
        b = torch.rand((cout,), generator=generator) * 2 * bound - bound
        params[name] = {"w": w.to(device), "b": b.to(device)}
    return params


def depth_head_apply(params: dict, features: torch.Tensor) -> torch.Tensor:
    """(N, hs, ws, C) encoder features -> (N, hs, ws) metric depth (> 0), f32:
    exp of the predicted log-depth clipped to [-4, 6]."""
    x = features.to(torch.bfloat16)
    if params["d_conv1"]["w"].shape[1] == 2 * x.shape[-1]:
        # global context: the image-mean feature beside every cell's own
        # (an f32 mean rounded to bf16, as jnp.mean of bf16 computes it)
        g = x.float().mean(dim=(1, 2), keepdim=True).to(torch.bfloat16)
        x = torch.cat([x, g.expand(x.shape)], dim=-1)
    x = x.permute(0, 3, 1, 2)
    x = relu(conv2d(x, params["d_conv1"], 1))
    x = relu(conv2d(x, params["d_conv2"], 1))
    x = relu(conv2d(x, params["d_conv3"], 1))
    log_d = conv2d(x, params["d_conv4"], 1).float()[:, 0]
    return torch.exp(torch.clamp(log_d, -4.0, 6.0))


def gradient_matching_loss(pred_depth: torch.Tensor, gt_depth: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """L1 on the spatial gradients of the log-depth difference over
    neighbouring valid cells (the structure term)."""
    d = torch.log(torch.clamp(pred_depth, min=1e-6)) - torch.log(torch.clamp(gt_depth, min=1e-6))
    vx = (valid[..., :, 1:] & valid[..., :, :-1]).float()
    vy = (valid[..., 1:, :] & valid[..., :-1, :]).float()
    gx = torch.abs(d[..., :, 1:] - d[..., :, :-1]) * vx
    gy = torch.abs(d[..., 1:, :] - d[..., :-1, :]) * vy
    n = torch.clamp(vx.sum() + vy.sum(), min=1.0)
    return (gx.sum() + gy.sum()) / n


def silog_loss(pred_depth: torch.Tensor, gt_depth: torch.Tensor, valid: torch.Tensor,
               lam: float = 0.85) -> torch.Tensor:
    """Eigen's scale-invariant log loss over the valid cells; lam = 1
    ignores the global scale, 0.85 keeps a little of it."""
    w = valid.float()
    n = torch.clamp(w.sum(), min=1.0)
    d = (torch.log(torch.clamp(pred_depth, min=1e-6)) - torch.log(torch.clamp(gt_depth, min=1e-6))) * w
    return (d * d).sum() / n - lam * (d.sum() / n) ** 2
