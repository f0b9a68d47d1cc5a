"""Affine image warp (rotation + uniform scale about the centre).

Counterpart of acezero_tpu/data/warp.py, computing the same function: the
inverse warp out(p) = img(R(-theta)/s (p - c) + c) as a two-pass
Catmull-Smith separable resampling,

  pass 1 (x): a per-image 1-D resize along x (a dense interpolation matrix,
              triangle filter, antialiased when minifying), then a per-row
              fractional shift along x;
  pass 2 (y): a per-image 1-D resize along y, then a per-column fractional
              shift along y;

with alpha = 1/(s cos t), shift slope 1 = s sin t, resize 2 = cos t / s and
shift slope 2 = -tan t. The resizes are batched f32 products with TF32 off.
The JAX package realises each fractional shift with a "barrel shifter" of
static slices and selects, because the TPU has no gather unit; here each
shift is a `torch.gather` of the two integer neighbours and the same clipped
linear blend, which gives the same values.
"""

from __future__ import annotations

import math

import torch

from acezero_tpu_torch.utils.precision import no_tf32


def _resize_matrix(n_out: int, n_in: int, scale: torch.Tensor, center: float, offset: int = 0,
                   max_aw: int = 2) -> torch.Tensor:
    """(B, n_out, n_in) 1-D interpolation matrices for per-image `scale` (B,):
    out[i] = sum_j M[i, j] src[j]. Output index i stands for coordinate
    i - offset and samples source coordinate scale*(i - offset + .5 - c) + c.
    Triangle filter of half-width max(1, scale), normalised over a tap range
    extended by `max_aw` each side, so that taps outside the image keep their
    weight but contribute zeros."""
    dev = scale.device
    i = torch.arange(n_out, dtype=torch.float32, device=dev) + 0.5 - offset
    src = scale[:, None] * (i[None, :] - center) + center  # (B, n_out)
    j = torch.arange(-max_aw, n_in + max_aw, dtype=torch.float32, device=dev) + 0.5
    aw = torch.clamp(scale, min=1.0)[:, None, None]
    w = torch.clamp(1.0 - torch.abs(src[:, :, None] - j[None, None, :]) / aw, min=0.0)
    w = w / torch.clamp(w.sum(dim=-1, keepdim=True), min=1e-8)
    return w[:, :, max_aw: max_aw + n_in]


def _shift_blend(arr_p: torch.Tensor, shift: torch.Tensor, pad: int, dim: int, n_out: int,
                 start: int) -> torch.Tensor:
    """out[..., x] = arr[..., x + shift] along `dim` (bilinear, zeros outside),
    for output positions [start, start + n_out) of the unpadded axis.

    arr_p is the array zero-padded by `pad` before and `pad + 1` after along
    `dim`; `shift` broadcasts against the output with the shifted axis of
    size 1. The shift is clipped to [-pad, pad] as in the JAX barrel shifter.
    """
    t = torch.clamp(shift + pad, 0.0, float(2 * pad))
    k = torch.floor(t)
    frac = t - k
    pos = torch.arange(start, start + n_out, device=arr_p.device)
    shape = [1] * arr_p.dim()
    shape[dim] = n_out
    idx0 = pos.view(shape) + k.to(torch.int64)
    out_shape = list(arr_p.shape)
    out_shape[dim] = n_out
    idx0 = idx0.expand(out_shape)
    v0 = torch.gather(arr_p, dim, idx0)
    v1 = torch.gather(arr_p, dim, idx0 + 1)
    return (1.0 - frac) * v0 + frac * v1


def affine_warp_batch(x: torch.Tensor, thetas: torch.Tensor, scales: torch.Tensor, max_rot_deg: float,
                      max_scale: float) -> torch.Tensor:
    """Warp a batch: out(p) = x(R(-theta)/s (p - c) + c), zeros outside.

    x: (B, H, W) float32 images; thetas, scales: (B,). `max_rot_deg` and
    `max_scale` bound the shifts (larger values clip the shift).
    """
    B, H, W = x.shape
    cx, cy = W / 2.0, H / 2.0
    max_rot = math.radians(max_rot_deg) + 1e-6
    max_scale_for_shift = max(1.0, max_scale)

    cos_t = torch.cos(thetas)
    sin_t = torch.sin(thetas)
    inv_s = 1.0 / scales
    a22 = cos_t * inv_s
    alpha = inv_s / cos_t
    slope1 = scales * sin_t
    slope2 = -sin_t / cos_t

    pad1 = int(math.ceil(max_scale_for_shift * math.sin(max_rot) * (H / 2.0))) + 2
    pad2 = int(math.ceil(math.tan(max_rot) * (W / 2.0))) + 2

    with no_tf32():
        # pass 1: resize along x onto a canvas extended by pad1 columns each
        # side (the shear reads up to pad1 past the nominal width), then shift
        Wx = _resize_matrix(W + 2 * pad1, W, alpha, cx, offset=pad1)  # (B, W + 2 pad1, W)
        r1 = torch.bmm(x, Wx.transpose(1, 2))  # (B, H, W + 2 pad1)
        yy = torch.arange(H, dtype=torch.float32, device=x.device) + 0.5
        shift1 = slope1[:, None] * (yy[None, :] - cy)  # (B, H)
        r1p = torch.nn.functional.pad(r1, (pad1, pad1 + 1))
        q1 = _shift_blend(r1p, shift1[:, :, None], pad1, dim=2, n_out=W, start=pad1)

        # pass 2: resize along y, then shift each column
        Wy = _resize_matrix(H + 2 * pad2, H, a22, cy, offset=pad2)  # (B, H + 2 pad2, H)
        r2 = torch.bmm(Wy, q1)  # (B, H + 2 pad2, W)
    xx = torch.arange(W, dtype=torch.float32, device=x.device) + 0.5
    shift2 = slope2[:, None] * (xx[None, :] - cx)  # (B, W)
    r2p = torch.nn.functional.pad(r2, (0, 0, pad2, pad2 + 1))
    return _shift_blend(r2p, shift2[:, None, :], pad2, dim=1, n_out=H, start=pad2)
