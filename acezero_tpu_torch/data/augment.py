"""Image normalisation and on-device augmentation.

Counterpart of acezero_tpu/data/augment.py: photometric jitter (brightness
scale, then a torchvision-style contrast blend towards the content mean),
then one affine warp about the canvas centre for the scale jitter and the
in-plane rotation. The supervision follows: the effective focal length is
s * f and the effective world-to-camera pose Rz(theta) @ T (the trainer
composes both); masks are the analytic affine image of the content
rectangle; supervision maps warp with nearest sampling, zeros outside.

Random draws come from an explicit `torch.Generator`; each can instead be
passed in as a tensor (the tests feed the JAX package's draws).
"""

from __future__ import annotations

import math

import torch

from acezero_tpu_torch.data.canvas_geom import content_mask
from acezero_tpu_torch.data.images import GRAY_MEAN, GRAY_STD
from acezero_tpu_torch.data.warp import affine_warp_batch


def normalize_images(images_u8: torch.Tensor) -> torch.Tensor:
    """uint8 (N, H, W) -> normalized float32 (N, H, W, 1)."""
    x = images_u8.to(torch.float32) / 255.0
    x = (x - GRAY_MEAN) / GRAY_STD
    return x[..., None]


def _inverse_affine(theta: torch.Tensor, scale: torch.Tensor, center_xy):
    """Inverse of p' = R(theta) s (p - c) + c as (A, b) with p = A p' + b,
    batched: theta, scale (N,) -> A (N, 2, 2), b (N, 2)."""
    cos = torch.cos(-theta) / scale
    sin = torch.sin(-theta) / scale
    A = torch.stack([torch.stack([cos, -sin], -1), torch.stack([sin, cos], -1)], -2)
    cx, cy = center_xy
    b0 = cx - (A[:, 0, 0] * cx + A[:, 0, 1] * cy)
    b1 = cy - (A[:, 1, 0] * cx + A[:, 1, 1] * cy)
    return A, torch.stack([b0, b1], -1)


def _round_half_away(c: torch.Tensor) -> torch.Tensor:
    """Round half away from zero (the nearest-index rule of the reference's
    map_coordinates), exactly."""
    r = torch.round(c)
    tr = torch.trunc(c)
    return torch.where(torch.abs(c - tr) == 0.5, tr + torch.sign(c), r)


def _affine_sample_nearest(img: torch.Tensor, A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour inverse warp of (N, h, w, C) maps, zeros outside:
    out(p) = img(A p + b) at pixel centres."""
    n, h, w, c = img.shape
    dev = img.device
    ys = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5)[None, :, None]
    xs = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5)[None, None, :]
    A = A[:, :, :, None, None]
    src_x = A[:, 0, 0] * xs + A[:, 0, 1] * ys + b[:, 0, None, None] - 0.5
    src_y = A[:, 1, 0] * xs + A[:, 1, 1] * ys + b[:, 1, None, None] - 0.5
    ix = _round_half_away(src_x).to(torch.int64)
    iy = _round_half_away(src_y).to(torch.int64)
    valid = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
    flat = (iy.clamp(0, h - 1) * w + ix.clamp(0, w - 1)).reshape(n, h * w, 1).expand(n, h * w, c)
    out = torch.gather(img.reshape(n, h * w, c), 1, flat).reshape(n, h, w, c)
    return torch.where(valid[..., None], out, torch.zeros((), dtype=img.dtype, device=dev))


def draw_aug_params(generator: torch.Generator, n: int, aug_rotation_deg: float, aug_scale_min: float,
                    aug_scale_max: float, aug_black_white: float = 0.1, device=None) -> dict:
    """`augment_batch`'s draws for `n` images from `generator` (on `device`,
    by default the generator's): {thetas (radians), scales, brightness,
    contrast}, each (n,) uniform, drawn in that order."""
    dev = generator.device if device is None else device

    def u(lo, hi):
        return torch.rand((n,), generator=generator, device=dev) * (hi - lo) + lo

    bw = aug_black_white
    return {"thetas": u(-1.0, 1.0) * aug_rotation_deg * math.pi / 180.0,
            "scales": u(aug_scale_min, aug_scale_max),
            "brightness": u(1.0 - bw, 1.0 + bw), "contrast": u(1.0 - bw, 1.0 + bw)}


def augment_batch(images_u8: torch.Tensor, sizes: torch.Tensor, aug_rotation_deg: float,
                  aug_scale_min: float, aug_scale_max: float, aug_black_white: float = 0.1,
                  enabled: bool = True, generator: torch.Generator | None = None,
                  params: dict | None = None) -> dict:
    """Photometric + geometric augmentation of a canvas batch.

    images_u8: (N, H, W) uint8 canvases; sizes: (N, 2) content (h, w).
    `params` ({thetas, scales, brightness, contrast}, each (N,)) overrides
    the draws from `generator`; with `enabled=False` nothing is drawn and the
    images are only normalised and masked.

    Returns images (N, H, W, 1) normalized float32, masks (N, H, W) bool,
    thetas (N,) radians and scales (N,).
    """
    n, h, w = images_u8.shape
    dev = images_u8.device
    if not enabled:
        ones = torch.ones((n,), dtype=torch.float32, device=dev)
        params = {"thetas": torch.zeros_like(ones), "scales": ones, "brightness": ones, "contrast": ones}
    elif params is None:
        if generator is None:
            raise ValueError("augment_batch needs a generator or explicit params")
        params = draw_aug_params(generator, n, aug_rotation_deg, aug_scale_min, aug_scale_max, aug_black_white,
                                 device=dev)
    thetas = params["thetas"].to(dev, torch.float32)
    scales = params["scales"].to(dev, torch.float32)
    brightness = params["brightness"].to(dev, torch.float32)
    contrast = params["contrast"].to(dev, torch.float32)

    x = images_u8.to(torch.float32) / 255.0
    base_mask = content_mask(h, w, sizes)
    mean_per_img = torch.sum(x * base_mask, dim=(1, 2)) / torch.clamp(base_mask.sum(dim=(1, 2)), min=1.0)
    x = x * brightness[:, None, None]
    x = x * contrast[:, None, None] + (1.0 - contrast[:, None, None]) * mean_per_img[:, None, None]
    x = torch.clamp(x, 0.0, 1.0)
    x = (x - GRAY_MEAN) / GRAY_STD

    if enabled and (aug_rotation_deg > 0.0 or aug_scale_max > aug_scale_min):
        images = affine_warp_batch(x, thetas, scales, float(aug_rotation_deg), float(aug_scale_max))
    else:
        images = x

    # the warped mask is the affine image of the content rectangle, tested
    # analytically; half-pixel shrink so bilinear samples never blend padding
    A, b = _inverse_affine(thetas, scales, (w / 2.0, h / 2.0))
    A = A[:, :, :, None, None]
    yy = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5)[None, :, None]
    xx = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5)[None, None, :]
    src_x = A[:, 0, 0] * xx + A[:, 0, 1] * yy + b[:, 0, None, None]
    src_y = A[:, 1, 0] * xx + A[:, 1, 1] * yy + b[:, 1, None, None]
    sh = sizes[:, 0].to(torch.int64)
    sw = sizes[:, 1].to(torch.int64)
    y0 = torch.div(h - sh, 2, rounding_mode="floor").to(torch.float32)[:, None, None]
    x0 = torch.div(w - sw, 2, rounding_mode="floor").to(torch.float32)[:, None, None]
    shf = sh.to(torch.float32)[:, None, None]
    swf = sw.to(torch.float32)[:, None, None]
    masks = (src_y >= y0 + 0.5) & (src_y <= y0 + shf - 0.5) & (src_x >= x0 + 0.5) & (src_x <= x0 + swf - 0.5)
    images = torch.where(masks, images, torch.zeros((), dtype=images.dtype, device=dev))
    return {"images": images[..., None], "masks": masks, "thetas": thetas, "scales": scales}


def warp_target_map(target_nhwc: torch.Tensor, thetas: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Warp subsampled supervision maps (N, h, w, C) with each image's affine,
    nearest sampling (so the all-zero "invalid" marker never bleeds), zeros
    outside. The affine is in cell units: rotation and scale about the centre
    commute with the uniform subsampling."""
    _, h, w, _ = target_nhwc.shape
    A, b = _inverse_affine(thetas, scales, (w / 2.0, h / 2.0))
    return _affine_sample_nearest(target_nhwc, A, b)
