"""Seed-depth providers and depth -> scene-coordinate targets.

Counterpart of acezero_tpu/data/depth.py. Depth maps seed the map through
supervised scene coordinates, from one of the JAX package's plug points:
  - depth files: float `.npy` arrays in metres, or any image file that
    `read_image` reads (a 16-bit PNG, TIFF, PGM or JPEG 2000 in
    millimetres, a float TIFF or PFM; a palette image such as a GIF gives
    its indices), its values divided by 1,000 as the JAX package divides
    `np.asarray(Image.open(path))`, float images too;
  - any callable `(rgb_uint8 HxWx3) -> depth_m HxW`, such as
    `learned_depth_estimator` (the seed-depth head on the encoder, run on
    the card unless the CPU is asked for).
The nearest resize of `depth_to_canvas` reproduces PIL's
`Image.resize(NEAREST)` index rule in numpy (the port reads no image
library). `zoe_depth_estimator` raises: the reference's ZoeDepth needs a
torch.hub download.
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable

import numpy as np
import torch

from acezero_tpu_torch import resolve_device
from acezero_tpu_torch.data.images import GRAY_MEAN, GRAY_STD, pil_array, pil_luma_u8, read_image
from acezero_tpu_torch.geometry.projection import OUTPUT_SUBSAMPLE

DepthEstimator = Callable[[np.ndarray], np.ndarray]


def load_depth_file(path: str | Path) -> np.ndarray:
    """A depth map in metres (float64): a `.npy` array as it is, an image
    read as millimetres: its values (`pil_array`, as `np.asarray` of PIL's
    image) divided by 1,000, also where they are floats already in metres,
    as the JAX package does."""
    p = str(path)
    if p.endswith(".npy"):
        return np.load(p).astype(np.float64)
    return pil_array(read_image(p)).astype(np.float64) / 1000.0


def _nearest_index(n_in: int, n_out: int) -> np.ndarray:
    """Source index of each output pixel under PIL's NEAREST resize: the
    pixel-centre coordinate (x + 0.5) * n_in / n_out, accumulated in double
    from 0.5 * scale one step at a time as PIL does, truncated."""
    scale = float(n_in) / n_out
    steps = np.full(n_out, scale)
    steps[0] = scale * 0.5
    return np.minimum(np.add.accumulate(steps).astype(np.int64), n_in - 1)


def depth_to_canvas(depth: np.ndarray, content_hw: tuple[int, int], canvas_hw: tuple[int, int]) -> np.ndarray:
    """Resize a depth map to the content size (nearest) and centre it on the
    canvas; padding gets depth 0 (invalid)."""
    h, w = content_hw
    hc, wc = canvas_hw
    d = np.asarray(depth, np.float32)
    resized = d[_nearest_index(d.shape[0], h)[:, None], _nearest_index(d.shape[1], w)[None, :]]
    out = np.zeros((hc, wc), np.float32)
    y0, x0 = (hc - h) // 2, (wc - w) // 2
    out[y0: y0 + h, x0: x0 + w] = resized
    return out


def subsample_depth(depth_canvas: np.ndarray, subsample: int = OUTPUT_SUBSAMPLE) -> np.ndarray:
    """The depth at subsampled cell centres."""
    off = subsample // 2
    return depth_canvas[off::subsample, off::subsample]


def seed_scene_coordinates(depth_canvas: np.ndarray, focal_canvas: float, pose_c2w: np.ndarray,
                           subsample: int = OUTPUT_SUBSAMPLE) -> np.ndarray:
    """Back-project canvas depth into world-space targets (hs, ws, 3); cells
    with invalid depth (0 or > 1000 m) become all-zero targets."""
    hc, wc = depth_canvas.shape
    d = subsample_depth(depth_canvas, subsample)
    hs, ws = d.shape
    ys = (np.arange(hs) + 0.5) * subsample
    xs = (np.arange(ws) + 0.5) * subsample
    xx, yy = np.meshgrid(xs, ys)
    cx, cy = wc / 2.0, hc / 2.0
    x = (xx - cx) / focal_canvas * d
    y = (yy - cy) / focal_canvas * d
    p_cam = np.stack([x, y, d], axis=-1)
    R = pose_c2w[:3, :3]
    t = pose_c2w[:3, 3]
    p_world = p_cam @ R.T + t
    valid = (d > 0) & (d <= 1000.0)
    return np.where(valid[..., None], p_world, 0.0).astype(np.float32)


def learned_depth_estimator(head_path: str | Path, encoder_params: dict | None = None,
                            encoder_path: str | Path | None = None, device=None) -> DepthEstimator:
    """The in-process seed-depth estimator: the depth head
    (models/depthnet.py) on the encoder's features, at stride 8 and repeated
    to pixel resolution. It runs on the encoder parameters' device, or on
    `device` (default cuda) when it loads the encoder from `encoder_path`.

    The JAX package's order holds: gray (PIL's `convert("L")`) / 255,
    zero-padded to a multiple of 8 at the image's own size, then normalised
    (so the pad is -1.6, not 0)."""
    from acezero_tpu_torch.models.depthnet import depth_head_apply
    from acezero_tpu_torch.models.encoder import encoder_apply
    from acezero_tpu_torch.models.torch_io import load_depth_head, load_encoder

    if encoder_params is None:
        if encoder_path is None:
            raise ValueError("learned_depth_estimator needs encoder params or a path")
        encoder_params = load_encoder(encoder_path, resolve_device(device))
    dev = encoder_params["conv1"]["w"].device
    head_params = load_depth_head(head_path, dev)

    def estimate(image_rgb: np.ndarray) -> np.ndarray:
        img = np.asarray(image_rgb)
        gray = pil_luma_u8(img).astype(np.float32) if img.ndim == 3 else img.astype(np.float32)
        h, w = gray.shape
        hp, wp = -(-h // 8) * 8, -(-w // 8) * 8
        pad = np.zeros((hp, wp), np.float32)
        pad[:h, :w] = gray / 255.0
        x = ((pad - GRAY_MEAN) / GRAY_STD)[None, ..., None]
        with torch.inference_mode():
            d8 = depth_head_apply(head_params, encoder_apply(encoder_params, torch.from_numpy(x).to(dev)))
        d8 = d8[0].double().cpu().numpy()
        return np.repeat(np.repeat(d8, 8, axis=0), 8, axis=1)[:h, :w]

    return estimate


def zoe_depth_estimator() -> DepthEstimator:
    """The reference's ZoeDepth needs a torch.hub download, which the port
    does not make: raises the JAX package's error for an environment
    without it."""
    raise RuntimeError(
        "ZoeDepth is unavailable in this environment (needs torch.hub "
        "network access). Provide --depth_files for the seed images or "
        "plug in a custom DepthEstimator callable."
    )
