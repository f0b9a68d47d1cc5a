"""Depth files and depth -> scene-coordinate targets (host, numpy).

Counterpart of the file helpers of acezero_tpu/data/depth.py. Depth maps
seed the map through supervised scene coordinates. The nearest resize of
`depth_to_canvas` reproduces PIL's `Image.resize(NEAREST)` index rule in
numpy (the port reads no image library). Only `.npy` depth files are read:
a 16-bit depth PNG needs a decoder the port's PNG reader does not have yet,
and raises. The learned seed-depth estimator is not ported yet.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from acezero_tpu_torch.geometry.projection import OUTPUT_SUBSAMPLE


def load_depth_file(path: str | Path) -> np.ndarray:
    """A depth map in metres from a `.npy` file (float64)."""
    p = str(path)
    if p.endswith(".npy"):
        return np.load(p).astype(np.float64)
    raise NotImplementedError(
        f"{p}: only .npy depth files are read; 16-bit depth PNGs need a decoder "
        "the port does not have yet"
    )


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
