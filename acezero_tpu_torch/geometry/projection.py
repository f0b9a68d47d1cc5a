"""Pinhole projection utilities.

Counterpart of acezero_tpu/geometry/projection.py: pixel targets at
subsampled cell centres `sub * (idx + 0.5)`, intrinsics with the principal
point at the image centre.
"""

from __future__ import annotations

import torch

from acezero_tpu_torch.utils.precision import f32_matmul

OUTPUT_SUBSAMPLE = 8  # encoder stride


def get_pixel_grid(h: int, w: int, subsample: int = OUTPUT_SUBSAMPLE, device="cpu") -> torch.Tensor:
    """Target pixel positions (h, w, 2) = (x, y) of the subsampled cells."""
    ys = (torch.arange(h, dtype=torch.float32, device=device) + 0.5) * subsample
    xs = (torch.arange(w, dtype=torch.float32, device=device) + 0.5) * subsample
    yy, xx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([xx, yy], dim=-1)


def make_intrinsics(focal, cx, cy) -> torch.Tensor:
    """(..., 3, 3) K matrices from focal length and principal point."""
    focal, cx, cy = torch.broadcast_tensors(
        torch.as_tensor(focal, dtype=torch.float32),
        torch.as_tensor(cx, dtype=torch.float32),
        torch.as_tensor(cy, dtype=torch.float32),
    )
    zero = torch.zeros_like(focal)
    one = torch.ones_like(focal)
    K = torch.stack([focal, zero, cx, zero, focal, cy, zero, zero, one], dim=-1)
    return K.reshape(focal.shape + (3, 3))


@f32_matmul
def project_points(points_w, pose_w2c, K, min_depth: float = 0.1):
    """Project world points (..., 3); returns pixels (..., 2) and signed depth."""
    R = pose_w2c[..., :3, :3]
    t = pose_w2c[..., :3, 3]
    p_cam = torch.einsum("...ij,...j->...i", R, points_w) + t
    depth = p_cam[..., 2]
    z = torch.clamp(depth, min=min_depth)
    f = K[..., 0, 0]
    cx = K[..., 0, 2]
    cy = K[..., 1, 2]
    px = torch.stack([f * p_cam[..., 0] / z + cx, f * p_cam[..., 1] / z + cy], dim=-1)
    return px, depth


@f32_matmul
def backproject_depth(depth, focal, cx, cy, pose_c2w, pixel_grid):
    """Lift an (h, w) depth map at the cell centres to world coordinates
    (h, w, 3); cells with depth <= 0 or > 1000 give zeros."""
    x = (pixel_grid[..., 0] - cx) / focal * depth
    y = (pixel_grid[..., 1] - cy) / focal * depth
    p_cam = torch.stack([x, y, depth], dim=-1)
    R = pose_c2w[:3, :3]
    t = pose_c2w[:3, 3]
    p_world = torch.einsum("ij,hwj->hwi", R, p_cam) + t
    valid = (depth > 0) & (depth <= 1000.0)
    return torch.where(valid[..., None], p_world, torch.zeros_like(p_world))
