"""Point-splat renderer for reconstruction videos.

Counterpart of acezero_tpu/viz/renderer.py: project the points, keep a
z-buffer by scatter-min over each point's splat footprint, and let only
the winners write their colour. The JAX package lets every splat within a
relative 1e-6 of a pixel's minimum depth write, in an unspecified order
(on the CPU, XLA's serial scatter leaves the last one). The port fixes
that rule: of a pixel's winners, the one with the largest splat index
writes (a scatter-max of the winners' indices, then a gather of their
colours), which is the JAX package's CPU result and the same bits on the
card every time. The projection sums its three products explicitly, so
the card and the CPU round alike.

`frustum_line_points` and `render_cameras` are the JAX package's numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from acezero_tpu_torch import resolve_device

_INT_RANGE = float(2**30)  # floor(u) is clamped here before the int cast (the casts saturate in XLA)


def _pixel(coord: torch.Tensor) -> torch.Tensor:
    return torch.nan_to_num(torch.floor(coord), nan=0.0).clamp(-_INT_RANGE, _INT_RANGE).to(torch.int64)


def render_point_cloud(
    xyz: torch.Tensor,
    rgb: torch.Tensor,
    pose_w2c,
    focal: float,
    h: int,
    w: int,
    splat: int = 2,
    background: float = 1.0,
) -> torch.Tensor:
    """Render points (n, 3) with colors (n, 3 in [0,1]) to an (h, w, 3)
    float32 image on the points' device."""
    dev = xyz.device
    pose = torch.as_tensor(np.asarray(pose_w2c, np.float32), device=dev)
    R, t = pose[:3, :3], pose[:3, 3]
    p_cam = xyz[:, 0:1] * R[:, 0] + xyz[:, 1:2] * R[:, 1] + xyz[:, 2:3] * R[:, 2] + t
    z = p_cam[:, 2]
    valid = z > 0.05
    z_safe = torch.where(valid, z, 1.0)
    f = float(np.float32(focal))
    u0 = _pixel(f * p_cam[:, 0] / z_safe + w / 2.0)
    v0 = _pixel(f * p_cam[:, 1] / z_safe + h / 2.0)

    # every point over its splat footprint, in the JAX package's order
    # (dy outer, dx inner); invalid points go to the dummy slot h*w
    flat = torch.cat([
        torch.where(valid, (v0 + dy).clamp(0, h - 1) * w + (u0 + dx).clamp(0, w - 1), h * w)
        for dy in range(splat) for dx in range(splat)
    ])
    zp = torch.where(valid, z, torch.inf).repeat(splat * splat)

    # pass 1: the depth buffer; pass 2: of the splats within 1e-6 of it,
    # the largest index writes its colour
    zbuf = torch.full((h * w + 1,), torch.inf, device=dev).scatter_reduce_(0, flat, zp, "amin")
    won = zp <= zbuf[flat] * (1.0 + 1e-6)
    best = torch.full((h * w + 1,), -1, dtype=torch.int64, device=dev).scatter_reduce_(
        0, torch.where(won, flat, h * w), torch.arange(flat.numel(), device=dev), "amax")[: h * w]
    img = torch.where((best >= 0)[:, None], rgb[best.clamp(min=0) % max(xyz.shape[0], 1)], background)
    return img.reshape(h, w, 3)


def frustum_line_points(pose_c2w: np.ndarray, size: float, samples: int = 24) -> np.ndarray:
    """Dense points along the 8 edges of a camera frustum (world space)."""
    s = size
    corners = np.array(
        [
            [0.0, 0.0, 0.0],
            [-s, -0.75 * s, 1.6 * s],
            [s, -0.75 * s, 1.6 * s],
            [s, 0.75 * s, 1.6 * s],
            [-s, 0.75 * s, 1.6 * s],
        ]
    )
    edges = [(0, 1), (0, 2), (0, 3), (0, 4), (1, 2), (2, 3), (3, 4), (4, 1)]
    ts = np.linspace(0.0, 1.0, samples)[:, None]
    pts = np.concatenate([corners[a] * (1 - ts) + corners[b] * ts for a, b in edges])
    return pts @ pose_c2w[:3, :3].T + pose_c2w[:3, 3]


def render_cameras(
    poses_c2w: np.ndarray,
    colors: np.ndarray,
    pose_w2c_view: np.ndarray,
    focal: float,
    h: int,
    w: int,
    marker_size: float = 0.03,
):
    """Rasterize camera frustums: returns (xyz, rgb) point sets for splatting."""
    pts, cols = [], []
    for pose, color in zip(poses_c2w, colors):
        p = frustum_line_points(pose, marker_size)
        pts.append(p)
        cols.append(np.tile(color, (p.shape[0], 1)))
    if not pts:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.float32)
    return np.concatenate(pts).astype(np.float32), np.concatenate(cols).astype(np.float32)


def composite_frame(
    cloud_xyz,
    cloud_rgb,
    camera_xyz: np.ndarray,
    camera_rgb: np.ndarray,
    pose_w2c_view: np.ndarray,
    focal: float,
    h: int,
    w: int,
    device=None,
) -> np.ndarray:
    """One video frame: point cloud + camera markers, uint8 (h, w, 3).

    The cloud may be numpy or tensors already on `device` (the visualizer
    keeps a device copy); `device` defaults to the cloud tensor's device,
    else to the card."""
    if device is None:
        device = cloud_xyz.device if isinstance(cloud_xyz, torch.Tensor) else resolve_device(None)
    xyz = torch.as_tensor(cloud_xyz, dtype=torch.float32, device=device)
    rgb = torch.as_tensor(cloud_rgb, dtype=torch.float32, device=device)
    if camera_xyz.size:
        xyz = torch.cat([xyz, torch.as_tensor(camera_xyz, dtype=torch.float32, device=device)])
        rgb = torch.cat([rgb, torch.as_tensor(camera_rgb, dtype=torch.float32, device=device)])
    if xyz.shape[0] == 0:
        return np.full((h, w, 3), 255, np.uint8)
    img = render_point_cloud(xyz, rgb, pose_w2c_view, focal, h, w)
    return (img * 255).clamp(0, 255).to(torch.uint8).cpu().numpy()
