"""Exact scene-coordinate grids of synthetic corpus scenes, by ray casting.

Counterpart of acezero_tpu/data/scene_raycast.py. The pretraining
augmentation (in-plane rotation and scale about the principal point) turns
each view into another pinhole camera of the same scene: w2c' = Rz(theta) @
w2c and f' = s * f. Instead of warping the stride-8 ground-truth map, the
supervision re-renders the exact coordinate grid for the augmented camera by
ray-casting the scene's boxes (the interior box and its occluders), so its
error is float round-off.

The geometry comes from `SyntheticScene.box_half` and `.occ_boxes`. Padded
occluder slots hold the PAD_BOX_COORD sentinel (a far-away degenerate box
that never wins the depth test), so scenes with different occluder counts
batch into one fixed-shape array. Batched natively over cameras (the JAX
package vmaps) with a Python loop over the occluder slots (it scans); f32
throughout, TF32 off.
"""

from __future__ import annotations

import numpy as np
import torch

from acezero_tpu_torch.utils.precision import no_tf32

PAD_BOX_COORD = 1.0e9


def pad_occ_boxes(occ_boxes_list: list[np.ndarray], max_boxes: int) -> np.ndarray:
    """Stack per-scene (K_i, 2, 3) occluder arrays into (S, max_boxes, 2, 3)."""
    out = np.full((len(occ_boxes_list), max_boxes, 2, 3), PAD_BOX_COORD, np.float32)
    for i, boxes in enumerate(occ_boxes_list):
        k = 0 if boxes is None else boxes.shape[0]
        if k:
            out[i, :k] = boxes
    return out


def render_coord_grid_batch(box_half: torch.Tensor, occ_boxes: torch.Tensor, c2w: torch.Tensor,
                            focal: torch.Tensor, ppx: float, ppy: float, h_cells: int, w_cells: int,
                            subsample: int = 8) -> torch.Tensor:
    """Exact world-coordinate grids (B, h_cells, w_cells, 3) for B cameras.

    box_half (B,), occ_boxes (B, K, 2, 3) as (lo, hi) corners, c2w (B, 4, 4),
    focal (B,). Cell targets sit at ((k + 0.5) * subsample) full-resolution
    pixels, the registrar's sampling grid.
    """
    dev = c2w.device
    xs = (torch.arange(w_cells, dtype=torch.float32, device=dev) + 0.5) * subsample
    ys = (torch.arange(h_cells, dtype=torch.float32, device=dev) + 0.5) * subsample
    v, u = torch.meshgrid(ys, xs, indexing="ij")
    f = focal.to(torch.float32)[:, None, None]
    d_cam = torch.stack([(u - ppx) / f, (v - ppy) / f, torch.ones_like(u).expand(f.shape[0], -1, -1)], -1)
    R = c2w[:, :3, :3].to(torch.float32)
    origin = c2w[:, :3, 3].to(torch.float32)[:, None, None, :]  # (B, 1, 1, 3)
    with no_tf32():
        d_world = torch.einsum("bhwj,bij->bhwi", d_cam, R)  # d_cam @ R^T

    # |d| < 1e-12 becomes +1e-12 (the sign dropped), as the JAX package has it
    safe_d = torch.where(torch.abs(d_world) < 1e-12, torch.full_like(d_world, 1e-12), d_world)

    # interior walls: the last axis-plane exit along the ray
    bh = box_half.to(torch.float32)[:, None, None, None]
    t_lo = (-bh - origin) / safe_d
    t_hi = (bh - origin) / safe_d
    t_hit = torch.amin(torch.maximum(t_lo, t_hi), dim=-1)

    inf = torch.full_like(t_hit, float("inf"))
    boxes = occ_boxes.to(torch.float32)
    for k in range(boxes.shape[1]):
        lo = boxes[:, k, 0][:, None, None, :]
        hi = boxes[:, k, 1][:, None, None, :]
        t0 = (lo - origin) / safe_d
        t1 = (hi - origin) / safe_d
        t_near = torch.amax(torch.minimum(t0, t1), dim=-1)
        t_far = torch.amin(torch.maximum(t0, t1), dim=-1)
        hit = (t_near <= t_far) & (t_far > 0) & (t_near > 1e-3)
        t_hit = torch.minimum(t_hit, torch.where(hit, t_near, inf))
    return origin + d_world * t_hit[..., None]


def render_coord_grid(box_half, occ_boxes, c2w, focal, ppx: float, ppy: float, h_cells: int, w_cells: int,
                      subsample: int = 8) -> torch.Tensor:
    """One camera's grid (h_cells, w_cells, 3): box_half and focal scalars,
    occ_boxes (K, 2, 3), c2w (4, 4)."""
    c2w = torch.as_tensor(c2w)
    dev = c2w.device
    return render_coord_grid_batch(
        torch.as_tensor(box_half, dtype=torch.float32, device=dev).reshape(1),
        torch.as_tensor(occ_boxes, dtype=torch.float32, device=dev)[None], c2w[None],
        torch.as_tensor(focal, dtype=torch.float32, device=dev).reshape(1), ppx, ppy, h_cells, w_cells,
        subsample)[0]
