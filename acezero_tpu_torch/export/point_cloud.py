"""Point-cloud extraction from a trained scene map (`pc_final.ply`).

Counterpart of acezero_tpu/export/point_cloud.py, in two parts:
  - `predict_coords`: the scene coordinates of every frame, the encoder and
    the head (through K1 on the card) over chunks of `chunk` frames, one
    K1 launch a chunk;
  - `select_points`: the JAX package's per-frame selection on the host, in
    numpy so that it is exact: spatial smoothness (the neighbour-coordinate
    gradient under thresholds relaxed from 0.1 m to inf until enough points
    survive), camera depth under `filter_depth`, L1 reprojection error
    under 1 px relaxed per frame to keep `PC_POINTS_MIN / frames` points and
    subsampled (`default_rng(0)`) above `PC_POINTS_MAX / frames`; dense mode
    drops the gradient and error filters.
Colours are the RGB file's pixels at the cell centres after PIL's bilinear
resize to the content size (reproduced exactly by
`data.images.pil_resize_bilinear`), or the gray canvas when the file cannot
be read. The coordinates go through the canvas normalisation without
zeroing the padding, as the JAX package's export does.
"""

from __future__ import annotations

import logging
from pathlib import Path

import numpy as np
import torch

from acezero_tpu_torch.data.augment import normalize_images
from acezero_tpu_torch.data.images import pil_resize_bilinear, read_rgb
from acezero_tpu_torch.data.scene import SceneData
from acezero_tpu_torch.geometry.projection import get_pixel_grid
from acezero_tpu_torch.io.ply import write_ply_points
from acezero_tpu_torch.io.pose_files import PoseFileEntry
from acezero_tpu_torch.models.encoder import encoder_apply
from acezero_tpu_torch.models.head import HeadConfig, head_apply_image

_logger = logging.getLogger(__name__)

GRAD_THRESHOLDS = [0.1, 0.5, 1.0, np.inf]
PC_POINTS_MIN = 100_000
PC_POINTS_MAX = 1_000_000
REPRO_THRESHOLD = 1.0


@torch.inference_mode()
def predict_coords(encoder_params: dict, head_params: dict, head_cfg: HeadConfig, canvases_u8: np.ndarray,
                   chunk: int = 64) -> np.ndarray:
    """(n, hs, ws, 3) float32 scene coordinates of (n, H, W) uint8 canvases,
    on the encoder parameters' device, `chunk` frames a pass."""
    dev = encoder_params["conv1"]["w"].device
    out = []
    for c0 in range(0, len(canvases_u8), chunk):
        images = torch.from_numpy(np.ascontiguousarray(canvases_u8[c0: c0 + chunk])).to(dev)
        feats = encoder_apply(encoder_params, normalize_images(images))
        out.append(head_apply_image(head_params, head_cfg, feats).float().cpu().numpy())
    return np.concatenate(out) if out else np.zeros((0, 0, 0, 3), np.float32)


def _frame_colors(scene: SceneData, idx: int, hs: int, ws: int) -> np.ndarray:
    """(hs*ws, 3) uint8 colours at the cell centres; RGB when the file reads."""
    try:
        rgb = read_rgb(scene.rgb_files[idx])
    except (OSError, ValueError):  # not a readable PNG: the gray canvas
        gray = scene.images.content(idx)[4::8, 4::8][:hs, :ws]
        return np.stack([gray] * 3, axis=-1).reshape(-1, 3)
    h, w = (int(v) for v in scene.images.sizes[idx])
    hc, wc = scene.canvas_hw
    canvas = np.zeros((hc, wc, 3), np.uint8)
    y0, x0 = (hc - h) // 2, (wc - w) // 2
    canvas[y0: y0 + h, x0: x0 + w] = pil_resize_bilinear(rgb, h, w)
    return canvas[4::8, 4::8][:hs, :ws].reshape(-1, 3)


def select_points(coords: np.ndarray, frames: list[tuple[int, PoseFileEntry]], scene: SceneData,
                  filter_depth: float = 100.0, dense: bool = False, convention: str = "opencv"):
    """(xyz (N, 3) float32, rgb (N, 3) uint8) from the frames' coordinate
    maps `coords` (one (hs, ws, 3) map per entry of `frames`, (scene index,
    pose entry) pairs); the JAX package's selection, step for step."""
    n_frames = max(len(frames), 1)
    per_min = PC_POINTS_MIN // n_frames
    per_max = PC_POINTS_MAX // n_frames
    grad_ts = [np.inf] if dense else GRAD_THRESHOLDS
    repro_t = np.inf if dense else REPRO_THRESHOLD

    pc_xyz, pc_rgb = [], []
    for (idx, entry), crd in zip(frames, coords):
        hs, ws = crd.shape[:2]
        grid = get_pixel_grid(hs, ws).numpy()
        w2c = entry.pose_w2c
        p_cam = crd @ w2c[:3, :3].T + w2c[:3, 3]
        z = np.maximum(p_cam[..., 2], 0.1)
        f = entry.focal_length * scene.images.scale_factors[idx]
        cx, cy = scene.principal_point
        u = f * p_cam[..., 0] / z + cx
        v = f * p_cam[..., 1] / z + cy
        err = np.abs(u - grid[..., 0]) + np.abs(v - grid[..., 1])

        gx = np.linalg.norm(np.diff(crd, axis=1, prepend=crd[:, :1]), axis=-1)
        gy = np.linalg.norm(np.diff(crd, axis=0, prepend=crd[:1]), axis=-1)
        grad = np.maximum(gx, gy)
        for gt in grad_ts:
            grad_mask = grad < gt
            if grad_mask.sum() > per_min:
                break
        mask = grad_mask & (p_cam[..., 2] < filter_depth)
        if mask.sum() == 0:
            mask[:] = True

        err_mask = (err < repro_t) & mask
        n_valid = int(err_mask.sum())
        if n_valid < per_min:
            pool = err[mask]
            k = min(per_min, pool.size - 1)
            relaxed = np.sort(pool)[k] if pool.size else np.inf
            err_mask = (err < relaxed) & mask
        elif n_valid > per_max:
            keep = np.random.default_rng(0).choice(np.flatnonzero(err_mask), per_max, replace=False)
            err_mask = np.zeros_like(err_mask)
            err_mask.reshape(-1)[keep] = True

        sel = err_mask.reshape(-1)
        pc_xyz.append(crd.reshape(-1, 3)[sel])
        pc_rgb.append(_frame_colors(scene, idx, hs, ws)[sel])

    xyz = np.concatenate(pc_xyz) if pc_xyz else np.zeros((0, 3))
    rgb = np.concatenate(pc_rgb) if pc_rgb else np.zeros((0, 3), np.uint8)
    if convention == "opengl":
        xyz = xyz.copy()
        xyz[:, 1] = -xyz[:, 1]
        xyz[:, 2] = -xyz[:, 2]
    return xyz.astype(np.float32), rgb.astype(np.uint8)


def point_cloud_from_network(encoder_params, head_params, head_cfg: HeadConfig, scene: SceneData,
                             entries: list[PoseFileEntry], filter_depth: float = 100.0, dense: bool = False,
                             convention: str = "opencv"):
    """Extract (xyz (N, 3) float32, rgb (N, 3) uint8) from the trained map:
    every entry whose file is in the scene, at its pose and focal."""
    by_file = {f: i for i, f in enumerate(scene.rgb_files)}
    frames = [(by_file[e.rgb_file], e) for e in entries if e.rgb_file in by_file]
    canvases = scene.images.content(np.asarray([i for i, _ in frames], np.int64))
    coords = predict_coords(encoder_params, head_params, head_cfg, canvases)
    return select_points(coords, frames, scene, filter_depth, dense, convention)


def export_point_cloud_from_network(path: str | Path, encoder_params, head_params, head_cfg: HeadConfig,
                                    scene: SceneData, entries: list[PoseFileEntry], filter_depth: float = 100.0,
                                    dense: bool = False, convention: str = "opencv") -> None:
    xyz, rgb = point_cloud_from_network(encoder_params, head_params, head_cfg, scene, entries, filter_depth, dense,
                                        convention)
    write_ply_points(path, xyz, rgb)
    _logger.info("Exported %d points to %s", xyz.shape[0], path)
