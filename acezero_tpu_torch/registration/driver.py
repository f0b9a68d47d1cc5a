"""Registration driver: relocalize every frame of a scene against a map.

Counterpart of acezero_tpu/registration/driver.py (`register_frames`):
normalized canvases go through encoder + head to scene coordinates, chunk
by chunk, and then through the batched registrar. Outputs per frame: the
pose (world-to-camera in the entry, as pose files store it), the inlier
count as confidence, and the original-pixel focal length.

Two-tier refit budget: the refit loop of a chunk runs as long as its
slowest frame, so pass 1 caps every frame at `refit_tier1` refits and the
frames cut off while still growing re-run with the full budget and the
same hypothesis draws. The registrar is deterministic, so the result equals
a single full-budget pass. Frames where no minimal set validated get one
more pass with four times the tries.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field, replace

import numpy as np
import torch

from acezero_tpu_torch import resolve_device
from acezero_tpu_torch.data.augment import normalize_images
from acezero_tpu_torch.data.canvas_geom import content_mask
from acezero_tpu_torch.data.scene import SceneData
from acezero_tpu_torch.geometry.projection import get_pixel_grid
from acezero_tpu_torch.io.pose_files import PoseFileEntry
from acezero_tpu_torch.models.encoder import encoder_apply
from acezero_tpu_torch.models.head import HeadConfig, head_apply_image
from acezero_tpu_torch.registration.ransac import (
    RansacConfig,
    draw_hypothesis_indices,
    estimate_poses_batch,
)

_logger = logging.getLogger(__name__)


@dataclass(frozen=True)
class RegistrationConfig:
    ransac: RansacConfig = field(default_factory=lambda: RansacConfig(hypotheses=64, max_tries=16))
    confidence_threshold: float = 1000.0  # "successfully registered" bar for reporting
    max_estimates: int = -1
    frame_chunk: int = 64
    base_seed: int = 1305
    refit_tier1: int = 16  # pass-1 refit cap; <= 0 disables the two tiers


def _canvas_prologue(images_u8: torch.Tensor, sizes: torch.Tensor, subsample: int):
    """Normalize, zero the padding, and derive the cell mask, pixel grid and
    principal points of a chunk."""
    B, H, W = images_u8.shape
    images = normalize_images(images_u8)
    mask = content_mask(H, W, sizes)
    images = torch.where(mask[..., None], images, torch.zeros_like(images))
    off = subsample // 2
    mask_lr = mask[:, off::subsample, off::subsample]
    grid = get_pixel_grid(H // subsample, W // subsample, subsample, device=images_u8.device)
    ppx = torch.full((B,), W / 2.0, dtype=torch.float32, device=images_u8.device)
    ppy = torch.full((B,), H / 2.0, dtype=torch.float32, device=images_u8.device)
    return images, mask_lr, grid, ppx, ppy


@torch.inference_mode()
def coords_chunk(encoder_params, head_params, head_cfg: HeadConfig, images_u8, sizes, subsample: int = 8):
    """Scene coordinates (B, h, w, 3) and cell mask (B, h, w) of one chunk."""
    images, mask_lr, _, _, _ = _canvas_prologue(images_u8, sizes, subsample)
    feats = encoder_apply(encoder_params, images)
    return head_apply_image(head_params, head_cfg, feats), mask_lr


def register_frames(
    encoder_params,
    head_params,
    head_cfg: HeadConfig,
    scene: SceneData,
    cfg: RegistrationConfig,
    device=None,
    hyp_indices: torch.Tensor | None = None,
) -> list[PoseFileEntry]:
    """Register every frame of the scene; returns pose-file entries.

    Parameters must already be on `device` (default cuda). hyp_indices
    (frames, H, T, 4), indexed by scene frame, replaces the generator's
    draws of pass 1 (and so of the tier-2 rerun); the sampling-failure retry
    always draws from the generator, seeded from `cfg.base_seed`.
    """
    device = resolve_device(device)
    n = len(scene)
    order = np.random.default_rng(cfg.base_seed).permutation(n)
    if cfg.max_estimates > 0:
        order = order[: cfg.max_estimates]
    generator = torch.Generator(device=device).manual_seed(cfg.base_seed + 0x9E37)

    full_steps = cfg.ransac.refinement_steps
    tiered = 0 < cfg.refit_tier1 < full_steps
    pass1_steps = cfg.refit_tier1 if tiered else full_steps
    H, W = scene.images.canvas_hw
    grid = get_pixel_grid(H // 8, W // 8, 8, device=device)
    chunk = cfg.frame_chunk

    def run(idx, ransac_cfg, max_steps, draws):
        images = torch.from_numpy(np.ascontiguousarray(scene.images.canvases[idx])).to(device)
        sizes = torch.from_numpy(scene.images.sizes[idx].astype(np.int64)).to(device)
        coords, mask_lr = coords_chunk(encoder_params, head_params, head_cfg, images, sizes)
        if draws is None:
            draws = draw_hypothesis_indices(mask_lr.reshape(len(idx), -1), ransac_cfg.hypotheses,
                                            ransac_cfg.max_tries, generator)
        out = estimate_poses_batch(
            coords, mask_lr, grid,
            torch.as_tensor(scene.focals_canvas[idx], dtype=torch.float32, device=device),
            torch.full((len(idx),), W / 2.0, device=device),
            torch.full((len(idx),), H / 2.0, device=device),
            ransac_cfg, max_steps, hyp_indices=draws,
        )
        return {k: v.cpu().numpy() for k, v in out.items()}, draws

    def entry(i, pose_c2w, conf):
        return PoseFileEntry(
            rgb_file=scene.rgb_files[i],
            pose_w2c=np.linalg.inv(pose_c2w.astype(np.float64)),
            focal_length=float(scene.focals_orig[i]),
            confidence=float(conf),
        )

    entries: list[PoseFileEntry] = []
    entry_slot: dict[int, int] = {}
    failed: list[int] = []
    capped: dict[int, torch.Tensor] = {}  # frame -> its pass-1 draws
    t0 = time.time()
    for c0 in range(0, len(order), chunk):
        idx = order[c0 : c0 + chunk]
        given = None if hyp_indices is None else hyp_indices[torch.as_tensor(idx)]
        out, draws = run(idx, cfg.ransac, pass1_steps, given)
        for j, i in enumerate(idx):
            i = int(i)
            if not out["valid"][j]:
                failed.append(i)
            if tiered and out["hit_cap"][j]:
                capped[i] = draws[j]
            entry_slot[i] = len(entries)
            entries.append(entry(i, out["pose_c2w"][j], out["inlier_count"][j]))

    def rerun(frames, ransac_cfg, draws_of, only_valid):
        for c0 in range(0, len(frames), chunk):
            idx = np.asarray(frames[c0 : c0 + chunk])
            draws = draws_of(idx)
            out, _ = run(idx, ransac_cfg, full_steps, draws)
            for j, i in enumerate(idx):
                if not only_valid or out["valid"][j]:
                    entries[entry_slot[int(i)]] = entry(int(i), out["pose_c2w"][j], out["inlier_count"][j])

    if capped:
        _logger.info("Refit tier 2: %d/%d frames re-run at the %d-step cap.",
                     len(capped), len(order), full_steps)
        rerun(list(capped), cfg.ransac, lambda idx: torch.stack([capped[int(i)] for i in idx]), False)

    if failed and cfg.ransac.max_tries < 256:
        retry_cfg = replace(cfg.ransac, max_tries=cfg.ransac.max_tries * 4)
        _logger.info("Retrying %d total-sampling-failure frames with %d tries.",
                     len(failed), retry_cfg.max_tries)
        rerun(failed, retry_cfg, lambda idx: None, True)

    dt = time.time() - t0
    n_success = sum(e.confidence > cfg.confidence_threshold for e in entries)
    _logger.info(
        "Registered %d frames in %.1fs (%.1f frames/s); %d above confidence %.0f",
        len(entries), dt, len(entries) / max(dt, 1e-9), n_success, cfg.confidence_threshold,
    )
    return entries
