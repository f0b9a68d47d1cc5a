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

`register_frames_multi` scores several heads (the seed stage's candidate
maps) with one encoder pass per chunk and one registrar solve per head, at
the full refit budget, without the tiers and the retry, as in the JAX
package.

With a mesh both shard the frame axis, as in the JAX package: the chunk is
rounded up to a multiple of the mesh size and split by position over the
devices (`parallel.mesh.split_positions`); each device runs the encoder,
the head (K1) and the registrar on its frames against replicas of the
parameters. A chunk's hypothesis indices are drawn once on the primary
from the whole chunk's cell mask, in frame order, so the generator's stream
is the one device's; each device then takes its frames' draws. The tier-2
rerun and the sampling-failure retry split their chunks the same way. A
chunk whose rounded length differs from one device's (64 frames on 3
devices: 66) draws differently.
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
from acezero_tpu_torch.parallel.mesh import Mesh, split_positions
from acezero_tpu_torch.registration.ransac import (
    RansacConfig,
    draw_hypothesis_indices,
    estimate_poses_batch,
)
from acezero_tpu_torch.training.optim import tree_leaves, tree_unflatten

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


@torch.inference_mode()
def coords_chunk_multi(encoder_params, head_params_list, head_cfg: HeadConfig, images_u8, sizes,
                       subsample: int = 8):
    """Scene coordinates (S, B, h, w, 3) of one chunk under S heads sharing
    one encoder pass, and the cell mask (B, h, w)."""
    images, mask_lr, _, _, _ = _canvas_prologue(images_u8, sizes, subsample)
    feats = encoder_apply(encoder_params, images)
    return torch.stack([head_apply_image(hp, head_cfg, feats) for hp in head_params_list]), mask_lr


def _frame_order(n: int, cfg: RegistrationConfig) -> np.ndarray:
    order = np.random.default_rng(cfg.base_seed).permutation(n)
    return order[: cfg.max_estimates] if cfg.max_estimates > 0 else order


def _chunk_images(scene: SceneData, idx, device):
    images = torch.from_numpy(np.ascontiguousarray(scene.images.content(idx))).to(device)
    sizes = torch.from_numpy(scene.images.sizes[idx].astype(np.int64)).to(device)
    return images, sizes


def _lanes(encoder_params, heads, device, mesh: Mesh | None) -> list:
    """(device, encoder parameters, heads) of each device that registers
    frames: one lane on `device` without a mesh, one per mesh device with
    one. Registration only reads the parameters, so a lane on the primary
    uses them as they are (`.to` of a tensor already there returns it) and
    only other devices get a copy."""
    if mesh is None:
        return [(device, encoder_params, heads)]

    def on(tree, dev):
        return tree_unflatten(tree, [t.to(dev) if torch.is_tensor(t) else t for t in tree_leaves(tree)])

    return [(dev, on(encoder_params, dev), on(heads, dev)) for dev in mesh.devices]


def _spans(n: int, mesh: Mesh | None) -> list[tuple[int, int]]:
    """[lo, hi) of each lane's frames of an n-frame chunk (empty spans kept:
    they line up with the lanes)."""
    return [(0, n)] if mesh is None else split_positions(n, mesh)


def _draw(coords: list, spans: list, device, cfg: RansacConfig, generator) -> torch.Tensor:
    """One draw of the chunk's hypothesis indices on `device` from the lanes'
    cell masks (`coords[d][1]`, None for a lane without frames) put back in
    frame order: the one-device draw."""
    mask = torch.cat([c[1].reshape(hi - lo, -1).to(device) for c, (lo, hi) in zip(coords, spans) if c is not None])
    return draw_hypothesis_indices(mask, cfg.hypotheses, cfg.max_tries, generator)


def _frame_chunk(cfg: RegistrationConfig, mesh: Mesh | None) -> int:
    """The chunk length: rounded up to a multiple of the mesh size."""
    return cfg.frame_chunk if mesh is None else -(-cfg.frame_chunk // mesh.size) * mesh.size


def _entry(rgb_file: str, pose_c2w: np.ndarray, focal_orig: float, conf) -> PoseFileEntry:
    return PoseFileEntry(rgb_file=rgb_file, pose_w2c=np.linalg.inv(pose_c2w.astype(np.float64)),
                         focal_length=float(focal_orig), confidence=float(conf))


def register_frames_multi(
    encoder_params,
    head_params_list: list,
    head_cfg: HeadConfig,
    scene: SceneData,
    cfg: RegistrationConfig,
    device=None,
    hyp_indices: torch.Tensor | None = None,
    mesh: Mesh | None = None,
) -> list[list[PoseFileEntry]]:
    """Register the scene's frames against several heads; one entry list per
    head, in the same frame order.

    Each chunk runs the encoder once and every head's chain (through K1 on
    the card), then one registrar solve per head at the full refit budget.
    hyp_indices (S, frames, H, T, 4), indexed by head and scene frame,
    replaces the generator's draws. With a mesh (whose primary replaces
    `device`) each chunk's frames are split over its devices.
    """
    device = mesh.primary if mesh is not None else resolve_device(device)
    S = len(head_params_list)
    order = _frame_order(len(scene), cfg)
    generator = torch.Generator(device=device).manual_seed(cfg.base_seed + 0x9E37)
    H, W = scene.images.canvas_hw
    lanes = _lanes(encoder_params, head_params_list, device, mesh)
    grids = [get_pixel_grid(H // 8, W // 8, 8, device=dev) for dev, _, _ in lanes]
    chunk = _frame_chunk(cfg, mesh)
    results: list[list[PoseFileEntry]] = [[] for _ in range(S)]
    t0 = time.time()
    for c0 in range(0, len(order), chunk):
        idx = order[c0 : c0 + chunk]
        spans = _spans(len(idx), mesh)
        # every lane's encoder and heads before any registrar, which syncs
        coords = [coords_chunk_multi(enc, heads, head_cfg, *_chunk_images(scene, idx[lo:hi], dev))
                  if hi > lo else None for (dev, enc, heads), (lo, hi) in zip(lanes, spans)]
        for s in range(S):
            if hyp_indices is None:
                draws = _draw(coords, spans, device, cfg.ransac, generator)
            else:
                draws = hyp_indices[s][torch.as_tensor(idx)].to(device)
            outs = []
            for (dev, _, _), grid, (lo, hi), c in zip(lanes, grids, spans, coords):
                if hi == lo:
                    continue
                focals = torch.as_tensor(scene.focals_canvas[idx[lo:hi]], dtype=torch.float32, device=dev)
                out = estimate_poses_batch(
                    c[0][s], c[1], grid, focals, torch.full((hi - lo,), W / 2.0, device=dev),
                    torch.full((hi - lo,), H / 2.0, device=dev), cfg.ransac, cfg.ransac.refinement_steps,
                    hyp_indices=draws[lo:hi].to(dev))
                outs.append((out["pose_c2w"].cpu().numpy(), out["inlier_count"].cpu().numpy()))
            poses, confs = (np.concatenate(x) for x in zip(*outs))
            for j, i in enumerate(idx):
                results[s].append(_entry(scene.rgb_files[i], poses[j], scene.focals_orig[i], confs[j]))
    _logger.info("Registered %d frames x %d maps in %.1fs", len(order), S, time.time() - t0)
    return results


def register_frames(
    encoder_params,
    head_params,
    head_cfg: HeadConfig,
    scene: SceneData,
    cfg: RegistrationConfig,
    focal_override_orig: float | None = None,
    device=None,
    hyp_indices: torch.Tensor | None = None,
    mesh: Mesh | None = None,
) -> list[PoseFileEntry]:
    """Register every frame of the scene; returns pose-file entries.

    focal_override_orig: an original-pixel focal length that replaces the
    scene's per-frame focals (the pipeline passes its refined estimate).
    Parameters must already be on `device` (default cuda). hyp_indices
    (frames, H, T, 4), indexed by scene frame, replaces the generator's
    draws of pass 1 (and so of the tier-2 rerun); the sampling-failure retry
    always draws from the generator, seeded from `cfg.base_seed`. With a
    mesh (whose primary replaces `device`) each chunk's frames are split
    over its devices; the draws stay those of one device.
    """
    device = mesh.primary if mesh is not None else resolve_device(device)
    n = len(scene)
    order = _frame_order(n, cfg)
    if focal_override_orig is not None:
        focals_canvas = focal_override_orig * scene.images.scale_factors
        focals_orig = np.full(n, focal_override_orig, np.float32)
    else:
        focals_canvas, focals_orig = scene.focals_canvas, scene.focals_orig
    generator = torch.Generator(device=device).manual_seed(cfg.base_seed + 0x9E37)

    full_steps = cfg.ransac.refinement_steps
    tiered = 0 < cfg.refit_tier1 < full_steps
    pass1_steps = cfg.refit_tier1 if tiered else full_steps
    H, W = scene.images.canvas_hw
    lanes = _lanes(encoder_params, head_params, device, mesh)
    grids = [get_pixel_grid(H // 8, W // 8, 8, device=dev) for dev, _, _ in lanes]
    chunk = _frame_chunk(cfg, mesh)

    def run(idx, ransac_cfg, max_steps, draws):
        """(outputs as numpy in frame order, the chunk's draws on `device`)."""
        spans = _spans(len(idx), mesh)
        # every lane's encoder and head before any registrar, which syncs
        coords = [coords_chunk(enc, head, head_cfg, *_chunk_images(scene, idx[lo:hi], dev)) if hi > lo else None
                  for (dev, enc, head), (lo, hi) in zip(lanes, spans)]
        if draws is None:
            draws = _draw(coords, spans, device, ransac_cfg, generator)
        outs = []
        for (dev, _, _), grid, (lo, hi), c in zip(lanes, grids, spans, coords):
            if hi == lo:
                continue
            out = estimate_poses_batch(
                c[0], c[1], grid,
                torch.as_tensor(focals_canvas[idx[lo:hi]], dtype=torch.float32, device=dev),
                torch.full((hi - lo,), W / 2.0, device=dev),
                torch.full((hi - lo,), H / 2.0, device=dev),
                ransac_cfg, max_steps, hyp_indices=draws[lo:hi].to(dev),
            )
            outs.append({k: v.cpu().numpy() for k, v in out.items()})
        return {k: np.concatenate([o[k] for o in outs]) for k in outs[0]}, draws

    def entry(i, pose_c2w, conf):
        return _entry(scene.rgb_files[i], pose_c2w, focals_orig[i], conf)

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
