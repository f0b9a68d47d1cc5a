"""Batched RANSAC pose registrar (the DSAC* replacement).

Counterpart of acezero_tpu/registration/ransac.py, with frames as a batch
dimension instead of a vmap: masked-uniform minimal sets -> Grunert P3P +
4th-point disambiguation + validation -> soft-inlier scoring -> refits on
the growing inlier set -> tight-inlier polish.

The refit loop of each frame runs until its inlier count stops growing or
the step cap is hit. Here that is one loop over the batch with finished
frames masked; it stops when no frame is still growing, at the cost of one
host sync per step.

Random draws: JAX's threefry and torch's Philox cannot agree, so the
hypothesis indices (frames, H, T, 4) can be passed in; otherwise they are
drawn masked-uniform from a `torch.Generator`.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from acezero_tpu_torch.geometry.rotations import matrix_to_rodrigues, rodrigues_to_matrix
from acezero_tpu_torch.geometry.transforms import invert_se3, make_se3
from acezero_tpu_torch.registration.lm import lm_pnp, reprojection_errors
from acezero_tpu_torch.registration.p3p import p3p_grunert
from acezero_tpu_torch.utils.precision import f32_matmul


@dataclass(frozen=True)
class RansacConfig:
    hypotheses: int = 64
    max_tries: int = 16  # sampling attempts per hypothesis
    inlier_threshold: float = 10.0  # px
    inlier_alpha: float = 100.0
    max_reproj_error: float = 100.0  # px, error clamp
    subsample: int = 8
    refinement_steps: int = 100  # refit cap
    lm_iterations: int = 3  # LM iterations per refit
    polish_lm_iterations: int = 3  # minimal-set polish after P3P
    polish_tau: float = 5.0  # tight-inlier polish band (px); 0 disables
    polish_steps: int = 6


def draw_hypothesis_indices(mask_flat: torch.Tensor, hypotheses: int, tries: int,
                            generator: torch.Generator) -> torch.Tensor:
    """(B, H, T, 4) cell indices, uniform over each frame's valid cells."""
    B, N = mask_flat.shape
    count = mask_flat.sum(dim=-1)
    u = torch.rand((B, hypotheses * tries * 4), generator=generator, device=mask_flat.device)
    k = torch.floor(u * count[:, None]).long()
    k = torch.minimum(k, torch.clamp(count - 1, min=0)[:, None])
    cum = torch.cumsum(mask_flat.long(), dim=-1)
    idx = torch.searchsorted(cum, k + 1).clamp(max=N - 1)
    return idx.reshape(B, hypotheses, tries, 4)


def _bearings(px, focal, ppx, ppy):
    f = torch.stack([(px[..., 0] - ppx) / focal, (px[..., 1] - ppy) / focal,
                     torch.ones_like(px[..., 0])], dim=-1)
    return f / torch.linalg.vector_norm(f, dim=-1, keepdim=True)


def _take(x: torch.Tensor, idx: torch.Tensor, dim: int) -> torch.Tensor:
    """x indexed along `dim` by idx (x's shape up to dim, without dim)."""
    shape = list(x.shape)
    idx = idx.reshape(idx.shape + (1,) * (x.dim() - idx.dim()))
    shape[dim] = 1
    return torch.gather(x, dim, idx.expand(shape)).squeeze(dim)


@f32_matmul
def _sample_hypotheses(idx, pts, px, focal, ppx, ppy, cfg: RansacConfig):
    """Solve the minimal sets and keep each hypothesis' first valid try.

    idx (B, H, T, 4); pts (B, N, 3); px (N, 2); focal, ppx, ppy (B,).
    Returns rvec (B, H, 3), tvec (B, H, 3), valid (B, H).
    """
    B, H, T, _ = idx.shape
    bi = torch.arange(B, device=idx.device)[:, None, None, None]
    sel_pts = pts[bi, idx]  # (B, H, T, 4, 3)
    sel_px = px[idx]  # (B, H, T, 4, 2)
    f4, cx4, cy4 = (v[:, None, None, None] for v in (focal, ppx, ppy))
    sel_bear = _bearings(sel_px, f4, cx4, cy4)

    R, t, valid_c = p3p_grunert(sel_pts[..., :3, :], sel_bear[..., :3, :])

    p4 = sel_pts[..., 3, :]
    u4 = sel_px[..., 3, :]
    p4_cam = torch.einsum("bhtcij,bhtj->bhtci", R, p4) + t
    z4 = p4_cam[..., 2]
    z4_safe = torch.where(torch.abs(z4) < 1e-9, torch.full_like(z4, 1e-9), z4)
    u4_proj = torch.stack([f4 * p4_cam[..., 0] / z4_safe + cx4,
                           f4 * p4_cam[..., 1] / z4_safe + cy4], dim=-1)
    err4 = torch.linalg.vector_norm(u4_proj - u4[..., None, :], dim=-1)
    err4 = torch.where(valid_c & (z4 > 0), err4, torch.full_like(err4, float("inf")))
    best_c = torch.argmin(err4, dim=-1)  # (B, H, T)

    R_best = _take(R, best_c, 3)
    t_best = _take(t, best_c, 3)
    err4_best = _take(err4, best_c, 3)
    rvec = matrix_to_rodrigues(R_best)  # (B, H, T, 3)

    errs_min = reprojection_errors(rvec, t_best, sel_pts, sel_px, focal[:, None, None],
                                   ppx[:, None, None], ppy[:, None, None], cfg.max_reproj_error)
    try_valid = (
        torch.all(errs_min < cfg.inlier_threshold, dim=-1)
        & torch.isfinite(err4_best)
        & torch.isfinite(rvec).all(dim=-1)
        & torch.isfinite(t_best).all(dim=-1)
    )
    first = torch.argmax(try_valid.to(torch.int32), dim=-1)  # first valid try
    hyp_valid = try_valid.any(dim=-1)
    rvec_h = _take(rvec, first, 2)
    tvec_h = _take(t_best, first, 2)
    if cfg.polish_lm_iterations > 0:
        sel_pts_h = _take(sel_pts, first, 2)
        sel_px_h = _take(sel_px, first, 2)
        w4 = torch.ones(sel_pts_h.shape[:-1], dtype=pts.dtype, device=pts.device)
        rvec_h, tvec_h, _ = lm_pnp(rvec_h, tvec_h, sel_pts_h, sel_px_h, w4, focal[:, None],
                                   ppx[:, None], ppy[:, None], iterations=cfg.polish_lm_iterations)
    return rvec_h, tvec_h, hyp_valid


@f32_matmul
def _refine(rvec, tvec, pts, px, mask_f, focal, ppx, ppy, cfg: RansacConfig, max_steps: int):
    """Refits on the current inlier set while the inlier count grows, per
    frame, up to `max_steps` refits; tracks the best pose. Returns
    (rvec, tvec, inliers, hit_cap), hit_cap marking frames the cap cut off
    while still growing."""

    def count_and_mask(rv, tv):
        errs = reprojection_errors(rv, tv, pts, px, focal, ppx, ppy, cfg.max_reproj_error)
        inl = (errs < cfg.inlier_threshold) & (mask_f > 0)
        return inl.to(pts.dtype), inl.sum(dim=-1, dtype=torch.int32)

    B = rvec.shape[0]
    best_count = torch.full((B,), 4, dtype=torch.int32, device=rvec.device)
    best_rvec, best_tvec = rvec, tvec
    growing = torch.ones(B, dtype=torch.bool, device=rvec.device)
    steps = torch.zeros(B, dtype=torch.int32, device=rvec.device)
    while True:
        active = growing & (steps < max_steps)
        if not bool(active.any()):
            break
        w, count = count_and_mask(rvec, tvec)
        improved = count > best_count
        upd = active & improved
        best_count = torch.where(upd, count, best_count)
        best_rvec = torch.where(upd[:, None], rvec, best_rvec)
        best_tvec = torch.where(upd[:, None], tvec, best_tvec)
        new_rvec, new_tvec, _ = lm_pnp(rvec, tvec, pts, px, w, focal, ppx, ppy,
                                       iterations=cfg.lm_iterations)
        rvec = torch.where(active[:, None], new_rvec, rvec)
        tvec = torch.where(active[:, None], new_tvec, tvec)
        growing = torch.where(active, improved, growing)
        steps = steps + active.to(torch.int32)
    _, count = count_and_mask(rvec, tvec)
    improved = count > best_count
    best_count = torch.where(improved, count, best_count)
    best_rvec = torch.where(improved[:, None], rvec, best_rvec)
    best_tvec = torch.where(improved[:, None], tvec, best_tvec)
    hit_cap = growing & (steps >= max_steps)
    return best_rvec, best_tvec, best_count, hit_cap


@f32_matmul
def _tight_polish(rvec, tvec, inliers, pts, px, mask_f, focal, ppx, ppy, cfg: RansacConfig):
    """Fixed-step refits on the cells within polish_tau px (half of the steps
    at polish_tau, the rest at polish_tau / 2), rolled back per frame if the
    tau=10 inlier count drops by more than 2."""
    half = (cfg.polish_steps + 1) // 2
    rv, tv = rvec, tvec
    for step in range(cfg.polish_steps):
        tau = cfg.polish_tau if step < half else cfg.polish_tau / 2.0
        errs_p = reprojection_errors(rv, tv, pts, px, focal, ppx, ppy, cfg.max_reproj_error)
        w_p = ((errs_p < tau) & (mask_f > 0)).to(pts.dtype)
        enough = w_p.sum(dim=-1) >= 16
        rv2, tv2, _ = lm_pnp(rv, tv, pts, px, w_p, focal, ppx, ppy, iterations=cfg.lm_iterations)
        keep = enough & torch.isfinite(rv2).all(dim=-1) & torch.isfinite(tv2).all(dim=-1)
        rv = torch.where(keep[:, None], rv2, rv)
        tv = torch.where(keep[:, None], tv2, tv)
    errs10 = reprojection_errors(rv, tv, pts, px, focal, ppx, ppy, cfg.max_reproj_error)
    n10 = ((errs10 < cfg.inlier_threshold) & (mask_f > 0)).sum(dim=-1, dtype=torch.int32)
    accept = n10 + 2 >= inliers
    return (torch.where(accept[:, None], rv, rvec), torch.where(accept[:, None], tv, tvec),
            torch.where(accept, n10, inliers))


@f32_matmul
def estimate_poses_batch(
    scene_coords: torch.Tensor,
    valid_masks: torch.Tensor,
    pixel_grid: torch.Tensor,
    focals: torch.Tensor,
    ppxs: torch.Tensor,
    ppys: torch.Tensor,
    cfg: RansacConfig = RansacConfig(),
    max_refine_steps: int | None = None,
    hyp_indices: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
) -> dict:
    """Register a batch of frames.

    scene_coords (B, h, w, 3); valid_masks (B, h, w) bool; pixel_grid
    (h, w, 2); focals, ppxs, ppys (B,). hyp_indices (B, H, T, 4) into the
    flattened cells, or None to draw them from `generator`. Returns a dict
    of pose_c2w (B, 4, 4), inlier_count (B,) int32 (the confidence), score
    (B,), valid (B,) and hit_cap (B,).
    """
    B, h, w, _ = scene_coords.shape
    device = scene_coords.device
    pts = scene_coords.reshape(B, h * w, 3).float()
    px = pixel_grid.reshape(h * w, 2).float()
    mask = valid_masks.reshape(B, h * w).bool()
    mask_f = mask.float()
    focals, ppxs, ppys = (torch.as_tensor(v, dtype=torch.float32, device=device).expand(B)
                          for v in (focals, ppxs, ppys))
    steps = cfg.refinement_steps if max_refine_steps is None else int(max_refine_steps)

    if hyp_indices is None:
        if generator is None:
            raise ValueError("pass hyp_indices or a torch.Generator for the hypothesis draws")
        hyp_indices = draw_hypothesis_indices(mask, cfg.hypotheses, cfg.max_tries, generator)
    idx = hyp_indices.to(device=device, dtype=torch.long)
    if tuple(idx.shape) != (B, cfg.hypotheses, cfg.max_tries, 4):
        raise ValueError(f"hyp_indices {tuple(idx.shape)} != {(B, cfg.hypotheses, cfg.max_tries, 4)}")

    rvec_h, tvec_h, hyp_valid = _sample_hypotheses(idx, pts, px, focals, ppxs, ppys, cfg)

    errs = reprojection_errors(rvec_h, tvec_h, pts[:, None], px, focals[:, None], ppxs[:, None],
                               ppys[:, None], cfg.max_reproj_error)  # (B, H, N)
    beta = 5.0 / cfg.inlier_threshold
    soft = torch.sigmoid(-beta * (errs - cfg.inlier_threshold))
    n_valid = torch.clamp(mask_f.sum(dim=-1), min=1.0)
    scores = cfg.inlier_alpha * torch.sum(soft * mask_f[:, None], dim=-1) / n_valid[:, None]
    scores = torch.where(hyp_valid, scores, torch.full_like(scores, float("-inf")))
    best_h = torch.argmax(scores, dim=-1)
    any_valid = hyp_valid.any(dim=-1)

    rvec, tvec, inliers, hit_cap = _refine(
        _take(rvec_h, best_h, 1), _take(tvec_h, best_h, 1), pts, px, mask_f, focals, ppxs, ppys,
        cfg, steps,
    )
    if cfg.polish_steps > 0 and cfg.polish_tau > 0:
        rvec, tvec, inliers = _tight_polish(rvec, tvec, inliers, pts, px, mask_f, focals, ppxs,
                                            ppys, cfg)

    pose_c2w = invert_se3(make_se3(rodrigues_to_matrix(rvec), tvec))
    eye = torch.eye(4, dtype=pose_c2w.dtype, device=device).expand_as(pose_c2w)
    return {
        "pose_c2w": torch.where(any_valid[:, None, None], pose_c2w, eye),
        "inlier_count": torch.where(any_valid, inliers, torch.zeros_like(inliers)),
        "score": _take(scores, best_h, 1),
        "valid": any_valid,
        "hit_cap": hit_cap & any_valid,
    }


def estimate_pose(scene_coords, valid_mask, pixel_grid, focal, ppx, ppy, cfg: RansacConfig = RansacConfig(),
                  max_refine_steps: int | None = None, hyp_indices=None, generator=None) -> dict:
    """One frame: scene_coords (h, w, 3), valid_mask (h, w), hyp_indices
    (H, T, 4) or None. Returns the dict of `estimate_poses_batch` without
    the batch axis."""
    f, cx, cy = (torch.as_tensor(v, dtype=torch.float32, device=scene_coords.device).reshape(1)
                 for v in (focal, ppx, ppy))
    out = estimate_poses_batch(
        scene_coords[None], valid_mask[None], pixel_grid, f, cx, cy, cfg, max_refine_steps,
        None if hyp_indices is None else hyp_indices[None], generator,
    )
    return {k: v[0] for k, v in out.items()}
