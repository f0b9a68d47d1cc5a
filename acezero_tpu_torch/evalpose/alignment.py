"""Robust similarity alignment between estimated and ground-truth pose sets.

Counterpart of acezero_tpu/evalpose/alignment.py (the reference's RANSAC
alignment, eval_poses_util.py:71-181): 3-point Kabsch hypotheses solved as
one batch, inlier counting in hypothesis chunks, and the top-K refinement
with the weighted Kabsch and the accept-if-better rule. The minimal samples
come from `np.random.default_rng(seed)` as in the JAX package, so both
packages draw the same hypotheses. Scoring runs on the host: the Kabsch
solves in float32 torch, the rest in float64 numpy, as in the JAX package.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from acezero_tpu_torch.geometry.kabsch import kabsch_umeyama

_logger = logging.getLogger(__name__)


def _inlier_mask(T, scale, gt_t, gt_R, est_t, est_R, thresh_t, thresh_r):
    """(..., n) inliers of hypotheses T (..., 4, 4) with scales (...)."""
    t_new = np.einsum("...ab,nb->...na", T[..., :3, :3], gt_t) + T[..., None, :3, 3]
    dt = np.linalg.norm(t_new - est_t, axis=-1)
    R_pure = T[..., :3, :3] / np.maximum(scale, 1e-12)[..., None, None]
    rel = np.einsum("...ab,nbc->...nac", R_pure, gt_R)
    tr = np.einsum("...nab,nab->...n", rel, est_R)
    ang = np.arccos(np.clip((tr - 1) / 2, -1, 1))
    return (dt < thresh_t) & (ang < np.deg2rad(thresh_r))


def estimate_alignment(
    poses_est_c2w: np.ndarray,
    poses_gt_c2w: np.ndarray,
    confidences: np.ndarray,
    confidence_threshold: float = 500.0,
    min_confident: int = 10,
    inlier_threshold_t: float = 0.05,
    inlier_threshold_r: float = 5.0,
    ransac_iterations: int = 10000,
    refinement_max_hyp: int = 12,
    refinement_max_it: int = 8,
    estimate_scale: bool = True,
    seed: int = 0,
):
    """Estimate T aligning GT poses onto estimated poses.

    Returns (T (4, 4) with the scale folded into the rotation block, scale),
    or (None, 1.0) when alignment fails; callers then report infinite errors.
    """
    finite = np.isfinite(poses_gt_c2w).all(axis=(1, 2))
    confident = finite & (confidences > confidence_threshold)
    n_conf = int(confident.sum())
    if n_conf < min_confident:
        _logger.info("Too few confident estimates (%d) for alignment.", n_conf)
        return None, 1.0

    gt = poses_gt_c2w[confident].astype(np.float64)
    est = poses_est_c2w[confident].astype(np.float64)

    rng = np.random.default_rng(seed)
    samples = np.stack([rng.choice(n_conf, 3, replace=False) for _ in range(ransac_iterations)])

    def f32(a):
        return torch.from_numpy(np.asarray(a, np.float32))

    T_all, s_all = kabsch_umeyama(f32(gt[samples][:, :, :3, 3]), f32(est[samples][:, :, :3, 3]),
                                  estimate_scale=estimate_scale)
    T_all = T_all.numpy().astype(np.float64)
    s_all = s_all.numpy().astype(np.float64)

    gt_t, est_t = gt[:, :3, 3], est[:, :3, 3]
    gt_R, est_R = gt[:, :3, :3], est[:, :3, :3]

    def inliers_of(T, scale):
        return _inlier_mask(T, scale, gt_t, gt_R, est_t, est_R, inlier_threshold_t, inlier_threshold_r)

    scores = np.zeros(ransac_iterations, np.int64)
    minimal_ok = np.zeros(ransac_iterations, bool)
    chunk = 512
    for h0 in range(0, ransac_iterations, chunk):
        inl = inliers_of(T_all[h0: h0 + chunk], s_all[h0: h0 + chunk])
        scores[h0: h0 + chunk] = inl.sum(axis=1)
        minimal_ok[h0: h0 + chunk] = np.take_along_axis(inl, samples[h0: h0 + chunk], axis=1).sum(axis=1) >= 3

    valid_hyp = minimal_ok & (scores > 0)
    if not valid_hyp.any():
        _logger.info("No valid RANSAC alignment hypothesis.")
        return None, 1.0

    order = np.argsort(-np.where(valid_hyp, scores, -1))[:refinement_max_hyp]
    best_T, best_scale, best_score = None, 1.0, -1
    for h in order:
        T, scale, score = T_all[h], s_all[h], scores[h]
        inl = inliers_of(T, scale)
        for _ in range(refinement_max_it):
            T_new, s_new = kabsch_umeyama(f32(gt_t), f32(est_t), weights=f32(inl),
                                          estimate_scale=estimate_scale)
            T_new = T_new.numpy().astype(np.float64)
            s_new = float(s_new)
            inl_new = inliers_of(T_new, s_new)
            if inl_new.sum() > score:
                T, scale, score, inl = T_new, s_new, inl_new.sum(), inl_new
            else:
                break
        if score > best_score:
            best_T, best_scale, best_score = T, float(scale), score

    _logger.info("Alignment: best hypothesis has %d/%d inliers, scale %.4f", best_score, n_conf, best_scale)
    return best_T, best_scale
