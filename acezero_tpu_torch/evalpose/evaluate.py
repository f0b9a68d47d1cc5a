"""Pose-accuracy metrics: % within 5 cm / 5° after a similarity alignment.

Counterpart of acezero_tpu/evalpose/evaluate.py (the reference's
eval_poses.py:110-191): align GT onto the estimates (confidence-filtered
RANSAC Kabsch), then per-frame translation and rotation errors, accuracy at
the thresholds, and the reference's medians (`sorted()[n // 2]`). Estimates
and GT poses correspond by the alphabetical order of the file names.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from acezero_tpu_torch.evalpose.alignment import estimate_alignment
from acezero_tpu_torch.io.pose_files import PoseFileEntry


@dataclass
class PoseErrors:
    accuracy: float  # percentage within thresholds
    median_rot_deg: float
    median_trans_cm: float
    rot_errors_deg: np.ndarray
    trans_errors_cm: np.ndarray
    aligned: bool


def evaluate_poses(
    entries: list[PoseFileEntry],
    gt_poses_c2w: list[np.ndarray],
    do_alignment: bool = True,
    estimate_scale: bool = True,
    alignment_conf_threshold: float = 500.0,
    thresh_t: float = 0.05,
    thresh_r: float = 5.0,
) -> PoseErrors:
    """Accuracy metrics of pose-file entries against GT cam-to-world poses.

    `entries` are sorted by file name here and must correspond 1:1 with the
    alphabetically sorted GT poses.
    """
    entries = sorted(entries, key=lambda e: e.rgb_file)
    if len(entries) != len(gt_poses_c2w):
        raise ValueError(f"{len(entries)} estimates vs {len(gt_poses_c2w)} GT poses")

    est_c2w = np.stack([e.pose_c2w for e in entries])
    gt_c2w = np.stack(gt_poses_c2w).astype(np.float64)
    conf = np.asarray([e.confidence for e in entries])

    if do_alignment:
        T, scale = estimate_alignment(est_c2w, gt_c2w, conf, confidence_threshold=alignment_conf_threshold,
                                      inlier_threshold_t=thresh_t, inlier_threshold_r=thresh_r,
                                      estimate_scale=estimate_scale)
    else:
        T, scale = np.eye(4), 1.0

    n = len(entries)
    if T is None:
        inf = np.full(n, np.inf)
        return PoseErrors(0.0, math.inf, math.inf, inf, inf.copy(), aligned=False)

    gt_aligned = np.einsum("ab,nbc->nac", T, gt_c2w)
    t_err = np.linalg.norm(gt_aligned[:, :3, 3] - est_c2w[:, :3, 3], axis=1) / max(scale, 1e-12)

    R_pure = T[:3, :3] / np.cbrt(max(np.linalg.det(T[:3, :3]), 1e-300))
    rel = np.einsum("nab,ncb->nac", est_c2w[:, :3, :3], np.einsum("ab,nbc->nac", R_pure, gt_c2w[:, :3, :3]))
    tr = np.trace(rel, axis1=1, axis2=2)
    r_err = np.degrees(np.arccos(np.clip((tr - 1) / 2, -1, 1)))

    acc = float(np.mean((r_err < thresh_r) & (t_err < thresh_t)) * 100.0)
    mid = n // 2  # the reference's median: sorted()[n // 2]
    return PoseErrors(
        accuracy=acc,
        median_rot_deg=float(np.sort(r_err)[mid]),
        median_trans_cm=float(np.sort(t_err * 100.0)[mid]),
        rot_errors_deg=r_err,
        trans_errors_cm=t_err * 100.0,
        aligned=True,
    )
