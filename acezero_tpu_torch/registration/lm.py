"""Weighted Levenberg-Marquardt PnP, batched over leading dimensions.

Counterpart of acezero_tpu/registration/lm.py. Pose: world-to-camera
(Rodrigues rvec, translation t), p_cam = R(rvec) p_world + t. Inlier
selection is a weight vector, so a refit is a fixed-shape computation that
batches over frames and hypotheses.
"""

from __future__ import annotations

import torch

from acezero_tpu_torch.geometry.rotations import matrix_to_rodrigues, rodrigues_to_matrix
from acezero_tpu_torch.utils.precision import f32_matmul

_EPS = 1e-12


def _per_point(v, like: torch.Tensor) -> torch.Tensor:
    """A scalar or a per-batch intrinsic, shaped to broadcast over points."""
    v = torch.as_tensor(v, dtype=like.dtype, device=like.device)
    return v[..., None] if v.dim() else v


def _project(rvec, tvec, world_pts, focal, ppx, ppy):
    R = rodrigues_to_matrix(rvec)
    p_cam = world_pts @ R.transpose(-1, -2) + tvec[..., None, :]
    z = p_cam[..., 2]
    z_safe = torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
    f = _per_point(focal, z)
    return p_cam, z, z_safe, f, _per_point(ppx, z), _per_point(ppy, z)


@f32_matmul
def reprojection_errors(rvec, tvec, world_pts, target_px, focal, ppx, ppy, max_error: float = 100.0):
    """Euclidean reprojection error per point, clamped at `max_error`;
    points behind the camera get `max_error`.

    rvec, tvec (..., 3); world_pts (..., n, 3); target_px (..., n, 2);
    focal, ppx, ppy scalars or (...). Returns (..., n).
    """
    p_cam, z, z_safe, f, cx, cy = _project(rvec, tvec, world_pts, focal, ppx, ppy)
    u = f * p_cam[..., 0] / z_safe + cx
    v = f * p_cam[..., 1] / z_safe + cy
    err = torch.sqrt((u - target_px[..., 0]) ** 2 + (v - target_px[..., 1]) ** 2 + _EPS)
    err = torch.where(z > 1e-9, err, torch.full_like(err, max_error))
    return torch.clamp(err, max=max_error)


@f32_matmul
def _residuals_and_jacobian(rvec, tvec, world_pts, target_px, focal, ppx, ppy):
    """Residuals (..., n, 2) and their Jacobian (..., n, 2, 6) wrt a left
    rotation perturbation and the translation."""
    p_cam, z, z_safe, f, cx, cy = _project(rvec, tvec, world_pts, focal, ppx, ppy)
    x, y = p_cam[..., 0], p_cam[..., 1]
    inv_z = 1.0 / z_safe
    u = f * x * inv_z + cx
    v = f * y * inv_z + cy
    res = torch.stack([u - target_px[..., 0], v - target_px[..., 1]], dim=-1)

    zero = torch.zeros_like(x)
    du = torch.stack([f * inv_z, zero, -f * x * inv_z * inv_z], dim=-1)
    dv = torch.stack([zero, f * inv_z, -f * y * inv_z * inv_z], dim=-1)
    d_px_d_pcam = torch.stack([du, dv], dim=-2)

    pc = p_cam - tvec[..., None, :]
    px_, py_, pz_ = pc[..., 0], pc[..., 1], pc[..., 2]
    neg_skew = torch.stack(
        [
            torch.stack([zero, pz_, -py_], dim=-1),
            torch.stack([-pz_, zero, px_], dim=-1),
            torch.stack([py_, -px_, zero], dim=-1),
        ],
        dim=-2,
    )
    J_r = d_px_d_pcam @ neg_skew
    return res, torch.cat([J_r, d_px_d_pcam], dim=-1)


@f32_matmul
def lm_pnp(rvec0, tvec0, world_pts, target_px, weights, focal, ppx, ppy, iterations: int = 10):
    """Damped Gauss-Newton PnP over a weighted point set.

    rvec0, tvec0 (..., 3); world_pts (..., n, 3); target_px (..., n, 2);
    weights (..., n) >= 0; focal, ppx, ppy scalars or (...). Returns
    (rvec, tvec, cost) of the best evaluated pose. One residual/Jacobian
    evaluation per iteration: the cost of the current pose decides whether
    the previous step is kept or rolled back.
    """
    wsum = torch.clamp(weights.sum(dim=-1), min=1e-9)
    batch = rvec0.shape[:-1]
    rvec, tvec = rvec0, tvec0
    lam = torch.full(batch, 1e-3, dtype=rvec0.dtype, device=rvec0.device)
    best_cost = torch.full(batch, float("inf"), dtype=rvec0.dtype, device=rvec0.device)
    best_rvec, best_tvec = rvec0, tvec0
    best_JtJ = torch.eye(6, dtype=rvec0.dtype, device=rvec0.device).expand(batch + (6, 6))
    best_Jtr = torch.zeros(batch + (6,), dtype=rvec0.dtype, device=rvec0.device)
    for _ in range(iterations + 1):
        res, J = _residuals_and_jacobian(rvec, tvec, world_pts, target_px, focal, ppx, ppy)
        cost = torch.sum(weights * torch.sum(res * res, dim=-1), dim=-1) / wsum
        Jw = J * weights[..., None, None]
        JtJ = torch.einsum("...nri,...nrj->...ij", Jw, J)
        Jtr = torch.einsum("...nri,...nr->...i", Jw, res)

        improved = cost < best_cost
        imp1 = improved[..., None]
        best_cost = torch.where(improved, cost, best_cost)
        best_rvec = torch.where(imp1, rvec, best_rvec)
        best_tvec = torch.where(imp1, tvec, best_tvec)
        best_JtJ = torch.where(imp1[..., None], JtJ, best_JtJ)
        best_Jtr = torch.where(imp1, Jtr, best_Jtr)
        lam = torch.clamp(torch.where(improved, lam * 0.33, lam * 10.0), 1e-8, 1e6)

        damp = torch.clamp(torch.diagonal(best_JtJ, dim1=-2, dim2=-1), min=1e-6)
        A = best_JtJ + lam[..., None, None] * torch.diag_embed(damp)
        dx = -torch.linalg.solve_ex(A, best_Jtr)[0]

        dR = rodrigues_to_matrix(dx[..., :3])
        rvec = matrix_to_rodrigues(dR @ rodrigues_to_matrix(best_rvec))
        tvec = best_tvec + dx[..., 3:]
    return best_rvec, best_tvec, best_cost
