"""Kabsch/Umeyama point-set alignment, weighted, batched over leading dims.

Counterpart of acezero_tpu/geometry/kabsch.py, which the JAX package maps
over hypotheses with `jax.vmap`; here every leading dimension is a batch.
The scale convention is the reference's (eval_poses_util.py:32-36):
`scale = mean(|c2|^2) / trace(diag(S) @ correction)`, mapping set 1 onto
set 2, and the scale is folded into the rotation block of T.
"""

from __future__ import annotations

import torch

from acezero_tpu_torch.utils.precision import f32_matmul


@f32_matmul
def kabsch_umeyama(pts1: torch.Tensor, pts2: torch.Tensor, weights: torch.Tensor | None = None,
                   estimate_scale: bool = False):
    """T (..., 4, 4) and scale (...) such that `s * R @ p1 + t ~= p2`.

    pts1, pts2: (..., n, 3); weights: optional (..., n), non-negative, 0
    masks a row out. T[..., :3, :3] = s * R, as the reference composes it.
    """
    if weights is None:
        weights = torch.ones(pts1.shape[:-1], dtype=pts1.dtype, device=pts1.device)
    wsum = torch.clamp(weights.sum(-1, keepdim=True), min=1e-9)
    w = (weights / wsum)[..., None]

    mu1 = (pts1 * w).sum(-2)
    mu2 = (pts2 * w).sum(-2)
    c1 = pts1 - mu1[..., None, :]
    c2 = pts2 - mu2[..., None, :]

    cov = (c1 * w).transpose(-1, -2) @ c2  # weighted covariance
    u, s, vt = torch.linalg.svd(cov)
    v, ut = vt.transpose(-1, -2), u.transpose(-1, -2)
    d = torch.sign(torch.linalg.det(v @ ut))
    one = torch.ones_like(d)
    corr = torch.stack([one, one, d], dim=-1)

    if estimate_scale:
        pts_var = ((c2 * c2).sum(-1) * w[..., 0]).sum(-1)
        scale = pts_var / torch.clamp((s * corr).sum(-1), min=1e-12)
    else:
        scale = one

    R = scale[..., None, None] * ((v * corr[..., None, :]) @ ut)
    t = mu2 - (R @ mu1[..., None])[..., 0]

    T = torch.eye(4, dtype=pts1.dtype, device=pts1.device).expand(*R.shape[:-2], 4, 4).clone()
    T[..., :3, :3] = R
    T[..., :3, 3] = t
    return T, scale
