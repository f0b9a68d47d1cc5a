"""Rotation representations and conversions, batched over leading dims.

Counterpart of acezero_tpu/geometry/rotations.py, with the same conventions:
quaternions (w, x, y, z), rotation matrices applied as `R @ v`, Rodrigues
vectors axis * angle in radians.
"""

from __future__ import annotations

import torch

from acezero_tpu_torch.utils.precision import f32_matmul

_EPS = 1e-12


def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(v, dim=-1, keepdim=True)


def quat_wxyz_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Quaternions (..., 4) in (w, x, y, z) order to matrices (..., 3, 3)."""
    q = q / torch.clamp(_norm(q), min=_EPS)
    w, x, y, z = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    m = torch.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(q.shape[:-1] + (3, 3))


def matrix_to_quat_wxyz(m: torch.Tensor) -> torch.Tensor:
    """Matrices (..., 3, 3) to quaternions (..., 4), largest-pivot branch,
    sign canonicalised to w >= 0."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22
    qw2 = 1.0 + tr
    qx2 = 1.0 + m00 - m11 - m22
    qy2 = 1.0 - m00 + m11 - m22
    qz2 = 1.0 - m00 - m11 + m22
    cand_w = torch.stack([qw2, m21 - m12, m02 - m20, m10 - m01], dim=-1)
    cand_x = torch.stack([m21 - m12, qx2, m01 + m10, m02 + m20], dim=-1)
    cand_y = torch.stack([m02 - m20, m01 + m10, qy2, m12 + m21], dim=-1)
    cand_z = torch.stack([m10 - m01, m02 + m20, m12 + m21, qz2], dim=-1)
    pivots = torch.stack([qw2, qx2, qy2, qz2], dim=-1)
    best = torch.argmax(pivots, dim=-1)
    cands = torch.stack([cand_w, cand_x, cand_y, cand_z], dim=-2)
    idx = best[..., None, None].expand(best.shape + (1, 4))
    q = torch.gather(cands, -2, idx)[..., 0, :]
    q = q / torch.clamp(_norm(q), min=_EPS)
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


@f32_matmul
def rodrigues_to_matrix(rvec: torch.Tensor) -> torch.Tensor:
    """Axis-angle (..., 3) to rotation matrices (..., 3, 3), Taylor-safe at 0."""
    theta2 = torch.sum(rvec * rvec, dim=-1)
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS))
    small = theta2 < 1e-8
    sin_t = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    cos_t = torch.where(
        small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / torch.clamp(theta2, min=_EPS)
    )
    kx, ky, kz = rvec.unbind(-1)
    zero = torch.zeros_like(kx)
    K = torch.stack([zero, -kz, ky, kz, zero, -kx, -ky, kx, zero], dim=-1).reshape(
        rvec.shape[:-1] + (3, 3)
    )
    K2 = K @ K
    eye = torch.eye(3, dtype=rvec.dtype, device=rvec.device)
    return eye + sin_t[..., None, None] * K + cos_t[..., None, None] * K2


def matrix_to_rodrigues(m: torch.Tensor) -> torch.Tensor:
    """Rotation matrices (..., 3, 3) to axis-angle vectors (..., 3)."""
    q = matrix_to_quat_wxyz(m)
    w = torch.clamp(q[..., 0], -1.0, 1.0)
    v = q[..., 1:]
    vnorm = torch.linalg.vector_norm(v, dim=-1)
    angle = 2.0 * torch.atan2(vnorm, w)
    scale = torch.where(vnorm < 1e-9, 2.0, angle / torch.clamp(vnorm, min=_EPS))
    return v * scale[..., None]


def rotation_angle(m: torch.Tensor) -> torch.Tensor:
    """Rotation angle in radians of matrices (..., 3, 3)."""
    tr = m[..., 0, 0] + m[..., 1, 1] + m[..., 2, 2]
    return torch.arccos(torch.clamp((tr - 1.0) / 2.0, -1.0, 1.0))


@f32_matmul
def special_gramschmidt(m: torch.Tensor) -> torch.Tensor:
    """Project (..., 3, 3) onto SO(3) by Gram-Schmidt of the first two columns."""
    c0 = m[..., :, 0]
    c1 = m[..., :, 1]
    e0 = c0 / torch.clamp(_norm(c0), min=_EPS)
    c1p = c1 - torch.sum(e0 * c1, dim=-1, keepdim=True) * e0
    e1 = c1p / torch.clamp(_norm(c1p), min=_EPS)
    e2 = torch.linalg.cross(e0, e1)
    return torch.stack([e0, e1, e2], dim=-1)


@f32_matmul
def special_procrustes(m: torch.Tensor) -> torch.Tensor:
    """Nearest rotation matrix in Frobenius norm, via an SVD."""
    u, _, vt = torch.linalg.svd(m, full_matrices=False)
    det = torch.linalg.det(u @ vt)
    d = torch.cat([torch.ones(m.shape[:-2] + (2,), dtype=m.dtype, device=m.device), det[..., None]], dim=-1)
    return (u * d[..., None, :]) @ vt
