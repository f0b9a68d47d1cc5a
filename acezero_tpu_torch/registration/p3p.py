"""Batched minimal perspective-three-point solver.

Counterpart of acezero_tpu/registration/p3p.py: Grunert's reduction to a
quartic, a closed-form Ferrari solve with Newton polishing, Newton polish of
the three distances on the law-of-cosines system, and the rigid pose from
aligning the two triangle frames. Fixed-size candidate arrays with validity
masks, batched over any leading dimensions.
"""

from __future__ import annotations

import torch

from acezero_tpu_torch.utils.precision import f32_matmul

_EPS = 1e-12


def _cbrt(x: torch.Tensor) -> torch.Tensor:
    return torch.sign(x) * torch.abs(x).pow(1.0 / 3.0)


def _solve_cubic_largest_real(b, c, d):
    """Largest real root of m^3 + b m^2 + c m + d = 0, element-wise."""
    p = c - b * b / 3.0
    q = 2.0 * b * b * b / 27.0 - b * c / 3.0 + d
    disc = (q / 2.0) ** 2 + (p / 3.0) ** 3

    safe_p = torch.clamp(p, max=-_EPS)
    rho = torch.sqrt(torch.clamp(-safe_p / 3.0, min=_EPS))
    arg = torch.clamp(3.0 * q / (2.0 * safe_p * rho), -1.0, 1.0)
    theta = torch.arccos(arg) / 3.0
    t_trig = 2.0 * rho * torch.cos(theta)

    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t_card = _cbrt(-q / 2.0 + sq) + _cbrt(-q / 2.0 - sq)

    t = torch.where(disc > 0, t_card, t_trig)
    return t - b / 3.0


def solve_quartic(coeffs: torch.Tensor):
    """Real roots of c4 x^4 + c3 x^3 + c2 x^2 + c1 x + c0 = 0.

    coeffs (..., 5) ordered [c4, c3, c2, c1, c0] -> (roots (..., 4),
    valid (..., 4)): Ferrari's closed form, then 3 Newton steps on the
    original quartic.
    """
    c4, c3, c2, c1, c0 = coeffs.unbind(-1)
    scale = torch.where(torch.abs(c4) < _EPS, torch.ones_like(c4), c4)
    b, c, d, e = c3 / scale, c2 / scale, c1 / scale, c0 / scale

    b2 = b * b
    p = c - 3.0 * b2 / 8.0
    q = d - b * c / 2.0 + b2 * b / 8.0
    r = e - b * d / 4.0 + b2 * c / 16.0 - 3.0 * b2 * b2 / 256.0

    m = _solve_cubic_largest_real(p, (2.0 * p * p - 8.0 * r) / 8.0, -(q * q) / 8.0)
    m = torch.clamp(m, min=1e-10)

    s = torch.sqrt(2.0 * m)
    t0 = p / 2.0 + m
    t1 = q / (2.0 * s)
    disc1 = s * s - 4.0 * (t0 + t1)
    disc2 = s * s - 4.0 * (t0 - t1)
    sq1 = torch.sqrt(torch.clamp(disc1, min=0.0))
    sq2 = torch.sqrt(torch.clamp(disc2, min=0.0))
    roots = torch.stack(
        [(s + sq1) / 2.0, (s - sq1) / 2.0, (-s + sq2) / 2.0, (-s - sq2) / 2.0], dim=-1
    ) - (b / 4.0)[..., None]
    valid = torch.stack([disc1 >= 0, disc1 >= 0, disc2 >= 0, disc2 >= 0], dim=-1)

    k4, k3, k2, k1, k0 = (v[..., None] for v in (c4, c3, c2, c1, c0))
    for _ in range(3):
        f = (((k4 * roots + k3) * roots + k2) * roots + k1) * roots + k0
        df = ((4.0 * k4 * roots + 3.0 * k3) * roots + 2.0 * k2) * roots + k1
        step = f / torch.where(torch.abs(df) < _EPS, torch.full_like(df, float("inf")), df)
        roots = roots - torch.where(valid, step, torch.zeros_like(step))
    return roots, valid


def _triangle_frame(pts: torch.Tensor) -> torch.Tensor:
    """Right-handed orthonormal frame (..., 3, 3) of a 3-point triangle:
    columns are the first edge, the in-plane perpendicular and the normal."""
    e1 = pts[..., 1, :] - pts[..., 0, :]
    e2 = pts[..., 2, :] - pts[..., 0, :]
    u = e1 / torch.clamp(torch.linalg.vector_norm(e1, dim=-1, keepdim=True), min=_EPS)
    n = torch.linalg.cross(e1, e2)
    n = n / torch.clamp(torch.linalg.vector_norm(n, dim=-1, keepdim=True), min=_EPS)
    v = torch.linalg.cross(n, u)
    return torch.stack([u, v, n], dim=-1)


@f32_matmul
def _kabsch_3pt(cam_pts: torch.Tensor, world_pts: torch.Tensor):
    """Rigid w2c (R, t) with cam = R @ world + t from 3 exact
    correspondences, by aligning the two triangle frames."""
    F_c = _triangle_frame(cam_pts)
    F_w = _triangle_frame(world_pts)
    R = F_c @ F_w.transpose(-1, -2)
    mu_c = cam_pts.mean(dim=-2)
    mu_w = world_pts.mean(dim=-2)
    t = mu_c - (R @ mu_w[..., :, None])[..., 0]
    return R, t


@f32_matmul
def p3p_grunert(world_pts: torch.Tensor, bearings: torch.Tensor):
    """Up to four w2c candidates from 3 world points and 3 unit bearings.

    world_pts, bearings: (..., 3, 3), rows are points. Returns
    (R (..., 4, 3, 3), t (..., 4, 3), valid (..., 4)).
    """
    P1, P2, P3 = world_pts[..., 0, :], world_pts[..., 1, :], world_pts[..., 2, :]
    f1, f2, f3 = bearings[..., 0, :], bearings[..., 1, :], bearings[..., 2, :]

    a2 = torch.sum((P2 - P3) ** 2, dim=-1)
    b2 = torch.sum((P1 - P3) ** 2, dim=-1)
    c2 = torch.sum((P1 - P2) ** 2, dim=-1)
    b2 = torch.clamp(b2, min=_EPS)

    cos_a = torch.sum(f2 * f3, dim=-1)
    cos_b = torch.sum(f1 * f3, dim=-1)
    cos_g = torch.sum(f1 * f2, dim=-1)

    p = (a2 - c2) / b2
    cb2 = c2 / b2
    n2, n1, n0 = p - 1.0, -2.0 * p * cos_b, p + 1.0
    d1, d0 = -2.0 * cos_a, 2.0 * cos_g
    e2, e1, e0 = -cb2, 2.0 * cb2 * cos_b, 1.0 - cb2

    q4 = n2 * n2
    q3 = 2.0 * n2 * n1
    q2 = 2.0 * n2 * n0 + n1 * n1
    q1 = 2.0 * n1 * n0
    q0 = n0 * n0
    g = -2.0 * cos_g
    q3 = q3 + g * n2 * d1
    q2 = q2 + g * (n2 * d0 + n1 * d1)
    q1 = q1 + g * (n1 * d0 + n0 * d1)
    q0 = q0 + g * n0 * d0
    dd2, dd1, dd0 = d1 * d1, 2.0 * d1 * d0, d0 * d0
    q4 = q4 + dd2 * e2
    q3 = q3 + dd2 * e1 + dd1 * e2
    q2 = q2 + dd2 * e0 + dd1 * e1 + dd0 * e2
    q1 = q1 + dd1 * e0 + dd0 * e1
    q0 = q0 + dd0 * e0

    v_roots, v_valid = solve_quartic(torch.stack([q4, q3, q2, q1, q0], dim=-1))

    Nv = (n2[..., None] * v_roots + n1[..., None]) * v_roots + n0[..., None]
    Dv = d1[..., None] * v_roots + d0[..., None]
    u = Nv / torch.where(torch.abs(Dv) < 1e-8, torch.full_like(Dv, float("inf")), Dv)

    denom = 1.0 + v_roots * v_roots - 2.0 * v_roots * cos_b[..., None]
    s1 = torch.sqrt(b2[..., None] / torch.clamp(denom, min=_EPS))
    s2 = u * s1
    s3 = v_roots * s1
    valid = (
        v_valid & (v_roots > 0) & (u > 0) & (denom > _EPS)
        & torch.isfinite(s1) & torch.isfinite(s2)
    )

    # Newton polish of the distances on the law-of-cosines system
    a2e, b2e, c2e = a2[..., None], b2[..., None], c2[..., None]
    ca, cb, cg = cos_a[..., None], cos_b[..., None], cos_g[..., None]
    zero = torch.zeros_like(s1)
    eye = torch.eye(3, dtype=s1.dtype, device=s1.device)
    for _ in range(3):
        g1 = s2 * s2 + s3 * s3 - 2.0 * s2 * s3 * ca - a2e
        g2 = s1 * s1 + s3 * s3 - 2.0 * s1 * s3 * cb - b2e
        g3 = s1 * s1 + s2 * s2 - 2.0 * s1 * s2 * cg - c2e
        gvec = torch.stack([g1, g2, g3], dim=-1)
        J = torch.stack(
            [
                torch.stack([zero, 2.0 * (s2 - s3 * ca), 2.0 * (s3 - s2 * ca)], dim=-1),
                torch.stack([2.0 * (s1 - s3 * cb), zero, 2.0 * (s3 - s1 * cb)], dim=-1),
                torch.stack([2.0 * (s1 - s2 * cg), 2.0 * (s2 - s1 * cg), zero], dim=-1),
            ],
            dim=-2,
        )
        step = torch.linalg.solve_ex(J + 1e-6 * eye, gvec)[0]
        step = torch.where(torch.isfinite(step), step, torch.zeros_like(step))
        s1 = s1 - step[..., 0]
        s2 = s2 - step[..., 1]
        s3 = s3 - step[..., 2]
    valid = valid & (s1 > 0) & (s2 > 0) & (s3 > 0)

    cam_pts = torch.stack(
        [
            s1[..., None] * f1[..., None, :],
            s2[..., None] * f2[..., None, :],
            s3[..., None] * f3[..., None, :],
        ],
        dim=-2,
    )
    world_rep = world_pts[..., None, :, :].expand(cam_pts.shape)
    R, t = _kabsch_3pt(cam_pts, world_rep)
    valid = valid & torch.isfinite(t).all(dim=-1)
    return R, t, valid
