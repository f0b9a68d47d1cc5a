"""Pose-only bundle adjustment over multi-view feature tracks.

Counterpart of acezero_tpu/reconstruct/ba.py. The Sim(3) pose graph
(reconstruct/loopclose.py) drains the rigid per-frame part of ring drift;
what it cannot express is a non-rigid bend. This module runs a
Levenberg-Marquardt bundle adjustment on the matcher's pixel
correspondences, camera poses only:

  - a track is one source cell plus its matched pixel in every pair that
    matched it (tracks with >= 2 targets pin the per-pair scale field that
    two-view landmarks leave free);
  - per iteration each track's landmark is the least-squares intersection
    of its rays, residuals get Cauchy weights, the 3x3 landmark block is
    eliminated exactly (Schur complement) and the damped (6n, 6n) camera
    system is solved densely;
  - a weak se(3) prior toward the initial poses and a hard anchor on frame
    0 fix the gauge; a step is kept only when it lowers the robust cost.

Tracks are processed in chunks of `chunk` to bound memory, as the JAX
package scans over them; the iterations are a Python loop that reads
nothing back to the host until the end. The normal equations accumulate
through `_ordered_add`, whose sums do not depend on thread order, so a run
gives the same bits every time on the card too (a scatter-add there is
atomic adds).
"""

from __future__ import annotations

import numpy as np
import torch

from acezero_tpu_torch import resolve_device
from acezero_tpu_torch.utils.precision import f32_matmul


def _skew(v: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) cross-product matrices."""
    x, y, z = v.unbind(-1)
    o = torch.zeros_like(x)
    return torch.stack([torch.stack([o, -z, y], -1), torch.stack([z, o, -x], -1),
                        torch.stack([-y, x, o], -1)], -2)


def _exp_so3(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues exponential, (..., 3) -> (..., 3, 3)."""
    theta = torch.clamp(torch.linalg.vector_norm(w, dim=-1, keepdim=True), min=1e-12)
    K = _skew(w / theta)
    st = torch.sin(theta)[..., None]
    ct = torch.cos(theta)[..., None]
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(K.shape)
    return eye + st * K + (1.0 - ct) * (K @ K)


def _rotlog(R: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> (..., 3) rotation log (small-angle safe)."""
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    theta = torch.arccos(torch.clamp((tr - 1.0) * 0.5, -1.0, 1.0))
    w = torch.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0], R[..., 1, 0] - R[..., 0, 1]], -1)
    s = torch.where(theta > 1e-6, theta / torch.clamp(2.0 * torch.sin(theta), min=1e-12),
                    torch.full_like(theta, 0.5))
    return w * s[..., None]


def _segments(keys: torch.Tensor):
    """A plan for summing values by key in a fixed order: the stable sort
    order of `keys`, the distinct keys and the length of each run."""
    order = torch.argsort(keys, stable=True)
    uniq, counts = torch.unique_consecutive(keys[order], return_counts=True)
    return order, uniq, counts


def _ordered_add(target: torch.Tensor, plan, values: torch.Tensor) -> None:
    """target[key] += the sum of the values with that key (`plan` from
    `_segments`), in place: each run is summed in its original order, one
    thread a run (`torch.segment_reduce`), and the distinct keys are written
    once each. So no sum depends on thread order, on the card as on the
    CPU, and within one track chunk the order is a serial scatter-add's."""
    order, uniq, counts = plan
    sums = torch.segment_reduce(values.reshape(len(order), -1)[order], "sum", lengths=counts, axis=0)
    target[uniq] += sums.reshape((-1,) + target.shape[1:])


def tracks_from_pair_matches(
    pair_idx: np.ndarray,  # (E, 2) int (src, tgt) graph-frame indices
    u_src: np.ndarray,  # (E, P, 2) source pixels (same cells for one src frame)
    u_tgt: np.ndarray,  # (E, P, 2) matched target pixels
    ok: np.ndarray,  # (E, P) bool
    max_obs: int = 6,
    min_targets: int = 1,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Group pair matches into per-source-cell tracks: all pairs of a source
    frame share its strided source cells, so this is pure regrouping.
    Returns (trk_frame (T, O) with -1 padding, trk_px (T, O, 2), trk_ok
    (T, O)); observation 0 is the source cell centre."""
    E, P = u_src.shape[:2]
    by_src: dict[int, list[int]] = {}
    for e in range(E):
        by_src.setdefault(int(pair_idx[e, 0]), []).append(e)

    n_tgt = max_obs - 1
    frames, pxs, oks = [], [], []
    for i, edges in sorted(by_src.items()):
        # a frame's outgoing edges by match count: the strongest targets
        # survive the max_obs cap
        edges = sorted(edges, key=lambda e: -int(ok[e].sum()))[:n_tgt]
        f = np.full((P, max_obs), -1, np.int64)
        p = np.zeros((P, max_obs, 2), np.float32)
        o = np.zeros((P, max_obs), bool)
        f[:, 0] = i
        p[:, 0] = u_src[edges[0]]
        o[:, 0] = True
        for c, e in enumerate(edges):
            f[:, 1 + c] = pair_idx[e, 1]
            p[:, 1 + c] = u_tgt[e]
            o[:, 1 + c] = ok[e]
        keep = o[:, 1:].sum(1) >= min_targets
        frames.append(f[keep])
        pxs.append(p[keep])
        oks.append(o[keep])
    if not frames:
        return (np.zeros((0, max_obs), np.int64), np.zeros((0, max_obs, 2), np.float32),
                np.zeros((0, max_obs), bool))
    return np.concatenate(frames), np.concatenate(pxs), np.concatenate(oks)


@f32_matmul
def pose_ba_core(
    R0,  # (n, 3, 3) world-to-camera rotations (graph frames)
    t0,  # (n, 3) world-to-camera translations
    focals,  # (n,) canvas-pixel focal lengths
    ppx: float,
    ppy: float,
    trk_frame,  # (T, O) graph-frame index per observation (-1 pad)
    trk_px,  # (T, O, 2) observation pixels (canvas coords)
    trk_ok,  # (T, O) bool
    iterations: int = 30,
    huber_px: float = 4.0,
    # gauge/soft-mode prior toward the initial poses: 1e4 holds the weakly
    # observable bend modes against ~2 px matcher noise (the JAX package's
    # measurement); refine_poses_ba passes 300 for sub-pixel-refined matches
    prior_rot: float = 1e4,
    prior_t: float = 1e4,
    chunk: int = 8192,
):
    """Track bundle adjustment; returns (R (n, 3, 3), t (n, 3), diag) with
    diag {"rms_px": (iterations,), "n_obs": ()} on R0's device. Frame 0 is
    hard-anchored."""
    dev = R0.device
    n = R0.shape[0]
    O = trk_frame.shape[1]
    fidx = torch.clamp(trk_frame, min=0).long()
    okb = trk_ok & (trk_frame >= 0)
    T = fidx.shape[0]
    spans = [(c0, min(c0 + chunk, T)) for c0 in range(0, T, chunk)]
    # block (o, p) of a track -> frame pair (f[o], f[p]); the frames of a
    # chunk never change, so each chunk's summation plan is made once
    plans = [(_segments((fidx[a:b, :, None] * n + fidx[a:b, None, :]).reshape(-1)),
              _segments(fidx[a:b].reshape(-1))) for a, b in spans]
    eye3 = torch.eye(3, device=dev)
    h2 = huber_px * huber_px
    oi = torch.arange(O, device=dev)

    def track_geometry(R, t, fc, uc, oc):
        """Triangulated landmarks, residuals and weights of one track chunk."""
        Rc = R[fc]  # (c, O, 3, 3)
        tc = t[fc]  # (c, O, 3)
        f = focals[fc]  # (c, O)
        cc = -torch.einsum("coij,coi->coj", Rc, tc)  # camera centres
        d = torch.stack([(uc[..., 0] - ppx) / f, (uc[..., 1] - ppy) / f, torch.ones_like(f)], -1)
        d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
        dw = torch.einsum("coji,coj->coi", Rc, d)  # world-frame bearings
        of = oc.float()
        # least-squares ray intersection: sum w (I - d d^T)(X - c) = 0
        Pm = (eye3 - dw[..., :, None] * dw[..., None, :]) * of[..., None, None]
        A = Pm.sum(1) + 1e-5 * eye3
        b = torch.einsum("coij,coj->ci", Pm, cc)
        X = torch.linalg.solve_ex(A, b[..., None])[0][..., 0]  # (c, 3)
        pc = torch.einsum("coij,cj->coi", Rc, X) + tc
        z = pc[..., 2]
        z_ok = z > 1e-2
        inv_z = 1.0 / torch.clamp(z, min=1e-2)
        pr = torch.stack([f * pc[..., 0] * inv_z + ppx, f * pc[..., 1] * inv_z + ppy], -1)
        res = pr - uc  # (c, O, 2)
        r2 = (res * res).sum(-1)
        return Rc, f, pc, inv_z, res, r2, of * z_ok, tc

    def prior_cost(R, t):
        pw = _rotlog(torch.einsum("nij,nkj->nik", R, R0))
        pv = t - t0
        return 0.5 * (prior_rot * (pw * pw).sum() + prior_t * (pv * pv).sum())

    def robust(r2, valid):
        return (valid * 0.5 * h2 * torch.log1p(r2 / h2)).sum()

    def cost_pass(R, t):
        """Robust (Cauchy) data cost plus the prior: the objective the LM
        acceptance tests (w = 1/(1 + r2/h2) is its IRLS weight)."""
        cost = torch.zeros((), device=dev)
        for a, b in spans:
            *_, r2, valid, _ = track_geometry(R, t, fidx[a:b], trk_px[a:b], okb[a:b])
            cost = cost + robust(r2, valid)
        return cost + prior_cost(R, t)

    def hg_pass(R, t):
        """Normal equations (landmarks Schur-eliminated) and the robust cost."""
        H = torch.zeros(n * n, 6, 6, device=dev)
        g = torch.zeros(n, 6, device=dev)
        wsum = rsum = cost = torch.zeros((), device=dev)
        for (a, b), (plan_H, plan_g) in zip(spans, plans):
            fc, uc, oc = fidx[a:b], trk_px[a:b], okb[a:b]
            Rc, f, pc, inv_z, res, r2, valid, tc = track_geometry(R, t, fc, uc, oc)
            zero = torch.zeros_like(inv_z)
            du = torch.stack([f * inv_z, zero, -f * pc[..., 0] * inv_z**2], -1)
            dv = torch.stack([zero, f * inv_z, -f * pc[..., 1] * inv_z**2], -1)
            dpx = torch.stack([du, dv], -2)  # (c, O, 2, 3)
            Jw = -(dpx @ _skew(pc - tc))  # pc - tc = R X
            Jc = torch.cat([Jw, dpx], -1)  # (c, O, 2, 6) camera Jacobian
            JX = dpx @ Rc  # (c, O, 2, 3)
            w = valid / (1.0 + r2 / h2)
            wJX = JX * w[..., None, None]
            wJc = Jc * w[..., None, None]
            # per-track landmark block with RELATIVE damping (an absolute
            # epsilon leaves near-rank-2 blocks at condition ~1e9 in f32)
            HXX = torch.einsum("cori,corj->cij", wJX, JX)
            lamX = 1e-3 * (HXX[:, 0, 0] + HXX[:, 1, 1] + HXX[:, 2, 2]) / 3.0 + 1e-6
            S = torch.linalg.inv_ex(HXX + lamX[:, None, None] * eye3)[0]  # (c, 3, 3)
            W = wJc.transpose(-1, -2) @ JX  # (c, O, 6, 3)
            gX = torch.einsum("cori,cor->ci", wJX, res)
            WS = W @ S[:, None]  # (c, O, 6, 3)
            Hd = wJc.transpose(-1, -2) @ Jc  # (c, O, 6, 6) diagonal blocks
            gd = (wJc.transpose(-1, -2) @ res[..., None])[..., 0] - (WS @ gX[:, None, :, None])[..., 0]
            Hx = -torch.einsum("coik,cpjk->copij", WS, W)  # (c, O, O, 6, 6)
            Hx[:, oi, oi] += Hd
            _ordered_add(H, plan_H, Hx)
            _ordered_add(g, plan_g, gd)
            wsum = wsum + w.sum()
            rsum = rsum + (w * r2).sum()
            cost = cost + robust(r2, valid)
        return H.reshape(n, n, 6, 6), g, wsum, rsum, cost + prior_cost(R, t)

    prior = torch.tensor([prior_rot] * 3 + [prior_t] * 3, device=dev)
    di = torch.arange(n, device=dev)
    R, t, lam = R0, t0, torch.tensor(1e-3, device=dev)
    rms_hist = []
    for _ in range(iterations):
        # Levenberg-Marquardt with step acceptance: a step is kept only when
        # it lowers the robust objective; a rejected one raises the damping
        H, g, wsum, rsum, cost0 = hg_pass(R, t)
        pw = _rotlog(torch.einsum("nij,nkj->nik", R, R0))  # R R0^T
        H[di, di] += torch.diag(prior)
        g = g + prior * torch.cat([pw, t - t0], -1)
        H[0, 0] += 1e6 * torch.eye(6, device=dev)  # hard anchor on frame 0
        # Jacobi-preconditioned damped solve (the raw diagonal spans the
        # prior, the data and the anchor: ~1e2 to 1e7)
        Hf = H.permute(0, 2, 1, 3).reshape(6 * n, 6 * n)
        dg = torch.clamp(torch.diagonal(Hf), min=1e-6)
        Hf = Hf + lam * torch.diag(dg)
        Dinv = 1.0 / torch.sqrt(dg + lam * dg)
        Hs = Hf * Dinv[:, None] * Dinv[None, :]
        delta = -(torch.linalg.solve_ex(Hs, (g.reshape(6 * n) * Dinv)[:, None])[0][:, 0] * Dinv).reshape(n, 6)
        delta[0] = 0.0
        # trust region: at most ~6 deg of rotation, and 5% of the camera
        # cloud's spread of translation, per step
        centers = -torch.einsum("nij,ni->nj", R, t)
        spread = torch.sqrt(((centers - centers.mean(0)) ** 2).sum(-1).mean())
        t_cap = torch.clamp(0.05 * 2.0 * spread, min=1e-3)
        rot_n = torch.linalg.vector_norm(delta[:, :3], dim=-1, keepdim=True)
        t_n = torch.linalg.vector_norm(delta[:, 3:], dim=-1, keepdim=True)
        delta = torch.cat([delta[:, :3] * torch.clamp(0.1 / torch.clamp(rot_n, min=1e-9), max=1.0),
                           delta[:, 3:] * torch.clamp(t_cap / torch.clamp(t_n, min=1e-9), max=1.0)], -1)
        delta = torch.where(torch.isfinite(delta), delta, torch.zeros_like(delta))
        R_cand = _exp_so3(delta[:, :3]) @ R
        t_cand = t + delta[:, 3:]
        accept = cost_pass(R_cand, t_cand) < cost0
        R = torch.where(accept, R_cand, R)
        t = torch.where(accept, t_cand, t)
        lam = torch.clamp(torch.where(accept, lam / 3.0, lam * 5.0), 1e-5, 1e3)
        rms_hist.append(torch.sqrt(rsum / torch.clamp(wsum, min=1e-9) / 2.0))
    return R, t, {"rms_px": torch.stack(rms_hist), "n_obs": okb.sum()}


def refine_poses_ba(
    w2c: np.ndarray,  # (ns, 4, 4) current w2c of the graph frames
    focals_canvas: np.ndarray,  # (ns,)
    pp: tuple[float, float],
    pair_idx: np.ndarray,  # (E, 2) graph-local indices
    u_src: np.ndarray,  # (E, P, 2)
    u_tgt: np.ndarray,  # (E, P, 2)
    ok: np.ndarray,  # (E, P)
    iterations: int = 30,
    max_obs: int = 6,
    prior: float = 300.0,
    device=None,
) -> tuple[np.ndarray, dict]:
    """Pair matches -> tracks -> BA on `device` (default cuda) -> corrected
    w2c (numpy).

    `prior` is the se(3) prior weight of pose_ba_core; 300 is the JAX
    package's value for sub-pixel-refined matches (~0.3 px)."""
    device = resolve_device(device)
    trk_f, trk_px, trk_ok = tracks_from_pair_matches(pair_idx, u_src, u_tgt, ok, max_obs=max_obs)
    if len(trk_f) < 64:
        return w2c, {"skipped": "too_few_tracks"}

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    R, t, diag = pose_ba_core(
        f32(w2c[:, :3, :3]), f32(w2c[:, :3, 3]), f32(focals_canvas), float(pp[0]), float(pp[1]),
        torch.as_tensor(trk_f, device=device), f32(trk_px), torch.as_tensor(trk_ok, device=device),
        iterations=iterations, prior_rot=prior, prior_t=prior,
    )
    out = np.tile(np.eye(4), (len(w2c), 1, 1))
    out[:, :3, :3] = R.double().cpu().numpy()
    out[:, :3, 3] = t.double().cpu().numpy()
    rms = diag["rms_px"].cpu().numpy()
    return out, {
        "rms_px_first": float(rms[0]),
        "rms_px_last": float(rms[-1]),
        "n_tracks": int(len(trk_f)),
        "n_obs": int(diag["n_obs"]),
    }
