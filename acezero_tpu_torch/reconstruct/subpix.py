"""Sub-pixel photometric refinement of cross-view matches at full resolution.

Counterpart of acezero_tpu/reconstruct/subpix.py. The loop-closure matcher
(reconstruct/loopclose.py) associates stride-8 feature cells, a ~0.5-2 px
measurement; the track BA needs 0.1-0.3 px. Each accepted match is upgraded:

  1. geometric prewarp: the K x K source patch around the matched source
     cell centre is lifted onto the source frame's coordinate sheet
     (perspective-correct inverse-depth interpolation) and projected into
     the target view, anchored at the matcher's estimate;
  2. coarse-to-fine photometric Gauss-Newton on the raw grayscale canvases:
     a 2-D shift plus gain and bias (4 parameters), first at 2-px patch
     spacing, then at 1-px;
  3. acceptance: within `max_shift_px` of the matcher, the matcher within
     `max_geo_px` of the geometric prediction, a textured patch
     (`min_grad`) and normalized correlation `min_zncc`; everything else
     keeps the unrefined match and is flagged.

The JAX package vmaps one match at a time; here every tensor carries the
(pair, match, patch pixel) axes of a pair chunk, and the fixed-count GN
loops are Python loops that never read a value back to the host.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass

import numpy as np
import torch

from acezero_tpu_torch.utils.precision import f32_matmul

_logger = logging.getLogger(__name__)


@dataclass(frozen=True)
class SubpixConfig:
    patch: int = 9  # patch side (odd), in spacing units
    spacings: tuple = (2, 1)  # coarse-to-fine patch spacings (px)
    gn_iterations: int = 5  # GN steps per spacing level
    max_shift_px: float = 6.0  # reject refinements farther from the matcher
    # reject matches whose matcher estimate already disagrees with the
    # geometric sheet projection by more than this: photometric aliases
    # (repeating texture) lock tens of px away, drift lives at a few px
    max_geo_px: float = 8.0
    min_zncc: float = 0.6  # acceptance correlation
    min_grad: float = 2.0  # texture floor, u8 units / px (mean |grad|)
    max_matches_per_pair: int = 192  # refinement budget per pair
    subsample: int = 8  # cell pitch of the coordinate maps


def _bilinear(img: torch.Tensor, u: torch.Tensor, v: torch.Tensor):
    """Bilinear samples of images (B, H, W) at (u=col, v=row) positions
    (B, ...), one image per leading index. Returns (values, in_bounds)."""
    B, H, W = img.shape
    shape = u.shape
    u = u.reshape(B, -1)
    v = v.reshape(B, -1)
    u0 = torch.floor(u)
    v0 = torch.floor(v)
    au = u - u0
    av = v - v0
    u0i = torch.clamp(u0.long(), 0, W - 1)
    v0i = torch.clamp(v0.long(), 0, H - 1)
    u1i = torch.clamp(u0i + 1, 0, W - 1)
    v1i = torch.clamp(v0i + 1, 0, H - 1)
    flat = img.reshape(B, H * W)

    def at(vi, ui):
        return torch.gather(flat, 1, vi * W + ui)

    p00, p01, p10, p11 = at(v0i, u0i), at(v0i, u1i), at(v1i, u0i), at(v1i, u1i)
    val = (1 - av) * ((1 - au) * p00 + au * p01) + av * ((1 - au) * p10 + au * p11)
    inb = (u >= 0) & (u <= W - 1) & (v >= 0) & (v <= H - 1)
    return val.reshape(shape), inb.reshape(shape)


def _sample_sheet_world(Xmap, Vmap, w2c, f, ppx, ppy, gi, gj, subsample, depth_min=0.1, bounds=True):
    """World points of coordinate sheets at continuous cell coords.

    Xmap (B, h, w, 3), Vmap (B, h, w), w2c (B, 4, 4), f (B,); gi, gj
    (B, ...) index the sheet of their leading index. Perspective-correct:
    interpolate the support cells' INVERSE camera depth and back-project
    through the continuous query pixel (bilinear on raw 3D bows planar
    sheets). Returns (points (B, ..., 3), support_valid (B, ...)); the
    support must be valid and in front of the camera, and with `bounds` the
    query inside the sheet. Loop closure's matcher samples with
    bounds=False, as the JAX package's `pairwise_sim3.sample_sheet` does."""
    B, h, w = Xmap.shape[:3]
    shape = gi.shape
    gi = gi.reshape(B, -1)
    gj = gj.reshape(B, -1)
    Rw, tw = w2c[:, :3, :3], w2c[:, :3, 3]
    u = gj * subsample + subsample / 2.0
    v = gi * subsample + subsample / 2.0
    i0 = torch.floor(gi).long()
    j0 = torch.floor(gj).long()
    ai = gi - i0
    aj = gj - j0
    i0c = torch.clamp(i0, 0, h - 1)
    j0c = torch.clamp(j0, 0, w - 1)
    i1c = torch.clamp(i0 + 1, 0, h - 1)
    j1c = torch.clamp(j0 + 1, 0, w - 1)
    Xf = Xmap.reshape(B, h * w, 3)
    Vf = Vmap.reshape(B, h * w)

    def X_at(i, j):
        return torch.gather(Xf, 1, (i * w + j)[..., None].expand(-1, -1, 3))

    def V_at(i, j):
        return torch.gather(Vf, 1, i * w + j)

    r2, t2 = Rw[:, 2], tw[:, 2:3]

    def zq(X):
        return torch.einsum("bqc,bc->bq", X, r2) + t2

    z00, z01 = zq(X_at(i0c, j0c)), zq(X_at(i0c, j1c))
    z10, z11 = zq(X_at(i1c, j0c)), zq(X_at(i1c, j1c))

    def izc(zc):
        return 1.0 / torch.clamp(zc, min=1e-6)

    iz = (1 - ai) * ((1 - aj) * izc(z00) + aj * izc(z01)) + ai * ((1 - aj) * izc(z10) + aj * izc(z11))
    z_s = 1.0 / torch.clamp(iz, min=1e-9)
    fb = f[:, None]
    x_cam = torch.stack([(u - ppx) / fb * z_s, (v - ppy) / fb * z_s, z_s], -1)
    Xs = torch.einsum("bqc,bcd->bqd", x_cam - tw[:, None, :], Rw)
    ok = (
        V_at(i0c, j0c) & V_at(i0c, j1c) & V_at(i1c, j0c) & V_at(i1c, j1c)
        & (z00 > depth_min) & (z01 > depth_min) & (z10 > depth_min) & (z11 > depth_min)
    )
    if bounds:
        ok = ok & (gi >= 0) & (gi <= h - 1) & (gj >= 0) & (gj <= w - 1)
    return Xs.reshape(*shape, 3), ok.reshape(shape)


@f32_matmul
def _refine_pairs(
    images,  # (F, H, W) float32 grayscale canvases (0..255)
    coords,  # (F, h, w, 3) predicted coordinate maps
    valid,  # (F, h, w) bool
    w2c,  # (F, 4, 4)
    focals,  # (F,)
    ppx: float,
    ppy: float,
    src_idx,  # (E,) source frame per pair
    tgt_idx,  # (E,)
    u_src,  # (E, M, 2) canvas px (col, row) of selected source cells
    u_tgt,  # (E, M, 2) canvas px matcher estimate in the target
    sel_ok,  # (E, M) bool
    cfg: SubpixConfig,
):
    """Refined target pixels (E, M, 2), acceptance (E, M) and zncc (E, M)."""
    dev = images.device
    K = cfg.patch
    half = K // 2
    a = torch.arange(-half, half + 1, dtype=torch.float32, device=dev)
    gx, gy = torch.meshgrid(a, a, indexing="xy")
    dgrid = torch.stack([gx, gy], -1).reshape(-1, 2)  # (K*K, 2) (du, dv) in spacing units
    sub = cfg.subsample
    E, M = sel_ok.shape
    img_s, img_t = images[src_idx], images[tgt_idx]
    Xmap_s, Vmap_s, w2c_s = coords[src_idx], valid[src_idx], w2c[src_idx]
    Rt, tt = w2c[tgt_idx][:, :3, :3], w2c[tgt_idx][:, :3, 3]
    f_s, f_t = focals[src_idx], focals[tgt_idx][:, None, None]
    c = K * K // 2
    eye4 = 1e-4 * torch.eye(4, device=dev)

    d = torch.zeros(E, M, 2, device=dev)
    accept = sel_ok.clone()
    zncc_final = torch.zeros(E, M, device=dev)
    grad_final = torch.zeros(E, M, device=dev)

    def grads(tu, tv):
        Txp, _ = _bilinear(img_t, tu + 0.5, tv)
        Txm, _ = _bilinear(img_t, tu - 0.5, tv)
        Typ, _ = _bilinear(img_t, tu, tv + 0.5)
        Tym, _ = _bilinear(img_t, tu, tv - 0.5)
        return Txp - Txm, Typ - Tym

    for spacing in cfg.spacings:
        offs = dgrid * spacing  # (K2, 2) px offsets
        qu = u_src[..., 0:1] + offs[:, 0]  # (E, M, K2)
        qv = u_src[..., 1:2] + offs[:, 1]
        S, s_inb = _bilinear(img_s, qu, qv)
        # geometric prewarp: lift patch pixels onto the source sheet, project
        # into the target view
        gi = (qv - sub / 2.0) / sub
        gj = (qu - sub / 2.0) / sub
        Xw, sheet_ok = _sample_sheet_world(Xmap_s, Vmap_s, w2c_s, f_s, ppx, ppy, gi, gj, sub)
        pc = torch.einsum("emkc,edc->emkd", Xw, Rt) + tt[:, None, None, :]
        z = torch.clamp(pc[..., 2], min=1e-6)
        Wu = f_t * pc[..., 0] / z + ppx
        Wv = f_t * pc[..., 1] / z + ppy
        # anchor the warp at the matcher's estimate: the centre pixel lands on
        # it; the unanchored centre is the geometric prediction
        geo_dist = torch.sqrt((Wu[..., c] - u_tgt[..., 0]) ** 2 + (Wv[..., c] - u_tgt[..., 1]) ** 2)
        accept = accept & (geo_dist <= cfg.max_geo_px)
        Wu = Wu - Wu[..., c : c + 1] + u_tgt[..., 0:1]
        Wv = Wv - Wv[..., c : c + 1] + u_tgt[..., 1:2]
        pre_ok = s_inb & sheet_ok
        n_pre = pre_ok.sum(-1)
        wgt = pre_ok.float()
        S0 = S - (S * wgt).sum(-1, keepdim=True) / torch.clamp(n_pre, min=1)[..., None]

        ga = torch.ones(E, M, device=dev)
        gb = torch.zeros(E, M, device=dev)
        for _ in range(cfg.gn_iterations):
            tu = Wu + d[..., 0:1]
            tv = Wv + d[..., 1:2]
            T, t_inb = _bilinear(img_t, tu, tv)
            Tx, Ty = grads(tu, tv)
            m = (pre_ok & t_inb).float()
            A = ga[..., None]
            r = A * T + gb[..., None] - S0
            J = torch.stack([A * Tx, A * Ty, T, torch.ones_like(T)], -1)  # (E, M, K2, 4)
            Jm = J * m[..., None]
            H = Jm.transpose(-1, -2) @ J + eye4
            g = -(Jm.transpose(-1, -2) @ r[..., None])
            delta = torch.linalg.solve_ex(H, g)[0][..., 0]
            enough = m.sum(-1) >= 0.5 * K * K
            delta = torch.where(enough[..., None], delta, torch.zeros_like(delta))
            # keep the walk inside the acceptance region
            d = torch.clamp(d + delta[..., :2], -cfg.max_shift_px, cfg.max_shift_px)
            ga = torch.clamp(ga + delta[..., 2], 0.2, 5.0)
            gb = gb + delta[..., 3]

        # level-final diagnostics (the acceptance at the finest spacing)
        tu = Wu + d[..., 0:1]
        tv = Wv + d[..., 1:2]
        T, t_inb = _bilinear(img_t, tu, tv)
        m = (pre_ok & t_inb).float()
        n_m = torch.clamp(m.sum(-1, keepdim=True), min=1.0)
        Tm = T - (T * m).sum(-1, keepdim=True) / n_m
        Sm = S - (S * m).sum(-1, keepdim=True) / n_m
        zncc_final = (Tm * Sm * m).sum(-1) / torch.clamp(
            torch.sqrt((Tm * Tm * m).sum(-1) * (Sm * Sm * m).sum(-1)), min=1e-6)
        Tx, Ty = grads(tu, tv)
        grad_final = ((Tx.abs() + Ty.abs()) * m).sum(-1) / n_m[..., 0]
        accept = accept & (n_pre >= 0.7 * K * K) & (m.sum(-1) >= 0.7 * K * K)

    shift = torch.linalg.vector_norm(d, dim=-1)
    accept = (accept & (zncc_final >= cfg.min_zncc) & (grad_final >= cfg.min_grad)
              & (shift < cfg.max_shift_px - 1e-3))
    return u_tgt + d, accept, zncc_final


def refine_matches_photometric(
    images_u8,  # (F, H, W) uint8 canvases of the graph frames (tensor or numpy)
    coords,  # (F, h, w, 3) tensor
    valid,  # (F, h, w)
    w2c,  # (F, 4, 4) numpy
    focals_canvas,  # (F,) numpy
    canvas_hw: tuple,
    pairs: np.ndarray,  # (E, 2) graph-frame indices (src, tgt)
    u_src: np.ndarray,  # (P, 2) canvas px, shared source-cell grid
    u_tgt: np.ndarray,  # (E, P, 2) canvas px matcher estimates
    ok: np.ndarray,  # (E, P)
    cfg: SubpixConfig = SubpixConfig(),
    pair_chunk: int = 64,
) -> tuple[np.ndarray, np.ndarray, dict]:
    """Refine matcher correspondences photometrically on coords' device; see
    the module docstring. Returns (u_tgt_refined (E, P, 2), ok_refined
    (E, P), diagnostics). Unaccepted matches keep their original u_tgt with
    ok_refined False."""
    coords = torch.as_tensor(coords)
    dev = coords.device
    E, P = ok.shape
    M = min(cfg.max_matches_per_pair, P)
    H, W = canvas_hw

    # per-pair selection: ok-first stable order, evenly strided to M
    sel = np.zeros((E, M), np.int64)
    sel_ok = np.zeros((E, M), bool)
    for e in range(E):
        good = np.where(ok[e])[0]
        if len(good) == 0:
            continue
        take = good[np.round(np.linspace(0, len(good) - 1, M)).astype(int)]
        sel[e] = take
        # strided selection repeats indices when len(good) < M; keep first
        sel_ok[e] = np.concatenate([[True], np.diff(take) > 0])

    u_src_sel = np.broadcast_to(u_src[None], (E, P, 2))
    u_src_sel = np.take_along_axis(u_src_sel, sel[..., None], axis=1).astype(np.float32)
    u_tgt_sel = np.take_along_axis(u_tgt, sel[..., None], axis=1).astype(np.float32)

    images_f = torch.as_tensor(images_u8).to(dev).float()
    valid_t = torch.as_tensor(valid).to(dev)
    w2c_t = torch.as_tensor(np.asarray(w2c, np.float32), device=dev)
    focals_t = torch.as_tensor(np.asarray(focals_canvas, np.float32), device=dev)

    u_ref = np.array(u_tgt, np.float32, copy=True)
    ok_ref = np.zeros((E, P), bool)
    znccs = []
    for c0 in range(0, E, pair_chunk):
        pidx = np.arange(c0, min(c0 + pair_chunk, E))

        def dev_t(a):
            return torch.as_tensor(a, device=dev)

        out_u, out_ok, out_z = _refine_pairs(
            images_f, coords, valid_t, w2c_t, focals_t, W / 2.0, H / 2.0,
            dev_t(pairs[pidx, 0]), dev_t(pairs[pidx, 1]),
            dev_t(u_src_sel[pidx]), dev_t(u_tgt_sel[pidx]), dev_t(sel_ok[pidx]), cfg,
        )
        out_u, out_ok, out_z = out_u.cpu().numpy(), out_ok.cpu().numpy(), out_z.cpu().numpy()
        for k, e in enumerate(pidx):
            # scatter ONLY accepted entries: `sel[e]` repeats indices when the
            # pair had fewer good matches than the budget, and a duplicate's
            # False must not overwrite an accepted True
            acc = out_ok[k]
            idx = sel[e][acc]
            u_ref[e, idx] = out_u[k][acc]
            ok_ref[e, idx] = True
        znccs.append(out_z[out_ok])

    z_all = np.concatenate(znccs) if znccs else np.zeros(0)
    diag = {
        "n_selected": int(sel_ok.sum()),
        "n_accepted": int(ok_ref.sum()),
        "accept_rate": float(ok_ref.sum() / max(sel_ok.sum(), 1)),
        "median_zncc": float(np.median(z_all)) if len(z_all) else 0.0,
        "median_shift_px": float(
            np.median(np.linalg.norm((u_ref - u_tgt)[ok_ref], axis=-1))
        ) if ok_ref.any() else 0.0,
    }
    return u_ref, ok_ref, diag
