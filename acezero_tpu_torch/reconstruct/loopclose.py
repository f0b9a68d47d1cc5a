"""Sim(3) pose-graph loop closure over the learned map's cross-view consistency.

Counterpart of acezero_tpu/reconstruct/loopclose.py. Incremental map growth
bends the map on ring captures: early and late frames store slightly
misaligned "sheets" of the same geometry, and nothing in the mapping loss
pulls them together. This stage drains that drift:

  1. predict every graph frame's scene-coordinate map under the current head
     (encoder -> head, K1 on the card), with the encoder's cell features
     randomly projected to `feature_dim` for matching;
  2. for co-visible frame pairs (i, j), fit the sheet misalignment M_ij as a
     Sim(3) on feature-matched 3D-3D correspondences, then polish it with
     point-to-plane terms (`pairwise_sim3`, all pairs of a chunk at once);
  3. solve a robust information-form pose graph for per-frame corrections
     S_i from S_i = S_j o M_ij (host numpy, a small Laplacian);
  4. apply c2w_i' = S_i o c2w_i; optionally refine the matches
     photometrically (subpix.py) and run a track BA (ba.py) on them.

Device work runs on the tensors' device in float32 with TF32 off: the
96-wide cosine products decide argmax and margin tests, and the GN steps
are pose algebra. The fixed-count loops are Python loops that read nothing
back to the host; each pair chunk is fetched once.
"""

from __future__ import annotations

import functools
import logging
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from acezero_tpu_torch import resolve_device
from acezero_tpu_torch.geometry.projection import get_pixel_grid
from acezero_tpu_torch.geometry.rotations import rodrigues_to_matrix
from acezero_tpu_torch.io.pose_files import PoseFileEntry
from acezero_tpu_torch.models.encoder import encoder_apply
from acezero_tpu_torch.models.head import head_apply_image
from acezero_tpu_torch.reconstruct.ba import refine_poses_ba
from acezero_tpu_torch.reconstruct.subpix import _sample_sheet_world, refine_matches_photometric
from acezero_tpu_torch.registration.driver import _canvas_prologue, _chunk_images
from acezero_tpu_torch.utils.precision import f32_matmul, no_tf32
from acezero_tpu_torch.utils.profiling import stage

_logger = logging.getLogger(__name__)

# the JAX package's matching projection, jax.random.normal(PRNGKey(7),
# (512, 96)) / sqrt(512), stored because torch cannot draw it
PROJ_FILE = Path(__file__).with_name("feature_proj.npy")


@dataclass(frozen=True)
class LoopCloseConfig:
    neighbors: int = 6  # k-NN frame pairs per confident frame (directed)
    sample_step: int = 2  # cell subsample for source points (P = h*w/step^2)
    icp_iterations: int = 4  # robust-refit rounds per match round
    match_rounds: int = 2  # feature-matching association rounds
    match_min_sim: float = 0.5  # cosine floor for a usable match
    match_min_margin: float = 0.03  # best-vs-second margin (2nd outside excl.)
    match_exclude_cells: int = 2  # neighborhood excluded from the 2nd-best
    match_gate_cells: float = 8.0  # round-2 gate radius around projection
    polish_iterations: int = 3  # final joint matched+point-to-plane GN steps
    plane_win: int = 5  # PCA window (cells) for target sheet normals
    plane_ratio: float = 10.0  # min mid/smallest eigenvalue ratio for planarity
    graph_iterations: int = 4  # robust reweighting rounds of the graph solve
    info_condition_cap: float = 100.0  # per-edge information eigenvalue cap
    rms_gate: float = 3.0  # drop edges with rms > gate * median rms
    cycle_gate: float = 4.0  # drop edge pairs with fwd∘rev error > gate * median
    min_pair_points: int = 64  # drop pairs with fewer robust inliers
    min_pair_overlap: float = 0.2  # mutual view-overlap floor for graph edges
    feature_dim: int = 96  # random-projection dim for matching features
    sigma_floor_rel: float = 2e-3  # robust-kernel floor, fraction of scene diagonal
    own_reproj_px: float = 20.0  # own-frame reprojection gate for source points
    depth_min: float = 0.1  # reference depth validity band (ace_trainer.py:558)
    depth_max: float = 1000.0
    pair_chunk: int = 64  # pairs per device program (memory bound)
    # track BA over the matcher's correspondences after the graph correction:
    # "off"; "raw" (stride-8 matches; measured by the JAX package to hurt,
    # kept for experiments); "subpix" (photometrically refined matches only,
    # subpix.py)
    ba: str = "subpix"
    ba_iterations: int = 30
    ba_max_obs: int = 6
    ba_prior: float = 300.0  # se(3) prior of the BA, tuned for refined matches
    # fewest accepted refined matches for the subpix BA to run
    subpix_min_matches: int = 300


# ------------------------------------------------------------------- device


def _masked_median(r: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Median of r over valid entries along the last axis (sort with invalid
    = +inf; the upper median, as the JAX package takes it)."""
    order = torch.sort(torch.where(valid, r, torch.full_like(r, float("inf"))), dim=-1).values
    n_valid = valid.sum(-1)
    idx = torch.clamp(n_valid // 2, 0, r.shape[-1] - 1)
    med = torch.gather(order, -1, idx[..., None])[..., 0]
    return torch.where(n_valid > 0, med, torch.zeros_like(med))


def _box_sum(a: torch.Tensor, win: int) -> torch.Tensor:
    """Zero-padded ("SAME") win x win box sum over dims 1 and 2 of
    (B, h, w, C), by shifted adds: integer counts stay exact."""
    lo = (win - 1) // 2
    h, w = a.shape[1:3]
    ap = F.pad(a, (0, 0, lo, win - 1 - lo, lo, win - 1 - lo))
    rows = sum(ap[:, d : d + h] for d in range(win))
    return sum(rows[:, :, d : d + w] for d in range(win))


# cuSOLVER's batched eigensolver refuses a batch of 307,200 3x3 matrices
# (CUSOLVER_STATUS_INVALID_VALUE from its workspace query on an H100, CUDA
# 12.8); 28,800 pass. The sheet normals solve in slices of this many.
EIGH_BATCH = 16384


def _eigh(A: torch.Tensor, max_batch: int = EIGH_BATCH):
    """torch.linalg.eigh of (..., n, n), at most `max_batch` matrices a call."""
    flat = A.reshape(-1, *A.shape[-2:])
    parts = [torch.linalg.eigh(flat[i : i + max_batch]) for i in range(0, len(flat), max_batch)]
    evals = torch.cat([p[0] for p in parts]).reshape(A.shape[:-1])
    evecs = torch.cat([p[1] for p in parts]).reshape(A.shape)
    return evals, evecs


def _sheet_normals(X, V, cam_c, win: int = 5, ratio: float = 10.0):
    """Per-cell normals of coordinate-map sheets by windowed PCA.

    X (B, h, w, 3), V (B, h, w), cam_c (B, 3). Returns (normals (B, h, w, 3)
    oriented toward the camera, plane_ok (B, h, w): valid, at least 60% of
    the window supported, and the mid eigenvalue above `ratio` times the
    smallest)."""
    Vf = V.float()
    outer = (X[..., :, None] * X[..., None, :]) * Vf[..., None, None]
    sums = _box_sum(torch.cat([Vf[..., None], X * Vf[..., None], outer.reshape(*X.shape[:3], 9)], -1), win)
    N, S1, S2 = sums[..., 0], sums[..., 1:4], sums[..., 4:].reshape(*X.shape[:3], 3, 3)
    Nc = torch.clamp(N, min=1.0)
    mu = S1 / Nc[..., None]
    cov = S2 / Nc[..., None, None] - mu[..., :, None] * mu[..., None, :]
    evals, evecs = _eigh(cov)  # ascending
    n = evecs[..., :, 0]
    flip = (n * (cam_c[:, None, None, :] - mu)).sum(-1) < 0
    n = torch.where(flip[..., None], -n, n)
    ok = V & (N >= 0.6 * win * win) & (evals[..., 1] > ratio * torch.clamp(evals[..., 0], min=1e-12))
    return n, ok


def _sim3_jacobian(Y: torch.Tensor) -> torch.Tensor:
    """d(X - Y)/d(dw, dv, dsig) on the left Sim(3) tangent: [[Y]x, -I, -Y],
    (..., 3, 7)."""
    Z = torch.zeros_like(Y[..., 0])
    Yx = torch.stack([torch.stack([Z, -Y[..., 2], Y[..., 1]], -1),
                      torch.stack([Y[..., 2], Z, -Y[..., 0]], -1),
                      torch.stack([-Y[..., 1], Y[..., 0], Z], -1)], -2)
    eye = torch.eye(3, dtype=Y.dtype, device=Y.device).expand(Yx.shape)
    return torch.cat([Yx, -eye, -Y[..., :, None]], -1)


def _truncated_step(s, R, t, H, g, n_ok):
    """Truncated-eigensolve GN step: directions with under 1e-4 of the
    dominant curvature get no update; pairs with fewer than 4 usable
    residuals stay put. Returns the updated (s, R, t)."""
    evals, evecs = torch.linalg.eigh(H)
    emax = torch.clamp(evals[:, -1:], min=1e-12)
    inv = torch.where(evals > 1e-4 * emax, 1.0 / evals, torch.zeros_like(evals))
    delta = ((evecs * inv[:, None, :]) @ (evecs.transpose(1, 2) @ g[..., None]))[..., 0]
    delta = torch.where((n_ok >= 4)[:, None], delta, torch.zeros_like(delta))
    dR = rodrigues_to_matrix(delta[:, :3])
    e = torch.exp(delta[:, 6])
    return (torch.clamp(e * s, 0.5, 2.0), dR @ R,
            e[:, None] * (dR @ t[..., None])[..., 0] + delta[:, 3:6])


def _weighted_normal(J, w, res):
    """sum_p w_p J_p^T J_p and -sum_p w_p J_p^T res_p over the point axis
    of J (E, P, a, 7), w (E, P), res (E, P, a)."""
    E = J.shape[0]
    Jw = (J * w[..., None, None]).reshape(E, -1, 7)
    Jf = J.reshape(E, -1, 7)
    return Jw.transpose(1, 2) @ Jf, -(Jw.transpose(1, 2) @ res.reshape(E, -1, 1))[..., 0]


@f32_matmul
def pairwise_sim3(
    src_pts,  # (E, P, 3) world points of source frames (subsampled cells)
    src_feat,  # (E, P, F) L2-normalized matching features of source cells
    src_valid,  # (E, P) bool
    tgt_maps,  # (E, h, w, 3) full coordinate maps of target frames
    tgt_feat,  # (E, h, w, F) L2-normalized features of target cells
    tgt_valid,  # (E, h, w) bool
    tgt_w2c,  # (E, 4, 4) current world-to-camera of target frames
    tgt_focal,  # (E,) canvas-pixel focal
    ppx: float,
    ppy: float,
    sigma_floor: float,  # robust-kernel floor (world units)
    cfg: LoopCloseConfig,
    subsample: int = 8,
):
    """Fit M_ij per pair such that tgt_sheet ≈ M_ij(src_sheet) (Sim(3)).

    Feature matching resolves what pure geometry cannot (a box world maps
    onto itself under many Sim(3)s):
      1. dense cosine matching, a (P, h*w) product per pair, argmax with a
         spatially separated second-best margin test; later rounds gate the
         candidates around the current estimate's projection; a parabola
         through the neighbouring similarities gives the sub-cell peak;
      2. per match round, `icp_iterations` robust truncated-GN refits on the
         fixed matched pairs;
      3. `polish_iterations` joint steps: matched point-to-point plus
         ray-associated point-to-plane with perspective-correct sampling.

    Returns per pair: scale (E,), R (E, 3, 3), t (E, 3), n_inliers (E,),
    rms (E,), H (E, 7, 7) (the information of the final joint fit per
    inlier, tangent order rotation, translation, log-scale), u_tgt (E, P, 2)
    matched target pixels and m_ok (E, P).
    """
    E, h, w = tgt_maps.shape[:3]
    P = src_pts.shape[1]
    dev = tgt_maps.device
    Xi, Fi, Vi = src_pts, src_feat, src_valid
    Rw, tw = tgt_w2c[:, :3, :3], tgt_w2c[:, :3, 3]
    f = tgt_focal[:, None]
    cam_c = -torch.einsum("eji,ej->ei", Rw, tw)
    nrm_map, plane_ok_map = _sheet_normals(tgt_maps, tgt_valid, cam_c, cfg.plane_win, cfg.plane_ratio)
    nrm_flat = nrm_map.reshape(E, h * w, 3)
    plane_flat = plane_ok_map.reshape(E, h * w)
    Fj_t = tgt_feat.reshape(E, h * w, -1).transpose(1, 2)
    Vj_flat = tgt_valid.reshape(E, h * w)
    rows = torch.arange(h, dtype=torch.float32, device=dev)
    cols = torch.arange(w, dtype=torch.float32, device=dev)

    def transform(s, R, t):
        return s[:, None, None] * (Xi @ R.transpose(1, 2)) + t[:, None, :]

    def project_cells(Y):
        """Continuous target-cell coordinates and depth of points Y."""
        pc = Y @ Rw.transpose(1, 2) + tw[:, None, :]
        z = pc[..., 2]
        zs = torch.where(z.abs() < 1e-6, torch.full_like(z, 1e-6), z)
        u = f * pc[..., 0] / zs + ppx
        v = f * pc[..., 1] / zs + ppy
        return (v - subsample / 2) / subsample, (u - subsample / 2) / subsample, z

    def sample_sheet(gi, gj):
        return _sample_sheet_world(tgt_maps, tgt_valid, tgt_w2c, tgt_focal, ppx, ppy, gi, gj, subsample,
                                   cfg.depth_min, bounds=False)

    def match(s, R, t, gate: float):
        """Best-feature correspondence with sub-cell peak refinement, gated
        around the current estimate's projection."""
        sims = Fi @ Fj_t  # (E, P, h*w)
        gi_p, gj_p, _ = project_cells(transform(s, R, t))
        d2 = ((rows - gi_p[..., None]) ** 2)[..., :, None] + ((cols - gj_p[..., None]) ** 2)[..., None, :]
        sims.masked_fill_(~(Vj_flat[:, None, :] & (d2.reshape(E, P, h * w) <= gate * gate)), -2.0)
        del d2
        best = torch.argmax(sims, dim=-1)
        sim1 = torch.gather(sims, -1, best[..., None])[..., 0]
        bi_i, bj_i = best // w, best % w
        bi, bj = bi_i.float(), bj_i.float()

        def s_at(di, dj):
            idx = torch.clamp(bi_i + di, 0, h - 1) * w + torch.clamp(bj_i + dj, 0, w - 1)
            return torch.gather(sims, -1, idx[..., None])[..., 0]

        def peak_offset(sm, s0, sp):
            den = sm - 2.0 * s0 + sp
            return torch.where(den < -1e-9, torch.clamp(0.5 * (sm - sp) / den, -0.5, 0.5), torch.zeros_like(den))

        oi = peak_offset(s_at(-1, 0), sim1, s_at(1, 0))
        oj = peak_offset(s_at(0, -1), sim1, s_at(0, 1))
        excl = cfg.match_exclude_cells
        near = (((rows - bi[..., None]).abs() <= excl)[..., :, None]
                & ((cols - bj[..., None]).abs() <= excl)[..., None, :])
        sim2 = sims.masked_fill_(near.reshape(E, P, h * w), -2.0).amax(-1)
        del sims, near
        ok = Vi & (sim1 > cfg.match_min_sim) & (sim1 - sim2 > cfg.match_min_margin)
        Xs, vj = sample_sheet(bi + oi, bj + oj)
        # continuous target cell coords (col, row): the BA's observations
        return Xs, ok & vj, torch.stack([bj + oj, bi + oi], -1)

    def gn_step(s, R, t, Xj, ok):
        """One robust GN step against fixed correspondences Xj."""
        Y = transform(s, R, t)
        res = Xj - Y
        r = torch.linalg.vector_norm(res, dim=-1)
        sigma = torch.clamp(1.4826 * _masked_median(r, ok), min=sigma_floor)
        wgt = ok * (1.0 / (1.0 + (r / (2.0 * sigma[:, None])) ** 2))
        H, g = _weighted_normal(_sim3_jacobian(Y), wgt, res)
        return _truncated_step(s, R, t, H, g, ok.sum(-1))

    def gn_joint(s, R, t, Xj_m, ok_m):
        """One robust GN step on matched point-to-point plus ray-associated
        point-to-plane residuals, each set weighted by its own robust sigma
        (w = rho'/sigma^2), so the summed H is the edge's information."""
        Y = transform(s, R, t)
        res_m = Xj_m - Y
        r_m = torch.linalg.vector_norm(res_m, dim=-1)
        sig_m = torch.clamp(1.4826 * _masked_median(r_m, ok_m), min=sigma_floor)[:, None]
        w_m = ok_m * (1.0 / (1.0 + (r_m / (2.0 * sig_m)) ** 2)) / sig_m**2
        gi, gj, z = project_cells(Y)
        inb = (z > cfg.depth_min) & (gi >= 0) & (gi <= h - 1) & (gj >= 0) & (gj <= w - 1)
        Xs, vj = sample_sheet(gi, gj)
        cell = torch.clamp(torch.round(gi).long(), 0, h - 1) * w + torch.clamp(torch.round(gj).long(), 0, w - 1)
        nrm = torch.gather(nrm_flat, 1, cell[..., None].expand(-1, -1, 3))
        ok_p = Vi & inb & vj & torch.gather(plane_flat, 1, cell)
        r_p = (nrm * (Xs - Y)).sum(-1)
        sig_p = torch.clamp(1.4826 * _masked_median(r_p.abs(), ok_p), min=0.1 * sigma_floor)[:, None]
        w_p = ok_p * (1.0 / (1.0 + (r_p / (2.0 * sig_p)) ** 2)) / sig_p**2
        J = _sim3_jacobian(Y)
        Jp = torch.einsum("epa,epai->epi", nrm, J)[..., None, :]
        H_m, g_m = _weighted_normal(J, w_m, res_m)
        H_p, g_p = _weighted_normal(Jp, w_p, r_p[..., None])
        H = H_m + H_p
        return _truncated_step(s, R, t, H, g_m + g_p, ok_m.sum(-1)), (w_m * sig_m**2, r_m, H)

    s = torch.ones(E, device=dev)
    R = torch.eye(3, device=dev).repeat(E, 1, 1)
    t = torch.zeros(E, 3, device=dev)
    # feature-matching rounds: the first ungated, later ones gated
    for round_idx in range(cfg.match_rounds):
        Xj_m, m_ok, _ = match(s, R, t, 1e9 if round_idx == 0 else cfg.match_gate_cells)
        for _ in range(cfg.icp_iterations):
            s, R, t = gn_step(s, R, t, Xj_m, m_ok)
    # joint polish: matched (fixed) + point-to-plane (ray)
    Xj_m, m_ok, uv_m = match(s, R, t, cfg.match_gate_cells)
    for _ in range(cfg.polish_iterations):
        (s, R, t), _ = gn_joint(s, R, t, Xj_m, m_ok)
    # final statistics and the joint information matrix
    _, (wgt, r, H) = gn_joint(s, R, t, Xj_m, m_ok)
    n_in = ((wgt > 0.5) & m_ok).sum(-1)  # robust weight above half
    rms = torch.sqrt((wgt * r * r).sum(-1) / torch.clamp(wgt.sum(-1), min=1e-9))
    return {
        "scale": s, "R": R, "t": t, "n_inliers": n_in, "rms": rms,
        "H": H / torch.clamp(n_in, min=1).float()[:, None, None],
        "u_tgt": uv_m * subsample + subsample / 2.0,
        "m_ok": m_ok,
    }


@f32_matmul
def map_validity(coords, mask_lr, poses_w2c, focals, ppx: float, ppy: float, grid,
                 depth_min: float, depth_max: float, own_reproj_px: float):
    """Validity of each predicted cell of coords (N, h, w, 3): canvas
    content, camera depth in band, and own-frame reprojection within
    `own_reproj_px` of the cell centre `grid` (h, w, 2)."""
    pc = torch.einsum("nhwc,ndc->nhwd", coords, poses_w2c[:, :3, :3]) + poses_w2c[:, None, None, :3, 3]
    z = pc[..., 2]
    zs = torch.where(z.abs() < 1e-6, torch.full_like(z, 1e-6), z)
    f = focals[:, None, None]
    err = torch.hypot(f * pc[..., 0] / zs + ppx - grid[..., 0], f * pc[..., 1] / zs + ppy - grid[..., 1])
    return mask_lr & (z > depth_min) & (z < depth_max) & (err < own_reproj_px)


OVERLAP_ROWS = 64  # frames per chunk of view_overlap_matrix: (64, M, P, 3) points


@f32_matmul
def view_overlap_matrix(pts, valid, w2c, focal, ppx: float, ppy: float, h_img: float, w_img: float,
                        depth_min: float):
    """O[i, j] = fraction of frame i's valid points (pts (M, P, 3), valid
    (M, P)) that land in camera j's image in front of it; rows in chunks
    of OVERLAP_ROWS to bound memory."""
    R, t = w2c[:, :3, :3], w2c[:, :3, 3]
    n_valid = torch.clamp(valid.sum(-1), min=1)
    out = []
    rows = OVERLAP_ROWS
    for r0 in range(0, len(pts), rows):
        pc = torch.einsum("ipc,jdc->ijpd", pts[r0 : r0 + rows], R) + t[None, :, None, :]
        z = pc[..., 2]
        zs = torch.where(z.abs() < 1e-6, torch.full_like(z, 1e-6), z)
        u = focal[None, :, None] * pc[..., 0] / zs + ppx
        v = focal[None, :, None] * pc[..., 1] / zs + ppy
        inb = (z > depth_min) & (u >= 0) & (u < w_img) & (v >= 0) & (v < h_img)
        out.append((inb & valid[r0 : r0 + rows, None, :]).sum(-1) / n_valid[r0 : r0 + rows, None])
    return torch.cat(out)


@functools.lru_cache(maxsize=1)
def _shipped_projection() -> np.ndarray:
    return np.load(PROJ_FILE)


def feature_projection(channels: int, feature_dim: int) -> torch.Tensor:
    """The JAX package's (channels, feature_dim) matching projection; only
    its 512 x 96 draw ships, other shapes need `proj` passed explicitly."""
    proj = _shipped_projection()
    if proj.shape != (channels, feature_dim):
        raise ValueError(f"the shipped feature projection is {proj.shape}; pass proj for "
                         f"({channels}, {feature_dim})")
    return torch.from_numpy(proj)


@torch.inference_mode()
def coords_feats_chunk(encoder_params, head_params, head_cfg, images_u8, sizes, feature_dim: int = 96,
                       subsample: int = 8, proj: torch.Tensor | None = None):
    """Coordinate maps (B, h, w, 3), cell mask (B, h, w) and matching
    features (B, h, w, feature_dim) of one chunk of canvases.

    As registration.driver.coords_chunk (encoder -> head, through K1 on the
    card), plus the encoder's cell features times a fixed random projection
    (512 -> feature_dim keeps the cosine structure), L2-normalized. `proj`
    (C, feature_dim) replaces the JAX package's draw."""
    images, mask_lr, _, _, _ = _canvas_prologue(images_u8, sizes, subsample)
    feats = encoder_apply(encoder_params, images)
    coords = head_apply_image(head_params, head_cfg, feats)
    if proj is None:
        proj = feature_projection(feats.shape[-1], feature_dim)
    with no_tf32():
        fp = feats.float() @ proj.to(feats.device, torch.float32)
    fp = fp / torch.clamp(torch.linalg.vector_norm(fp, dim=-1, keepdim=True), min=1e-8)
    return coords, mask_lr, fp


# --------------------------------------------------------------------- host


def _sim3_mul(a, b):
    """(s, R, t) composition a ∘ b, action x -> s R x + t."""
    sa, Ra, ta = a
    sb, Rb, tb = b
    return sa * sb, Ra @ Rb, sa * Ra @ tb + ta


def _sim3_inv(a):
    sa, Ra, ta = a
    return 1.0 / sa, Ra.T, -(1.0 / sa) * (Ra.T @ ta)


def _rotlog(R: np.ndarray) -> np.ndarray:
    from scipy.spatial.transform import Rotation

    return Rotation.from_matrix(R).as_rotvec()


def _rotexp(w: np.ndarray) -> np.ndarray:
    from scipy.spatial.transform import Rotation

    return Rotation.from_rotvec(w).as_matrix()


def solve_pose_graph(
    n: int,
    pairs: np.ndarray,  # (E, 2) int — constraint S_i = S_j ∘ M_ij
    m_scale: np.ndarray,  # (E,)
    m_R: np.ndarray,  # (E, 3, 3)
    m_t: np.ndarray,  # (E, 3)
    weights: np.ndarray,  # (E,) scalar edge weights
    cfg: LoopCloseConfig = LoopCloseConfig(),
    infos: np.ndarray | None = None,  # (E, 7, 7) per-edge information
):
    """Per-frame Sim(3) corrections from pairwise sheet-misalignment edges.

    Information-form Gauss-Newton (a copy of the JAX package's numpy
    solver): each edge contributes its 7x7 information block (rotation,
    translation, log-scale) with the eigenvalue spread capped at
    `info_condition_cap` and unit-trace normalization, or the identity with
    `infos=None`. Left increments, re-linearized each outer round; one
    (7n x 7n) block-Laplacian solve per round; Geman-McClure reweighting by
    Mahalanobis residual between rounds (with a hard cut at 2.5); gauge
    anchored at frame 0.

    Returns (scales (n,), R (n, 3, 3), t (n, 3), diag dict).
    """
    E = len(pairs)
    if E == 0 or n == 0:
        return np.ones(n), np.tile(np.eye(3), (n, 1, 1)), np.zeros((n, 3)), {
            "edges": 0, "residual_rot_deg": 0.0, "residual_t": 0.0,
        }
    w_base = weights.astype(np.float64).copy()
    if infos is None:
        lam = np.broadcast_to(np.eye(7), (E, 7, 7)).copy()
    else:
        lam = infos.astype(np.float64).copy()
        lam = 0.5 * (lam + np.transpose(lam, (0, 2, 1)))
        evals, evecs = np.linalg.eigh(lam)
        emax = np.maximum(evals[:, -1:], 1e-12)
        evals = np.clip(evals, emax / cfg.info_condition_cap, None)
        lam = np.einsum("eab,eb,ecb->eac", evecs, evals, evecs)
        lam *= (7.0 / np.trace(lam, axis1=1, axis2=2))[:, None, None]
    i, j = pairs[:, 0], pairs[:, 1]

    s = np.ones(n)
    R = np.tile(np.eye(3), (n, 1, 1))
    t = np.zeros((n, 3))
    w_rob = np.ones(E)
    diag = {}

    for outer in range(cfg.graph_iterations):
        # edge residuals E_e = S_i^{-1} ∘ S_j ∘ M_ij
        s_jm = s[j] * m_scale
        R_jm = np.einsum("eab,ebc->eac", R[j], m_R)
        t_jm = s[j, None] * np.einsum("eab,eb->ea", R[j], m_t) + t[j]
        R_err = np.einsum("eba,ebc->eac", R[i], R_jm)
        t_err = np.einsum("eba,eb->ea", R[i], t_jm - t[i]) / s[i, None]
        s_err = s_jm / s[i]
        f = np.concatenate([_rotlog(R_err), t_err, np.log(s_err)[:, None]], axis=1)  # (E, 7)

        # robust reweighting (skipped on the first round: f starts at the
        # raw measurement, which is signal)
        if outer > 0:
            z2 = np.einsum("ea,eab,eb->e", f, lam, f)
            z = np.sqrt(np.maximum(z2, 0.0))
            sig_z = max(1.4826 * np.median(z), 1e-8)
            u = z / (3.0 * sig_z)
            w_rob = np.where(u > 2.5, 0.0, 1.0 / (1.0 + u * u))

        w = (w_base * w_rob)[:, None, None] * lam  # (E, 7, 7)

        # the block Laplacian of x_i - x_j = f_e
        A = np.zeros((n, 7, n, 7))
        b = np.zeros((n, 7))
        np.add.at(A, (i, slice(None), i, slice(None)), w)
        np.add.at(A, (j, slice(None), j, slice(None)), w)
        np.add.at(A, (i, slice(None), j, slice(None)), -w)
        np.add.at(A, (j, slice(None), i, slice(None)), -w)
        wf = np.einsum("eab,eb->ea", w, f)
        np.add.at(b, i, wf)
        np.add.at(b, j, -wf)
        A = A.reshape(7 * n, 7 * n)
        b = b.reshape(7 * n)
        anchor = 10.0 * max(float(np.trace(A)) / max(n, 1), 1.0)
        A[:7, :7] += anchor * np.eye(7)
        A += 1e-9 * np.trace(A) / (7 * n) * np.eye(7 * n)
        x = np.linalg.solve(A, b).reshape(n, 7)

        # left increments S_k <- exp(x_k) ∘ S_k
        dR = _rotexp(x[:, :3])
        s = np.exp(x[:, 6]) * s
        t = np.exp(x[:, 6, None]) * np.einsum("nab,nb->na", dR, t) + x[:, 3:6]
        R = np.einsum("nab,nbc->nac", dR, R)

        rr = np.degrees(np.linalg.norm(f[:, :3], axis=-1))
        rt = np.linalg.norm(f[:, 3:6], axis=-1)
        diag = {"edges": E, "residual_rot_deg": float(np.median(rr)), "residual_t": float(np.median(rt)),
                "outer": outer}

    # re-anchor the gauge exactly at frame 0
    G = _sim3_inv((s[0], R[0], t[0]))
    for k in range(n):
        s[k], R[k], t[k] = _sim3_mul(G, (s[k], R[k], t[k]))
    return s, R, t, diag


def select_pairs(overlap: np.ndarray, k: int, min_overlap: float = 0.2) -> np.ndarray:
    """Directed top-k co-visible pairs per frame, scored by the mutual
    overlap min(O_ij, O_ji); pairs under `min_overlap` are dropped."""
    m = len(overlap)
    k = min(k, m - 1)
    if k <= 0:
        return np.zeros((0, 2), np.int64)
    mutual = np.minimum(overlap, overlap.T).astype(np.float64)
    np.fill_diagonal(mutual, -1.0)
    nn = np.argsort(-mutual, axis=1)[:, :k]
    src = np.repeat(np.arange(m), k)
    pairs = np.stack([src, nn.reshape(-1)], axis=1)
    score = mutual[pairs[:, 0], pairs[:, 1]]
    return pairs[score >= min_overlap]


def loop_close_core(
    coords,  # (n, h, w, 3) predicted coordinate maps, scene frame order (tensor)
    feats,  # (n, h, w, F) L2-normalized per-cell matching features
    mask_lr,  # (n, h, w) canvas-content mask
    w2c_scene: np.ndarray,  # (n, 4, 4) current poses, scene order
    conf_scene: np.ndarray,  # (n,)
    focals_canvas: np.ndarray,  # (n,)
    canvas_hw: tuple[int, int],
    conf_threshold: float,
    cfg: LoopCloseConfig = LoopCloseConfig(),
):
    """Per-frame Sim(3) corrections from the coordinate maps, on coords'
    device. Returns (s_all (n,), R_all (n, 3, 3), t_all (n, 3), diag):
    identity for every frame when the stage skips (diag["skipped"] says
    why); otherwise diag carries the edge statistics and `ba_data`, the
    matches for the BA."""
    coords = torch.as_tensor(coords)
    dev = coords.device
    feats = torch.as_tensor(feats, device=dev)
    mask_lr = torch.as_tensor(mask_lr, device=dev)
    n = len(w2c_scene)
    H, W = canvas_hw
    sub = 8
    s_id = np.ones(n)
    R_id = np.tile(np.eye(3), (n, 1, 1))
    t_id = np.zeros((n, 3))

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    valid = map_validity(coords, mask_lr, f32(w2c_scene), f32(focals_canvas), W / 2.0, H / 2.0,
                         get_pixel_grid(H // sub, W // sub, sub, device=dev), cfg.depth_min, cfg.depth_max,
                         cfg.own_reproj_px)

    # scene scale for the robust floor (5-95% bbox diagonal of valid coords)
    cv = coords.cpu().numpy()
    vv = valid.cpu().numpy()
    pts = cv[vv]
    if len(pts) < 100:
        return s_id, R_id, t_id, {"skipped": "no_valid_points"}
    lo, hi = np.percentile(pts, [5, 95], axis=0)
    diag_len = float(np.linalg.norm(hi - lo))
    sigma_floor = cfg.sigma_floor_rel * max(diag_len, 1e-6)

    # graph frames and pairs
    graph_idx = np.where(conf_scene >= conf_threshold)[0]
    if len(graph_idx) < 3:
        return s_id, R_id, t_id, {"skipped": "too_few_frames"}
    c2w_all = np.linalg.inv(w2c_scene)
    centers = c2w_all[graph_idx, :3, 3]

    step = cfg.sample_step
    h, w = coords.shape[1:3]
    src_all = coords[:, ::step, ::step].reshape(n, -1, 3)
    srcf_all = feats[:, ::step, ::step].reshape(n, -1, feats.shape[-1])
    srcv_all = valid[:, ::step, ::step].reshape(n, -1)

    # co-visibility graph from measured view overlap (camera-centre
    # proximity is meaningless for convergent captures)
    ostep = max(1, 4 // step)
    g_dev = torch.as_tensor(graph_idx, device=dev)
    overlap = view_overlap_matrix(src_all[g_dev][:, ::ostep], srcv_all[g_dev][:, ::ostep],
                                  f32(w2c_scene[graph_idx]), f32(focals_canvas[graph_idx]), W / 2.0, H / 2.0,
                                  float(H), float(W), cfg.depth_min).cpu().numpy()
    pairs_local = select_pairs(overlap, cfg.neighbors, cfg.min_pair_overlap)
    if len(pairs_local) < 2:
        return s_id, R_id, t_id, {"skipped": "too_few_covisible_pairs"}
    pairs = graph_idx[pairs_local]  # scene-frame indices (E, 2)
    E = len(pairs)
    out = {"scale": [], "R": [], "t": [], "n_inliers": [], "rms": [], "H": [], "u_tgt": [], "m_ok": []}
    chunk_e = min(cfg.pair_chunk, E)
    for c0 in range(0, E, chunk_e):
        pc = pairs[c0 : c0 + chunk_e]
        si = torch.as_tensor(pc[:, 0], device=dev)
        ti = torch.as_tensor(pc[:, 1], device=dev)
        res = pairwise_sim3(src_all[si], srcf_all[si], srcv_all[si], coords[ti], feats[ti], valid[ti],
                            f32(w2c_scene[pc[:, 1]]), f32(focals_canvas[pc[:, 1]]), W / 2.0, H / 2.0,
                            sigma_floor, cfg, subsample=sub)
        for k in out:
            out[k].append(res[k].cpu().numpy())
    m_scale = np.concatenate(out["scale"]).astype(np.float64)
    m_R = np.concatenate(out["R"]).astype(np.float64)
    m_t = np.concatenate(out["t"]).astype(np.float64)
    n_in = np.concatenate(out["n_inliers"]).astype(np.float64)
    rms = np.concatenate(out["rms"]).astype(np.float64)
    m_H = np.concatenate(out["H"]).astype(np.float64)
    m_u_tgt = np.concatenate(out["u_tgt"]).astype(np.float32)
    m_okm = np.concatenate(out["m_ok"])

    good = n_in >= cfg.min_pair_points
    # rms gate: a wrong-basin fit shows up as an rms outlier among its peers
    if good.any():
        med_rms = np.median(rms[good])
        good &= rms <= cfg.rms_gate * max(med_rms, sigma_floor)
    # forward/backward cycle: where both (i, j) and (j, i) were measured,
    # M_ij ∘ M_ji must be ~identity; rotation and scale errors become lengths
    # over half the scene diagonal
    eidx = {(int(i), int(j)): e for e, (i, j) in enumerate(pairs)}
    cyc = np.full(E, np.nan)
    for e, (i, j) in enumerate(pairs):
        e2 = eidx.get((int(j), int(i)))
        if e2 is None or not (good[e] and good[e2]):
            continue
        C = _sim3_mul((m_scale[e], m_R[e], m_t[e]), (m_scale[e2], m_R[e2], m_t[e2]))
        cyc[e] = np.linalg.norm(C[2]) + (np.linalg.norm(_rotlog(C[1])) + abs(np.log(C[0]))) * 0.5 * diag_len
    has_cyc = np.isfinite(cyc)
    if has_cyc.any():
        cyc_lim = cfg.cycle_gate * max(np.median(cyc[has_cyc]), 2.0 * sigma_floor)
        good &= ~(has_cyc & (cyc > cyc_lim))
    if good.sum() < 2:
        return s_id, R_id, t_id, {"skipped": "too_few_pairs"}
    # graph weights: sqrt of the inlier count (tempers hub frames)
    weights = np.sqrt(n_in) * good

    remap = -np.ones(n, np.int64)
    remap[graph_idx] = np.arange(len(graph_idx))
    pairs_g = remap[pairs]
    s_g, R_g, t_g, gdiag = solve_pose_graph(len(graph_idx), pairs_g[good], m_scale[good], m_R[good], m_t[good],
                                            weights[good], cfg, infos=m_H[good])

    # a frame whose edges were all wrong (or that has none left) can get a
    # wild correction: it inherits the nearest sane frame's instead
    t_mag = np.linalg.norm(t_g, axis=1)
    r_mag = np.linalg.norm(np.stack([_rotlog(R_g[k]) for k in range(len(R_g))]), axis=1)
    t_lim = max(10.0 * np.median(t_mag), 0.25 * diag_len)
    r_lim = max(10.0 * np.median(r_mag), np.radians(30.0))
    has_edge = np.zeros(len(graph_idx), bool)
    has_edge[pairs_g[good].ravel()] = True
    sane = has_edge & (t_mag <= t_lim) & (r_mag <= r_lim) & (np.abs(np.log(s_g)) <= 0.5)
    if not sane.all():
        if not sane.any():
            return s_id, R_id, t_id, {"skipped": "all_corrections_insane"}
        gcent = c2w_all[graph_idx, :3, 3]
        for k in np.where(~sane)[0]:
            d = np.linalg.norm(gcent[sane] - gcent[k], axis=-1)
            src = np.where(sane)[0][np.argmin(d)]
            s_g[k], R_g[k], t_g[k] = s_g[src], R_g[src], t_g[src]
        _logger.info("loop closure: clamped %d insane corrections", int((~sane).sum()))

    s_all, R_all, t_all = s_id, R_id, t_id
    s_all[graph_idx], R_all[graph_idx], t_all[graph_idx] = s_g, R_g, t_g
    non_graph = np.where(remap < 0)[0]
    if len(non_graph):
        d = np.linalg.norm(c2w_all[non_graph, :3, 3][:, None] - centers[None], axis=-1)
        nearest = graph_idx[np.argmin(d, axis=1)]
        s_all[non_graph] = s_all[nearest]
        R_all[non_graph] = R_all[nearest]
        t_all[non_graph] = t_all[nearest]

    # the BA's source pixels: the strided source-cell centres (one grid for
    # every source frame, row-major like the ::step reshape)
    ii = np.arange(0, h, step) * sub + sub / 2.0
    jj = np.arange(0, w, step) * sub + sub / 2.0
    u_src = np.stack([np.tile(jj, len(ii)), np.repeat(ii, len(jj))], -1).astype(np.float32)

    diag = {
        "edges": int(good.sum()),
        "median_edge_rms": float(np.median(rms[good])),
        "median_corr_t": float(np.median(np.linalg.norm(t_g, axis=1))),
        "median_corr_rot_deg": float(np.median(np.degrees(np.linalg.norm(_rotlog(R_g), axis=1)))),
        "scene_diag": float(diag_len),
        "ba_data": {
            # indices into the core's input frames, as the corrections
            "pairs": pairs[good],
            "u_src": u_src,
            "u_tgt": m_u_tgt[good],
            "ok": np.asarray(m_okm[good]),
            "valid": vv,  # per-frame map validity (the subpix prewarp)
        },
        **{f"graph_{k}": v for k, v in gdiag.items()},
    }
    return s_all, R_all, t_all, diag


def loop_close_entries(
    encoder_params,
    head_params,
    head_cfg,
    scene,
    entries,
    conf_threshold: float,
    focal_override_orig: float | None = None,
    cfg: LoopCloseConfig = LoopCloseConfig(),
    max_frames: int = 256,
    device=None,
):
    """Estimate and apply Sim(3) loop-closure corrections to pose entries.

    At most `max_frames` confident frames, evenly strided over scene order,
    form the pose graph; every frame is corrected (non-graph frames take the
    nearest graph frame's correction). Parameters must be on `device`
    (default cuda). Returns (corrected entries, diagnostics)."""
    device = resolve_device(device)
    n = len(scene)
    by_file = {f: k for k, f in enumerate(scene.rgb_files)}
    order = np.asarray([by_file[e.rgb_file] for e in entries])
    H, W = scene.images.canvas_hw

    if focal_override_orig is not None:
        focals_canvas = np.asarray(focal_override_orig * scene.images.scale_factors, np.float32)
    else:
        focals_canvas = np.asarray(scene.focals_canvas, np.float32)

    # poses in scene order
    w2c = np.stack([e.pose_w2c for e in entries]).astype(np.float64)
    conf = np.asarray([e.confidence for e in entries])
    w2c_scene = np.empty_like(w2c)
    conf_scene = np.empty_like(conf)
    w2c_scene[order] = w2c
    conf_scene[order] = conf

    # graph frames: confident frames, evenly strided over scene order
    cand = np.where(conf_scene >= conf_threshold)[0]
    if len(cand) < 3:
        return entries, {"skipped": "too_few_frames"}
    if len(cand) > max_frames:
        sub = cand[np.round(np.linspace(0, len(cand) - 1, max_frames)).astype(int)]
    else:
        sub = cand
    ns = len(sub)

    # coordinate maps and matching features of the graph frames, in chunks
    # of 64 frames
    coords_list, mask_list, feat_list = [], [], []
    for c0 in range(0, ns, 64):
        cc, mm, ff = coords_feats_chunk(encoder_params, head_params, head_cfg,
                                        *_chunk_images(scene, sub[c0 : c0 + 64], device),
                                        feature_dim=cfg.feature_dim)
        coords_list.append(cc)
        mask_list.append(mm)
        feat_list.append(ff)
    coords = torch.cat(coords_list)
    mask_lr = torch.cat(mask_list)
    feats = torch.cat(feat_list)

    s_sub, R_sub, t_sub, diag = loop_close_core(coords, feats, mask_lr, w2c_scene[sub], conf_scene[sub],
                                                focals_canvas[sub], (H, W), conf_threshold, cfg)
    if "skipped" in diag:
        _logger.warning("loop closure skipped: %s", diag["skipped"])
        return entries, diag

    # extend to all scene frames: nearest graph camera centre
    s_all = np.ones(n)
    R_all = np.tile(np.eye(3), (n, 1, 1))
    t_all = np.zeros((n, 3))
    s_all[sub], R_all[sub], t_all[sub] = s_sub, R_sub, t_sub
    c2w_all = np.linalg.inv(w2c_scene)
    rest = np.setdiff1d(np.arange(n), sub)
    nearest_of_rest = rest
    if len(rest):
        d = np.linalg.norm(c2w_all[rest, :3, 3][:, None] - c2w_all[sub, :3, 3][None], axis=-1)
        nearest_of_rest = sub[np.argmin(d, axis=1)]
        s_all[rest] = s_all[nearest_of_rest]
        R_all[rest] = R_all[nearest_of_rest]
        t_all[rest] = t_all[nearest_of_rest]

    # c2w' = S_i ∘ c2w: the rigid part moves the camera with its sheet, the
    # scale moves the camera centre
    c2w_corr = np.tile(np.eye(4), (n, 1, 1))
    c2w_corr[:, :3, :3] = R_all @ c2w_all[:, :3, :3]
    c2w_corr[:, :3, 3] = s_all[:, None] * np.einsum("nab,nb->na", R_all, c2w_all[:, :3, 3]) + t_all

    # track BA on the matcher's correspondences: drains the non-rigid bend
    # the per-frame corrections cannot express; non-graph frames take the
    # nearest graph frame's rigid delta
    ba_data = diag.pop("ba_data", None)
    run_ba = cfg.ba in ("raw", "subpix") and ba_data is not None and len(ba_data["pairs"]) >= 2
    if run_ba and cfg.ba == "subpix":
        # full-resolution photometric correspondences; the BA takes only
        # the accepted ones
        with stage("loop_closure_subpix"):
            u_ref, ok_ref, sp_diag = refine_matches_photometric(
                scene.images.content(sub), coords, ba_data["valid"], w2c_scene[sub], focals_canvas[sub],
                (H, W), ba_data["pairs"], ba_data["u_src"], ba_data["u_tgt"], ba_data["ok"],
            )
        diag["subpix"] = sp_diag
        _logger.info("Sub-pixel refinement: %d/%d matches accepted (median zncc %.3f, median shift %.2f px)",
                     sp_diag["n_accepted"], sp_diag["n_selected"], sp_diag["median_zncc"],
                     sp_diag["median_shift_px"])
        if sp_diag["n_accepted"] >= cfg.subpix_min_matches:
            ba_data["u_tgt"], ba_data["ok"] = u_ref, ok_ref
        else:
            run_ba = False
            diag["ba"] = {"skipped": "too_few_refined_matches"}
    if run_ba:
        Epairs = len(ba_data["pairs"])
        w2c_ba, ba_diag = refine_poses_ba(
            np.linalg.inv(c2w_corr[sub]), focals_canvas[sub], (W / 2.0, H / 2.0), ba_data["pairs"],
            np.broadcast_to(ba_data["u_src"][None], (Epairs,) + ba_data["u_src"].shape), ba_data["u_tgt"],
            ba_data["ok"], iterations=cfg.ba_iterations, max_obs=cfg.ba_max_obs, prior=cfg.ba_prior,
            device=device,
        )
        diag["ba"] = ba_diag
        if "skipped" not in ba_diag:
            D = np.linalg.inv(w2c_ba) @ np.linalg.inv(c2w_corr[sub])
            nearest_all = np.empty(n, np.int64)
            nearest_all[sub] = np.arange(ns)
            if len(rest):
                sub_pos = {int(f): p for p, f in enumerate(sub)}
                nearest_all[rest] = [sub_pos[int(f)] for f in nearest_of_rest]
            c2w_corr = D[nearest_all] @ c2w_corr
            _logger.info("BA polish: %d tracks, rms %.2f -> %.2f px", ba_diag["n_tracks"],
                         ba_diag["rms_px_first"], ba_diag["rms_px_last"])

    new_entries = [PoseFileEntry(rgb_file=e.rgb_file, pose_w2c=np.linalg.inv(c2w_corr[by_file[e.rgb_file]]),
                                 focal_length=e.focal_length, confidence=e.confidence) for e in entries]
    _logger.info(
        "Loop closure: %d edges, median sheet rms %.4f, median correction %.1f cm / %.2f deg "
        "(graph residual %.2f deg / %.1f cm)",
        diag["edges"], diag["median_edge_rms"], diag["median_corr_t"] * 100, diag["median_corr_rot_deg"],
        diag.get("graph_residual_rot_deg", 0.0), diag.get("graph_residual_t", 0.0) * 100,
    )
    return new_entries, diag
