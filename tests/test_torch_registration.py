"""The port's registrar (P3P, LM, RANSAC, two-tier refit) against acezero_tpu."""

import os
import sys
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from test_registration import _make_scene, _render_synthetic_frame  # noqa: E402

from acezero_tpu import registration as jreg  # noqa: E402
from acezero_tpu_torch import registration as treg  # noqa: E402
from acezero_tpu_torch.geometry import backproject_depth, get_pixel_grid  # noqa: E402
from acezero_tpu_torch.registration import driver as tdrv  # noqa: E402

SCENE = "results/heldout/scenes/chesslike_a"


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


@pytest.mark.parametrize(
    "coeffs",
    [np.poly([1.0, 2.0, -3.0, 0.5]), -2.5 * np.poly([1.0, 2.0, -3.0, 0.5]),
     np.array([1.0, 0, 0, 0, 1.0]), np.poly([2.0, -5.0, 1j, -1j]).real],
)
def test_solve_quartic_matches_jax(coeffs):
    c = np.asarray(coeffs, np.float32)[None]
    r_j, v_j = jreg.solve_quartic(jnp.asarray(c))
    r_t, v_t = treg.solve_quartic(_t(c))
    np.testing.assert_array_equal(v_t.numpy(), np.asarray(v_j))
    valid = np.asarray(v_j)
    np.testing.assert_allclose(r_t.numpy()[valid], np.asarray(r_j)[valid], atol=1e-4)


def test_p3p_matches_jax(rng):
    pts, R_true, t_true, bearings = _make_scene(rng)
    R_j, t_j, v_j = jreg.p3p_grunert(jnp.asarray(pts[None], jnp.float32), jnp.asarray(bearings[None], jnp.float32))
    R_t, t_t, v_t = treg.p3p_grunert(_t(pts[None]), _t(bearings[None]))
    v = np.asarray(v_j)[0]
    np.testing.assert_array_equal(v_t.numpy()[0], v)
    np.testing.assert_allclose(R_t.numpy()[0][v], np.asarray(R_j)[0][v], atol=1e-4)
    np.testing.assert_allclose(t_t.numpy()[0][v], np.asarray(t_j)[0][v], atol=1e-4)
    errs = [np.linalg.norm(R_t.numpy()[0, i] - R_true) + np.linalg.norm(t_t.numpy()[0, i] - t_true)
            for i in range(4) if v[i]]
    assert min(errs) < 5e-3

    # batch of random (mostly degenerate) problems: same shapes, same validity
    P = rng.normal(size=(7, 5, 3, 3)).astype(np.float32)
    b = rng.normal(size=(7, 5, 3, 3))
    b = (b / np.linalg.norm(b, axis=-1, keepdims=True)).astype(np.float32)
    R_j, t_j, v_j = jreg.p3p_grunert(jnp.asarray(P), jnp.asarray(b))
    R_t, t_t, v_t = treg.p3p_grunert(_t(P), _t(b))
    assert R_t.shape == (7, 5, 4, 3, 3) and t_t.shape == (7, 5, 4, 3) and v_t.shape == (7, 5, 4)
    assert np.mean(v_t.numpy() == np.asarray(v_j)) > 0.97


def test_reprojection_errors_match_jax(rng):
    pts = (rng.normal(size=(50, 3)) + [0, 0, 5]).astype(np.float32)
    pts[:3, 2] = -1.0  # behind the camera
    px = rng.uniform(0, 640, size=(50, 2)).astype(np.float32)
    rvec = np.array([0.05, -0.1, 0.02], np.float32)
    tvec = np.array([0.1, 0.2, -0.3], np.float32)
    want = jreg.reprojection_errors(jnp.asarray(rvec), jnp.asarray(tvec), jnp.asarray(pts),
                                    jnp.asarray(px), 500.0, 320.0, 240.0, 100.0)
    got = treg.reprojection_errors(_t(rvec), _t(tvec), _t(pts), _t(px), 500.0, 320.0, 240.0, 100.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3)
    assert (got.numpy()[:3] == 100.0).all()


def test_lm_pnp_matches_jax(rng):
    from scipy.spatial.transform import Rotation

    n, focal, ppx, ppy = 200, 500.0, 320.0, 240.0
    pts, R_true, t_true, _ = _make_scene(rng, n=n)
    rvec_true = Rotation.from_matrix(R_true).as_rotvec()
    p_cam = pts @ R_true.T + t_true
    px = np.stack([focal * p_cam[:, 0] / p_cam[:, 2] + ppx, focal * p_cam[:, 1] / p_cam[:, 2] + ppy], 1)
    rvec0 = rvec_true + rng.normal(size=3) * 0.05
    tvec0 = t_true + rng.normal(size=3) * 0.1
    w = (rng.uniform(size=n) > 0.2).astype(np.float32)
    args = (rvec0, tvec0, pts, px, w)
    r_j, t_j, c_j = jreg.lm_pnp(*(jnp.asarray(a, jnp.float32) for a in args), focal, ppx, ppy, iterations=15)
    r_t, t_t, c_t = treg.lm_pnp(*(_t(a) for a in args), focal, ppx, ppy, iterations=15)
    np.testing.assert_allclose(r_t.numpy(), np.asarray(r_j), atol=1e-4)
    np.testing.assert_allclose(t_t.numpy(), np.asarray(t_j), atol=2e-4)
    np.testing.assert_allclose(r_t.numpy(), rvec_true, atol=1e-3)
    assert float(c_t) < 1e-3


def _jax_draws(key, mask, H, T):
    logits = jnp.where(jnp.asarray(mask).reshape(-1), 0.0, -jnp.inf)
    return torch.from_numpy(np.array(jax.random.categorical(key, logits, shape=(H, T, 4))))


def _rot_err_deg(Ra, Rb):
    c = np.clip((np.trace(Ra @ Rb.T) - 1) / 2, -1, 1)
    return np.degrees(np.arccos(c))


@pytest.mark.parametrize("case", ["outliers", "masked"])
def test_estimate_pose_injected_draws_match_jax(rng, case):
    if case == "outliers":
        pts_w, _, grid, focal, ppx, ppy = _render_synthetic_frame(rng, noise=0.005, outlier_frac=0.4)
        mask = np.ones(pts_w.shape[:2], bool)
    else:
        pts_w, _, grid, focal, ppx, ppy = _render_synthetic_frame(rng)
        pts_w = pts_w.copy()
        pts_w[:, 16:] = 1e3
        mask = np.ones(pts_w.shape[:2], bool)
        mask[:, 16:] = False
    cfg_j = jreg.RansacConfig(hypotheses=16, max_tries=8, refinement_steps=8)
    cfg_t = treg.RansacConfig(hypotheses=16, max_tries=8, refinement_steps=8)
    key = jax.random.PRNGKey(11)
    out_j = jax.device_get(jreg.estimate_pose(key, jnp.asarray(pts_w, jnp.float32), jnp.asarray(mask),
                                              jnp.asarray(grid, jnp.float32), focal, ppx, ppy, cfg_j))
    out_t = treg.estimate_pose(_t(pts_w), torch.from_numpy(mask), _t(grid), focal, ppx, ppy, cfg_t,
                               hyp_indices=_jax_draws(key, mask, 16, 8))
    assert bool(out_t["valid"]) == bool(out_j["valid"]) is True
    P_t, P_j = out_t["pose_c2w"].numpy().astype(np.float64), out_j["pose_c2w"].astype(np.float64)
    assert np.linalg.norm(P_t[:3, 3] - P_j[:3, 3]) < 1e-3
    assert _rot_err_deg(P_t[:3, :3], P_j[:3, :3]) < 0.05
    n_t, n_j = int(out_t["inlier_count"]), int(out_j["inlier_count"])
    assert abs(n_t - n_j) <= max(1, 0.01 * n_j)
    assert int(out_t["inlier_count"]) <= int(mask.sum())


def test_two_tier_refit_equals_full_budget(rng):
    """A short-cap pass plus a full-budget rerun with the same draws is
    bit-equal to one full-budget pass (the contract register_frames keeps)."""
    pts_w, _, grid, focal, ppx, ppy = _render_synthetic_frame(rng, noise=0.02, outlier_frac=0.5)
    mask = np.ones(pts_w.shape[:2], bool)
    cfg_full = treg.RansacConfig(hypotheses=16, max_tries=8, refinement_steps=40)
    draws = _jax_draws(jax.random.PRNGKey(7), mask, 16, 8)  # the draws of the JAX test
    args = (_t(pts_w), torch.from_numpy(mask), _t(grid), focal, ppx, ppy)
    out_t1 = treg.estimate_pose(*args, replace(cfg_full, refinement_steps=2), hyp_indices=draws)
    out_full = treg.estimate_pose(*args, cfg_full, hyp_indices=draws)
    out_rerun = treg.estimate_pose(*args, cfg_full, max_refine_steps=40, hyp_indices=draws)
    assert bool(out_t1["hit_cap"]), "tier-1 cap was not hit; raise noise"
    for k in out_full:
        assert torch.equal(out_rerun[k], out_full[k]), k


def test_two_tier_driver_composition(monkeypatch):
    """register_frames with the two-tier budget returns entries equal to a
    single full-budget pass; scene coordinates are stubbed with noisy
    ground-truth maps so frames really hit the tier-1 cap."""
    from acezero_tpu_torch.data.scene import load_scene

    scene = load_scene(f"{SCENE}/frame_000[0-7].png", image_short_size=120, external_focal_length=520.0,
                       num_workers=2)
    n, h, w = len(scene), 15, 20
    rng = np.random.default_rng(11)
    maps = rng.uniform(-3, 3, size=(n, h, w, 3)).astype(np.float32)
    gt = _gt_maps(scene, sub=32)  # (n, 15, 20, 3): 120 px canvas, f = 130
    noisy = gt + rng.normal(0, 0.1, gt.shape)
    keep = rng.uniform(size=(n, h, w)) > 0.4
    maps[keep] = noisy[keep]

    # each canvas carries its frame index in its first pixel
    scene.images.canvases[:, 0, 0] = np.arange(n, dtype=np.uint8)

    def fake_coords(_enc, _head, _cfg, images, sizes, subsample=8):
        idx = images[:, 0, 0].long()
        return torch.from_numpy(maps)[idx], torch.ones((len(idx), h, w), dtype=torch.bool)

    monkeypatch.setattr(tdrv, "coords_chunk", fake_coords)
    base = dict(ransac=treg.RansacConfig(hypotheses=8, max_tries=8, refinement_steps=40), frame_chunk=4)
    logs = []
    monkeypatch.setattr(tdrv._logger, "info", lambda msg, *a: logs.append(msg % a))
    tiered = tdrv.register_frames(None, None, None, scene, tdrv.RegistrationConfig(**base, refit_tier1=2),
                                  device="cpu")
    assert any("Refit tier 2" in m for m in logs), "no frame hit the tier-1 cap"
    full = tdrv.register_frames(None, None, None, scene, tdrv.RegistrationConfig(**base, refit_tier1=0),
                                device="cpu")
    assert len(tiered) == len(full) == n
    for a, b in zip(tiered, full):
        assert a.rgb_file == b.rgb_file and a.confidence == b.confidence
        np.testing.assert_array_equal(a.pose_w2c, b.pose_w2c)


def _gt_maps(scene, sub=8):
    """World coordinates of the cell centres from the shipped depth and pose
    files: the 480x640 depth sampled every `sub` pixels, f = 520 scaled to
    the 8-pixel cells of a canvas `sub / 8` times smaller."""
    files = scene.rgb_files
    out = []
    for f in files:
        stem = f[: -len(".png")]
        depth = np.load(f"{stem}_depth.npy")[sub // 2 :: sub, sub // 2 :: sub]
        pose = np.loadtxt(f"{stem}_pose.txt")
        scale = 8 / sub
        grid = get_pixel_grid(depth.shape[0], depth.shape[1], 8)
        out.append(backproject_depth(_t(depth), 520.0 * scale, depth.shape[1] * 4.0,
                                     depth.shape[0] * 4.0, _t(pose), grid).numpy())
    return np.stack(out)


def test_ground_truth_recovery_chesslike():
    """Depth + pose of 4 frames -> exact scene coordinates -> the registrar
    recovers the ground-truth poses."""
    import glob

    frames = sorted(glob.glob(f"{SCENE}/frame_00[0-3]0.png"))
    scene_like = type("S", (), {"rgb_files": frames})
    coords = _gt_maps(scene_like)  # (4, 60, 80, 3)
    mask = np.linalg.norm(coords, axis=-1) > 0
    grid = get_pixel_grid(60, 80, 8)
    out = treg.estimate_poses_batch(
        _t(coords), torch.from_numpy(mask), grid, torch.full((4,), 520.0), torch.full((4,), 320.0),
        torch.full((4,), 240.0), treg.RansacConfig(), generator=torch.Generator().manual_seed(0))
    assert out["valid"].all()
    for i, f in enumerate(frames):
        gt = np.loadtxt(f[: -len(".png")] + "_pose.txt")
        est = out["pose_c2w"][i].numpy().astype(np.float64)
        assert np.linalg.norm(est[:3, 3] - gt[:3, 3]) < 2e-3
        assert _rot_err_deg(est[:3, :3], gt[:3, :3]) < 0.1
        assert int(out["inlier_count"][i]) > 0.95 * mask[i].sum()


def test_draws_are_uniform_over_valid_cells():
    """The generator's hypothesis draws (used when none are injected) land
    only on valid cells, all of them, about equally often."""
    mask = torch.zeros((2, 300), dtype=torch.bool)
    mask[0, 10:250] = True
    mask[1, ::3] = True
    idx = treg.draw_hypothesis_indices(mask, 256, 16, torch.Generator().manual_seed(3))
    assert idx.shape == (2, 256, 16, 4)
    for f in range(2):
        counts = torch.bincount(idx[f].reshape(-1), minlength=300)
        assert counts[~mask[f]].sum() == 0
        valid = counts[mask[f]].double()
        assert valid.min() > 0
        assert abs(valid.mean() - valid.median()) < 0.1 * valid.mean()
        assert valid.std() < 0.3 * valid.mean()  # Poisson spread: 68 or 164 draws a cell
