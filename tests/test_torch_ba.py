"""The port's pose-only track bundle adjustment
(acezero_tpu_torch/reconstruct/ba.py) against acezero_tpu's, on the CPU, on
tests/test_ba.py's irregular camera ring with exact, drifted and outlier
correspondences; the port also passes that file's golden checks (smooth
ring drift recovered, outliers survived, a no-op on exact poses)."""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import acezero_tpu.reconstruct.ba as jba
import acezero_tpu_torch.reconstruct.ba as tba

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_ba import _apply_drift, _make_matches, _pose_errors_after_sim3, _ring_setup, _smooth_drift  # noqa: E402


def test_so3_helpers_match_jax():
    """_skew exactly, _exp_so3 and _rotlog within 1e-6 (float32), from
    zero to large angles."""
    rng = np.random.default_rng(0)
    w = (rng.normal(size=(64, 3)) * np.geomspace(1e-9, 2.0, 64)[:, None]).astype(np.float32)
    np.testing.assert_array_equal(tba._skew(torch.from_numpy(w)).numpy(), np.asarray(jba._skew(jnp.asarray(w))))
    R_t = tba._exp_so3(torch.from_numpy(w))
    R_j = jba._exp_so3(jnp.asarray(w))
    np.testing.assert_allclose(R_t.numpy(), np.asarray(R_j), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tba._rotlog(R_t).numpy(), np.asarray(jba._rotlog(R_j)), rtol=0, atol=1e-6)


def test_tracks_from_pair_matches_matches_jax(rng):
    """Equal tracks (frames, pixels, flags) with the observation cap hit and
    with a minimum of two targets."""
    Rs, ts, pts, focal, ppx, ppy = _ring_setup(rng)
    pair_idx, us, ut, ok = _make_matches(Rs, ts, pts, focal, ppx, ppy, max_sep=3)
    for kw in ({"max_obs": 6}, {"max_obs": 3}, {"max_obs": 6, "min_targets": 2}):
        for a, b in zip(tba.tracks_from_pair_matches(pair_idx, us, ut, ok, **kw),
                        jba.tracks_from_pair_matches(pair_idx, us, ut, ok, **kw)):
            np.testing.assert_array_equal(a, b)


def _core(mod, R0, t0, focal, ppx, ppy, trk, **kw):
    n = len(R0)
    if mod is jba:
        R, t, d = jba.pose_ba_core(jnp.asarray(R0, jnp.float32), jnp.asarray(t0, jnp.float32),
                                   jnp.full((n,), focal, jnp.float32), ppx, ppy, jnp.asarray(trk[0], jnp.int32),
                                   jnp.asarray(trk[1]), jnp.asarray(trk[2]), **kw)
        return np.asarray(R), np.asarray(t), np.asarray(d["rms_px"]), int(d["n_obs"])
    R, t, d = tba.pose_ba_core(torch.as_tensor(R0, dtype=torch.float32), torch.as_tensor(t0, dtype=torch.float32),
                               torch.full((n,), focal), ppx, ppy, torch.as_tensor(trk[0]), torch.as_tensor(trk[1]),
                               torch.as_tensor(trk[2]), **kw)
    return R.numpy(), t.numpy(), d["rms_px"].numpy(), int(d["n_obs"])


@pytest.mark.parametrize("case", ["drift", "outliers", "exact"])
def test_pose_ba_core_matches_jax_and_golden(rng, case):
    """tests/test_ba.py's three cases through both packages (the port in
    track chunks of 1,000, JAX in one): rotations within 1e-5, translations
    within 1e-4 (the ring's radius is about 3), the rms history within
    1e-3 relative or 1e-4 px; then that file's golden bounds on the port."""
    Rs, ts, pts, focal, ppx, ppy = _ring_setup(rng)
    max_sep = 3 if case == "drift" else 2
    pair_idx, us, ut, ok = _make_matches(Rs, ts, pts, focal, ppx, ppy, max_sep=max_sep)
    if case == "outliers":
        m = rng.uniform(size=ut.shape[:2]) < 0.2
        ut = ut + m[..., None] * rng.normal(size=ut.shape).astype(np.float32) * 80.0
    if case == "exact":
        R0, t0, kw = Rs, ts, dict(iterations=10)
    else:
        R0, t0 = _apply_drift(Rs, ts, *_smooth_drift(len(Rs), rng))
        kw = dict(iterations=30, prior_rot=1e2, prior_t=1e2)
    trk = jba.tracks_from_pair_matches(pair_idx, us, ut, ok)
    R_j, t_j, rms_j, n_j = _core(jba, R0, t0, focal, ppx, ppy, trk, **kw)
    R_t, t_t, rms_t, n_t = _core(tba, R0, t0, focal, ppx, ppy, trk, chunk=1000, **kw)
    assert n_t == n_j
    np.testing.assert_allclose(R_t, R_j, rtol=0, atol=1e-5)
    np.testing.assert_allclose(t_t, t_j, rtol=0, atol=1e-4)
    np.testing.assert_allclose(rms_t, rms_j, rtol=1e-3, atol=1e-4)
    t_err, r_err = _pose_errors_after_sim3(R_t.astype(np.float64), t_t.astype(np.float64), Rs, ts)
    if case == "drift":
        t_err0, _ = _pose_errors_after_sim3(R0, t0, Rs, ts)
        assert np.median(t_err) < 0.04 and np.median(t_err) < 0.5 * np.median(t_err0)
        assert np.median(r_err) < 0.1 and rms_t[-1] < 0.5
    elif case == "outliers":
        assert np.median(t_err) < 0.035 and np.median(r_err) < 0.15
    else:
        c0 = np.einsum("nij,ni->nj", Rs.transpose(0, 2, 1), -ts)
        c1 = np.einsum("nij,ni->nj", R_t.transpose(0, 2, 1), -t_t)
        assert np.max(np.linalg.norm(c1 - c0, axis=1)) < 1e-3


def test_refine_poses_ba_matches_jax(rng):
    """The numpy wrapper at the loop-closure prior (300): the same w2c
    within 1e-4 and the same diagnostics; too few tracks skip."""
    Rs, ts, pts, focal, ppx, ppy = _ring_setup(rng)
    pair_idx, us, ut, ok = _make_matches(Rs, ts, pts, focal, ppx, ppy)
    R0, t0 = _apply_drift(Rs, ts, *_smooth_drift(len(Rs), rng))
    w2c = np.tile(np.eye(4), (len(Rs), 1, 1))
    w2c[:, :3, :3], w2c[:, :3, 3] = R0, t0
    args = (w2c, np.full(len(Rs), focal), (ppx, ppy), pair_idx, us, ut, ok)
    out_j, d_j = jba.refine_poses_ba(*args, iterations=10)
    out_t, d_t = tba.refine_poses_ba(*args, iterations=10, device="cpu")
    np.testing.assert_allclose(out_t, out_j, rtol=0, atol=1e-4)
    assert d_t["n_tracks"] == d_j["n_tracks"] and d_t["n_obs"] == d_j["n_obs"]
    assert d_t["rms_px_first"] == pytest.approx(d_j["rms_px_first"], rel=1e-4)
    assert d_t["rms_px_last"] == pytest.approx(d_j["rms_px_last"], rel=1e-3, abs=1e-4)
    few = tba.refine_poses_ba(w2c, np.full(len(Rs), focal), (ppx, ppy), pair_idx[:1], us[:1, :10], ut[:1, :10],
                              ok[:1, :10], device="cpu")
    assert few[0] is w2c and few[1] == {"skipped": "too_few_tracks"}
