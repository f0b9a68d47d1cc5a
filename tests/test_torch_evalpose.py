"""Pose scoring of the port against acezero_tpu: Kabsch/Umeyama, the RANSAC
similarity alignment, evaluate_poses, registration_rates and the eval CLI.

Tolerances: both packages solve Kabsch in float32 through different SVDs
(XLA's and LAPACK's), so T agrees to about float32's unit roundoff times
the coordinates' size: relative 1e-5 for the solves, 1e-5 absolute for an
alignment's T (coordinates of a few metres) and 1e-6 for its scale. The
alignment draws its minimal samples from the same numpy generator in both
packages, so the inlier counts must be equal and the medians (float64 from
there on) agree to 1e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from acezero_tpu.cli import eval_poses_cli as jcli
from acezero_tpu.evalpose import alignment as jal
from acezero_tpu.evalpose import evaluate_poses as j_evaluate
from acezero_tpu.geometry.kabsch import kabsch_umeyama as j_kabsch
from acezero_tpu.io.pose_files import PoseFileEntry as JEntry
from acezero_tpu.io.pose_files import registration_rates as j_rates
from acezero_tpu_torch.cli import eval_poses_cli as tcli
from acezero_tpu_torch.evalpose import alignment as tal
from acezero_tpu_torch.evalpose import evaluate_poses as t_evaluate
from acezero_tpu_torch.geometry.kabsch import kabsch_umeyama as t_kabsch
from acezero_tpu_torch.io.pose_files import PoseFileEntry, registration_rates, write_pose_file


def _rel(a, b):
    return float(np.linalg.norm(np.asarray(a, np.float64) - np.asarray(b, np.float64))
                 / np.linalg.norm(np.asarray(b, np.float64)))


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("scale", [False, True])
def test_kabsch_matches_jax(weighted, scale):
    rng = np.random.default_rng(7 + 2 * weighted + scale)
    for trial in range(5):
        n = 3 + weighted + 5 * trial  # a zero weight leaves 3 points
        p1 = rng.normal(size=(n, 3)).astype(np.float32) * 2.0
        R = Rotation.random(random_state=trial).as_matrix()
        p2 = (1.7 * p1 @ R.T + rng.normal(size=3) + rng.normal(size=(n, 3)) * 0.05).astype(np.float32)
        w = rng.uniform(0, 1, n).astype(np.float32) if weighted else None
        if weighted:
            w[0] = 0.0
        Tj, sj = j_kabsch(jnp.asarray(p1), jnp.asarray(p2), None if w is None else jnp.asarray(w),
                          estimate_scale=scale)
        Tt, st = t_kabsch(torch.from_numpy(p1), torch.from_numpy(p2), None if w is None else torch.from_numpy(w),
                          estimate_scale=scale)
        assert _rel(Tt.numpy(), np.asarray(Tj)) <= 1e-5
        assert abs(float(st) - float(sj)) <= 1e-5 * abs(float(sj))


def test_kabsch_batches_leading_dims():
    """One batched call equals the per-item calls (the JAX package's vmap)."""
    rng = np.random.default_rng(3)
    p1 = torch.from_numpy(rng.normal(size=(2, 4, 6, 3)).astype(np.float32))
    p2 = torch.from_numpy(rng.normal(size=(2, 4, 6, 3)).astype(np.float32))
    w = torch.from_numpy(rng.uniform(size=(2, 4, 6)).astype(np.float32))
    T, s = t_kabsch(p1, p2, w, estimate_scale=True)
    assert T.shape == (2, 4, 4, 4) and s.shape == (2, 4)
    T1, s1 = t_kabsch(p1[1, 2], p2[1, 2], w[1, 2], estimate_scale=True)
    np.testing.assert_allclose(T[1, 2].numpy(), T1.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(s[1, 2]), float(s1), rtol=1e-6)


def _random_c2w(rs, t_scale=2.0):
    T = np.eye(4)
    T[:3, :3] = Rotation.random(random_state=rs).as_matrix()
    T[:3, 3] = np.random.RandomState(rs).normal(size=3) * t_scale
    return T


def _pose_sets(seed, n=40, scale=1.6, outliers=5, noise=0.0):
    """GT poses, and estimates = similarity(GT) with a few corrupted ones and
    optional noise (tests/test_evalpose.py's trajectory)."""
    rng = np.random.default_rng(seed)
    gt = np.stack([_random_c2w(i) for i in range(n)])
    T_align = np.eye(4)
    T_align[:3, :3] = scale * Rotation.random(random_state=99).as_matrix()
    T_align[:3, 3] = [0.5, -1.0, 2.0]
    est = np.einsum("ab,nbc->nac", T_align, gt)
    est[:, :3, :3] /= scale
    est[:, :3, 3] += rng.normal(size=(n, 3)) * noise
    idx = rng.choice(n, outliers, replace=False)
    est[idx, :3, 3] += rng.normal(size=(outliers, 3)) * 3.0
    conf = rng.uniform(300, 3000, n)
    return gt, est, conf


@pytest.mark.parametrize("seed,noise", [(0, 0.0), (1, 0.02), (2, 0.04)])
def test_alignment_matches_jax(seed, noise):
    gt, est, conf = _pose_sets(seed, noise=noise)
    kw = dict(confidence_threshold=500, ransac_iterations=2000, seed=seed)
    Tj, sj = jal.estimate_alignment(est, gt, conf, **kw)
    Tt, st = tal.estimate_alignment(est, gt, conf, **kw)
    assert Tj is not None and Tt is not None
    np.testing.assert_allclose(Tt, Tj, atol=1e-5)
    assert abs(st - sj) <= 1e-6 * abs(sj)
    mask = conf > 500

    def count(T, s):
        return int(tal._inlier_mask(T, s, gt[mask, :3, 3], gt[mask, :3, :3], est[mask, :3, 3],
                                    est[mask, :3, :3], 0.05, 5.0).sum())

    assert count(Tt, st) == count(Tj, sj) > 0


def _entries(cls, est, conf):
    return [cls(f"f_{i:03d}.png", np.linalg.inv(est[i]), 500.0, float(conf[i])) for i in range(len(est))]


@pytest.mark.parametrize("align", [True, False])
def test_evaluate_poses_matches_jax(align):
    gt, est, conf = _pose_sets(5, noise=0.03, outliers=6)
    ej = j_evaluate(_entries(JEntry, est, conf), list(gt), do_alignment=align)
    et = t_evaluate(_entries(PoseFileEntry, est, conf), list(gt), do_alignment=align)
    assert et.aligned == ej.aligned is True
    assert et.accuracy == ej.accuracy
    assert abs(et.median_rot_deg - ej.median_rot_deg) <= 1e-4
    assert abs(et.median_trans_cm - ej.median_trans_cm) <= 1e-4
    np.testing.assert_allclose(et.trans_errors_cm, ej.trans_errors_cm, rtol=1e-4, atol=1e-4)
    if align:
        assert et.accuracy > 50.0
    else:
        assert et.accuracy == 0.0  # the similarity moves every pose


def test_evaluate_poses_too_few_confident():
    gt, est, conf = _pose_sets(6, n=12)
    conf[:] = 0.0
    ej = j_evaluate(_entries(JEntry, est, conf), list(gt))
    et = t_evaluate(_entries(PoseFileEntry, est, conf), list(gt))
    assert not et.aligned and not ej.aligned
    assert et.accuracy == ej.accuracy == 0.0
    assert np.isinf(et.median_trans_cm) and np.isinf(et.median_rot_deg)
    with pytest.raises(ValueError):
        t_evaluate(_entries(PoseFileEntry, est, conf)[:-1], list(gt))


@pytest.mark.parametrize("conf", [[], [0.0], [500.0, 500.5, 1200.0, 4001.0], np.linspace(0, 5000, 37)])
def test_registration_rates_match_jax(conf):
    th = [500, 1000, 2000, 4000]
    got, want = registration_rates(conf, th), j_rates(conf, th)
    if len(conf) == 0:
        assert all(np.isnan(g) for g in got) and all(np.isnan(w) for w in want)
    else:
        assert got == want


def test_eval_cli_flags_match_jax():
    def flags(parser):
        return {a.dest: (a.option_strings, a.default) for a in parser._actions if a.dest != "help"}

    assert flags(tcli.build_parser()) == flags(jcli.build_parser())


def test_eval_cli_prints_the_jax_numbers(tmp_path, capsys):
    gt, est, conf = _pose_sets(8, noise=0.02)
    for i, T in enumerate(gt):
        np.savetxt(tmp_path / f"f_{i:03d}_pose.txt", T)
    write_pose_file(tmp_path / "poses.txt", _entries(PoseFileEntry, est, conf))
    argv = [str(tmp_path / "poses.txt"), str(tmp_path / "f_*_pose.txt")]
    assert jcli.main(argv) == 0
    want = capsys.readouterr().out
    assert tcli.main(argv) == 0
    assert capsys.readouterr().out == want
