"""The port's sub-pixel photometric match refinement
(acezero_tpu_torch/reconstruct/subpix.py) against acezero_tpu's, on the CPU,
on tests/test_subpix.py's procedural room (10 views, 192 x 256, exact depth
and poses) and on numpy-seeded inputs; the port also passes that file's
golden checks (sub-pixel truth recovered, bad matches rejected)."""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import acezero_tpu.reconstruct.subpix as jsp
import acezero_tpu_torch.reconstruct.subpix as tsp

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_subpix import H, SUB, W, _true_projection  # noqa: E402
from test_subpix import stereo  # noqa: E402,F401  (the module fixture)


def test_bilinear_matches_jax():
    """Values within 1e-4 (u8 units) and equal bounds flags, in and out of
    the image, for two images at once."""
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 255, (2, 20, 30)).astype(np.float32)
    u = rng.uniform(-3, 33, (2, 500)).astype(np.float32)
    v = rng.uniform(-3, 23, (2, 500)).astype(np.float32)
    val_t, inb_t = tsp._bilinear(torch.from_numpy(img), torch.from_numpy(u), torch.from_numpy(v))
    for k in range(2):
        val_j, inb_j = jsp._bilinear(jnp.asarray(img[k]), jnp.asarray(u[k]), jnp.asarray(v[k]))
        np.testing.assert_allclose(val_t[k].numpy(), np.asarray(val_j), rtol=0, atol=1e-4)
        np.testing.assert_array_equal(inb_t[k].numpy(), np.asarray(inb_j))


def test_sample_sheet_world_matches_jax(stereo):
    """Sheet points within 1e-5 world units (1e-6 relative to the room) and
    equal support flags at random continuous cells, some off the sheet."""
    data, maps, valid, w2c = stereo
    rng = np.random.default_rng(1)
    h, w = maps.shape[1:3]
    gi = rng.uniform(-1, h, (2, 300)).astype(np.float32)
    gj = rng.uniform(-1, w, (2, 300)).astype(np.float32)
    f = np.full(2, data["focal"], np.float32)
    X_t, ok_t = tsp._sample_sheet_world(torch.from_numpy(maps[:2].astype(np.float32)), torch.from_numpy(valid[:2]),
                                        torch.from_numpy(w2c[:2].astype(np.float32)), torch.from_numpy(f),
                                        W / 2.0, H / 2.0, torch.from_numpy(gi), torch.from_numpy(gj), SUB)
    for k in range(2):
        X_j, ok_j = jsp._sample_sheet_world(jnp.asarray(maps[k], jnp.float32), jnp.asarray(valid[k]),
                                            jnp.asarray(w2c[k], jnp.float32), f[k], W / 2.0, H / 2.0,
                                            jnp.asarray(gi[k]), jnp.asarray(gj[k]), SUB)
        ok = np.asarray(ok_j)
        np.testing.assert_array_equal(ok_t[k].numpy(), ok)
        assert 0.3 < ok.mean() < 1.0
        np.testing.assert_allclose(X_t[k].numpy()[ok], np.asarray(X_j)[ok], rtol=0, atol=1e-5)


def _matches(stereo, pairs, border, stride, noise, seed):
    """tests/test_subpix.py's simulated matcher output: true projections of
    source cell centres plus `noise` (px, a function of the rng)."""
    data, maps, valid, w2c = stereo
    focal = data["focal"]
    h, w = H // SUB, W // SUB
    ii = np.arange(border, h - border, stride) * SUB + SUB / 2.0
    jj = np.arange(border, w - border, stride) * SUB + SUB / 2.0
    u_src = np.stack([np.tile(jj, len(ii)), np.repeat(ii, len(jj))], -1).astype(np.float32)
    P = len(u_src)
    u_true = np.zeros((len(pairs), P, 2), np.float32)
    ok = np.zeros((len(pairs), P), bool)
    gi = ((u_src[:, 1] - SUB / 2) / SUB).astype(int)
    gj = ((u_src[:, 0] - SUB / 2) / SUB).astype(int)
    for e, (s, t) in enumerate(pairs):
        ut, inb = _true_projection(maps, w2c, focal, s, t, u_src)
        u_true[e] = ut
        ok[e] = (inb & valid[s][gi, gj] & (ut[:, 0] > 8) & (ut[:, 0] < W - 8) & (ut[:, 1] > 8)
                 & (ut[:, 1] < H - 8))
    rng = np.random.default_rng(seed)
    return u_src, u_true, (u_true + noise(rng, u_true.shape)).astype(np.float32), ok


def _both(stereo, pairs, u_src, u_match, ok, budget):
    data, maps, valid, w2c = stereo
    f = np.full(10, data["focal"], np.float32)
    out_j = jsp.refine_matches_photometric(data["images_u8"], maps, valid, w2c, f, (H, W), pairs, u_src, u_match,
                                           ok, jsp.SubpixConfig(max_matches_per_pair=budget))
    out_t = tsp.refine_matches_photometric(torch.from_numpy(data["images_u8"]),
                                           torch.from_numpy(maps.astype(np.float32)), valid, w2c, f, (H, W),
                                           pairs, u_src, u_match, ok, tsp.SubpixConfig(max_matches_per_pair=budget),
                                           pair_chunk=2)
    return out_j, out_t


def test_refinement_matches_jax_and_recovers_truth(stereo):
    """Three pairs, matcher noise of up to 3 px, two pair chunks: the same
    selection and acceptances (at most 1% of the selected differ), refined
    pixels within 0.1 px of JAX's (median 1e-3 px: the photometric GN in
    float32 sums in another order), the diagnostics within 1e-4 relative.
    Golden (tests/test_subpix.py): over half accepted, median error under
    0.3 px, 90th percentile under 1 px."""
    pairs = np.asarray([[0, 1], [4, 5], [8, 9]])
    u_src, u_true, u_match, ok = _matches(stereo, pairs, 2, 1, lambda r, s: r.uniform(-3.0, 3.0, s), 4)
    assert ok.sum() > 300
    (u_j, ok_j, d_j), (u_t, ok_t, d_t) = _both(stereo, pairs, u_src, u_match, ok, 256)
    assert d_t["n_selected"] == d_j["n_selected"]
    assert (ok_t != ok_j).sum() <= 0.01 * d_j["n_selected"]
    both = ok_t & ok_j
    d = np.linalg.norm(u_t - u_j, axis=-1)[both]
    assert d.max() < 0.1 and np.median(d) < 1e-3, (d.max(), np.median(d))
    np.testing.assert_array_equal(u_t[~ok_t & ~ok_j], u_match[~ok_t & ~ok_j])
    for key in ("accept_rate", "median_zncc", "median_shift_px"):
        assert d_t[key] == pytest.approx(d_j[key], rel=1e-4), key
    assert d_t["n_accepted"] > 0.5 * d_t["n_selected"]
    err = np.linalg.norm((u_t - u_true)[ok_t], axis=-1)
    assert np.median(err) < 0.3 and np.percentile(err, 90) < 1.0


def test_refinement_rejects_bad_matches_like_jax(stereo):
    """Gross outliers 25-40 px from the truth: the same acceptances as JAX
    within 1% of the selected, and the golden check: under half accepted,
    and what is accepted is accurate (median under 1 px) or rare."""

    def far(rng, shape):
        d = rng.normal(size=shape)
        return d / np.linalg.norm(d, axis=-1, keepdims=True) * rng.uniform(25, 40, shape[:-1] + (1,))

    pairs = np.asarray([[0, 1]])
    u_src, u_true, u_match, ok = _matches(stereo, pairs, 3, 2, far, 5)
    (u_j, ok_j, d_j), (u_t, ok_t, d_t) = _both(stereo, pairs, u_src, u_match, ok, 128)
    assert (ok_t != ok_j).sum() <= max(1, 0.01 * d_j["n_selected"])
    assert d_t["accept_rate"] < 0.5
    if ok_t.any():
        err = np.linalg.norm((u_t - u_true)[ok_t], axis=-1)
        assert np.median(err) < 1.0 or ok_t.sum() < 0.1 * ok.sum()
