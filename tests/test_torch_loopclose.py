"""The port's loop closure (acezero_tpu_torch/reconstruct/loopclose.py)
against acezero_tpu's, on the CPU.

Inputs come from the JAX tests' own builders (tests/test_loopclose.py:
render_scene rings, exact coordinate maps, Random-Fourier features of the
true surface, injected smooth ring drift) and from numpy seeds. Each function
runs in both packages on the same inputs; each assertion states its
tolerance. The host solvers are copies of the JAX package's numpy code and
must agree to float64 rounding; the device functions run in float32 in both,
where eigensolvers and summation order differ in the last bits. The port also
passes the JAX tests' golden checks (ring drift drained, outlier edges
survived).
"""

import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import acezero_tpu.reconstruct.loopclose as jlc
import acezero_tpu_torch.reconstruct.loopclose as tlc
from acezero_tpu.data.synthetic import render_scene, scene_coordinate_maps

sys.path.insert(0, str(Path(__file__).resolve().parent))
import test_loopclose as jtests  # noqa: E402
from test_loopclose import _rand_sim3, _smooth_ring_drift, _synth_features  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _t(a, dtype=None):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _rot_deg(Ra, Rb):
    """Angle of Ra Rb^-1 in degrees (the inverse, not the transpose: poses
    stored in float32 are orthonormal only to 1e-7, which the arccos would
    turn into hundredths of a degree)."""
    rel = Ra @ np.linalg.inv(Rb)
    return np.degrees(np.arccos(np.clip((np.trace(rel, axis1=-2, axis2=-1) - 1) / 2, -1, 1)))


def test_feature_projection_is_the_jax_draw():
    """The shipped 512 x 96 projection equals jax.random.normal(PRNGKey(7))
    / sqrt(512) bit for bit; other shapes need an explicit `proj`."""
    C = 512
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(7), (C, 96), jnp.float32) / jnp.sqrt(C))
    got = tlc.feature_projection(512, 96).numpy()
    assert got.dtype == np.float32 and got.shape == (512, 96)
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    with pytest.raises(ValueError, match="pass proj"):
        tlc.feature_projection(512, 48)


def test_config_fields_and_defaults_match_jax():
    from acezero_tpu.reconstruct.subpix import SubpixConfig as JS

    from acezero_tpu_torch.reconstruct.subpix import SubpixConfig as TS

    for jc, tc in ((jlc.LoopCloseConfig, tlc.LoopCloseConfig), (JS, TS)):
        assert [(f.name, f.default) for f in dataclasses.fields(tc)] == \
               [(f.name, f.default) for f in dataclasses.fields(jc)]


# ------------------------------------------------------------------- host


def _ring_edges(n, rng, outliers=0):
    S = _smooth_ring_drift(n, rng)
    pairs, m_s, m_R, m_t = [], [], [], []
    for k in range(n):
        for d in (1, 2, n - 1, n - 2):
            i, j = k, (k + d) % n
            M = jlc._sim3_mul(jlc._sim3_inv(S[j]), S[i])
            pairs.append((i, j))
            m_s.append(M[0])
            m_R.append(M[1])
            m_t.append(M[2])
    for e in rng.choice(len(pairs), outliers, replace=False):
        m_s[e], m_R[e], m_t[e] = _rand_sim3(rng, 40.0, 1.0, 0.2)
    return S, np.asarray(pairs), np.asarray(m_s), np.stack(m_R), np.stack(m_t)


@pytest.mark.parametrize("n,outliers,seed", [(24, 0, 3), (20, 8, 5)])
def test_solve_pose_graph_matches_jax_and_recovers_drift(n, outliers, seed):
    """Identical to the JAX solver to 1e-9 (the same float64 numpy code),
    with and without per-edge information matrices; and the golden checks of
    tests/test_loopclose.py: exact edges recovered (scale 1e-3, 0.1 deg,
    5 mm), 10% wild edges survived (median 2 cm, 0.5 deg)."""
    rng = np.random.default_rng(seed)
    S, pairs, m_s, m_R, m_t = _ring_edges(n, rng, outliers)
    infos = np.einsum("eab,ecb->eac", *(2 * [rng.normal(size=(len(pairs), 7, 7))])) + np.eye(7)
    for kw in ({}, {"infos": infos}):
        out_j = jlc.solve_pose_graph(n, pairs, m_s, m_R, m_t, np.ones(len(pairs)), **kw)
        out_t = tlc.solve_pose_graph(n, pairs, m_s, m_R, m_t, np.ones(len(pairs)), **kw)
        for a, b in zip(out_j[:3], out_t[:3]):
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-9)
        assert out_t[3] == out_j[3]
    s_hat, R_hat, t_hat, diag = tlc.solve_pose_graph(n, pairs, m_s, m_R, m_t, np.ones(len(pairs)))
    G = tlc._sim3_inv(S[0])
    expect = [tlc._sim3_mul(G, S[k]) for k in range(n)]
    err_s = np.abs(s_hat - [e[0] for e in expect])
    err_r = _rot_deg(R_hat, np.stack([e[1] for e in expect]))
    err_t = np.linalg.norm(t_hat - np.stack([e[2] for e in expect]), axis=1)
    if outliers == 0:
        assert err_s.max() < 1e-3 and err_r.max() < 0.1 and err_t.max() < 5e-3
        assert diag["residual_rot_deg"] < 0.05 and diag["residual_t"] < 1e-3
    else:
        assert np.median(err_t) < 0.02 and np.median(err_r) < 0.5


def test_select_pairs_matches_jax():
    """Equal pair lists on a ring pattern (the golden case of
    tests/test_loopclose.py) and on random overlaps, with and without the
    overlap floor."""
    m = 12
    O = np.zeros((m, m))
    for i in range(m):
        O[i, (i + 1) % m] = O[i, (i - 1) % m] = 0.8
        O[i, (i + 2) % m] = O[i, (i - 2) % m] = 0.4
    O[0, 6] = 0.95
    rnd = np.random.default_rng(0).uniform(size=(15, 15))
    for ov, k, floor in ((O, 2, 0.2), (O, 4, 0.5), (rnd, 6, 0.2), (rnd, 20, 0.0), (rnd[:1, :1], 3, 0.2)):
        np.testing.assert_array_equal(tlc.select_pairs(ov, k, floor), jlc.select_pairs(ov, k, floor))
    pairs = tlc.select_pairs(O, 2)
    assert len(pairs) == 24 and all(min((j - i) % m, (i - j) % m) in (1, 2) for i, j in pairs)


# ----------------------------------------------------------------- device


@pytest.fixture(scope="module")
def ring():
    """tests/test_loopclose.py's ring scene: 16 'across' views, 96 x 128,
    exact 12 x 16 coordinate maps, Random-Fourier features."""
    scene = render_scene(16, h=96, w=128, focal=120.0, seed=11, look="across", n_occluders=0)
    maps = scene_coordinate_maps(scene).astype(np.float32)
    return scene, maps, _synth_features(maps)


def test_view_overlap_matrix_matches_jax(ring, monkeypatch):
    """The same fractions to 1e-6 on the ring and on an outward ring, in
    row chunks of 5, and the golden check: outward index neighbours overlap,
    opposite frames do not."""
    monkeypatch.setattr(tlc, "OVERLAP_ROWS", 5)
    for scene, maps in ((ring[0], ring[1]),
                        (s := render_scene(12, h=96, w=128, focal=120.0, seed=21, look="outward", n_occluders=0),
                         scene_coordinate_maps(s).astype(np.float32))):
        n, h, w = maps.shape[:3]
        pts = maps.reshape(n, -1, 3)
        valid = np.random.default_rng(n).uniform(size=(n, h * w)) > 0.2
        w2c = np.linalg.inv(scene.poses_c2w.astype(np.float64)).astype(np.float32)
        f = np.full(n, scene.focal, np.float32)
        O_j = np.asarray(jlc.view_overlap_matrix(jnp.asarray(pts), jnp.asarray(valid), jnp.asarray(w2c),
                                                 jnp.asarray(f), 64.0, 48.0, 96.0, 128.0, 0.1))
        O_t = tlc.view_overlap_matrix(_t(pts), _t(valid), _t(w2c), _t(f), 64.0, 48.0, 96.0, 128.0, 0.1).numpy()
        np.testing.assert_allclose(O_t, O_j, rtol=0, atol=1e-6)
    mutual = np.minimum(O_t, O_t.T)
    assert np.median([mutual[i, (i + 1) % 12] for i in range(12)]) > 0.15
    assert np.median([mutual[i, (i + 6) % 12] for i in range(12)]) < 0.05


def test_map_validity_matches_jax(ring):
    """Equal masks on noisy maps (2 cm noise, a band of cells pushed behind
    the camera, a fifth of the content mask off)."""
    scene, maps, _ = ring
    n, h, w = maps.shape[:3]
    rng = np.random.default_rng(1)
    coords = (maps + rng.normal(size=maps.shape) * 0.02).astype(np.float32)
    w2c = np.linalg.inv(scene.poses_c2w.astype(np.float64)).astype(np.float32)
    cam = scene.poses_c2w[:, None, None, :3, 3].astype(np.float32)
    coords[:, :2] = 2 * cam - coords[:, :2]  # mirrored through the camera centre
    mask = rng.uniform(size=(n, h, w)) > 0.2
    f = np.full(n, scene.focal, np.float32)
    from acezero_tpu.geometry.projection import get_pixel_grid as jgrid

    from acezero_tpu_torch.geometry.projection import get_pixel_grid as tgrid

    v_j = np.asarray(jlc.map_validity(jnp.asarray(coords), jnp.asarray(mask), jnp.asarray(w2c), jnp.asarray(f),
                                      64.0, 48.0, jgrid(h, w, 8), 0.1, 1000.0, 20.0))
    v_t = tlc.map_validity(_t(coords), _t(mask), _t(w2c), _t(f), 64.0, 48.0, tgrid(h, w, 8), 0.1, 1000.0,
                           20.0).numpy()
    np.testing.assert_array_equal(v_t, v_j)
    assert 0.2 < v_t.mean() < 0.8


def test_masked_median_matches_jax():
    rng = np.random.default_rng(2)
    r = rng.uniform(size=(5, 37)).astype(np.float32)
    valid = rng.uniform(size=(5, 37)) > 0.5
    valid[3] = False
    want = np.stack([np.asarray(jlc._masked_median(jnp.asarray(r[k]), jnp.asarray(valid[k]))) for k in range(5)])
    np.testing.assert_array_equal(tlc._masked_median(_t(r), _t(valid)).numpy(), want)


def test_sheet_normals_match_jax(ring):
    """Planarity flags equal; normals (after the camera-facing flip) within
    1e-4 where the flag is set (cells without a planar neighbourhood carry
    an eigenvector of a degenerate subspace, which no code uses)."""
    scene, maps, _ = ring
    rng = np.random.default_rng(3)
    X = (maps[:4] + rng.normal(size=maps[:4].shape) * 0.003).astype(np.float32)
    V = rng.uniform(size=X.shape[:3]) > 0.1
    cams = scene.poses_c2w[:4, :3, 3].astype(np.float32)
    n_t, ok_t = tlc._sheet_normals(_t(X), _t(V), _t(cams))
    for k in range(4):
        n_j, ok_j = jlc._sheet_normals(jnp.asarray(X[k]), jnp.asarray(V[k]), jnp.asarray(cams[k]))
        np.testing.assert_array_equal(ok_t[k].numpy(), np.asarray(ok_j))
        ok = np.asarray(ok_j)
        assert ok.mean() > 0.3
        np.testing.assert_allclose(n_t[k].numpy()[ok], np.asarray(n_j)[ok], rtol=0, atol=1e-4)


def test_eigh_in_slices_equals_one_call():
    """The sheet normals' eigensolve in slices (cuSOLVER refuses very large
    batches) gives what one call gives."""
    A = torch.from_numpy(np.random.default_rng(4).normal(size=(5, 7, 3, 3)).astype(np.float32))
    A = A + A.transpose(-1, -2)
    want = torch.linalg.eigh(A)
    for got, ref in zip(tlc._eigh(A, max_batch=4), want):
        assert torch.equal(got, ref)


def _pair_inputs(ring, drift_seed=7):
    """The known-offset pair of tests/test_loopclose.py: the most co-visible
    pair, frame j's sheet and pose drifted by a random Sim(3) D."""
    scene, maps, feats = ring
    n, h, w = maps.shape[:3]
    w2c = np.linalg.inv(scene.poses_c2w.astype(np.float64)).astype(np.float32)
    O = tlc.view_overlap_matrix(_t(maps.reshape(n, -1, 3)), torch.ones(n, h * w, dtype=torch.bool), _t(w2c),
                                torch.full((n,), scene.focal), 64.0, 48.0, 96.0, 128.0, 0.1).numpy()
    mutual = np.minimum(O, O.T)
    np.fill_diagonal(mutual, -1)
    i, j = np.unravel_index(np.argmax(mutual), mutual.shape)
    D = _rand_sim3(np.random.default_rng(drift_seed), 5.0, 0.2, 0.03)
    Xj = (D[0] * maps[j] @ D[1].T) + D[2]
    c2w_j = scene.poses_c2w[j].astype(np.float64)
    c2w_jd = np.eye(4)
    c2w_jd[:3, :3] = D[1] @ c2w_j[:3, :3]
    c2w_jd[:3, 3] = D[0] * D[1] @ c2w_j[:3, 3] + D[2]
    args = (maps[i].reshape(1, -1, 3), feats[i].reshape(1, -1, feats.shape[-1]), np.ones((1, h * w), bool),
            Xj[None].astype(np.float32), feats[j][None], np.ones((1, h, w), bool),
            np.linalg.inv(c2w_jd)[None].astype(np.float32), np.full((1,), scene.focal, np.float32))
    return args, D, i


def test_pairwise_sim3_matches_jax(ring):
    """Two pairs in one call (the known-offset pair and its reverse): the
    fitted Sim(3) within 1e-4 (scale), 0.01 deg and 1e-4 world units of
    JAX's; inlier counts within 1%, rms and H within 1e-3 relative; the
    matches equal but for at most 1% of the cells, their pixels within
    1e-3 px. And the golden check of tests/test_loopclose.py: the fit is
    the injected D (scale 2e-2, 1 deg, 5 cm at this coarse canvas)."""
    (Xi, Fi, Vi, Xj, Fj, Vj, w2c, f), D, i = _pair_inputs(ring)
    scene = ring[0]
    # the reverse pair: frame j's drifted sheet into frame i's true sheet
    cat = [np.concatenate([a, a]) for a in (Xi, Fi, Vi, Xj, Fj, Vj, w2c, f)]
    cat[0][1] = Xj[0].reshape(-1, 3)
    cat[1][1] = Fj[0].reshape(-1, Fj.shape[-1])
    cat[3][1] = Xi[0].reshape(Xj.shape[1:])
    cat[4][1] = Fi[0].reshape(Fj.shape[1:])
    cat[6][1] = np.linalg.inv(scene.poses_c2w[i].astype(np.float64)).astype(np.float32)
    cfg_j, cfg_t = jlc.LoopCloseConfig(), tlc.LoopCloseConfig()
    res_j = jlc.pairwise_sim3(*[jnp.asarray(a) for a in cat], 64.0, 48.0, 1e-3, cfg_j)
    res_t = tlc.pairwise_sim3(*[_t(a) for a in cat], 64.0, 48.0, 1e-3, cfg_t)
    r_j = {k: np.asarray(v) for k, v in res_j.items()}
    r_t = {k: v.numpy() for k, v in res_t.items()}
    np.testing.assert_allclose(r_t["scale"], r_j["scale"], rtol=0, atol=1e-4)
    assert _rot_deg(r_t["R"], r_j["R"]).max() < 0.01
    np.testing.assert_allclose(r_t["t"], r_j["t"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(r_t["n_inliers"], r_j["n_inliers"], rtol=0.01)
    np.testing.assert_allclose(r_t["rms"], r_j["rms"], rtol=1e-3)
    assert np.abs(r_t["H"] - r_j["H"]).max() <= 1e-3 * np.abs(r_j["H"]).max()
    assert (r_t["m_ok"] != r_j["m_ok"]).mean() <= 0.01
    both = r_t["m_ok"] & r_j["m_ok"]
    np.testing.assert_allclose(r_t["u_tgt"][both], r_j["u_tgt"][both], rtol=0, atol=1e-3)
    # golden: M = D on the forward pair
    assert abs(r_t["scale"][0] - D[0]) < 2e-2
    assert _rot_deg(r_t["R"][0], D[1]) < 1.0
    assert np.linalg.norm(r_t["t"][0] - D[2]) < 0.05
    assert r_t["n_inliers"][0] > 50


def _drifted_ring(n=20, seed=13):
    """tests/test_loopclose.py's drift-drain input: exact maps and poses of
    an 'across' ring with smooth per-frame Sim(3) drift injected."""
    scene = render_scene(n, h=96, w=128, focal=120.0, seed=seed, look="across", n_occluders=0)
    maps = scene_coordinate_maps(scene)
    S_true = _smooth_ring_drift(n, np.random.default_rng(17), rot_deg=5.0, trans=0.2, dscale=0.02)
    coords = np.empty_like(maps)
    w2c = np.empty((n, 4, 4))
    for k in range(n):
        Sinv = jlc._sim3_inv(S_true[k])
        coords[k] = (Sinv[0] * maps[k] @ Sinv[1].T) + Sinv[2]
        c2w = scene.poses_c2w[k].astype(np.float64)
        c2w_d = np.eye(4)
        c2w_d[:3, :3] = Sinv[1] @ c2w[:3, :3]
        c2w_d[:3, 3] = Sinv[0] * Sinv[1] @ c2w[:3, 3] + Sinv[2]
        w2c[k] = np.linalg.inv(c2w_d)
    return scene, maps, coords.astype(np.float32), w2c


LC_SMALL = dict(min_pair_points=30, own_reproj_px=50.0, sample_step=1)


def test_loop_close_core_matches_jax():
    """The drifted 20-frame ring through both packages' loop_close_core: the
    same surviving edges and pairs, the same match masks, corrections within
    1e-5 (scale), 1e-3 deg and 1e-4 world units (the scene diagonal is
    about 13), and the diagnostics within 1e-4 relative."""
    scene, maps, coords, w2c = _drifted_ring()
    n, h, w = maps.shape[:3]
    feats = _synth_features(maps)
    args = (np.full(n, 5000.0), np.full(n, scene.focal, np.float32), (96, 128), 500.0)
    s_j, R_j, t_j, d_j = jlc.loop_close_core(coords, feats, np.ones((n, h, w), bool), w2c, *args,
                                             cfg=jlc.LoopCloseConfig(**LC_SMALL))
    s_t, R_t, t_t, d_t = tlc.loop_close_core(_t(coords), _t(feats), torch.ones(n, h, w, dtype=torch.bool), w2c,
                                             *args, cfg=tlc.LoopCloseConfig(**LC_SMALL))
    assert d_t["edges"] == d_j["edges"] > 20
    np.testing.assert_array_equal(d_t["ba_data"]["pairs"], d_j["ba_data"]["pairs"])
    np.testing.assert_array_equal(d_t["ba_data"]["ok"], d_j["ba_data"]["ok"])
    np.testing.assert_array_equal(d_t["ba_data"]["valid"], d_j["ba_data"]["valid"])
    np.testing.assert_allclose(d_t["ba_data"]["u_tgt"], d_j["ba_data"]["u_tgt"], rtol=0, atol=1e-3)
    np.testing.assert_allclose(s_t, s_j, rtol=0, atol=1e-5)
    assert _rot_deg(R_t, R_j).max() < 1e-3
    np.testing.assert_allclose(t_t, t_j, rtol=0, atol=1e-4)
    for key in ("median_edge_rms", "median_corr_t", "median_corr_rot_deg", "scene_diag", "graph_residual_t"):
        assert d_t[key] == pytest.approx(d_j[key], rel=1e-4), key


def test_loop_close_core_drains_ring_drift(monkeypatch):
    """tests/test_loopclose.py's golden drift drain, on the port: injected
    ~20 cm / 5 deg ring drift down to a median under 8 cm / 3.5 deg."""
    scene = render_scene(20, h=96, w=128, focal=120.0, seed=13, look="across", n_occluders=0)
    maps = scene_coordinate_maps(scene)

    def port_core(coords, feats, mask, *a, cfg, **kw):
        return tlc.loop_close_core(_t(coords), _t(feats), _t(mask), *a, cfg=tlc.LoopCloseConfig(**LC_SMALL), **kw)

    monkeypatch.setattr(jtests, "loop_close_core", port_core)
    errs_t, errs_r, diag = jtests._drift_drain_errors(scene, maps, jlc.LoopCloseConfig(**LC_SMALL))
    assert np.median(errs_t) < 0.08 and np.median(errs_r) < 3.5
    assert diag["median_corr_t"] > 0.01


# ------------------------------------------------------------ the chunk


def test_coords_feats_chunk_matches_jax():
    """Four chesslike_a frames at a 120-pixel side through the shipped v6
    encoder and 512-wide head, JAX weights converted by params_from_jax:
    the same cell mask; coordinates within the registration slice's
    tolerance (rtol 0.05, atol 0.2: bf16 convolutions round differently);
    unit-norm features whose cosine with JAX's is at least 0.99 in 99% of
    the cells (the bf16 encoder's differences, projected)."""
    from acezero_tpu.data.scene import load_scene as j_load
    from acezero_tpu.models import torch_io as jio

    from acezero_tpu_torch.data.scene import load_scene as t_load
    from acezero_tpu_torch.models.torch_io import params_from_jax

    rgb = str(ROOT / "results/heldout/scenes/chesslike_a/frame_00[0-3]0.png")
    kw = dict(image_short_size=120, external_focal_length=520.0, num_workers=2)
    scene_j, scene_t = j_load(rgb, **kw), t_load(rgb, **kw)
    enc_np = jio.load_encoder(ROOT / "weights/tpu_encoder_v6.pt")
    head_cfg_j, head_np = jio.load_head(ROOT / "results/heldout/sweep_a_warmstart/iteration2.pt")
    enc_t, head_t = params_from_jax(enc_np, head_np)
    from acezero_tpu_torch.models.head import HeadConfig

    head_cfg_t = HeadConfig(num_head_blocks=head_cfg_j.num_head_blocks, use_homogeneous=head_cfg_j.use_homogeneous)
    canv, sizes, root_idx = scene_j.images.device_view()
    c_j, m_j, f_j = jlc._coords_feats_chunk_from_root(jax.tree.map(jnp.asarray, enc_np),
                                                     jax.tree.map(jnp.asarray, head_np), head_cfg_j, canv, sizes,
                                                     jnp.asarray(root_idx, jnp.int32))
    c_t, m_t, f_t = tlc.coords_feats_chunk(enc_t, head_t, head_cfg_t, _t(scene_t.images.canvases),
                                           _t(scene_t.images.sizes.astype(np.int64)))
    assert f_t.shape == (4, 15, 20, 96)
    np.testing.assert_array_equal(m_t.numpy(), np.asarray(m_j))
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), rtol=0.05, atol=0.2)
    np.testing.assert_allclose(torch.linalg.vector_norm(f_t, dim=-1).numpy(), 1.0, atol=1e-5)
    cos = (f_t.numpy() * np.asarray(f_j)).sum(-1)
    assert np.quantile(cos, 0.01) >= 0.99, np.quantile(cos, [0.0, 0.01, 0.5])


# ----------------------------------------------------- loop_close_entries


@pytest.fixture(scope="module")
def ring_dir(tmp_path_factory):
    """A drifted 20-frame ring written as PNGs, loaded by both packages."""
    scene, maps, coords, w2c = _drifted_ring()
    out = tmp_path_factory.mktemp("lc_ring")
    for i, img in enumerate(scene.images_u8):
        Image.fromarray(img).save(out / f"frame_{i:03d}.png")
    return out, scene, maps, coords, w2c


def _fake_chunks(monkeypatch, coords, feats, canvases):
    """Both packages' coordinate/feature chunks replaced by the drifted
    exact maps and the synthetic features (a head trained on this ring
    would take minutes; the chunk itself is held above)."""
    from acezero_tpu_torch.reconstruct import loopclose as tmod

    def fake_j(enc, head, head_cfg, canv, sizes, idx, feature_dim=96, subsample=8):
        idx = np.asarray(idx)
        return jnp.asarray(coords[idx]), jnp.ones(coords[idx].shape[:3], bool), jnp.asarray(feats[idx])

    keys = {canvases[i].tobytes(): i for i in range(len(canvases))}

    def fake_t(enc, head, head_cfg, images_u8, sizes, feature_dim=96, subsample=8, proj=None):
        idx = [keys[im.numpy().tobytes()] for im in images_u8]
        return _t(coords[idx]), torch.ones(coords[idx].shape[:3], dtype=torch.bool), _t(feats[idx])

    monkeypatch.setattr(jlc, "_coords_feats_chunk_from_root", fake_j)
    monkeypatch.setattr(tmod, "coords_feats_chunk", fake_t)


@pytest.mark.parametrize("max_frames,ba", [(256, "off"), (14, "subpix")])
def test_loop_close_entries_matches_jax(ring_dir, monkeypatch, max_frames, ba):
    """loop_close_entries end to end in both packages on the drifted ring
    (20 frames, 2 under the confidence bar, entries in a shuffled order).
    Without the BA, every frame in the graph: the same edges, corrected
    poses within 1e-4 world units and 1e-3 deg of JAX's (the scene diagonal
    is about 13). With max_frames 14 the graph is a strided subset and the
    rest take the nearest graph frame's correction; the default sub-pixel
    refinement (a 20-match floor so the BA runs at this size) selects the
    same matches and accepts as many within 2, the BA forms the same
    tracks, and the poses agree within 2e-3 world units and 0.1 deg: the
    refined pixels differ by up to 0.06 px in float32, and the BA's weakly
    observed modes carry that into the poses (tests/test_torch_ba.py holds
    the BA itself to 1e-4 on equal inputs)."""
    from acezero_tpu.data.scene import load_scene as j_load
    from acezero_tpu.io.pose_files import PoseFileEntry as JEntry

    from acezero_tpu_torch.data.scene import load_scene as t_load
    from acezero_tpu_torch.io.pose_files import PoseFileEntry as TEntry

    path, scene, maps, coords, w2c = ring_dir
    n = len(maps)
    kw = dict(image_short_size=96, external_focal_length=scene.focal, num_workers=2)
    scene_j, scene_t = j_load(str(path / "*.png"), **kw), t_load(str(path / "*.png"), **kw)
    assert scene_t.canvas_hw == (96, 128)
    _fake_chunks(monkeypatch, coords, _synth_features(maps), scene_t.images.canvases)
    conf = np.full(n, 900.0)
    conf[[3, 11]] = 100.0
    order = np.random.default_rng(0).permutation(n)  # entries in registration order
    cfg_kw = dict(LC_SMALL, subpix_min_matches=20, ba=ba)
    out = {}
    for name, mod, sc, Entry, cfg in (("jax", jlc, scene_j, JEntry, jlc.LoopCloseConfig(**cfg_kw)),
                                      ("port", tlc, scene_t, TEntry, tlc.LoopCloseConfig(**cfg_kw))):
        entries = [Entry(sc.rgb_files[k], w2c[k], scene.focal, conf[k]) for k in order]
        extra = {"device": "cpu"} if name == "port" else {}
        out[name] = mod.loop_close_entries({}, {}, None, sc, entries, conf_threshold=500.0, cfg=cfg,
                                           max_frames=max_frames, **extra)
    (e_j, d_j), (e_t, d_t) = out["jax"], out["port"]
    assert "skipped" not in d_t and d_t["edges"] == d_j["edges"]
    assert [e.rgb_file for e in e_t] == [e.rgb_file for e in e_j]
    assert [e.confidence for e in e_t] == [e.confidence for e in e_j]
    P_t = np.stack([e.pose_c2w for e in e_t])
    P_j = np.stack([e.pose_c2w for e in e_j])
    if ba == "off":
        assert "ba" not in d_t and "subpix" not in d_t
        tol_t, tol_deg = 1e-4, 1e-3
    else:
        assert "skipped" not in d_t["ba"], d_t["ba"]
        assert d_t["ba"]["n_tracks"] == d_j["ba"]["n_tracks"] and d_t["ba"]["n_obs"] == d_j["ba"]["n_obs"]
        assert d_t["subpix"]["n_selected"] == d_j["subpix"]["n_selected"]
        assert abs(d_t["subpix"]["n_accepted"] - d_j["subpix"]["n_accepted"]) <= 2
        tol_t, tol_deg = 2e-3, 0.1
    np.testing.assert_allclose(P_t[:, :3, 3], P_j[:, :3, 3], rtol=0, atol=tol_t)
    assert _rot_deg(P_t[:, :3, :3], P_j[:, :3, :3]).max() < tol_deg
    # the corrections did something
    assert np.abs(P_t[:, :3, 3] - np.linalg.inv(w2c[order])[:, :3, 3]).max() > 0.01


def test_loop_close_entries_skips_too_few_frames(ring_dir):
    """Fewer than three confident frames: the entries come back unchanged."""
    from acezero_tpu_torch.data.scene import load_scene as t_load
    from acezero_tpu_torch.io.pose_files import PoseFileEntry

    path, scene, maps, coords, w2c = ring_dir
    sc = t_load(str(path / "*.png"), image_short_size=96, external_focal_length=scene.focal, num_workers=2)
    entries = [PoseFileEntry(f, w2c[k], scene.focal, 900.0 if k < 2 else 1.0) for k, f in enumerate(sc.rgb_files)]
    out, diag = tlc.loop_close_entries({}, {}, None, sc, entries, conf_threshold=500.0, device="cpu")
    assert out is entries and diag == {"skipped": "too_few_frames"}
