"""The whole registration slice, port against acezero_tpu, on 4 chesslike_a
frames at image_resolution 120 (120x160 canvas, 15x20 cells) with the
shipped v6 encoder and the shipped 512-wide head (one extra block)."""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import acezero_tpu.registration.driver as jdrv
from acezero_tpu.cli import register_cli as jcli
from acezero_tpu.data.scene import load_scene as j_load_scene
from acezero_tpu.models import torch_io as jio
from acezero_tpu_torch.cli import register_cli as tcli
from acezero_tpu_torch.data.scene import load_scene as t_load_scene
from acezero_tpu_torch.models import torch_io as tio
from acezero_tpu_torch.registration import driver as tdrv

SCENE = "results/heldout/scenes/chesslike_a"
RGB = f"{SCENE}/frame_00[0-3]0.png"
ENCODER = "weights/tpu_encoder_v6.pt"
HEAD = "results/heldout/sweep_a_warmstart/iteration2.pt"
RES = 120


@pytest.fixture(scope="module")
def setup():
    kw = dict(image_short_size=RES, external_focal_length=520.0, num_workers=2)
    scene_j = j_load_scene(RGB, **kw)
    scene_t = t_load_scene(RGB, **kw)
    enc_j = jax.tree.map(jnp.asarray, jio.load_encoder(ENCODER))
    cfg_j, head_j = jio.load_head(HEAD)
    head_j = jax.tree.map(jnp.asarray, head_j)
    enc_t = tio.load_encoder(ENCODER)
    cfg_t, head_t = tio.load_head(HEAD)
    return scene_j, scene_t, (enc_j, head_j, cfg_j), (enc_t, head_t, cfg_t)


def test_coordinate_stage_matches_jax(setup):
    scene_j, scene_t, (enc_j, head_j, cfg_j), (enc_t, head_t, cfg_t) = setup
    np.testing.assert_array_equal(scene_t.images.canvases, scene_j.images.canvases)
    coords_j, mask_j = jdrv._coords_chunk(enc_j, head_j, cfg_j, scene_j.images.canvases,
                                          scene_j.images.sizes)
    coords_t, mask_t = tdrv.coords_chunk(enc_t, head_t, cfg_t,
                                         torch.from_numpy(scene_t.images.canvases),
                                         torch.from_numpy(scene_t.images.sizes.astype(np.int64)))
    assert coords_t.shape == (4, 15, 20, 3)
    np.testing.assert_array_equal(mask_t.numpy(), np.asarray(mask_j))
    np.testing.assert_allclose(coords_t.numpy(), np.asarray(coords_j), rtol=0.05, atol=0.2)


def _jax_pass1_draws(scene, cfg):
    """The hypothesis indices JAX's register_frames draws in pass 1: one
    threefry key per chunk slot from the host rng, then
    jax.random.categorical over the frame's valid cells (ransac.py:89)."""
    n = len(scene)
    order = np.random.default_rng(cfg.base_seed).permutation(n)
    keys = jdrv._host_keys(np.random.default_rng(cfg.base_seed + 0x9E37), (1, cfg.frame_chunk))[0]
    H, W = scene.images.canvas_hw
    mask = np.asarray(jdrv.content_mask(H, W, scene.images.sizes))[:, 4::8, 4::8]
    draws = np.zeros((n, cfg.ransac.hypotheses, cfg.ransac.max_tries, 4), np.int64)
    for slot, i in enumerate(order):
        logits = jnp.where(jnp.asarray(mask[i]).reshape(-1), 0.0, -jnp.inf)
        draws[i] = np.asarray(jax.random.categorical(
            jnp.asarray(keys[slot]), logits, shape=draws.shape[1:]))
    return torch.from_numpy(draws)


def _rot_err_deg(Ra, Rb):
    return np.degrees(np.arccos(np.clip((np.trace(Ra @ Rb.T) - 1) / 2, -1, 1)))


def test_register_frames_matches_jax(setup):
    scene_j, scene_t, (enc_j, head_j, cfg_j), (enc_t, head_t, cfg_t) = setup
    cfg_jr = jdrv.RegistrationConfig()
    cfg_tr = tdrv.RegistrationConfig()
    ent_j = jdrv.register_frames(enc_j, head_j, cfg_j, scene_j, cfg_jr)
    ent_t = tdrv.register_frames(enc_t, head_t, cfg_t, scene_t, cfg_tr, device="cpu",
                                 hyp_indices=_jax_pass1_draws(scene_j, cfg_jr))
    assert [e.rgb_file for e in ent_t] == [e.rgb_file for e in ent_j]
    assert [e.focal_length for e in ent_t] == [e.focal_length for e in ent_j]
    assert [e.confidence > 0 for e in ent_t] == [e.confidence > 0 for e in ent_j]
    n_cells = 15 * 20
    compared = 0
    for a, b in zip(ent_t, ent_j):
        assert np.isfinite(a.pose_w2c).all() and np.isfinite(a.confidence)
        if b.confidence >= 0.2 * n_cells:
            compared += 1
            pa, pb = a.pose_c2w, b.pose_c2w
            assert np.linalg.norm(pa[:3, 3] - pb[:3, 3]) < 0.01, a.rgb_file
            assert _rot_err_deg(pa[:3, :3], pb[:3, :3]) < 0.5, a.rgb_file
            assert abs(a.confidence - b.confidence) <= 0.05 * b.confidence, a.rgb_file
    print(f"{compared} of {len(ent_j)} frames at >= 20% inliers compared;",
          [(a.confidence, b.confidence) for a, b in zip(ent_t, ent_j)])


def test_cli_writes_same_frames_and_format(tmp_path, monkeypatch):
    monkeypatch.setenv("ACEZERO_CACHE_DIR", "0")  # keep the JAX CLI's cache out of the repo
    for name in ("j", "t"):
        (tmp_path / name).mkdir()
        shutil.copy(HEAD, tmp_path / name / "map.pt")
    common = [RGB, "--encoder_path", ENCODER, "--use_external_focal_length", "520",
              "--image_resolution", str(RES), "--session", "s1", "--hypotheses", "16",
              "--hypotheses_max_tries", "8"]
    assert jcli.main([common[0], str(tmp_path / "j" / "map.pt"), *common[1:]]) == 0
    assert tcli.main([common[0], str(tmp_path / "t" / "map.pt"), *common[1:], "--device", "cpu"]) == 0
    lines_j = (tmp_path / "j" / "poses_s1.txt").read_text().splitlines()
    lines_t = (tmp_path / "t" / "poses_s1.txt").read_text().splitlines()
    assert len(lines_t) == len(lines_j) == 4
    assert [l.split()[0] for l in lines_t] == [l.split()[0] for l in lines_j]
    for lt, lj in zip(lines_t, lines_j):
        tt, tj = lt.split(), lj.split()
        assert len(tt) == len(tj) == 10
        assert tt[8] == tj[8] == "520.0"
        assert all(np.isfinite(float(v)) for v in tt[1:])
        assert float(tt[9]).is_integer()


def test_cli_flags_match_jax():
    def flags(parser):
        return {a.dest: (a.option_strings, a.default) for a in parser._actions if a.dest != "help"}

    f_j, f_t = flags(jcli.build_parser()), flags(tcli.build_parser())
    assert f_t.pop("device") == (["--device"], "cuda")
    assert f_t == f_j
