"""The port's pose-file I/O and checkpoint loading against acezero_tpu."""

import jax
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from acezero_tpu.io import pose_files as jpf
from acezero_tpu.models import torch_io as jio
from acezero_tpu.models.encoder import init_encoder_params
from acezero_tpu.models.head import HeadConfig, init_head_params
from acezero_tpu_torch.io import pose_files as tpf
from acezero_tpu_torch.models import torch_io as tio

ENCODER = "weights/tpu_encoder_v6.pt"
HEAD = "results/heldout/sweep_a_warmstart/iteration2.pt"


def _entries(n, seed, perturb):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        pose = np.eye(4)
        pose[:3, :3] = Rotation.random(random_state=seed * 1000 + i).as_matrix()
        pose[:3, 3] = rng.normal(size=3)
        if perturb:  # registration output: f32 poses inverted in f64
            pose = np.linalg.inv(np.linalg.inv(pose).astype(np.float32).astype(np.float64))
        out.append((f"frame_{i:04d}.png", pose, float(np.float32(rng.uniform(100, 900))),
                    float(rng.integers(0, 5000))))
    return out


@pytest.mark.parametrize("perturb", [False, True])
def test_pose_file_bytes_identical(tmp_path, perturb):
    raw = _entries(200, 3 + perturb, perturb)
    jpf.write_pose_file(tmp_path / "j.txt", [jpf.PoseFileEntry(*e) for e in raw])
    tpf.write_pose_file(tmp_path / "t.txt", [tpf.PoseFileEntry(*e) for e in raw])
    assert (tmp_path / "t.txt").read_bytes() == (tmp_path / "j.txt").read_bytes()

    back_t = tpf.read_pose_file(tmp_path / "j.txt", confidence_threshold=1000)
    back_j = jpf.read_pose_file(tmp_path / "j.txt", confidence_threshold=1000)
    assert [e.rgb_file for e in back_t] == [e.rgb_file for e in back_j]
    for a, b in zip(back_t, back_j):
        np.testing.assert_allclose(a.pose_w2c, b.pose_w2c, atol=1e-12)
        assert a.focal_length == b.focal_length and a.confidence == b.confidence


def test_pose_file_helpers(tmp_path):
    (tmp_path / "bad.txt").write_text("a 1 2 3\n")
    with pytest.raises(ValueError):
        tpf.read_pose_file(tmp_path / "bad.txt")
    (tmp_path / "f.txt").write_text("520.0\n")
    (tmp_path / "k.txt").write_text("500 0 320\n0 500 240\n0 0 1\n")
    for f in ("f.txt", "k.txt"):
        assert tpf.load_focal_length(tmp_path / f) == jpf.load_focal_length(tmp_path / f)
    pose = "results/heldout/scenes/chesslike_a/frame_0000_pose.txt"
    np.testing.assert_array_equal(tpf.load_pose_matrix(pose), jpf.load_pose_matrix(pose))
    glob = "results/heldout/scenes/chesslike_a/frame_000*.png"
    assert tpf.get_files_from_glob(glob) == jpf.get_files_from_glob(glob)
    with pytest.raises(FileNotFoundError):
        tpf.get_files_from_glob(str(tmp_path / "*.none"))


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _flatten(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def _to_jax_layout(enc_t, head_t):
    """The port's layout back in the JAX package's (HWIO convs)."""
    enc = None if enc_t is None else {
        k: {"w": p["w"].permute(2, 3, 1, 0).numpy(), "b": p["b"].numpy()} for k, p in enc_t.items()
    }
    head = None if head_t is None else dict(_flatten(head_t))
    return enc, head


def test_shipped_checkpoints_load_identically():
    enc_j = jio.load_encoder(ENCODER)
    enc_t = tio.load_encoder(ENCODER)
    assert set(enc_t) == set(enc_j) and len(enc_t) == 11
    enc_back, _ = _to_jax_layout(enc_t, None)
    for k in enc_j:
        np.testing.assert_array_equal(enc_back[k]["w"], enc_j[k]["w"])
        np.testing.assert_array_equal(enc_back[k]["b"], enc_j[k]["b"])

    cfg_j, head_j = jio.load_head(HEAD)
    cfg_t, head_t = tio.load_head(HEAD)
    assert cfg_t.__dict__ == cfg_j.__dict__
    assert cfg_t.num_head_blocks == 1 and cfg_t.use_homogeneous
    flat_j = dict(_flatten(head_j))
    flat_t = {k: v.numpy() for k, v in _flatten(head_t)}
    assert set(flat_t) == set(flat_j)
    for k in flat_j:
        np.testing.assert_array_equal(flat_t[k], flat_j[k], err_msg=k)


@pytest.mark.parametrize("num_blocks", [0, 2])
def test_params_from_jax_roundtrip(num_blocks):
    enc = jax.device_get(init_encoder_params(jax.random.PRNGKey(0)))
    cfg = HeadConfig(num_head_blocks=num_blocks)
    head = jax.device_get(init_head_params(jax.random.PRNGKey(1), cfg, np.array([1.0, 2.0, 3.0])))
    enc_t, head_t = tio.params_from_jax(enc, head)
    enc_back, flat_back = _to_jax_layout(enc_t, head_t)
    for k in enc:
        np.testing.assert_array_equal(enc_back[k]["w"], enc[k]["w"])
    flat = dict(_flatten(head))
    assert set(flat_back) == set(flat)
    for k in flat:
        np.testing.assert_array_equal(flat_back[k].numpy(), np.asarray(flat[k]), err_msg=k)
    assert isinstance(head_t["mean"], torch.Tensor) and head_t["mean"].shape == (3,)
