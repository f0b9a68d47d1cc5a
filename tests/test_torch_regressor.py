"""The port's Regressor bundle against acezero_tpu.models.Regressor.

The same weights (params_from_jax) give the same scene coordinates up to
the bf16 encoder and head chains' summation order: within COORD_TOL of the
map's extent, tests/test_torch_export.py's tolerance for the same
encoder-plus-head path. The constructors give the JAX package's shapes and
dtypes, and the forward equals the export path's predict_coords on the
same canvases bit for bit (both run the encoder and head_apply_image).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import acezero_tpu.ops.fused_head as jfh
from acezero_tpu.models import Regressor as JRegressor
from acezero_tpu.models import torch_io as jio
from acezero_tpu_torch.data.augment import normalize_images
from acezero_tpu_torch.export.point_cloud import predict_coords
from acezero_tpu_torch.models import OUTPUT_SUBSAMPLE, Regressor, torch_io

ENCODER = Path(__file__).resolve().parents[1] / "weights" / "tpu_encoder_v6.pt"
COORD_TOL = 1e-3  # tests/test_torch_export.py


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(jfh, "INTERPRET", True)


def _canvases(n, seed):
    yy, xx = np.mgrid[:48, :64]
    rng = np.random.default_rng(seed)
    return np.stack([((xx * (2 + i) + yy * 3) % 256 + rng.integers(-20, 20, xx.shape)).clip(0, 255)
                     for i in range(n)]).astype(np.uint8)


@pytest.mark.parametrize("num_blocks", [0, 1])
def test_forward_matches_jax(num_blocks, tmp_path):
    jreg = JRegressor.create_from_encoder(jax.random.PRNGKey(num_blocks), jax.tree.map(jnp.asarray,
                                          jio.load_encoder(ENCODER)), jnp.asarray([0.2, -0.1, 2.0]),
                                          num_head_blocks=num_blocks)
    jreg.save_head(tmp_path / "head.pt")
    treg = Regressor.create_from_split_state_dict(ENCODER, tmp_path / "head.pt", device="cpu")
    # the JAX head through the same f16 file, so both hold the same weights
    jreg = JRegressor.create_from_split_state_dict(ENCODER, tmp_path / "head.pt")
    assert treg.head_cfg == type(treg.head_cfg)(**vars(jreg.head_cfg))
    images = normalize_images(torch.from_numpy(_canvases(2, num_blocks)))
    want = np.asarray(jreg.forward(jnp.asarray(images.numpy())))
    got = treg.forward(images)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape == (2, 48 // OUTPUT_SUBSAMPLE,
                                                                              64 // OUTPUT_SUBSAMPLE, 3)
    assert np.abs(got.numpy() - want).max() <= COORD_TOL * np.abs(want).max()
    feats = treg.get_features(images)
    flat = treg.get_scene_coordinates_flat(feats.reshape(-1, feats.shape[-1]))
    assert torch.equal(flat.reshape(got.shape), got)
    assert torch.equal(treg.get_scene_coordinates_image(feats), got)


def test_forward_equals_predict_coords():
    reg = Regressor.create_from_encoder(torch.Generator().manual_seed(1), torch_io.load_encoder(ENCODER),
                                        torch.tensor([0.0, 0.0, 3.0]))
    canvases = _canvases(3, 7)
    want = predict_coords(reg.encoder_params, reg.head_params, reg.head_cfg, canvases)
    with torch.inference_mode():
        got = reg.forward(normalize_images(torch.from_numpy(canvases))).numpy()
    assert np.array_equal(got, want)


def test_constructors_shapes_and_dtypes(tmp_path, monkeypatch):
    gen = torch.Generator().manual_seed(11)
    reg = Regressor.create_new(gen, torch.zeros(3), device="cpu")
    jreg = JRegressor.create_new(jax.random.PRNGKey(11), jnp.zeros(3))

    def shapes(params):
        return {k: (tuple(v["w"].shape), str(v["w"].dtype).replace("torch.", "")) for k, v in params.items()
                if isinstance(v, dict)}

    assert shapes(reg.head_params) == shapes(jreg.head_params)
    assert reg.head_cfg == type(reg.head_cfg)(**vars(jreg.head_cfg))
    assert {k: tuple(v["w"].shape) for k, v in reg.encoder_params.items()} == \
        {k: tuple(np.asarray(v["w"]).transpose(3, 2, 0, 1).shape) for k, v in jreg.encoder_params.items()}
    imgs = torch.randn((1, 48, 64, 1), generator=torch.Generator().manual_seed(12))
    coords = reg.forward(imgs)
    assert coords.shape == (1, 6, 8, 3) and coords.dtype == torch.float32
    reg2 = reg.with_new_head(torch.Generator().manual_seed(13), torch.ones(3))
    assert reg2.encoder_params is reg.encoder_params and reg2.head_params is not reg.head_params
    assert not torch.allclose(coords, reg2.forward(imgs))
    enc_only = Regressor.create_from_encoder(gen, reg.encoder_params, torch.zeros(3), num_head_blocks=2,
                                             use_homogeneous=False)
    assert len(enc_only.head_params["blocks"]) == 2 and enc_only.head_params["fc3"]["w"].shape == (512, 3)
    reg.save_head(tmp_path / "h.pt")
    cfg, head = torch_io.load_head(tmp_path / "h.pt")
    # (the file keeps the scale bounds in float16, as in the JAX package)
    assert (cfg.num_head_blocks, cfg.use_homogeneous) == (reg.head_cfg.num_head_blocks, reg.head_cfg.use_homogeneous)
    assert head["fc3"]["w"].shape == reg.head_params["fc3"]["w"].shape
    with pytest.raises(ValueError, match="512 output channels"):
        Regressor.create_new(gen, torch.zeros(3), num_encoder_features=256, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Regressor.create_new(gen, torch.zeros(3))
