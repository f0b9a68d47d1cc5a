"""The port's encoder, head and fused-head chain against acezero_tpu."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import acezero_tpu.ops.fused_head as jfh
from acezero_tpu.models import torch_io as jio
from acezero_tpu.models.encoder import encoder_apply as j_encoder_apply
from acezero_tpu.models.head import HeadConfig as JHeadConfig
from acezero_tpu.models.head import head_apply_flat as j_head_apply_flat
from acezero_tpu.models.head import head_epilogue as j_head_epilogue
from acezero_tpu.models.head import init_head_params
from acezero_tpu_torch.models import torch_io as tio
from acezero_tpu_torch.models.encoder import encoder_apply as t_encoder_apply
from acezero_tpu_torch.models.head import HeadConfig, head_apply_flat, head_epilogue
from acezero_tpu_torch.ops import fused_head as tfh

ENCODER = "weights/tpu_encoder_v6.pt"
HEAD = "results/heldout/sweep_a_warmstart/iteration2.pt"
CHAIN_TOL = dict(rtol=0.05, atol=0.2)  # bf16 chain (tests/test_fused_head.py)


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(jfh, "INTERPRET", True)


def _images(seed):
    return np.random.default_rng(seed).normal(size=(2, 64, 96, 1)).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encoder_matches_jax(dtype):
    enc_j = jax.tree.map(jnp.asarray, jio.load_encoder(ENCODER))
    enc_t = tio.load_encoder(ENCODER)
    img = _images(0)
    want = np.asarray(j_encoder_apply(enc_j, jnp.asarray(img), getattr(jnp, dtype)), np.float32)
    with torch.inference_mode():
        got = t_encoder_apply(enc_t, torch.from_numpy(img), getattr(torch, dtype)).float().numpy()
    assert got.shape == want.shape == (2, 8, 12, 512)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=2e-3)  # tests/test_models.py:212
    else:
        # bf16 activations: XLA and torch round the same convolutions with
        # different summation orders, so single values can flip by one bf16
        # step (1/128 relative); the bulk must agree at the f32 tolerance
        scale = np.abs(want).max()
        assert np.abs(got - want).max() <= 0.02 * scale
        assert np.mean(np.abs(got - want) <= 2e-3 + 1e-2 * np.abs(want)) > 0.99


def _jax_head(num_blocks, seed):
    cfg = JHeadConfig(num_head_blocks=num_blocks)
    params = jax.device_get(init_head_params(jax.random.PRNGKey(seed), cfg, np.array([0.5, -0.5, 2.0])))
    return cfg, params


@pytest.mark.parametrize("num_blocks", [0, 1, 2])
def test_head_chain_and_coords_match_jax(num_blocks):
    cfg_j, params_j = _jax_head(num_blocks, num_blocks)
    _, head_t = tio.params_from_jax(None, params_j)
    cfg_t = HeadConfig(num_head_blocks=num_blocks)
    x = (np.random.default_rng(num_blocks).normal(size=(512, 512)) * 0.5).astype(np.float32)
    x_bf = jnp.asarray(x).astype(jnp.bfloat16)

    w_j, b_j, tags_j = jfh.head_params_to_stack(jax.tree.map(jnp.asarray, params_j), cfg_j)
    w_t, b_t, tags_t = tfh.head_params_to_stack(head_t, cfg_t)
    assert tags_t == tags_j
    np.testing.assert_array_equal(w_t.float().numpy(), np.asarray(w_j, np.float32))
    np.testing.assert_array_equal(b_t.numpy(), np.asarray(b_j))

    chain_j = np.asarray(jfh.fused_head_mlp(x_bf, w_j, b_j, tags_j), np.float32)
    x_t = torch.from_numpy(np.asarray(x_bf, np.float32)).to(torch.bfloat16)
    chain_t = tfh.fused_head_chain(x_t, w_t, b_t, tags_t)
    np.testing.assert_allclose(chain_t.float().numpy(), chain_j, **CHAIN_TOL)

    coords_j = np.asarray(j_head_apply_flat(jax.tree.map(jnp.asarray, params_j), cfg_j, jnp.asarray(x)))
    coords_t = head_apply_flat(head_t, cfg_t, torch.from_numpy(x))
    np.testing.assert_allclose(coords_t.numpy(), coords_j, **CHAIN_TOL)
    # the epilogue alone, on the same hidden activations
    hidden = jnp.asarray(chain_t.float().numpy()).astype(jnp.bfloat16)
    epi_j = np.asarray(j_head_epilogue(jax.tree.map(jnp.asarray, params_j), cfg_j, hidden))
    np.testing.assert_allclose(head_epilogue(head_t, cfg_t, chain_t).numpy(), epi_j, rtol=1e-4, atol=1e-4)


def test_shipped_head_f32_path_matches_jax():
    cfg_j, params_j = jio.load_head(HEAD)
    cfg_t, head_t = tio.load_head(HEAD)
    x = np.abs(np.random.default_rng(3).normal(size=(256, 512))).astype(np.float32)
    want = np.asarray(j_head_apply_flat(jax.tree.map(jnp.asarray, params_j), cfg_j, jnp.asarray(x),
                                        compute_dtype=jnp.float32))
    got = head_apply_flat(head_t, cfg_t, torch.from_numpy(x), compute_dtype=torch.float32).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)


def test_ragged_batch_plain_chain():
    """Any B runs (the JAX kernel needs B % 512 == 0); rows are independent."""
    _, params_j = _jax_head(1, 7)
    _, head_t = tio.params_from_jax(None, params_j)
    w, b, tags = tfh.head_params_to_stack(head_t, HeadConfig())
    x = torch.from_numpy(np.random.default_rng(8).normal(size=(512, 512)).astype(np.float32)).to(torch.bfloat16)
    full = tfh.fused_head_chain(x, w, b, tags)
    part = tfh.fused_head_chain(x[:37].contiguous(), w, b, tags)
    assert part.shape == (37, 512)
    np.testing.assert_array_equal(part.float().numpy(), full[:37].float().numpy())
    assert tfh.LAUNCHES == 0  # CPU tensors never launch the kernel


def test_wrapper_rejects_bad_inputs():
    _, params_j = _jax_head(0, 9)
    _, head_t = tio.params_from_jax(None, params_j)
    w, b, tags = tfh.head_params_to_stack(head_t, HeadConfig(num_head_blocks=0))
    x = torch.zeros((8, 512), dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        tfh.fused_head_chain(x.float(), w, b, tags)
    with pytest.raises(ValueError):
        tfh.fused_head_chain(x[:, :256], w, b, tags)
    with pytest.raises(ValueError):
        tfh.fused_head_chain(x, w, b, tags + (0,))
