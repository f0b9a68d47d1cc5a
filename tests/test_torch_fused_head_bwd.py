"""The head chain's backward (K2's plain version) and its autograd Function
against the JAX package's Pallas backward, run in interpret mode on the CPU.

Tolerances: both packages compute the same bf16 values at the same
rounding points, but XLA and torch sum the f32 products in other orders.
So a bf16 value may flip by one step, and, rarely (a few in a million), a
ReLU mask flips where the f32 pre-activation lies within that summation
noise of zero. A mask flip zeroes one pre-activation grad and changes the
whole row of every grad below it. Hence: the layer inputs elementwise
within 3% of the largest magnitude (tests/test_fused_head.py:64-69); the
pre-activation grads and dx within relative Frobenius 1e-2, with at least
99.9% of their elements within 3% of the largest magnitude and at most
1e-4 of the masks disagreeing. The Function's dx, dW and db against
jax.vjp: relative Frobenius <= 1e-2 (the same flips, summed over the
batch).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import acezero_tpu.ops.fused_head as jfh
from acezero_tpu.models.head import HeadConfig as JHeadConfig
from acezero_tpu.models.head import init_head_params as j_init_head_params
from acezero_tpu_torch.models import torch_io as tio
from acezero_tpu_torch.models.head import HeadConfig, head_apply_flat
from acezero_tpu_torch.ops import fused_head as tfh

TAGS = {5: (0, 0, 1, 0, 0), 8: (0, 0, 1, 0, 0, 1, 0, 0), 11: (0, 0, 1, 0, 0, 1, 0, 0, 1, 0, 0)}


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(jfh, "INTERPRET", True)


def _inputs(L, seed, B=512):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(B, 512)) * 0.5).astype(np.float32)
    w = (rng.uniform(-1, 1, (L, 512, 512)) / 512**0.5).astype(np.float32)
    b = (rng.uniform(-1, 1, (L, 512)) / 512**0.5).astype(np.float32)
    g = (rng.normal(size=(B, 512)) * 1e-2).astype(np.float32)
    # round x, w, g to bf16 once so both packages start from the same values
    bf = lambda a: np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))
    return bf(x), bf(w), b, bf(g)


def _t(a, dtype=torch.bfloat16):
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(dtype)


def _close_to_max(got, want, name, share=1.0):
    """At least `share` of the elements within 3% of the largest magnitude."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    denom = np.abs(want).max() + 1e-6
    if share == 1.0:
        np.testing.assert_allclose(got / denom, want / denom, atol=0.03, err_msg=name)
    else:
        assert np.mean(np.abs(got - want) <= 0.03 * denom) >= share, name


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.mark.parametrize("L", [5, 8, 11])
def test_plain_backward_matches_pallas(L, monkeypatch):
    x, w, b, g = _inputs(L, L)
    tags = TAGS[L]
    captured = {}
    real_einsum = jnp.einsum

    def spy(spec, actsin, gpre, **kw):  # the stacks _run_backward hands to its dW einsum
        captured["acts_in"], captured["gpre"] = actsin, gpre
        return real_einsum(spec, actsin, gpre, **kw)

    monkeypatch.setattr(jfh.jnp, "einsum", spy)
    dx_j, _, _ = jfh._run_backward(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16),
                                   jnp.asarray(b), jnp.asarray(g, jnp.bfloat16), tags)
    dx, gpre, acts_in = tfh.fused_head_chain_backward(_t(x), _t(w), _t(b, torch.float32), _t(g), tags)
    assert dx.dtype == gpre.dtype == acts_in.dtype == torch.bfloat16
    assert gpre.shape == acts_in.shape == (L, 512, 512)
    gpre_j = np.asarray(captured["gpre"], np.float32)
    for got, want, name in ((dx, dx_j, "dx"), (gpre, gpre_j, "gpre")):
        assert _rel(got.float().numpy(), np.asarray(want, np.float32)) <= 1e-2, name
        _close_to_max(got.float().numpy(), want, name, share=0.999)
    assert np.mean((gpre.float().numpy() == 0) != (gpre_j == 0)) <= 1e-4
    _close_to_max(acts_in.float().numpy(), captured["acts_in"], "acts_in")
    # layer 0's input is x itself, exactly
    np.testing.assert_array_equal(acts_in[0].float().numpy(), x)
    assert tfh.LAUNCHES_BWD == 0  # CPU tensors never launch the kernel


@pytest.mark.parametrize("L", [5, 8, 11])
def test_function_grads_match_jax_vjp(L):
    x, w, b, g = _inputs(L, 100 + L)
    tags = TAGS[L]
    out_j, vjp = jax.vjp(lambda x_, w_, b_: jfh.fused_head_mlp(x_, w_, b_, tags),
                         jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16), jnp.asarray(b))
    dx_j, dw_j, db_j = vjp(jnp.asarray(g, jnp.bfloat16))

    xt = _t(x).requires_grad_(True)
    wt = _t(w, torch.float32).requires_grad_(True)
    bt = _t(b, torch.float32).requires_grad_(True)
    out = tfh.FusedHeadChain.apply(xt, wt, bt, tags)
    assert out.dtype == torch.bfloat16
    _close_to_max(out.float().detach().numpy(), out_j, "out")
    out.backward(_t(g))
    assert xt.grad.dtype == torch.bfloat16 and wt.grad.dtype == torch.float32
    for got, want, name in ((xt.grad, dx_j, "dx"), (wt.grad, dw_j, "dW"), (bt.grad, db_j, "db")):
        assert _rel(got.float().numpy(), np.asarray(want, np.float32)) <= 1e-2, name


def test_function_matches_autograd_of_plain_chain():
    """On the CPU the Function's VJP is exactly torch autograd through the
    plain chain (same rounding points, same products)."""
    x, w, b, g = _inputs(8, 7, B=300)
    tags = TAGS[8]
    grads = []
    for fn in (lambda *a: tfh.FusedHeadChain.apply(*a, tags), lambda *a: tfh.fused_head_chain_plain(*a, tags)):
        wt = _t(w, torch.float32).requires_grad_(True)
        bt = _t(b, torch.float32).requires_grad_(True)
        (fn(_t(x), wt, bt).float() * _t(g, torch.float32)).sum().backward()
        grads.append((wt.grad, bt.grad))
    assert torch.equal(grads[0][0], grads[1][0]) and torch.equal(grads[0][1], grads[1][1])


def test_stack_to_head_grads_layout():
    """As tests/test_fused_head.py:72-85."""
    cfg = HeadConfig(num_head_blocks=1)
    params_j = jax.device_get(j_init_head_params(jax.random.PRNGKey(5), JHeadConfig(num_head_blocks=1),
                                                 jnp.zeros(3)))
    _, params = tio.params_from_jax(None, params_j)
    w, b, res_after = tfh.head_params_to_stack(params, cfg)
    assert w.shape == (8, 512, 512)
    assert res_after == (0, 0, 1, 0, 0, 1, 0, 0)

    dw = torch.arange(8, dtype=torch.float32)[:, None, None] * torch.ones((8, 512, 512))
    db = torch.arange(8, dtype=torch.float32)[:, None] * torch.ones((8, 512))
    grads = tfh.stack_to_head_grads(params, cfg, dw, db)
    assert float(grads["res3_conv1"]["w"][0, 0]) == 0.0
    assert float(grads["blocks"][0]["c0"]["w"][0, 0]) == 3.0
    assert float(grads["fc2"]["b"][0]) == 7.0
    assert float(grads["fc3"]["w"].abs().sum()) == 0.0
    assert float(grads["mean"].abs().sum()) == 0.0
    # the same layout as the JAX package's scatter
    grads_j = jfh.stack_to_head_grads(jax.tree.map(jnp.asarray, params_j), JHeadConfig(num_head_blocks=1),
                                      jnp.asarray(dw.numpy()), jnp.asarray(db.numpy()))
    for name in ("res3_conv1", "res3_conv3", "fc1", "fc2", "fc3"):
        np.testing.assert_array_equal(grads[name]["w"].numpy(), np.asarray(grads_j[name]["w"]))
    np.testing.assert_array_equal(grads["blocks"][0]["c2"]["b"].numpy(), np.asarray(grads_j["blocks"][0]["c2"]["b"]))


def _grad_fn_names(t):
    seen, stack, names = set(), [t.grad_fn], set()
    while stack:
        fn = stack.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        names.add(type(fn).__name__)
        stack.extend(f for f, _ in fn.next_functions)
    return names


@pytest.mark.parametrize("num_blocks", [0, 1, 2])
def test_head_apply_flat_trains_every_chain_weight(num_blocks):
    """The standard layout goes through FusedHeadChain, and the gradient
    reaches every layer of the chain (the trap: a kernel output without an
    autograd graph would leave the chain untrained)."""
    cfg_j = JHeadConfig(num_head_blocks=num_blocks)
    params_j = jax.device_get(j_init_head_params(jax.random.PRNGKey(num_blocks), cfg_j, np.zeros(3)))
    _, params = tio.params_from_jax(None, params_j)
    for leaf in tfh._chain_layers(params) + [params["fc3"]]:
        leaf["w"].requires_grad_(True)
        leaf["b"].requires_grad_(True)
    x = torch.from_numpy(np.abs(np.random.default_rng(1).normal(size=(64, 512))).astype(np.float32))
    out = head_apply_flat(params, HeadConfig(num_head_blocks=num_blocks), x)
    assert "FusedHeadChainBackward" in _grad_fn_names(out)
    out.sum().backward()
    chain = tfh._chain_layers(params)
    assert len(chain) == 5 + 3 * num_blocks
    for l, leaf in enumerate(chain):
        assert leaf["w"].grad is not None and float(leaf["w"].grad.abs().sum()) > 0, l
        assert leaf["b"].grad is not None and float(leaf["b"].grad.abs().sum()) > 0, l
