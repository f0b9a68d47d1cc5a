"""The port's losses, learning-rate schedules and AdamW against acezero_tpu.

All in float32 at atol 1e-6: both packages compute the same elementwise
float32 operations; the sums over a batch (the losses) may add in another
order, which stays far inside 1e-6 relative at these sizes (checked with
rtol 1e-6 there).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acezero_tpu.training import loss as jl
from acezero_tpu.training import optim as jo
from acezero_tpu.training import schedule as js
from acezero_tpu_torch.training import loss as tl
from acezero_tpu_torch.training import optim as to
from acezero_tpu_torch.training import schedule as ts


def _errs(seed=0, n=2048):
    rng = np.random.default_rng(seed)
    errs = np.abs(rng.standard_cauchy(n) * 30).astype(np.float32)
    valid = rng.uniform(size=n) > 0.2
    return errs, valid


@pytest.mark.parametrize("loss_type", ["tanh", "dyntanh", "l1", "l1+sqrt", "l1+log"])
@pytest.mark.parametrize("circle", [True, False])
def test_losses_match_jax(loss_type, circle):
    errs, valid = _errs()
    for it in (0, 700, 2500, 5000):
        cfg_j = jl.ReproLossConfig(total_iterations=5000, loss_type=loss_type, circle_schedule=circle)
        cfg_t = tl.ReproLossConfig(total_iterations=5000, loss_type=loss_type, circle_schedule=circle)
        want = float(jl.repro_loss(cfg_j, jnp.asarray(errs), jnp.asarray(valid), jnp.asarray(it, jnp.int32)))
        got = float(tl.repro_loss(cfg_t, torch.from_numpy(errs), torch.from_numpy(valid),
                                  torch.tensor(it, dtype=torch.int32)))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_dyntanh_weight_over_iterations():
    for circle in (True, False):
        cfg_j = jl.ReproLossConfig(total_iterations=1000, circle_schedule=circle)
        hp_t = tl.loss_hp(tl.ReproLossConfig(total_iterations=1000, circle_schedule=circle))
        its = np.arange(0, 1201, 50, dtype=np.int32)
        want = np.asarray([jl.dyntanh_weight_hp(jl.loss_hp(cfg_j), jnp.asarray(i)) for i in its])
        got = tl.dyntanh_weight_hp(hp_t, torch.from_numpy(its)).numpy()
        # values up to 51: one float32 step there is 3.8e-6, hence the rtol
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-7)
    with pytest.raises(ValueError):
        tl.loss_hp(tl.ReproLossConfig(loss_type="huber"))


SCHEDULES = {
    "constant": dict(schedule="constant"),
    "circle": dict(schedule="circle", iterations=3000, learning_rate_max=0.005),
    "1cyclepoly": dict(schedule="1cyclepoly", iterations=3000, warmup_iterations=400, cooldown_iterations=900,
                       learning_rate_max=0.003),
}


def _jax_schedule(cfg, inliers):
    """lr before each step and max_iterations after it, over len(inliers) steps."""
    def step(state, xs):
        it, inl = xs
        lr = js.schedule_lr(cfg, state, it)
        state = js.schedule_update(cfg, state, it, inl)
        return state, (lr, state.max_iterations)

    its = jnp.arange(len(inliers), dtype=jnp.int32)
    _, (lrs, maxes) = jax.lax.scan(step, js.init_schedule(cfg), (its, jnp.asarray(inliers)))
    return np.asarray(lrs), np.asarray(maxes)


def _torch_schedule(cfg, inliers):
    state = ts.init_schedule(cfg)
    lrs, maxes = [], []
    for i, inl in enumerate(torch.from_numpy(inliers)):
        it = torch.tensor(i, dtype=torch.int32)
        lrs.append(ts.schedule_lr(cfg, state, it))
        state = ts.schedule_update(cfg, state, it, inl)
        maxes.append(state.max_iterations)
    return torch.stack(lrs).numpy(), torch.stack(maxes).numpy()


@pytest.mark.parametrize("kind", sorted(SCHEDULES))
@pytest.mark.parametrize("trigger", [False, True])
def test_schedule_matches_jax(kind, trigger):
    """lr over 0..N; with high batch inliers after step 600 the 1cyclepoly
    cooldown triggers dynamically and max_iterations shrinks."""
    n = 1600
    inliers = np.where(np.arange(n) > 600, 0.9, 0.2).astype(np.float32) if trigger else np.full(n, 0.3, np.float32)
    cfg_j = js.ScheduleConfig(**SCHEDULES[kind])
    cfg_t = ts.ScheduleConfig(**SCHEDULES[kind])
    lr_j, max_j = _jax_schedule(cfg_j, inliers)
    lr_t, max_t = _torch_schedule(cfg_t, inliers)
    np.testing.assert_allclose(lr_t, lr_j, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(max_t, max_j)
    if kind == "1cyclepoly" and trigger:
        # the trigger fires once the last 100 inlier fractions all exceed 0.7
        assert max_t[-1] == 701 + 900 and max_t[-1] < cfg_t.iterations


def _tree(rng):
    return {"a": {"w": rng.normal(size=(6, 5)).astype(np.float32), "b": rng.normal(size=(5,)).astype(np.float32)},
            "blocks": [{"c0": {"w": rng.normal(size=(3, 3)).astype(np.float32)}}],
            "mean": rng.normal(size=(3,)).astype(np.float32)}


def _to_t(tree):
    return jax.tree.map(lambda x: torch.from_numpy(np.array(x, np.float32)), tree)


def _to_np(tree):
    return jax.tree.map(lambda x: np.asarray(x), tree)


def test_adamw_matches_jax_and_disabled_is_noop(rng):
    params = _tree(rng)
    pj, sj = jax.tree.map(jnp.asarray, params), jo.adamw_init(jax.tree.map(jnp.asarray, params))
    pt = _to_t(params)
    st = to.adamw_init(pt)
    for step in range(6):
        grads = jax.tree.map(lambda x: (rng.normal(size=np.shape(x)) * 0.1).astype(np.float32), params)
        enabled = step not in (2, 3)
        lr = np.float32(0.003 * (step + 1))
        pj_new, sj_new = jo.adamw_update(pj, jax.tree.map(jnp.asarray, grads), sj, jnp.asarray(lr),
                                         enabled=jnp.asarray(enabled))
        pt_new, st_new = to.adamw_update(pt, _to_t(grads), st, torch.tensor(lr), enabled=torch.tensor(enabled))
        for a, b in zip(jax.tree.leaves(_to_np(pj_new)), to.tree_leaves(pt_new)):
            np.testing.assert_allclose(b.numpy(), a, atol=1e-6, rtol=0)
        for a, b in zip(jax.tree.leaves(_to_np(sj_new.nu)), to.tree_leaves(st_new.nu)):
            np.testing.assert_allclose(b.numpy(), a, atol=1e-6, rtol=0)
        assert int(st_new.step) == int(sj_new.step)
        if not enabled:  # an exact no-op: parameters, moments and step unchanged
            for old, new in zip(to.tree_leaves(pt) + to.tree_leaves(st.mu), to.tree_leaves(pt_new) + to.tree_leaves(st_new.mu)):
                assert torch.equal(old, new)
            assert int(st_new.step) == int(st.step)
        pj, sj, pt, st = pj_new, sj_new, pt_new, st_new


def test_adamw_nan_grad_disabled_keeps_params():
    p = {"w": torch.ones(4)}
    state = to.adamw_init(p)
    new, new_state = to.adamw_update(p, {"w": torch.full((4,), float("nan"))}, state, torch.tensor(0.01),
                                     enabled=torch.tensor(False))
    assert torch.equal(new["w"], p["w"]) and torch.equal(new_state.mu["w"], state.mu["w"])
    assert int(new_state.step) == 0
