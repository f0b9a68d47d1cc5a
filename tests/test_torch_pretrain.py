"""The port's encoder pretraining against acezero_tpu's.

Tolerances:
- the corpus, `pad_occ_boxes` and the clipped gradients' structure are
  exact; the clips scale by one float32 factor computed from sums in
  another order, so they agree to 1e-6 relative;
- a pretraining chunk (2 steps from the same parameters and the JAX
  draws): each step's loss terms within 2e-4 relative. The encoder's bf16
  convolutions (oneDNN here, XLA in the JAX package) round single outputs
  differently, which moves the terms by about 1e-5 relative;
- the parameters after the chunk: each tree's update (after - before) within
  0.15 relative Frobenius of the JAX package's. Adam's first steps move a
  weight by about lr * sign(g), so weights whose gradient is within bf16
  rounding of zero flip their step; that is 2-7% of the update on these
  inputs, where a wrong term or a missing gradient is O(1).
"""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import acezero_tpu.pretrain.encoder_pretrain as jep
from acezero_tpu.models import torch_io as jio
from acezero_tpu.models.encoder import init_encoder_params as j_init_encoder
from acezero_tpu.models.head import HeadConfig as JHeadConfig
from acezero_tpu.training import optim as jopt
import acezero_tpu_torch.pretrain.encoder_pretrain as tep
from acezero_tpu_torch.models import torch_io as tio
from acezero_tpu_torch.models.encoder import LAYERS
from acezero_tpu_torch.models.head import HeadConfig
from acezero_tpu_torch.ops import fused_head as fh
from acezero_tpu_torch.training import optim as topt

TERMS_RTOL = 2e-4
UPDATE_TOL = 0.15


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The port's side on one thread: beside the other test workers, more
    threads only spin."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def test_clips_match_jax(rng):
    g = {"a": rng.normal(size=(3, 4)).astype(np.float32) * 5, "b": [rng.normal(size=(3,)).astype(np.float32)],
         "c": {"w": rng.normal(size=(3, 2, 2)).astype(np.float32) * 0.01}}
    for max_norm in (1.0, 100.0):
        want, wn = jopt.clip_global_norm(jax.tree.map(jnp.asarray, g), max_norm)
        got, gn = topt.clip_global_norm(jax.tree.map(torch.from_numpy, g), max_norm)
        np.testing.assert_allclose(gn.numpy(), np.asarray(wn), rtol=1e-6)
        for a, b in zip(topt.tree_leaves(got), jax.tree.leaves(_np(want))):
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-6, atol=1e-9)
        want, wn = jopt.clip_per_row_norm(jax.tree.map(jnp.asarray, g), max_norm)
        got, gn = topt.clip_per_row_norm(jax.tree.map(torch.from_numpy, g), max_norm)
        assert gn.shape == (3,)
        np.testing.assert_allclose(gn.numpy(), np.asarray(wn), rtol=1e-6)
        for a, b in zip(topt.tree_leaves(got), jax.tree.leaves(_np(want))):
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-6, atol=1e-9)


def test_clip_per_row_isolates_rows():
    """tests/test_pretrain_contrastive.py's case: one huge row cannot shrink another."""
    g = {"w": torch.stack([torch.ones(4) * 1e6, torch.ones(4) * 0.1])}
    clipped, norms = topt.clip_per_row_norm(g, 1.0)
    assert float(clipped["w"][0].norm()) == pytest.approx(1.0, rel=1e-5)
    assert torch.allclose(clipped["w"][1], torch.full((4,), 0.1))
    assert norms.shape == (2,)
    g = {"a": torch.ones(3) * 3.0, "b": torch.ones(4) * 4.0}
    clipped, norm = topt.clip_global_norm(g, 1.0)
    total = float(torch.sqrt(clipped["a"].square().sum() + clipped["b"].square().sum()))
    assert total == pytest.approx(1.0, rel=1e-5) and float(norm) == pytest.approx(float(np.sqrt(27 + 64)))


def test_save_encoder_round_trips_both_ways(tmp_path):
    gen = torch.Generator().manual_seed(3)
    from acezero_tpu_torch.models.encoder import init_encoder_params

    enc = init_encoder_params(gen)
    tio.save_encoder(tmp_path / "port.pt", enc)
    jax_loaded = jio.load_encoder(tmp_path / "port.pt")
    back = tio.params_from_jax(jax_loaded, None)[0]
    assert list(back) == list(enc)
    for k in enc:
        assert torch.equal(back[k]["w"], enc[k]["w"]) and torch.equal(back[k]["b"], enc[k]["b"])
    rng = np.random.default_rng(1)
    jenc = {name: {"w": rng.uniform(-0.1, 0.1, (kh, kw, cin, cout)).astype(np.float32),
                   "b": rng.uniform(-0.1, 0.1, cout).astype(np.float32)}
            for name, kh, kw, cin, cout, _ in LAYERS}  # the JAX package's HWIO layout
    jio.save_encoder(tmp_path / "jax.pt", jenc)
    loaded = tio.load_encoder(tmp_path / "jax.pt")
    want = tio.params_from_jax(jenc, None)[0]
    for k in want:
        assert torch.equal(loaded[k]["w"], want[k]["w"]) and torch.equal(loaded[k]["b"], want[k]["b"])
    # both writers give the same file contents; half writes fp16
    sd_j, sd_t = torch.load(tmp_path / "jax.pt"), tio.export_encoder_state_dict(want)
    assert list(sd_j) == list(sd_t) and all(torch.equal(sd_j[k], sd_t[k]) for k in sd_j)
    assert all(v.dtype == torch.float16 for v in tio.export_encoder_state_dict(want, half=True).values())


def _small_cfg(**kw):
    base = dict(num_scenes=2, views_per_scene=4, image_h=48, image_w=64, steps=10, batch_images=4, chunk_steps=3,
                low_texture_frac=0.5, photometric=True, across_frac=0.5, texture_octaves_max=3, pitch_frac=0.3)
    base.update(kw)
    return jep.PretrainConfig(**base), tep.PretrainConfig(**base)


def test_config_fields_and_defaults_match_jax():
    assert jep.PretrainConfig().__dict__ == tep.PretrainConfig().__dict__


class _SerialPool:
    """In place of the JAX package's fork pool: forking a process that runs
    JAX's threads may deadlock; the pool only parallelises the rendering."""

    def __init__(self, max_workers=None):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def map(self, fn, items):
        return map(fn, items)


def test_build_corpus_equal_in_every_field(monkeypatch):
    import concurrent.futures

    jcfg, tcfg = _small_cfg()
    monkeypatch.setattr(concurrent.futures, "ProcessPoolExecutor", _SerialPool)
    want = jep.build_corpus(jcfg)
    got = tep.build_corpus(tcfg, workers=1)
    pooled = tep.build_corpus(tcfg, workers=2)  # the spawn pool renders the same bits
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
        assert np.array_equal(pooled[k], want[k]), k


def test_lr_schedule_matches_jax():
    _, tcfg = _small_cfg(steps=1000, warmup_steps=200)
    for step in (0, 1, 57, 199, 200, 201, 640, 999, 1000, 1250):
        want = float(jep._lr_at(tcfg, jnp.asarray(step, jnp.int32)))
        assert tep._lr_at(tcfg, step) == pytest.approx(want, rel=1e-6, abs=1e-12)


def test_stacked_heads_convert_from_jax():
    hc = JHeadConfig(num_head_blocks=1)
    means = [jnp.asarray([0.1, 0.2, 0.3]), jnp.asarray([1.0, -1.0, 2.0]), jnp.zeros(3)]
    stack = _np(jep._stack_heads(jax.random.split(jax.random.PRNGKey(0), 3), hc, means))
    _, heads = tio.params_from_jax(None, stack)
    assert heads["mean"].shape == (3, 3) and heads["res3_conv1"]["w"].shape == (3, 512, 512)
    assert heads["blocks"][0]["c1"]["b"].shape == (3, 512)
    np.testing.assert_array_equal(heads["mean"].numpy(), np.stack([np.asarray(m) for m in means]))
    # the port's own stack has the same structure
    port = tep._stack_heads(torch.Generator().manual_seed(0), HeadConfig(num_head_blocks=1),
                            [np.asarray(m) for m in means])
    assert [tuple(t.shape) for t in topt.tree_leaves(port)] == [tuple(t.shape) for t in topt.tree_leaves(heads)]


def _jax_draws(cfg, key, n_steps):
    """The draws `_pretrain_chunk` makes from `key` (acezero_tpu/pretrain/
    encoder_pretrain.py: step_fn's split, `_sample_batch`, and
    augment_batch's uniforms, acezero_tpu/data/augment.py:123-139)."""
    V, B = cfg.views_per_scene, cfg.batch_images
    out = []
    for _ in range(n_steps):
        key, k_batch, k_aug = jax.random.split(key, 3)
        if cfg.contrastive_weight > 0.0:
            P = B // 2
            k_s, k_v1, k_v2, k_sign, k_far, k_fsel = jax.random.split(k_batch, 6)
            scene_sel = jax.random.randint(k_s, (P,), 0, cfg.num_scenes)
            off1 = jax.random.randint(k_v1, (P,), 0, V)
            delta = jax.random.randint(k_v2, (P,), 1, max(1, min(4, V // 8)) + 1)
            sign = jax.random.bernoulli(k_sign, 0.5, (P,)).astype(jnp.int32) * 2 - 1
            off2 = (off1 + sign * delta) % V
            if cfg.far_pair_frac > 0.0:
                off_far = jax.random.randint(k_far, (P,), 1, V)
                use_far = jax.random.bernoulli(k_fsel, cfg.far_pair_frac, (P,))
                off2 = jnp.where(use_far, (off1 + off_far) % V, off2)
            batch_idx = (scene_sel[:, None] * V + jnp.stack([off1, off2], -1)).reshape(-1)
        else:
            batch_idx = jax.random.randint(k_batch, (B,), 0, cfg.num_scenes * V)
        k_t, k_s, k_b, k_c = jax.random.split(k_aug, 4)
        u = lambda k, lo, hi: jax.random.uniform(k, (B,), minval=lo, maxval=hi)  # noqa: E731
        aug = {"thetas": u(k_t, -1.0, 1.0) * 15.0 * jnp.pi / 180.0, "scales": u(k_s, 2.0 / 3.0, 1.5),
               "brightness": u(k_b, 0.9, 1.1), "contrast": u(k_c, 0.9, 1.1)}
        out.append({"batch_idx": torch.from_numpy(np.array(batch_idx)),
                    "aug": {k: torch.from_numpy(np.array(v)) for k, v in aug.items()}})
    return out


def _rel_update(after, before, want_after):
    a = torch.cat([t.reshape(-1) for t in topt.tree_leaves(after)])
    b = torch.cat([t.reshape(-1) for t in topt.tree_leaves(before)])
    w = torch.cat([t.reshape(-1) for t in topt.tree_leaves(want_after)])
    return float((a - w).norm() / (w - b).norm())


CHUNK_CASES = {
    # exact supervision, contrastive pairs (96 x 128: at 64 x 96 the JAX run finds no positives)
    "exact_contrastive": dict(num_scenes=2, views_per_scene=12, image_h=96, image_w=128, batch_images=4,
                              chunk_steps=2, contrastive_weight=0.2, across_frac=1.0, far_pair_frac=0.5),
    "coarse_no_aug": dict(num_scenes=2, views_per_scene=6, image_h=64, image_w=96, batch_images=2,
                          chunk_steps=2, exact_supervision=False, use_aug=False),
}


@pytest.mark.parametrize("case", sorted(CHUNK_CASES))
def test_chunk_matches_jax(case):
    jcfg = jep.PretrainConfig(steps=100, **CHUNK_CASES[case])
    tcfg = tep.PretrainConfig(**jcfg.__dict__)
    corpus = tep.build_corpus(tcfg, workers=1)
    k_enc, k_heads, k_train = jax.random.split(jax.random.PRNGKey(jcfg.seed), 3)
    means = [jnp.asarray(m) for m in tep.scene_means(corpus, jcfg.num_scenes)]
    jparams = {"encoder": j_init_encoder(k_enc),
               "heads": jep._stack_heads(jax.random.split(k_heads, jcfg.num_scenes), JHeadConfig(0), means)}
    jstate = (jopt.adamw_init(jparams["encoder"]), jopt.adamw_init(jparams["heads"]))
    keys = ["images_u8", "coords", "w2c", "focals", "scene_ids"] + (
        ["c2w", "box_half", "occ_boxes"] if jcfg.exact_supervision else [])
    jdata = {k: jnp.asarray(corpus[k]) for k in keys}
    j_after, _, _, jstats = jep._pretrain_chunk(jparams, jstate, jdata, k_train, jnp.asarray(0, jnp.int32), jcfg,
                                                JHeadConfig(0))

    enc, heads = tio.params_from_jax(_np(jparams["encoder"]), _np(jparams["heads"]))
    params = {"encoder": enc, "heads": heads}
    state = (topt.adamw_init(enc), topt.adamw_init(heads))
    got, (enc_opt, head_opt), stats = tep.pretrain_chunk(
        params, state, tep.corpus_to_device(corpus, tcfg, "cpu"), 0, tcfg, HeadConfig(num_head_blocks=0),
        draws=_jax_draws(jcfg, k_train, jcfg.chunk_steps))
    for k in tep.STATS:
        np.testing.assert_allclose(stats[k].numpy(), np.asarray(jstats[k]), rtol=TERMS_RTOL, atol=1e-5, err_msg=k)
    assert all(np.isfinite(np.asarray(jstats[k])).all() for k in tep.STATS)
    if jcfg.contrastive_weight > 0:
        assert (stats["contrast"] > 0).any()
    want_enc, want_heads = tio.params_from_jax(_np(j_after["encoder"]), _np(j_after["heads"]))
    assert _rel_update(got["encoder"], enc, want_enc) <= UPDATE_TOL
    assert _rel_update(got["heads"], heads, want_heads) <= UPDATE_TOL
    assert int(enc_opt.step) == int(head_opt.step) == jcfg.chunk_steps
    # the heads' mean buffers train too
    assert not torch.equal(got["heads"]["mean"], heads["mean"])


def test_non_finite_loss_leaves_parameters_and_states_unchanged():
    _, tcfg = _small_cfg(chunk_steps=1)
    corpus = tep.build_corpus(tcfg, workers=1)
    params = tep.init_params(tcfg, corpus)
    params["heads"]["fc3"]["b"][1, 0] = float("nan")  # scene 1's head predicts NaN
    state = (topt.adamw_init(params["encoder"]), topt.adamw_init(params["heads"]))
    draws = [{"batch_idx": torch.tensor([4, 5, 6, 7]),
              "aug": {"thetas": torch.zeros(4), "scales": torch.ones(4), "brightness": torch.ones(4),
                      "contrast": torch.ones(4)}}]
    got, (enc_opt, head_opt), stats = tep.pretrain_chunk(params, state, tep.corpus_to_device(corpus, tcfg, "cpu"),
                                                         0, tcfg, HeadConfig(num_head_blocks=0), draws=draws)
    assert not torch.isfinite(stats["loss"]).any()
    for new, old in ((got, params), (enc_opt.mu, state[0].mu), (head_opt.nu, state[1].nu)):
        for a, b in zip(topt.tree_leaves(new), topt.tree_leaves(old)):
            torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
    assert int(enc_opt.step) == int(head_opt.step) == 0
    # a finite batch of the other scene moves both trees
    draws[0]["batch_idx"] = torch.tensor([0, 1, 2, 3])
    params["heads"]["fc3"]["b"][1, 0] = 0.0
    got, (enc_opt, _), stats = tep.pretrain_chunk(params, state, tep.corpus_to_device(corpus, tcfg, "cpu"), 5, tcfg,
                                                  HeadConfig(num_head_blocks=0), draws=draws)
    assert torch.isfinite(stats["loss"]).all() and int(enc_opt.step) == 1
    assert not torch.equal(got["encoder"]["conv1"]["w"], params["encoder"]["conv1"]["w"])


def _infonce_reference(f, g, m, tau, temp):
    """The loss in float64 loops over the positive cells only."""
    B, N = m.shape
    total, n_pos = 0.0, 0
    for p in range(B // 2):
        a, b = 2 * p, 2 * p + 1
        fa = f[a] / (np.linalg.norm(f[a], axis=-1, keepdims=True) + 1e-6)
        fb = f[b] / (np.linalg.norm(f[b], axis=-1, keepdims=True) + 1e-6)
        sim = fa @ fb.T / temp
        for n in range(N):
            if not m[a, n] or not m[b].any():
                continue
            d2 = np.where(m[b], ((g[a, n] - g[b]) ** 2).sum(-1), np.inf)
            j = int(np.argmin(d2))
            if d2[j] >= tau[a, n] ** 2:
                continue
            row = sim[n, m[b]]
            col = sim[m[a], j]
            ce_ab = -(sim[n, j] - np.log(np.exp(row - row.max()).sum()) - row.max())
            ce_ba = -(sim[n, j] - np.log(np.exp(col - col.max()).sum()) - col.max())
            total += 0.5 * (ce_ab + ce_ba)
            n_pos += 1
    return total / max(n_pos, 1)


def test_infonce_finite_with_invalid_cells(rng):
    """View a of pair 0 has invalid cells, pair 1's view a none valid (its
    log-softmax columns are NaN in the forward pass): the loss is the
    positives' mean and the gradient is finite."""
    B, hs, ws, C = 4, 3, 4, 8
    feats = torch.from_numpy(rng.normal(size=(B, hs, ws, C)).astype(np.float32)).requires_grad_(True)
    gt = rng.normal(size=(B, hs, ws, 3)).astype(np.float32)
    gt[1] = gt[0] + rng.normal(size=gt[0].shape).astype(np.float32) * 0.01  # pair 0 overlaps
    gt[3] = gt[2]
    mask = np.ones((B, hs, ws), bool)
    mask[0, 0, :2] = mask[1, 2, 3] = False
    mask[2] = False
    tau = np.full((B, hs, ws), 0.05, np.float32)
    _, tcfg = _small_cfg()
    loss = tep._contrastive_loss(feats.to(torch.bfloat16), torch.from_numpy(gt), torch.from_numpy(mask),
                                 torch.from_numpy(tau), tcfg)
    loss.backward()
    assert torch.isfinite(loss) and torch.isfinite(feats.grad).all() and feats.grad.abs().sum() > 0
    assert (feats.grad[2] == 0).all()  # no valid cell: no gradient
    f = feats.detach().to(torch.bfloat16).float().numpy().reshape(B, -1, C)
    want = _infonce_reference(f.astype(np.float64), gt.reshape(B, -1, 3), mask.reshape(B, -1), tau.reshape(B, -1),
                              tcfg.contrastive_temp)
    assert float(loss.detach()) == pytest.approx(want, rel=1e-5)


def test_one_head_launch_per_image_and_step(monkeypatch):
    """Each image runs its scene's head: `batch_images` chain launches
    forward and backward a step (K1 and K2 on the card)."""
    _, tcfg = _small_cfg(chunk_steps=2, contrastive_weight=0.2, views_per_scene=8)
    corpus = tep.build_corpus(tcfg, workers=1)
    calls = {"fwd": 0, "bwd": 0}
    real_fwd, real_bwd = fh.fused_head_chain, fh.fused_head_chain_backward

    def fwd(*a):
        calls["fwd"] += 1
        return real_fwd(*a)

    def bwd(*a):
        calls["bwd"] += 1
        return real_bwd(*a)

    monkeypatch.setattr(fh, "fused_head_chain", fwd)
    monkeypatch.setattr(fh, "fused_head_chain_backward", bwd)
    params = tep.init_params(tcfg, corpus)
    state = (topt.adamw_init(params["encoder"]), topt.adamw_init(params["heads"]))
    gen = torch.Generator().manual_seed(0)
    _, _, stats = tep.pretrain_chunk(params, state, tep.corpus_to_device(corpus, tcfg, "cpu"), 0, tcfg,
                                     HeadConfig(num_head_blocks=0), generator=gen)
    assert calls == {"fwd": 2 * tcfg.batch_images, "bwd": 2 * tcfg.batch_images}
    assert stats["loss"].shape == (2,) and torch.isfinite(stats["loss"]).all()


def test_sampled_pairs_are_ring_neighbours_of_one_scene():
    _, tcfg = _small_cfg(contrastive_weight=0.2, batch_images=8, views_per_scene=24, num_scenes=3)
    gen = torch.Generator().manual_seed(1)
    for far in (0.0, 1.0):
        cfg = replace(tcfg, far_pair_frac=far)
        idx = torch.stack([tep.sample_batch(cfg, 72, gen, "cpu") for _ in range(50)]).reshape(-1, 2)
        assert (idx // 24)[:, 0].eq((idx // 24)[:, 1]).all()
        sep = (idx[:, 1] - idx[:, 0]) % 24
        ring = torch.minimum(sep, 24 - sep)
        assert ring.min() >= 1 and (ring.max() <= 3 if far == 0.0 else ring.max() > 3)
    plain = tep.sample_batch(replace(tcfg, contrastive_weight=0.0), 72, gen, "cpu")
    assert plain.shape == (8,) and plain.min() >= 0 and plain.max() < 72
