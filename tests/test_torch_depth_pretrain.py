"""The port's seed-depth pretraining and its CLI against acezero_tpu's.

Tolerances: the corpus is the same numpy code with the same draws, so it is
bit-equal. A training chunk (3 steps from the JAX package's initialisation,
batch order and rates) holds each step's loss to 1e-3 relative: the frozen
encoder's and the head's bf16 convolutions (oneDNN here, XLA in the JAX
package) round single outputs differently, which moves the losses by up to
2e-4 relative on these inputs. The head's update (after - before) is held
to 0.15 relative Frobenius of the JAX package's (5% on these inputs):
Adam's first steps move a weight by about lr * sign(g), and weights whose
gradient is within bf16 rounding of zero flip their step.
"""

import argparse
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import acezero_tpu.pretrain.depth_pretrain as jdp
from acezero_tpu.cli import pretrain_depth_cli as jcli
from acezero_tpu.models import torch_io as jio
from acezero_tpu.models.depthnet import init_depth_head_params as j_init_depth
from acezero_tpu.training import optim as jopt
from acezero_tpu_torch.cli import pretrain_depth_cli as tcli
from acezero_tpu_torch.models import torch_io as tio
import acezero_tpu_torch.pretrain.depth_pretrain as tdp
from acezero_tpu_torch.training import optim as topt

ROOT = Path(__file__).resolve().parents[1]
ENCODER = ROOT / "weights" / "tpu_encoder_v6.pt"
LOSS_RTOL = 1e-3
UPDATE_TOL = 0.15


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The port's side on one thread: beside the other test workers, more
    threads only spin."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(**kw):
    base = dict(num_scenes=3, views_per_scene=2, image_h=48, image_w=64, steps=3, batch_images=4)
    base.update(kw)
    return jdp.DepthPretrainConfig(**base), tdp.DepthPretrainConfig(**base)


def test_config_fields_and_defaults_match_jax():
    assert jdp.DepthPretrainConfig().__dict__ == tdp.DepthPretrainConfig().__dict__


@pytest.mark.parametrize("corpus", ["v4", "v5"])
def test_build_depth_corpus_bit_equal(corpus):
    jcfg, tcfg = _cfgs(corpus=corpus, num_scenes=4)
    (ji, jd), (ti, td) = jdp.build_depth_corpus(jcfg), tdp.build_depth_corpus(tcfg)
    assert ti.dtype == ji.dtype == np.uint8 and td.dtype == jd.dtype == np.float32
    assert td.shape == (8, 6, 8) and np.array_equal(ti, ji) and np.array_equal(td, jd)


def test_lr_table_warms_up_then_decays():
    _, tcfg = _cfgs(steps=300, warmup_steps=100)
    lr = tdp.lr_table(tcfg)
    assert lr.dtype == np.float32 and lr.shape == (300,)
    assert lr[0] == np.float32(1e-3) * np.float32(0.02) and lr[99] == np.float32(1e-3) and lr[100] == lr[99]
    assert (np.diff(lr[:100]) > 0).all() and (np.diff(lr[100:]) < 0).all() and lr[-1] > 0


def test_train_chunk_matches_jax():
    jcfg, tcfg = _cfgs(num_scenes=2, views_per_scene=4, image_h=64, image_w=96)
    images, gt = tdp.build_depth_corpus(tcfg)
    _, k_init = jax.random.split(jax.random.PRNGKey(jcfg.seed))
    jparams = j_init_depth(k_init)
    head0 = tio.params_from_jax(None, None, depth_np=jax.tree.map(np.asarray, jparams))[2]
    order = np.random.default_rng(jcfg.seed).integers(0, len(images), (3, jcfg.batch_images))
    lr = tdp.lr_table(tcfg)[:3]
    j_after, _, jlosses = jdp._train_chunk(
        jparams, jopt.adamw_init(jparams), jax.tree.map(jnp.asarray, jio.load_encoder(ENCODER)), jnp.asarray(images),
        jnp.asarray(gt), jnp.asarray(order, jnp.int32), jnp.asarray(lr), jcfg.silog_lambda, jcfg.grad_loss_weight)
    got, opt, losses = tdp.train_chunk(head0, topt.adamw_init(head0), tio.load_encoder(ENCODER),
                                       torch.from_numpy(images), torch.from_numpy(gt), torch.from_numpy(order), lr,
                                       tcfg.silog_lambda, tcfg.grad_loss_weight)
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses), rtol=LOSS_RTOL)
    want = tio.params_from_jax(None, None, depth_np=jax.tree.map(np.asarray, j_after))[2]
    flat = [torch.cat([t.reshape(-1) for t in topt.tree_leaves(p)]) for p in (got, head0, want)]
    assert float((flat[0] - flat[2]).norm() / (flat[2] - flat[1]).norm()) <= UPDATE_TOL
    assert int(opt.step) == 3


def _options(parser):
    out = {}
    for a in parser._actions:
        if a.dest == "help":
            continue
        out[a.dest] = (tuple(a.option_strings), a.default, a.type.__name__ if a.type else None,
                       tuple(a.choices) if a.choices else None, a.nargs, a.required)
    return out


class _Parsed(Exception):
    pass


def jax_parser(monkeypatch, cli):
    """The parser a JAX CLI's `main` builds (it has no build_parser): caught
    at parse time, before anything runs."""
    from acezero_tpu.utils import cache

    monkeypatch.setattr(cache, "enable_compilation_cache", lambda *a, **k: None)

    def catch(self, args=None, namespace=None):
        raise _Parsed(self)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", catch)
    with pytest.raises(_Parsed) as exc:
        cli.main(["x.pt"])
    monkeypatch.undo()
    return exc.value.args[0]


def test_cli_flags_match_jax_parser(monkeypatch):
    j = _options(jax_parser(monkeypatch, jcli))
    t = _options(tcli.build_parser())
    assert t.pop("device") == (("--device",), "cuda", "str", None, None, False)
    assert t == j


def test_cli_main_trains_on_the_cpu_and_writes_a_loadable_head(tmp_path):
    res = tcli.main([str(tmp_path / "depth.pt"), "--encoder_path", str(ENCODER), "--num_scenes", "1",
                     "--views_per_scene", "2", "--image_height", "48", "--image_width", "64", "--steps", "2",
                     "--batch_images", "2", "--corpus", "v4", "--device", "cpu"])
    assert np.isfinite(res["final_loss"]) and len(res["chunk_losses"]) == 1
    head = tio.load_depth_head(tmp_path / "depth.pt")
    jax_head = jio.load_encoder(tmp_path / "depth.pt")  # the JAX package reads the file too
    assert set(head) == set(jax_head) == {"d_conv1", "d_conv2", "d_conv3", "d_conv4"}
    for k in head:
        assert torch.equal(head[k]["w"], res["params"][k]["w"])
