"""The port's encoder probes, candidate selection and pretraining CLI
against acezero_tpu's.

Tolerances: `match_score` is a share of nearest-neighbour matches; the
features are bf16 convolution outputs that oneDNN and XLA round
differently, which can flip a match between near-tied cells, so the two
packages are held within 1.0 percentage point (equal on these inputs).
"""

import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acezero_tpu.cli import pretrain_cli as jcli
from acezero_tpu.models import torch_io as jio
from acezero_tpu.pretrain import encoder_eval as jev
from acezero_tpu_torch.cli import pretrain_cli as tcli
from acezero_tpu_torch.models import torch_io as tio
from acezero_tpu_torch.pretrain import encoder_eval as tev
from acezero_tpu_torch.pretrain import encoder_pretrain as tep
from test_torch_depth_pretrain import _options, jax_parser

ROOT = Path(__file__).resolve().parents[1]
ENCODER = ROOT / "weights" / "tpu_encoder_v6.pt"
MATCH_TOL_PP = 1.0


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The port's side on one thread: beside the other test workers, more
    threads only spin."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_eval_scenes_and_scores_match_jax():
    assert tev.EVAL_SCENES == jev.EVAL_SCENES
    for args in ((50.0,), (50.0, 30.0, 4.0), (12.5, None, None)):
        assert tev.EncoderScores(*args).combined == jev.EncoderScores(*args).combined


def test_match_score_matches_jax():
    kw = dict(n_views=12, h=120, w=160)
    want = jev.match_score(jax.tree.map(jnp.asarray, jio.load_encoder(ENCODER)), **kw)
    got = tev.match_score(tio.load_encoder(ENCODER), **kw)
    assert np.isfinite(want) and abs(got - want) <= MATCH_TOL_PP


class _Fit:
    """A stand-in MappingTrainer whose fit returns a fixed head; it keeps
    the configurations it was built with."""

    def __init__(self, head):
        self.head = head
        self.args = None

    def __call__(self, *args, **kwargs):
        self.args = args
        return self

    def train(self):
        return {"head_params": self.head}


SHORTFIT_KW = dict(iterations=3, n_views=6, h=96, w=128)


@pytest.mark.parametrize("case", ["head", "exact", "noisy"])
def test_shortfit_scores_match_jax(monkeypatch, case):
    """`shortfit_score`'s frames, scene load and scoring against the JAX
    package's, with the fit stubbed in both to return one head: `head` a
    JAX-initialised head (so the encoder and head run), `exact` and `noisy`
    the head's output replaced by each scored frame's ground-truth
    coordinates, exact (a known answer: every cell within 10 px, median
    under 0.5 px) or with 1-6 cm of noise (inlier share about half). The
    scoring is float64 numpy on the same float32 coordinates, so the exact
    cases agree to 1e-9; `head` rounds the encoder's bf16 features and the
    head chain differently (oneDNN against XLA): 1e-4 relative on the
    median."""
    from acezero_tpu.data import scene as jscene
    from acezero_tpu.models import head as jhead_mod
    from acezero_tpu.training import trainer as jtr
    from acezero_tpu_torch.data import scene as tscene
    from acezero_tpu_torch.data.synthetic import render_scene, scene_coordinate_maps
    from acezero_tpu_torch.models import head as thead_mod
    from acezero_tpu_torch.training import trainer as ttr

    for mod in (jscene, tscene):
        monkeypatch.setattr(mod, "load_scene", functools.partial(mod.load_scene, image_short_size=96))
    gt = scene_coordinate_maps(render_scene(6, h=96, w=128, **tev.EVAL_SCENES[0]))  # (6, 12, 16, 3)
    jhead = jhead_mod.init_head_params(jax.random.PRNGKey(3), jhead_mod.HeadConfig(num_head_blocks=1),
                                       jnp.asarray(gt.reshape(-1, 3).mean(0), jnp.float32))
    jfit, tfit = _Fit(jhead), _Fit(tio.params_from_jax(None, jax.tree.map(np.asarray, jhead))[1])
    monkeypatch.setattr(jtr, "MappingTrainer", jfit)
    monkeypatch.setattr(ttr, "MappingTrainer", tfit)
    if case != "head":
        sigma = 0.0 if case == "exact" else np.linspace(0.01, 0.06, 6)[:, None, None, None]
        coords = (gt + sigma * np.random.default_rng(7).normal(size=gt.shape)).astype(np.float32)
        for mod, wrap in ((jhead_mod, jnp.asarray), (thead_mod, torch.from_numpy)):
            frames = iter(coords)  # the scored frames, in order (6 views: every frame)
            monkeypatch.setattr(mod, "head_apply_image", lambda *a, _f=frames, _w=wrap: _w(next(_f)[None]))
    want = jev.shortfit_score(jax.tree.map(jnp.asarray, jio.load_encoder(ENCODER)), **SHORTFIT_KW)
    got = tev.shortfit_score(tio.load_encoder(ENCODER), **SHORTFIT_KW)
    # the fit the stubs stand in for is configured as the JAX package's
    (jscene_data, _, jhc, jcfg, jbuf), (tscene_data, _, thc, tcfg, tbuf) = jfit.args, tfit.args
    assert (jhc.num_head_blocks, jcfg.batch_size, jcfg.pose_refinement, jcfg.refine_calibration) == (
        thc.num_head_blocks, tcfg.batch_size, tcfg.pose_refinement, tcfg.refine_calibration)
    assert jcfg.schedule.__dict__ == tcfg.schedule.__dict__ and jcfg.loss.__dict__ == tcfg.loss.__dict__
    assert jbuf.__dict__ == tbuf.__dict__
    np.testing.assert_array_equal(tscene_data.poses_c2w, jscene_data.poses_c2w)
    if case == "head":
        assert got[0] == want[0] and got[1] == pytest.approx(want[1], rel=1e-4)
        return
    assert got == pytest.approx(want, rel=1e-9, abs=1e-9)
    if case == "exact":
        assert got[0] == 100.0 and got[1] < 0.5
    else:
        assert 20.0 < got[0] < 80.0 and got[1] > 1.0


def test_shortfit_runs_on_the_cpu(monkeypatch):
    """The short fit end to end at a tiny size (its PNG frames, load_scene
    on a 96-pixel canvas, a few mapping steps, the reprojection score)."""
    from acezero_tpu_torch.data import scene

    monkeypatch.setattr(scene, "load_scene", functools.partial(scene.load_scene, image_short_size=96))
    inl, med = tev.shortfit_score(tio.load_encoder(ENCODER), iterations=3, n_views=6, h=96, w=128)
    assert 0.0 <= inl <= 100.0 and np.isfinite(med) and med > 0


def _tiny(**kw):
    base = dict(num_scenes=2, views_per_scene=4, image_h=48, image_w=64, steps=2, batch_images=2, chunk_steps=1)
    base.update(kw)
    return tep.PretrainConfig(**base)


def test_select_keeps_the_best_candidate_and_writes_each(tmp_path, monkeypatch):
    """With the probes stubbed (the second candidate scores best), every
    candidate is written as it completes and the best one is the output."""
    scores = iter([tev.EncoderScores(40.0, 10.0, 5.0), tev.EncoderScores(20.0, 30.0, 3.0),
                   tev.EncoderScores(90.0, 5.0, 9.0)])
    seen = []

    def stub(enc):
        seen.append(enc["conv1"]["w"].clone())
        return next(scores)

    monkeypatch.setattr(tev, "evaluate_encoder", stub)
    monkeypatch.setattr(tep, "build_corpus", functools.partial(tep.build_corpus, workers=1))
    out = tmp_path / "enc.pt"
    res = tep.pretrain_encoder_select(_tiny(), n_candidates=3, output_path=out, device="cpu")
    assert [c["seed"] for c in res["candidates"]] == [42, 143, 244]
    assert res["scores"].combined == pytest.approx(35.0)
    cands = [tio.load_encoder(tmp_path / f"enc.cand{c}.pt") for c in range(3)]
    assert all(torch.equal(cand["conv1"]["w"], s) for cand, s in zip(cands, seen))
    final = tio.load_encoder(out)
    assert all(torch.equal(final[k]["w"], cands[1][k]["w"]) for k in final)
    assert not torch.equal(cands[0]["conv1"]["w"], cands[1]["conv1"]["w"])


def test_cli_flags_match_jax_parser(monkeypatch):
    j = _options(jax_parser(monkeypatch, jcli))
    t = _options(tcli.build_parser())
    assert t.pop("device") == (("--device",), "cuda", "str", None, None, False)
    assert t == j


def test_cli_main_trains_on_the_cpu_and_writes_a_loadable_encoder(tmp_path, monkeypatch):
    # one-step chunks (the CLI has no flag for them; the default is 100)
    monkeypatch.setattr(tcli, "PretrainConfig", functools.partial(tep.PretrainConfig, chunk_steps=1))
    monkeypatch.setattr(tep, "build_corpus", functools.partial(tep.build_corpus, workers=1))
    res = tcli.main([str(tmp_path / "enc.pt"), "--num_scenes", "2", "--views_per_scene", "8", "--image_height",
                     "48", "--image_width", "64", "--steps", "2", "--batch_images", "2", "--contrastive_weight",
                     "0.2", "--device", "cpu"])
    assert len(res["history"]) == len(res["chunk_means"]) == 2
    assert all(np.isfinite(h["loss"]) for h in res["history"])
    ref = tio.load_encoder(ENCODER)
    got = tio.load_encoder(tmp_path / "enc.pt")
    assert {k: v["w"].shape for k, v in got.items()} == {k: v["w"].shape for k, v in ref.items()}
    assert set(jio.load_encoder(tmp_path / "enc.pt")) == set(ref)  # the JAX package reads the file too
    assert torch.equal(got["conv1"]["w"], res["encoder"]["conv1"]["w"])
