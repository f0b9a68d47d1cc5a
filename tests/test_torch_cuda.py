"""The port's CUDA kernels on the card: built with nvcc, held against their
plain versions at the main path's shapes. Skipped where there is no card;
run them on the machine with the card:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(`--noconftest` because tests/conftest.py imports jax, which that machine
may not have.)
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from acezero_tpu_torch.ops import fused_head as fh
from acezero_tpu_torch.utils.precision import no_tf32

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there (no interpret mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("B,tags", [(307_200, (0, 0, 1, 0, 0, 1, 0, 0)),
                                    (3 * 4800 + 37, (0, 0, 1, 0, 0)),
                                    (4800, (0, 0, 1, 0, 0, 1, 0, 0, 1, 0, 0)),
                                    (5120, (0, 0, 1, 0, 0, 1, 0, 0)),
                                    (1, (0, 0, 1, 0, 0, 1, 0, 0)),
                                    (64, (0, 0, 1, 0, 0, 1, 0, 0)),
                                    (65, (0, 0, 1, 0, 0, 1, 0, 0)),
                                    (5120, (0,)),
                                    (5120 + 37, (1,)),
                                    (132 * 64, (0, 0, 1, 0, 0, 1, 0, 0)),
                                    ((2 * 132 + 1) * 64 + 37, (0, 0, 1, 0, 0, 1, 0, 0))])
def test_fused_head_fwd_matches_plain(cuda, B, tags):
    """K1 against its plain version at relative Frobenius 1e-2: the main
    paths' shapes, the tile edges, one layer with and without the residual
    add, a full H100 (one tile per SM) and a persistent grid whose tile count
    is no multiple of the SMs."""
    rng = np.random.default_rng(B)
    L = len(tags)
    x = torch.from_numpy(rng.normal(size=(B, 512)).astype(np.float32) * 0.5).to(cuda, torch.bfloat16)
    w = torch.from_numpy(rng.uniform(-1, 1, (L, 512, 512)).astype(np.float32) / 512**0.5).to(cuda, torch.bfloat16)
    b = torch.from_numpy(rng.uniform(-1, 1, (L, 512)).astype(np.float32) / 512**0.5).to(cuda)
    before = fh.LAUNCHES
    out = fh.fused_head_chain(x, w, b, tags)
    torch.cuda.synchronize()
    assert fh.LAUNCHES == before + 1
    with no_tf32():
        ref = fh.fused_head_chain_plain(x, w, b, tags).float()
    rel = float((out.float() - ref).norm() / ref.norm())
    assert rel <= 1e-2


@pytest.mark.parametrize("B,tags", [(5120, (0, 0, 1, 0, 0, 1, 0, 0)),
                                    (5120 + 37, (0, 0, 1, 0, 0, 1, 0, 0)),
                                    (5120, (0, 0, 1, 0, 0)),
                                    (5120, (0, 0, 1, 0, 0, 1, 0, 0, 1, 0, 0)),
                                    (1, (0, 0, 1, 0, 0, 1, 0, 0)),
                                    (64, (0, 0, 1, 0, 0, 1, 0, 0)),
                                    (65, (0, 0, 1, 0, 0, 1, 0, 0)),
                                    (5120, (0,)),
                                    (5120 + 37, (1,))])
def test_fused_head_bwd_matches_plain(cuda, B, tags):
    """K2 against its plain version: relative Frobenius 2e-2 (chip_smoke.py
    K2_TOL: tensor-core and IEEE sums flip single bf16 roundings and, rarely,
    ReLU masks, compounded over the walk back); the Function's dW, db against
    autograd of the plain chain at 2e-2."""
    rng = np.random.default_rng(B + len(tags))
    L = len(tags)
    x = torch.from_numpy(rng.normal(size=(B, 512)).astype(np.float32) * 0.5).to(cuda, torch.bfloat16)
    w = torch.from_numpy(rng.uniform(-1, 1, (L, 512, 512)).astype(np.float32) / 512**0.5).to(cuda, torch.bfloat16)
    b = torch.from_numpy(rng.uniform(-1, 1, (L, 512)).astype(np.float32) / 512**0.5).to(cuda)
    g = torch.from_numpy(rng.normal(size=(B, 512)).astype(np.float32) * 1e-2).to(cuda, torch.bfloat16)
    before = fh.LAUNCHES_BWD
    out = fh.fused_head_chain_backward(x, w, b, g, tags)
    torch.cuda.synchronize()
    assert fh.LAUNCHES_BWD == before + 1
    with no_tf32():
        ref = fh.fused_head_chain_backward_plain(x, w, b, g, tags)
    for o, r in zip(out, ref):
        assert o.shape == r.shape and o.dtype == torch.bfloat16
        assert float((o.float() - r.float()).norm() / r.float().norm()) <= 2e-2
    grads = []
    for fn in (lambda *a: fh.FusedHeadChain.apply(*a, tags), lambda *a: fh.fused_head_chain_plain(*a, tags)):
        wf = w.float().requires_grad_(True)
        bf = b.clone().requires_grad_(True)
        with no_tf32():
            (fn(x, wf, bf).float() * g.float()).sum().backward()
        grads.append((wf.grad, bf.grad))
    for got, want in zip(*grads):
        assert float((got - want).norm() / want.norm()) <= 2e-2


def test_mini_reconstruction_loop_on_the_card(cuda, tmp_path):
    """The reconstruction CLI's mini loop (tests/test_pipeline_e2e.py:32's
    budgets) on 10 chesslike_a frames with their depth files at a 120-pixel
    short side: the same artifacts as on the CPU, a 10-line poses_final.txt,
    and both kernels launched by the run."""
    from acezero_tpu_torch.cli import ace_zero_cli
    from acezero_tpu_torch.io.pose_files import read_pose_file

    scene = Path(__file__).resolve().parents[1] / "results" / "heldout" / "scenes" / "chesslike_a"
    argv = [str(scene / "frame_000?.png"), str(tmp_path), "--depth_files", str(scene / "frame_000?_depth.npy"),
            "--use_external_focal_length", "520", "--image_resolution", "120", "--try_seeds", "1",
            "--seed_iterations", "20", "--iterations", "30", "--iterations_max", "2",
            "--learning_rate_schedule", "constant", "--max_dataset_passes", "2", "--num_head_blocks", "0",
            "--ransac_iterations", "8", "--registration_confidence", "5", "--final_refine", "false",
            "--final_refit", "false", "--loop_closure", "false"]
    fwd, bwd = fh.LAUNCHES, fh.LAUNCHES_BWD
    result = ace_zero_cli.main(argv, learning_rate_min=0.003, max_training_buffer_size=2048, samples_per_image=128,
                               batch_size=128, chunk_steps=10, registration_frame_chunk=8, refinement_steps=2)
    torch.cuda.synchronize()
    assert fh.LAUNCHES > fwd and fh.LAUNCHES_BWD - bwd == 50  # 20 seed steps + 30 round steps
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == ["iteration0_seed0.pt", "iteration1.pt", "poses_final.txt", "poses_iteration0_seed0.txt",
                     "poses_iteration0_seed0_fastcheck.txt", "poses_iteration1.txt",
                     "poses_iteration1_preliminary.txt"]
    entries = read_pose_file(tmp_path / "poses_final.txt")
    assert len(entries) == 10 and all(np.isfinite(e.pose_w2c).all() for e in entries)
    assert result["iterations"] == 1 and all(0.0 <= r <= 1.0 for r in result["rate_history"])


@pytest.mark.parametrize("frames,stride", [(12, 16), (16, 8)])
def test_loop_close_core_card_matches_cpu(cuda, frames, stride):
    """The port's loop_close_core on the card against itself on the CPU, on
    drifted exact maps of chesslike_a frames (30 x 40 and 60 x 80 cells,
    chip_smoke.drifted_chesslike): the same selected pairs and surviving
    edges, and every pairwise fit and every frame's correction within 1e-3
    of the scene diagonal and 0.05 deg, scales within 1e-3. The card's
    cuSOLVER eigensolves and cuBLAS products (TF32 off) sum in another order
    than the CPU's."""
    from acezero_tpu_torch.reconstruct import loopclose as lc

    maps, feats, w2c, focals, hw = chip_smoke.drifted_chesslike(np, frames, stride)
    out = {}
    for dev in ("cpu", cuda):
        out[str(dev)] = chip_smoke.core_with_fits(
            np, lc, torch.from_numpy(maps).to(dev), torch.from_numpy(feats).to(dev),
            torch.ones(maps.shape[:3], dtype=torch.bool, device=dev), w2c, np.full(frames, 2000.0), focals, hw, 500.0)
    assert "skipped" not in out["cuda"][3] and "skipped" not in out["cpu"][3]
    d = chip_smoke.card_vs_cpu(np, out["cuda"], out["cpu"])
    assert d["pairs_equal"] and d["edges_card"] == d["edges_cpu"] >= 2 * frames
    tol = 1e-3 * d["scene_diag"]
    assert d["edge_fits"]["trans"]["max"] <= tol and d["edge_fits"]["rot_deg"]["max"] <= 0.05
    assert d["frame_corrections"]["trans"]["max"] <= tol and d["frame_corrections"]["rot_deg"]["max"] <= 0.05
    assert d["frame_corrections"]["scale_max"] <= 1e-3


def test_ba_and_loop_close_core_repeat_bit_for_bit(cuda):
    """loop_close_core and refine_poses_ba run twice on the card on one
    input give the same bits: no sum on the path depends on thread order
    (the BA's normal equations accumulate in a fixed order). Drifted exact
    maps of 16 chesslike_a frames at 60 x 80 cells, the BA on their
    matches."""
    from acezero_tpu_torch.reconstruct import loopclose as lc
    from acezero_tpu_torch.reconstruct.ba import refine_poses_ba

    maps, feats, w2c, focals, hw = chip_smoke.drifted_chesslike(np, 16, 8)
    args = (torch.from_numpy(maps).to(cuda), torch.from_numpy(feats).to(cuda),
            torch.ones(maps.shape[:3], dtype=torch.bool, device=cuda), w2c, np.full(16, 2000.0), focals, hw, 500.0)
    runs = [lc.loop_close_core(*args) for _ in range(2)]
    assert "skipped" not in runs[0][3]
    for a, b in zip(runs[0][:3], runs[1][:3]):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    data = runs[0][3]["ba_data"]
    E = len(data["pairs"])
    ba = [refine_poses_ba(w2c, focals, (hw[1] / 2.0, hw[0] / 2.0), data["pairs"],
                          np.broadcast_to(data["u_src"][None], (E,) + data["u_src"].shape), data["u_tgt"], data["ok"],
                          device=cuda) for _ in range(2)]
    assert "skipped" not in ba[0][1] and ba[0][1]["n_tracks"] >= 64
    assert np.array_equal(ba[0][0], ba[1][0]) and ba[0][1] == ba[1][1]


def test_learned_depth_card_matches_cpu(cuda):
    """The learned seed-depth estimator (v4 head, v6 encoder) on a
    chesslike_a frame: finite positive depth at 480 x 640, and the card
    within chip_smoke.SEEDDEPTH_CPU_TOL of the port's CPU path in log-depth
    (cuDNN and the CPU round the bf16 convolutions' sums in other orders)."""
    from acezero_tpu_torch.data.depth import learned_depth_estimator
    from acezero_tpu_torch.data.images import read_rgb

    img = read_rgb(chip_smoke.SCENE / "frame_0006.png")
    d = {dev: learned_depth_estimator(chip_smoke.DEPTH_HEAD, encoder_path=chip_smoke.ENCODER, device=dev)(img)
         for dev in (cuda, "cpu")}
    assert d[cuda].shape == (480, 640) and np.isfinite(d[cuda]).all() and (d[cuda] > 0).all()
    assert np.abs(np.log(d[cuda]) - np.log(d["cpu"])).max() <= chip_smoke.SEEDDEPTH_CPU_TOL


def test_host_spill_matches_device_buffer_bit_for_bit(cuda):
    """MappingTrainer on 8 chesslike_a frames at their shipped poses (120-pixel
    side, batch 1,024): the host-spill buffer (pinned host rows, batches
    streamed on a side stream) and the device buffer from one seed fill the
    same rows and train the same bits over 60 steps, across sync groups."""
    from acezero_tpu_torch.data.scene import load_scene
    from acezero_tpu_torch.models import torch_io
    from acezero_tpu_torch.models.head import HeadConfig
    from acezero_tpu_torch.training import BufferConfig, MappingTrainer, ScheduleConfig, TrainConfig
    from acezero_tpu_torch.training.optim import tree_leaves

    s = chip_smoke.SCENE
    scene = load_scene(str(s / "frame_000[0-7].png"), pose_files=str(s / "frame_000[0-7]_pose.txt"),
                       external_focal_length=520.0, image_short_size=120)
    enc = torch_io.load_encoder(chip_smoke.ENCODER, cuda)
    out = {}
    for spill in (False, True):
        cfg = TrainConfig(batch_size=1024, schedule=ScheduleConfig(iterations=60), buffer_host_spill=spill,
                          chunk_steps=7, sync_every_chunks=2)
        trainer = MappingTrainer(scene, enc, HeadConfig(), cfg, BufferConfig(samples_per_image=256), base_seed=5)
        buffer = trainer.build_buffer()
        assert (buffer["features"].device.type == "cpu") == spill and (not spill or buffer["features"].is_pinned())
        state = trainer.train_to_budget(trainer.build_state(), buffer)[0]
        out[spill] = ({k: v.cpu() for k, v in buffer.items()}, [t.cpu() for t in tree_leaves(state.head_params)],
                      int(state.iteration))
    assert all(torch.equal(out[False][0][k], out[True][0][k]) for k in out[False][0])
    assert out[False][2] == out[True][2] == 60
    assert all(torch.equal(a, b) for a, b in zip(out[False][1], out[True][1]))


def test_renderer_card_matches_cpu_and_repeats(cuda):
    """The splat renderer at 720 x 1280 on 300,000 points: the card within
    0.1% of the CPU's pixels, and the same bits when run twice (the
    depth and winner scatters are min and max, independent of order)."""
    from acezero_tpu_torch.viz.renderer import composite_frame

    rng = np.random.default_rng(12)
    xyz = (rng.normal(size=(300_000, 3)) * [1.5, 1.0, 0.8] + [0, 0, 4.0]).astype(np.float32)
    rgb = rng.uniform(size=(300_000, 3)).astype(np.float32)
    cams = (rng.normal(size=(2_000, 3)) + [0, 0, 4.0]).astype(np.float32), rng.uniform(size=(2_000, 3)).astype(
        np.float32)
    view = np.eye(4)
    view[:3, 3] = [0.1, -0.2, 0.3]
    xyz_d, rgb_d = torch.from_numpy(xyz).to(cuda), torch.from_numpy(rgb).to(cuda)
    card = [composite_frame(xyz_d, rgb_d, *cams, view, 800.0, 720, 1280) for _ in range(2)]
    cpu = composite_frame(xyz, rgb, *cams, view, 800.0, 720, 1280, device="cpu")
    assert np.array_equal(card[0], card[1])
    assert np.any(card[0] != cpu, axis=-1).mean() <= 1e-3
    assert (card[0] != 255).any()


def test_regressor_equals_predict_coords_on_the_card(cuda):
    """Regressor.forward and the export's predict_coords run the same
    encoder and K1 launch on the same canvases: the same bits."""
    from acezero_tpu_torch.data.augment import normalize_images
    from acezero_tpu_torch.export.point_cloud import predict_coords
    from acezero_tpu_torch.models import Regressor

    reg = Regressor.create_from_split_state_dict(chip_smoke.ENCODER, chip_smoke.HEAD)
    canvases = np.random.default_rng(13).integers(0, 256, (8, 96, 128)).astype(np.uint8)
    before = fh.LAUNCHES
    want = predict_coords(reg.encoder_params, reg.head_params, reg.head_cfg, canvases)
    with torch.inference_mode():
        got = reg.forward(normalize_images(torch.from_numpy(canvases).to(cuda))).cpu().numpy()
    assert fh.LAUNCHES == before + 2
    assert np.array_equal(got, want) and np.isfinite(got).all()


def test_pretrain_steps_card_match_cpu_with_one_head_launch_per_image(cuda):
    """Two encoder-pretraining steps past the warm-up (exact supervision,
    contrastive pairs, augmentation) and two seed-depth steps from the same
    parameters and draws on the card and on the CPU: every loss term within
    chip_smoke's PRETRAIN_CPU_RTOL, each tree's update within its
    PRETRAIN_UPDATE_TOL, and K1 and K2 launched once an image a step."""
    from acezero_tpu_torch.models import torch_io
    from acezero_tpu_torch.models.depthnet import init_depth_head_params
    from acezero_tpu_torch.models.head import HeadConfig
    from acezero_tpu_torch.pretrain import depth_pretrain as tdp
    from acezero_tpu_torch.pretrain import encoder_pretrain as tep
    from acezero_tpu_torch.training.optim import adamw_init, tree_leaves, tree_unflatten

    def to(tree, dev):
        return tree_unflatten(tree, [t.to(dev) for t in tree_leaves(tree)])

    cfg = tep.PretrainConfig(num_scenes=2, views_per_scene=12, image_h=96, image_w=128, batch_images=4,
                             contrastive_weight=0.2, across_frac=1.0)
    corpus = tep.build_corpus(cfg, workers=1)
    params = tep.init_params(cfg, corpus)
    draws = chip_smoke.pretrain_draws(torch, tep, cfg, len(corpus["images_u8"]), 2, seed=7)
    stats, after, launches = {}, {}, None
    for dev in (cuda, torch.device("cpu")):
        p = to(params, dev)
        before = (fh.LAUNCHES, fh.LAUNCHES_BWD)
        after[dev.type], _, st = tep.pretrain_chunk(
            p, (adamw_init(p["encoder"]), adamw_init(p["heads"])), tep.corpus_to_device(corpus, cfg, dev),
            chip_smoke.PRETRAIN_CPU_STEP0, cfg, HeadConfig(num_head_blocks=0), draws=draws)
        stats[dev.type] = {k: v.cpu() for k, v in st.items()}
        if dev.type == "cuda":
            torch.cuda.synchronize()
            launches = (fh.LAUNCHES - before[0], fh.LAUNCHES_BWD - before[1])
    assert launches == (2 * cfg.batch_images, 2 * cfg.batch_images)
    for k in tep.STATS:
        card, cpu = stats["cuda"][k], stats["cpu"][k]
        assert torch.isfinite(card).all()
        assert ((card - cpu).abs() <= chip_smoke.PRETRAIN_CPU_RTOL * cpu.abs().clamp(min=1e-6)).all(), (k, card, cpu)
    for t in ("encoder", "heads"):
        upd = chip_smoke.rel_update(torch, tree_leaves, after["cuda"][t], params[t], after["cpu"][t])
        assert upd <= chip_smoke.PRETRAIN_UPDATE_TOL, (t, upd)

    dcfg = tdp.DepthPretrainConfig(num_scenes=2, views_per_scene=4, image_h=96, image_w=128, batch_images=4, steps=2)
    images, gt = tdp.build_depth_corpus(dcfg)
    order = np.random.default_rng(dcfg.seed).integers(0, len(images), (2, dcfg.batch_images))
    init = init_depth_head_params(torch.Generator().manual_seed(dcfg.seed))
    losses, heads = {}, {}
    for dev in (cuda, torch.device("cpu")):
        p = to(init, dev)
        heads[dev.type], _, l = tdp.train_chunk(p, adamw_init(p), torch_io.load_encoder(chip_smoke.ENCODER, dev),
                                  torch.from_numpy(images).to(dev), torch.from_numpy(gt).to(dev),
                                  torch.from_numpy(order).to(dev), tdp.lr_table(dcfg), dcfg.silog_lambda,
                                  dcfg.grad_loss_weight)
        losses[dev.type] = l.cpu()
    assert ((losses["cuda"] - losses["cpu"]).abs() <= chip_smoke.PRETRAIN_CPU_RTOL * losses["cpu"].abs()).all()
    upd = chip_smoke.rel_update(torch, tree_leaves, heads["cuda"], init, heads["cpu"])
    assert upd <= chip_smoke.PRETRAIN_UPDATE_TOL, upd
