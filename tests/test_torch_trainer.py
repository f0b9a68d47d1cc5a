"""The port's mapping trainer against acezero_tpu's.

Tolerances: the loss on a fixed batch at rtol 1e-3 and each parameter
leaf's gradient within relative Frobenius 2e-2 — both packages run the
head chain in bf16 at the same rounding points (the JAX side through its
Pallas VJP in interpret mode, `use_fused_head=True`), but sum in other
orders, so single bf16 values and, rarely, ReLU masks flip; the pose and
focal algebra is float32 in both. Ten training steps on the same batches:
the loss trajectory within 2% (the bf16 noise above, compounded by ten
AdamW steps). The mini mapping loop is the convergence check of
tests/test_trainer.py:75-130 at a smaller size.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import acezero_tpu.ops.fused_head as jfh
from acezero_tpu.models.head import HeadConfig as JHeadConfig
from acezero_tpu.models.head import init_head_params as j_init_head
from acezero_tpu.models.posenet import init_posenet_params as j_init_posenet
from acezero_tpu.training import trainer as jt
from acezero_tpu.training.optim import adamw_init as j_adamw_init
from acezero_tpu.training.schedule import init_schedule as j_init_schedule
from acezero_tpu_torch.data.images import DecodedImages
from acezero_tpu_torch.data.scene import SceneData
from acezero_tpu_torch.models import torch_io as tio
from acezero_tpu_torch.models.encoder import init_encoder_params
from acezero_tpu_torch.models.head import HeadConfig, head_apply_flat
from acezero_tpu_torch.training import optim as to
from acezero_tpu_torch.training import trainer as tt
from acezero_tpu_torch.training.buffer import BufferConfig, fill_training_buffer
from acezero_tpu_torch.training.loss import ReproLossConfig
from acezero_tpu_torch.training.schedule import ScheduleConfig, init_schedule

sys.path.insert(0, str(Path(__file__).resolve().parent))
from synthetic import render_room_scene  # noqa: E402

SCENE = Path(__file__).resolve().parents[1] / "results" / "heldout" / "scenes" / "chesslike_a"
B = 512
HC, WC = 60, 80  # canvas of the fixed batch (cells 7 x 10)


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(jfh, "INTERPRET", True)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These tests run thousands of small CPU ops; beside other test
    processes, torch's default thread pool oversubscribes the cores and
    they slow down many times over. tests/test_torch_pipeline.py and
    tests/test_torch_mesh.py import this fixture too."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ctx_np():
    poses = np.stack([np.loadtxt(SCENE / f"frame_{i:04d}_pose.txt") for i in range(0, 40, 10)])
    w2c = np.linalg.inv(poses).astype(np.float32)
    # the scene point 2 m in front of the cameras, on average: the head's mean
    mean = np.mean(poses[:, :3, 3] + 2.0 * poses[:, :3, 2], axis=0).astype(np.float32)
    return {"poses_w2c": w2c[:, :3, :4], "focals": np.full(4, 65.0, np.float32),
            "ppx": np.float32(WC / 2.0), "ppy": np.float32(HC / 2.0)}, mean, poses


def _batch_np(rng, poses, n=B):
    img_idx = rng.integers(0, 4, n).astype(np.int32)
    px = np.stack([rng.uniform(0, WC, n), rng.uniform(0, HC, n)], -1).astype(np.float32)
    # depth targets: 2 m in front of the camera, some cells without one
    crds = (poses[img_idx, :3, 3] + 2.0 * poses[img_idx, :3, 2] + rng.normal(size=(n, 3)) * 0.3).astype(np.float32)
    crds[rng.uniform(size=n) < 0.2] = 0.0
    return {"features": np.abs(rng.normal(size=(n, 512))).astype(np.float32),
            "target_px": px, "target_crds": crds, "img_idx": img_idx,
            "theta": rng.uniform(-0.2, 0.2, n).astype(np.float32),
            "scale": rng.uniform(0.8, 1.3, n).astype(np.float32)}


def _params(seed, refinement, ctx, mean):
    head_j = jax.device_get(j_init_head(jax.random.PRNGKey(seed), JHeadConfig(), jnp.asarray(mean)))
    if refinement == "mlp":
        pose_j = jax.device_get(j_init_posenet(jax.random.PRNGKey(seed + 1)))
        _, head_t, pose_t = tio.params_from_jax(None, head_j, posenet_np=pose_j)
    else:
        _, head_t = tio.params_from_jax(None, head_j)
        pose_j = {}
        if refinement == "naive":
            noise = np.random.default_rng(seed).normal(size=ctx["poses_w2c"].shape).astype(np.float32) * 0.01
            pose_j = {"pose_buffer": ctx["poses_w2c"] + noise}
        pose_t = {k: torch.from_numpy(np.array(v)) for k, v in pose_j.items()}
    return head_j, pose_j, head_t, pose_t


def _cfgs(refinement, calib, depth, **kw):
    common = dict(pose_refinement=refinement, refine_calibration=calib, use_depth=depth, batch_size=B)
    cfg_j = jt.TrainConfig(use_fused_head=True, loss=jt.ReproLossConfig(loss_type="tanh"), **common, **kw)
    cfg_t = tt.TrainConfig(loss=ReproLossConfig(loss_type="tanh"), **common, **kw)
    return cfg_j, cfg_t


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if np.linalg.norm(want) == 0:
        return np.linalg.norm(got)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


@pytest.mark.parametrize("depth", [False, True])
@pytest.mark.parametrize("calib", [False, True])
@pytest.mark.parametrize("refinement", ["none", "naive", "mlp"])
def test_loss_and_grads_match_jax(refinement, calib, depth):
    ctx_np, mean, poses = _ctx_np()
    rng = np.random.default_rng(3)
    batch_np = _batch_np(rng, poses)
    head_j, pose_j, head_t, pose_t = _params(5, refinement, ctx_np, mean)
    cfg_j, cfg_t = _cfgs(refinement, calib, depth)
    focal_g = np.float32(0.05)
    it = 700

    trainable_j = (jax.tree.map(jnp.asarray, head_j), jax.tree.map(jnp.asarray, pose_j), jnp.asarray(focal_g))
    (loss_j, aux_j), grads_j = jax.value_and_grad(jt._loss_fn, has_aux=True)(
        trainable_j, jax.tree.map(jnp.asarray, batch_np), jax.tree.map(jnp.asarray, ctx_np), jt.train_hp(cfg_j),
        cfg_j, JHeadConfig(), jnp.asarray(it, jnp.int32))

    leaves = [t.requires_grad_(True) for t in to.tree_leaves((head_t, pose_t))]
    focal_t = torch.tensor(focal_g, requires_grad=True)
    batch_t = {k: torch.from_numpy(v) for k, v in batch_np.items()}
    ctx_t = {k: torch.as_tensor(v) for k, v in ctx_np.items()}
    loss_t, aux_t = tt._loss_fn((head_t, pose_t, focal_t), batch_t, ctx_t, tt.train_hp(cfg_t), cfg_t, HeadConfig(),
                                torch.tensor(it, dtype=torch.int32))
    grads_t = torch.autograd.grad(loss_t, leaves + [focal_t], allow_unused=True)

    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j), rtol=1e-3)
    assert abs(float(aux_t["batch_inliers"]) - float(aux_j["batch_inliers"])) <= 2.0 / B
    want = jax.tree.leaves(jax.device_get(grads_j))
    assert len(want) == len(grads_t)
    for i, (g, w) in enumerate(zip(grads_t, want)):
        g = np.zeros(np.shape(w), np.float32) if g is None else g.numpy()
        assert _rel(g, w) <= 2e-2, (i, _rel(g, w))


def _jax_state(head_j, pose_j, cfg_j, key):
    f0 = jnp.asarray(0.0, jnp.float32)
    head = jax.tree.map(jnp.asarray, head_j)
    pose = jax.tree.map(jnp.asarray, pose_j)
    return jt.TrainState(head_params=head, head_opt=j_adamw_init(head), pose_params=pose,
                         pose_opt=j_adamw_init(pose), focal_g=f0, focal_opt=j_adamw_init(f0),
                         sched=j_init_schedule(cfg_j.schedule), iteration=jnp.asarray(0, jnp.int32),
                         nan_steps=jnp.asarray(0, jnp.int32), key=key)


def test_ten_steps_match_jax():
    ctx_np, mean, poses = _ctx_np()
    rng = np.random.default_rng(4)
    buffer_np = _batch_np(rng, poses, n=2048)
    buffer_np["features"] = np.asarray(jnp.asarray(buffer_np["features"]).astype(jnp.bfloat16).astype(jnp.float32))
    head_j, pose_j, head_t, pose_t = _params(6, "mlp", ctx_np, mean)
    sched = dict(schedule=ScheduleConfig(schedule="1cyclepoly", iterations=100, warmup_iterations=5,
                                         learning_rate_max=0.003, cooldown_iterations=20))
    cfg_j, cfg_t = _cfgs("mlp", True, False, **sched)
    cfg_j = cfg_j.__class__(**{**cfg_j.__dict__, "schedule": jt.ScheduleConfig(**sched["schedule"].__dict__)})

    key = jax.random.PRNGKey(9)
    buffer_j = {k: jnp.asarray(v).astype(jnp.bfloat16) if k == "features" else jnp.asarray(v)
                for k, v in buffer_np.items()}
    _, stats_j = jt._train_chunk(_jax_state(head_j, pose_j, cfg_j, key), buffer_j,
                                 jax.tree.map(jnp.asarray, ctx_np), cfg_j, JHeadConfig(), 10)
    # the JAX chunk's batch rows: one key split per step (trainer.py:367-370)
    idx, k = [], key
    for _ in range(10):
        k, k_batch = jax.random.split(k)
        idx.append(np.array(jax.random.randint(k_batch, (B,), 0, 2048)))

    focal = torch.zeros(())
    state = tt.TrainState(head_params=head_t, head_opt=to.adamw_init(head_t), pose_params=pose_t,
                          pose_opt=to.adamw_init(pose_t), focal_g=focal, focal_opt=to.adamw_init(focal),
                          sched=init_schedule(cfg_t.schedule), iteration=torch.zeros((), dtype=torch.int32),
                          nan_steps=torch.zeros((), dtype=torch.int32))
    buffer_t = {k: torch.from_numpy(np.array(v)).to(torch.bfloat16 if k == "features" else None)
                for k, v in buffer_np.items()}
    state, stats_t = tt.train_steps(state, buffer_t, {k: torch.as_tensor(v) for k, v in ctx_np.items()},
                                    tt.train_hp(cfg_t), cfg_t, HeadConfig(), 10, batch_indices=idx)
    loss_j = np.asarray(stats_j["loss"])
    loss_t = stats_t["loss"].numpy()
    assert np.isfinite(loss_t).all() and int(state.iteration) == 10
    np.testing.assert_allclose(loss_t, loss_j, rtol=0.02)
    np.testing.assert_allclose(stats_t["lr"].numpy(), np.asarray(stats_j["lr"]), rtol=1e-6)


def _synthetic_scene(data, depth_idx):
    n, h, w = data["images_u8"].shape
    hw = np.tile(np.asarray([[h, w]], np.int32), (n, 1))
    images = DecodedImages(canvases=data["images_u8"], sizes=hw, orig_sizes=hw,
                           scale_factors=np.ones(n, np.float32))
    scene = SceneData(rgb_files=[f"synthetic_{i:03d}.png" for i in range(n)], images=images,
                      poses_c2w=data["poses_c2w"].astype(np.float32), pose_valid=np.ones(n, bool),
                      focals_canvas=np.full(n, data["focal"], np.float32),
                      focals_orig=np.full(n, data["focal"], np.float32))
    for i in depth_idx:
        scene.depth_maps[i] = data["depth"][i]
    return scene


def test_mini_mapping_loop_converges():
    """A 1-image seed with ground-truth depth drives the predictions towards
    the back-projected targets (tests/test_trainer.py:75-130, smaller)."""
    torch.manual_seed(0)
    data = render_room_scene(1, h=48, w=64, focal=55.0)
    scene = _synthetic_scene(data, [0])
    cfg = tt.TrainConfig(batch_size=256, use_depth=True, chunk_steps=40, sync_every_chunks=2,
                         schedule=ScheduleConfig(schedule="constant", iterations=120, learning_rate_min=0.003),
                         loss=ReproLossConfig(loss_type="tanh", total_iterations=120), iterations_output=40)
    buf_cfg = BufferConfig(max_buffer_size=2048, samples_per_image=256, max_dataset_passes=8, image_chunk=1)
    enc = init_encoder_params(torch.Generator().manual_seed(2))
    trainer = tt.MappingTrainer(scene, enc, HeadConfig(), cfg, buf_cfg)
    result = trainer.train()
    assert result["iterations"] == result["steps"] == 120
    assert [e["iteration"] for e in result["log"]] == [40, 80, 120]

    clean = fill_training_buffer(enc, scene.images.canvases, scene.images.sizes,
                                 BufferConfig(max_buffer_size=512, samples_per_image=256, max_dataset_passes=2,
                                              use_aug=False, image_chunk=1),
                                 target_maps=trainer._seed_target_maps(), generator=torch.Generator().manual_seed(3))
    target = clean["target_crds"].numpy()
    valid = np.abs(target).sum(-1) > 1e-5
    with torch.no_grad():
        err = np.linalg.norm(head_apply_flat(result["head_params"], HeadConfig(), clean["features"]).numpy()
                             - target, axis=-1)[valid]
        err0 = np.linalg.norm(head_apply_flat(trainer.head_params_init, HeadConfig(), clean["features"]).numpy()
                              - target, axis=-1)[valid]
    assert np.median(err) < 0.45 * np.median(err0), (np.median(err), np.median(err0))
    R = result["poses_w2c"][:, :3, :3]
    np.testing.assert_allclose(R @ R.transpose(0, 2, 1), np.eye(3)[None], atol=1e-5)


@pytest.mark.parametrize("use_depth,refine", [(False, "mlp"), (True, "none")])
def test_host_spill_matches_device_buffer(use_depth, refine):
    """buffer_host_spill keeps the buffer on the host and streams each
    step's batch from it (a worker thread gathers ahead): from one seed it
    fills the same rows and trains the same bits as the device buffer, over
    two sync groups (66 steps, then 4), the first past one draw group (64
    steps). Both run on the CPU here; tests/test_torch_cuda.py holds the
    card."""
    data = render_room_scene(3, h=24, w=32)
    out = {}
    for spill in (False, True):
        cfg = tt.TrainConfig(batch_size=64, schedule=ScheduleConfig(iterations=70), use_depth=use_depth,
                             pose_refinement=refine, refine_calibration=refine == "mlp", buffer_host_spill=spill,
                             chunk_steps=33, sync_every_chunks=2)
        trainer = tt.MappingTrainer(_synthetic_scene(data, [0] if use_depth else []),
                                    init_encoder_params(torch.Generator().manual_seed(0)), HeadConfig(), cfg,
                                    BufferConfig(max_buffer_size=1024, samples_per_image=128, max_dataset_passes=2),
                                    base_seed=11)
        buffer = trainer.build_buffer()
        state, it, steps, _ = trainer.train_to_budget(trainer.build_state(), buffer)
        out[spill] = (buffer, state, it, steps)
    for k in out[False][0]:
        assert torch.equal(out[False][0][k], out[True][0][k]), k
    assert out[False][2:] == out[True][2:] == (70, 70)
    for a, b in zip(to.tree_leaves((out[False][1].head_params, out[False][1].pose_params, out[False][1].focal_g)),
                    to.tree_leaves((out[True][1].head_params, out[True][1].pose_params, out[True][1].focal_g))):
        assert torch.equal(a, b)


def test_frame_callback_at_every_sync():
    """The pipeline's per-sync hook (JAX trainer.py:606-609): with a callback
    the trainer syncs every chunk_steps steps and, with iterations_output at
    the chunk length, calls it at each sync with the (N, 3, 4) refined
    world-to-camera poses; the last call comes at the final iteration."""
    data = render_room_scene(3, h=24, w=32)
    calls = []
    cfg = tt.TrainConfig(batch_size=64, chunk_steps=10, sync_every_chunks=4, iterations_output=10,
                         pose_refinement="mlp",
                         schedule=ScheduleConfig(schedule="constant", iterations=35, learning_rate_min=0.003),
                         loss=ReproLossConfig(loss_type="tanh", total_iterations=35))
    buf_cfg = BufferConfig(max_buffer_size=1024, samples_per_image=64, max_dataset_passes=2, image_chunk=3)
    trainer = tt.MappingTrainer(_synthetic_scene(data, []), init_encoder_params(torch.Generator().manual_seed(0)),
                                HeadConfig(), cfg, buf_cfg,
                                frame_callback=lambda it, poses: calls.append((it, poses)))
    result = trainer.train()
    assert [it for it, _ in calls] == [10, 20, 30, 35] and result["iterations"] == 35
    for _, poses in calls:
        assert isinstance(poses, np.ndarray) and poses.shape == (3, 3, 4) and np.isfinite(poses).all()
    np.testing.assert_array_equal(calls[-1][1], result["poses_w2c"])
