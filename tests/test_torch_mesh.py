"""The data mesh (acezero_tpu_torch/parallel/mesh.py) and the paths that run
over it, on the CPU.

torch has one CPU device, so these tests run on logical meshes: one device
named N times (`make_mesh(devices=["cpu"] * N)`); the sharding, gathers,
reductions and splits are the ones that run on several cards.

Bounds:
- `gather_rows` is bit-equal to indexing the whole buffer; a mesh of one
  device gives the bits of no mesh for `train_steps`, `MappingTrainer` and
  `register_frames`.
- Ten steps on a 4-shard mesh against one device on the same batch rows:
  the first step's loss within 1e-6 relative (only the order of the sums
  differs: measured 6.5e-8), the ten steps' losses within 2e-2, the
  parameters within 0.1 relative Frobenius, the schedule's discrete state
  equal and its rolling inlier fractions within 2e-2. The bf16 chain and
  AdamW's early, nearly sign-like steps turn any change in summation order
  into diverging trajectories: one device on the same rows in another
  order drifts as far (measured on this CPU: losses 1.0-1.7e-2 apart and
  parameters 2.4-3.1e-2 after ten steps; the 4-shard mesh 0.8e-2 and
  4.2e-2), so bounds of 1e-5 and 1e-4 cannot hold.
- The 4-shard mesh against the JAX package's `_train_chunk` on its own
  4-device mesh with the JAX draws: the learning rate within 1e-6 and the
  loss within 4e-2 relative, where `test_ten_steps_match_jax` holds one
  device to 2e-2. On the CPU the JAX package's 4-device run gives the bits
  of its one-device run, so the mesh inherits the one-device gap (1.76e-2
  at step 6 of these draws) and adds the port's own summation-order spread
  (0.97e-2 between its 4-shard and one-device runs): measured 2.74e-2.
- Registration on a 4-shard mesh, with scene coordinates stubbed as in
  `test_two_tier_driver_composition`, for given hypothesis indices and for
  the generator's draws (made once on the primary, so the same as one
  device's): not the same bits, since the registrar's batched solves and
  sums round otherwise at another batch size (poses about 3e-7 apart), but
  the same frames valid, inliers within max(1, 1%), and poses within the
  bounds of tests/test_torch_registration.py:127-130 (1e-3 m, 0.05 deg)
  for three frames in four and within the stub maps' noise for all
  (`_entries_close` says why).
- One mini loop (tests/test_torch_pipeline.py's) on a 2-shard mesh against
  the JAX pipeline on its 8-device mesh: the artifacts, frames and rate
  band of `test_mini_loop_matches_jax`. It is marked `slow`, as every
  end-to-end parity test but tests/test_torch_pipeline.py's one mini loop
  (the JAX pipeline on 8 virtual devices alone takes over a minute here,
  and far longer beside the other test files).
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
from acezero_tpu.parallel.mesh import make_mesh as j_make_mesh
from acezero_tpu.parallel.mesh import replicate as j_replicate
from acezero_tpu.parallel.mesh import shard_rows as j_shard_rows
from acezero_tpu.reconstruct import AceZeroConfig as JConfig
from acezero_tpu.reconstruct import AceZeroPipeline as JPipeline
from acezero_tpu.training import trainer as jt
import acezero_tpu_torch.reconstruct.pipeline as tpipe
from acezero_tpu_torch.cli import ace_zero_cli
from acezero_tpu_torch.models.encoder import init_encoder_params
from acezero_tpu_torch.models.head import HeadConfig, init_head_params
from acezero_tpu_torch.parallel import (
    DATA_AXIS,
    broadcast_,
    gather_rows,
    make_mesh,
    reduce_sum,
    replicate,
    shard_rows,
    split_positions,
)
from acezero_tpu_torch.reconstruct import AceZeroConfig
from acezero_tpu_torch.registration import driver as tdrv
from acezero_tpu_torch.registration import ransac as treg
from acezero_tpu_torch.training import optim as to
from acezero_tpu_torch.training import trainer as tt
from acezero_tpu_torch.training.buffer import BufferConfig
from acezero_tpu_torch.training.loss import ReproLossConfig
from acezero_tpu_torch.training.schedule import ScheduleConfig, init_schedule

sys.path.insert(0, str(Path(__file__).resolve().parent))
from synthetic import render_room_scene  # noqa: E402
from test_torch_pipeline import MINI, MINI_FLAGS, MINI_OVERRIDES, N, RATE_BAND, _scene_kw, scene_dir  # noqa: E402,F401
from test_torch_trainer import (  # noqa: E402,F401
    B,
    _batch_np,
    _cfgs,
    _ctx_np,
    _jax_state,
    _params,
    _synthetic_scene,
    one_torch_thread,
)

SCENE = Path(__file__).resolve().parents[1] / "results" / "heldout" / "scenes" / "chesslike_a"


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(jfh, "INTERPRET", True)


def _mesh(n):
    return make_mesh(devices=["cpu"] * n)


def _leaves_equal(a, b):
    la, lb = to.tree_leaves(a), to.tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


# ------------------------------------------------------------- the module


def test_make_mesh_raises_without_cuda_and_takes_named_devices(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for args in ((), (2,)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make_mesh(*args)
    mesh = make_mesh(devices=["cpu"] * 3)
    assert mesh.size == 3 and mesh.primary == torch.device("cpu") and DATA_AXIS == "data"
    assert make_mesh(2, devices=["cpu"] * 3).size == 2
    with pytest.raises(ValueError):
        make_mesh(devices=[])


def test_shard_replicate_broadcast_reduce_round_trips():
    rng = np.random.default_rng(0)
    tree = {"a": torch.from_numpy(rng.normal(size=(12, 5)).astype(np.float32)),
            "b": {"c": torch.arange(12, dtype=torch.int32)}, "l": [torch.ones(12, 2, dtype=torch.bfloat16)]}
    shards = shard_rows(tree, _mesh(3))
    assert len(shards) == 3 and all(s["a"].shape == (4, 5) for s in shards)
    assert torch.equal(torch.cat([s["a"] for s in shards]), tree["a"])
    assert torch.equal(torch.cat([s["b"]["c"] for s in shards]), tree["b"]["c"])
    assert torch.equal(torch.cat([s["l"][0] for s in shards]), tree["l"][0])
    with pytest.raises(ValueError, match="equal shards"):
        shard_rows({"x": torch.zeros(13)}, _mesh(3))

    reps = replicate(tree, _mesh(2))
    ptrs = {t.data_ptr() for t in to.tree_leaves(tree)}
    for rep in reps:
        assert _leaves_equal(rep, tree)
        # a replica on the primary's own device is a copy, never an alias
        assert not ptrs & {t.data_ptr() for t in to.tree_leaves(rep)}
    reps[0]["a"].add_(1.0)
    assert not torch.equal(reps[0]["a"], tree["a"]) and torch.equal(reps[1]["a"], tree["a"])
    new = {"a": tree["a"] * 2, "b": {"c": tree["b"]["c"] + 1}, "l": [tree["l"][0] * 3]}
    broadcast_(reps, new)
    assert all(_leaves_equal(rep, new) for rep in reps)

    xs = [torch.from_numpy(rng.normal(size=7).astype(np.float32)) for _ in range(3)]
    total = reduce_sum([{"v": x} for x in xs], "cpu")["v"]
    assert torch.equal(total, (xs[0] + xs[1]) + xs[2])
    assert reduce_sum([{"v": xs[0]}], "cpu")["v"] is xs[0]


@pytest.mark.parametrize("n", [1, 2, 3, 4, 8])
def test_gather_rows_bit_equal_to_indexing(n):
    """Global rows in, the batch split by position out (uneven B), bit-equal
    to indexing the whole buffer, with inf and NaN in rows never drawn."""
    rng = np.random.default_rng(n)
    M, B = 840, 101
    buffer = {"features": torch.from_numpy(rng.normal(size=(M, 16)).astype(np.float32)).to(torch.bfloat16),
              "target_px": torch.from_numpy(rng.normal(size=(M, 2)).astype(np.float32)),
              "img_idx": torch.from_numpy(rng.integers(0, 9, M).astype(np.int32)),
              "theta": torch.from_numpy(rng.normal(size=M).astype(np.float32))}
    poisoned = rng.choice(M, 60, replace=False)
    buffer["features"][poisoned[:30]] = float("nan")
    buffer["target_px"][poisoned[30:]] = float("inf")
    buffer["theta"][poisoned] = float("nan")
    allowed = np.setdiff1d(np.arange(M), poisoned)
    idx = torch.from_numpy(rng.choice(allowed, B))
    mesh = _mesh(n)
    parts = gather_rows(shard_rows(buffer, mesh), idx, mesh)
    sizes = [len(p) for p in torch.tensor_split(torch.arange(B), n)]
    assert [p["theta"].shape[0] for p in parts] == sizes == [hi - lo for lo, hi in split_positions(B, mesh)]
    for k, v in buffer.items():
        got = torch.cat([p[k] for p in parts])
        assert got.dtype == v.dtype and torch.equal(got, v[idx]), k


# ---------------------------------------------------------------- mapping


def _ten_step_setup():
    ctx_np, mean, poses = _ctx_np()
    rng = np.random.default_rng(4)
    buffer_np = _batch_np(rng, poses, n=2048)
    buffer_np["features"] = np.asarray(jnp.asarray(buffer_np["features"]).astype(jnp.bfloat16).astype(jnp.float32))
    head_j, pose_j, head_t, pose_t = _params(6, "mlp", ctx_np, mean)
    sched = dict(schedule=ScheduleConfig(schedule="1cyclepoly", iterations=100, warmup_iterations=5,
                                         learning_rate_max=0.003, cooldown_iterations=20))
    cfg_j, cfg_t = _cfgs("mlp", True, False, **sched)
    cfg_j = cfg_j.__class__(**{**cfg_j.__dict__, "schedule": jt.ScheduleConfig(**sched["schedule"].__dict__)})
    buffer_t = {k: torch.from_numpy(np.array(v)).to(torch.bfloat16 if k == "features" else None)
                for k, v in buffer_np.items()}
    ctx_t = {k: torch.as_tensor(v) for k, v in ctx_np.items()}
    return ctx_np, buffer_np, head_j, pose_j, head_t, pose_t, cfg_j, cfg_t, buffer_t, ctx_t


def _state_t(head_t, pose_t, cfg_t):
    head_t, pose_t = (to.tree_unflatten(t, [x.clone() for x in to.tree_leaves(t)]) for t in (head_t, pose_t))
    focal = torch.zeros(())
    return tt.TrainState(head_params=head_t, head_opt=to.adamw_init(head_t), pose_params=pose_t,
                         pose_opt=to.adamw_init(pose_t), focal_g=focal, focal_opt=to.adamw_init(focal),
                         sched=init_schedule(cfg_t.schedule), iteration=torch.zeros((), dtype=torch.int32),
                         nan_steps=torch.zeros((), dtype=torch.int32))


def _run(mesh, state, buffer_t, ctx_t, cfg_t, idx):
    if mesh is None:
        return tt.train_steps(state, buffer_t, ctx_t, tt.train_hp(cfg_t), cfg_t, HeadConfig(), len(idx),
                              batch_indices=idx)
    return tt.train_steps(state, shard_rows(buffer_t, mesh), replicate(ctx_t, mesh), tt.train_hp(cfg_t), cfg_t,
                          HeadConfig(), len(idx), batch_indices=idx, mesh=mesh)


def _rel_frob(a, b):
    la, lb = to.tree_leaves(a), to.tree_leaves(b)
    return float(torch.sqrt(sum(((x - y) ** 2).sum() for x, y in zip(la, lb)))
                 / torch.sqrt(sum((y ** 2).sum() for y in lb)))


@pytest.fixture(scope="module")
def ten_steps():
    """The setup of `test_ten_steps_match_jax`, the JAX chunk's batch rows
    (one key split a step, trainer.py:367-370), and the port's ten steps on
    one device and on four shards, each with the loss, inlier fraction and
    gradients of its first step."""
    setup = _ten_step_setup()
    *_, head_t, pose_t, _, cfg_t, buffer_t, ctx_t = setup
    key = jax.random.PRNGKey(9)
    idx, k = [], key
    for _ in range(10):
        k, k_batch = jax.random.split(k)
        idx.append(np.array(jax.random.randint(k_batch, (B,), 0, 2048)))
    applied, runs = {}, {}
    real_apply = tt._apply_step
    with pytest.MonkeyPatch.context() as mp:
        for name, mesh in (("one", None), ("mesh4", _mesh(4))):
            def apply(state, loss, batch_inliers, grads, hp, cfg, name=name):
                applied.setdefault(name, (loss, batch_inliers, grads))
                return real_apply(state, loss, batch_inliers, grads, hp, cfg)

            mp.setattr(tt, "_apply_step", apply)
            runs[name] = _run(mesh, _state_t(head_t, pose_t, cfg_t), buffer_t, ctx_t, cfg_t, idx)
    return setup, key, runs, applied


def test_train_steps_four_shards_track_one_device(ten_steps):
    """(A mesh of one device gives the bits of none:
    `test_mapping_trainer_one_device_mesh_bit_equal`.)"""
    _, _, runs, applied = ten_steps
    (s1, st1), (s4, st4) = runs["one"], runs["mesh4"]

    # four shards: the first step's loss, inlier fraction and gradients are
    # the sums of one device in another order
    (l1, bi1, g1), (l4, bi4, g4) = applied["one"], applied["mesh4"]
    assert abs(float(l4) / float(l1) - 1) <= 1e-6 and float(bi4) == float(bi1)
    rel = [float((x - y).norm() / y.norm()) for x, y in zip(to.tree_leaves(g4), to.tree_leaves(g1)) if y.norm() > 0]
    # fc3's weight gradient is a bf16 product (dense in bf16, as in the JAX
    # package), rounded per part; every other gradient accumulates in f32
    assert max(rel) <= 1e-2 and sorted(rel)[-2] <= 1e-5, sorted(rel)[-3:]

    loss1, loss4 = st1["loss"].numpy(), st4["loss"].numpy()
    assert np.isfinite(loss4).all() and int(s4.iteration) == 10
    np.testing.assert_allclose(loss4, loss1, rtol=2e-2)
    np.testing.assert_allclose(st4["lr"].numpy(), st1["lr"].numpy(), rtol=1e-6)
    assert _rel_frob((s4.head_params, s4.pose_params), (s1.head_params, s1.pose_params)) <= 0.1
    assert abs(float(s4.focal_g) - float(s1.focal_g)) <= 0.1 * abs(float(s1.focal_g))
    for name in ("in_cooldown", "cooldown_start", "max_iterations", "stat_ptr"):
        assert torch.equal(getattr(s4.sched, name), getattr(s1.sched, name)), name
    assert float((s4.sched.stat_buffer - s1.sched.stat_buffer).abs().max()) <= 2e-2
    assert int(s4.nan_steps) == int(s1.nan_steps) == 0


def test_four_shard_train_steps_match_jax_mesh(ten_steps):
    """The same ten steps against the JAX package's `_train_chunk` with its
    buffer sharded and its state replicated over make_mesh(4) (the
    conftest's virtual devices), the JAX draws injected."""
    (ctx_np, buffer_np, head_j, pose_j, _, _, cfg_j, *_), key, runs, _ = ten_steps
    jmesh = j_make_mesh(4)
    buffer_j = {k: jnp.asarray(v).astype(jnp.bfloat16) if k == "features" else jnp.asarray(v)
                for k, v in buffer_np.items()}
    _, stats_j = jt._train_chunk(j_replicate(_jax_state(head_j, pose_j, cfg_j, key), jmesh),
                                 j_shard_rows(buffer_j, jmesh), j_replicate(jax.tree.map(jnp.asarray, ctx_np), jmesh),
                                 cfg_j, JHeadConfig(), 10)
    state, stats_t = runs["mesh4"]
    loss_t, loss_j = stats_t["loss"].numpy(), np.asarray(stats_j["loss"])
    assert np.isfinite(loss_t).all() and int(state.iteration) == 10
    np.testing.assert_allclose(loss_t, loss_j, rtol=0.04)
    np.testing.assert_allclose(stats_t["lr"].numpy(), np.asarray(stats_j["lr"]), rtol=1e-6)


def test_mapping_trainer_one_device_mesh_bit_equal():
    """MappingTrainer end to end (fill, truncation, shards, replicas,
    `train_steps` through the budget loop) on a mesh of one device: the
    bits of no mesh. On three shards the buffer is truncated to a multiple
    of 3 and sharded."""
    data = render_room_scene(2, h=48, w=64, focal=55.0)
    scene = _synthetic_scene(data, [0])
    cfg = tt.TrainConfig(batch_size=128, use_depth=True, chunk_steps=10, sync_every_chunks=1,
                         schedule=ScheduleConfig(schedule="constant", iterations=20, learning_rate_min=0.003),
                         loss=ReproLossConfig(loss_type="tanh", total_iterations=20), iterations_output=10)
    buf_cfg = BufferConfig(max_buffer_size=1024, samples_per_image=128, max_dataset_passes=2, image_chunk=2)
    enc = init_encoder_params(torch.Generator().manual_seed(2))
    res = {name: tt.MappingTrainer(scene, enc, HeadConfig(), cfg, buf_cfg, mesh=mesh).train()
           for name, mesh in (("one", None), ("mesh1", _mesh(1)))}
    assert res["one"]["iterations"] == res["mesh1"]["iterations"] == 20
    assert res["one"]["buffer_rows"] == res["mesh1"]["buffer_rows"] == 4096
    assert _leaves_equal(res["one"]["head_params"], res["mesh1"]["head_params"])
    np.testing.assert_array_equal(res["one"]["poses_w2c"], res["mesh1"]["poses_w2c"])

    trainer = tt.MappingTrainer(scene, enc, HeadConfig(), cfg, buf_cfg, mesh=_mesh(3))
    shards = trainer.build_buffer()
    assert len(shards) == 3 and all(s["features"].shape[0] == 4095 // 3 for s in shards)
    assert len(trainer.mesh_ctx) == 3
    assert tt.MappingTrainer(scene, enc, HeadConfig(), tt.TrainConfig(buffer_host_spill=True), buf_cfg,
                             mesh=_mesh(3)).mesh is None


# ----------------------------------------------------------- registration


@pytest.fixture(scope="module")
def stub_scene():
    """8 chesslike_a frames at a 120-pixel side, each canvas carrying its
    frame index in its first pixel, and the scene-coordinate maps the stub
    returns: ground truth with noise on 60% of the cells (so that frames hit
    the tier-1 cap), frame 7 without a valid cell (a sampling failure)."""
    from acezero_tpu_torch.data.scene import load_scene
    from test_torch_registration import _gt_maps

    scene = load_scene(str(SCENE / "frame_000[0-7].png"), image_short_size=120, external_focal_length=520.0,
                       num_workers=2)
    n, h, w = len(scene), 15, 20
    rng = np.random.default_rng(11)
    maps = rng.uniform(-3, 3, size=(n, h, w, 3)).astype(np.float32)
    gt = _gt_maps(scene, sub=32)
    noisy = gt + rng.normal(0, 0.1, gt.shape)
    keep = rng.uniform(size=(n, h, w)) > 0.4
    maps[keep] = noisy[keep]
    masks = np.ones((n, h, w), bool)
    masks[7] = False
    scene.images.canvases[:, 0, 0] = np.arange(n, dtype=np.uint8)
    return scene, torch.from_numpy(maps), torch.from_numpy(masks)


def _stub_coords(monkeypatch, maps, masks):
    def fake_coords(_enc, _head, _cfg, images, sizes, subsample=8):
        idx = images[:, 0, 0].long()
        return maps[idx], masks[idx]

    def fake_multi(_enc, heads, _cfg, images, sizes, subsample=8):
        idx = images[:, 0, 0].long()
        return torch.stack([maps[idx] + 0.05 * s for s in range(len(heads))]), masks[idx]

    monkeypatch.setattr(tdrv, "coords_chunk", fake_coords)
    monkeypatch.setattr(tdrv, "coords_chunk_multi", fake_multi)


def _entries_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.rgb_file == y.rgb_file and x.confidence == y.confidence and x.focal_length == y.focal_length
        np.testing.assert_array_equal(x.pose_w2c, y.pose_w2c)


def _entries_close(a, b):
    """The registration bounds of tests/test_torch_registration.py:127-130:
    the same frames valid and inlier counts within max(1, 1%); poses within
    1e-3 m and 0.05 deg for at least three frames in four, and within the
    stub's noise (0.1 m, 1 deg) for every frame. The registrar's batched
    solves and sums round otherwise at another batch size (poses about 3e-7
    apart), and on the stub's noisy maps (0.1 m noise, 40% outliers) such a
    difference can flip one cell at the 10-pixel inlier threshold, after
    which the refit lands centimetres away (measured: one frame of 16 in the
    multi-head case, 3.2 cm, 161 against 162 inliers)."""
    assert [x.rgb_file for x in a] == [y.rgb_file for y in b]
    tight = []
    for x, y in zip(a, b):
        assert (x.confidence > 0) == (y.confidence > 0) and x.focal_length == y.focal_length
        assert abs(x.confidence - y.confidence) <= max(1.0, 0.01 * y.confidence)
        Px, Py = x.pose_c2w, y.pose_c2w
        dt = np.linalg.norm(Px[:3, 3] - Py[:3, 3])
        dr = np.degrees(np.arccos(np.clip((np.trace(Px[:3, :3] @ Py[:3, :3].T) - 1) / 2, -1, 1)))
        assert dt < 0.1 and dr < 1.0, (x.rgb_file, dt, dr)
        tight.append(dt < 1e-3 and dr < 0.05)
    assert np.mean(tight) >= 0.75, tight


@pytest.mark.parametrize("given", [False, True], ids=["generator", "hyp_indices"])
def test_register_frames_on_four_shards_tracks_one_device(stub_scene, monkeypatch, given):
    scene, maps, masks = stub_scene
    _stub_coords(monkeypatch, maps, masks)
    ransac = treg.RansacConfig(hypotheses=8, max_tries=8, refinement_steps=40)
    cfg = tdrv.RegistrationConfig(ransac=ransac, frame_chunk=4, refit_tier1=2)
    hyp = None
    if given:
        g = torch.Generator().manual_seed(5)
        hyp = treg.draw_hypothesis_indices(masks.reshape(len(scene), -1), 8, 8, g)
    logs = []
    monkeypatch.setattr(tdrv._logger, "info", lambda msg, *a: logs.append(msg % a))
    one = tdrv.register_frames(None, None, None, scene, cfg, device="cpu", hyp_indices=hyp)
    assert any("Refit tier 2" in m for m in logs) and any("sampling-failure" in m for m in logs), logs
    lanes = []
    real_lanes = tdrv._lanes
    monkeypatch.setattr(tdrv, "_lanes", lambda *a: lanes.append(real_lanes(*a)) or lanes[-1])
    # chunks of 4 frames: 1 frame a device; the last chunk (2 frames) and the
    # reruns leave devices without frames
    four = tdrv.register_frames(None, None, None, scene, cfg, hyp_indices=hyp, mesh=_mesh(4))
    assert len(lanes[0]) == 4
    _entries_close(four, one)


def test_register_frames_multi_on_four_shards_tracks_one_device(stub_scene, monkeypatch):
    scene, maps, masks = stub_scene
    _stub_coords(monkeypatch, maps, masks)
    cfg = tdrv.RegistrationConfig(ransac=treg.RansacConfig(hypotheses=8, max_tries=8, refinement_steps=40),
                                  frame_chunk=4)
    one = tdrv.register_frames_multi(None, [None, None], None, scene, cfg, device="cpu")
    four = tdrv.register_frames_multi(None, [None, None], None, scene, cfg, mesh=_mesh(4))
    for a, b in zip(four, one):
        _entries_close(a, b)


def test_chunk_rounding_follows_the_jax_driver():
    """frame_chunk rounds up to a multiple of the mesh size: 64 frames stay
    64 for 1, 2, 4 and 8 devices and become 66 for 3 (whose draws then
    differ from one device's)."""
    cfg = tdrv.RegistrationConfig(frame_chunk=64)
    assert [tdrv._frame_chunk(cfg, _mesh(n)) for n in (1, 2, 3, 4, 8)] == [64, 64, 66, 64, 64]
    assert tdrv._frame_chunk(cfg, None) == 64


def test_register_frames_one_device_mesh_bit_equal_real_path():
    """The encoder, the head and the registrar for real (random weights) on a
    mesh of one device: the bits of no mesh."""
    from acezero_tpu_torch.data.scene import load_scene

    scene = load_scene(str(SCENE / "frame_000[0-5].png"), image_short_size=120, external_focal_length=520.0,
                       num_workers=2)
    enc = init_encoder_params(torch.Generator().manual_seed(0))
    head_cfg = HeadConfig(num_head_blocks=0)
    head = init_head_params(torch.Generator().manual_seed(1), head_cfg, np.zeros(3))
    cfg = tdrv.RegistrationConfig(ransac=treg.RansacConfig(hypotheses=8, max_tries=4, refinement_steps=4),
                                  frame_chunk=4)
    one = tdrv.register_frames(enc, head, head_cfg, scene, cfg, device="cpu")
    mesh1 = tdrv.register_frames(enc, head, head_cfg, scene, cfg, mesh=_mesh(1))
    _entries_equal(mesh1, one)


# --------------------------------------------------------------- pipeline


@pytest.mark.parametrize("num_devices,visible,want", [
    (0, 4, None), (2, 4, 2), (8, 4, 4), (1, 4, None), (0, 1, None), (3, 0, None)])
def test_pipeline_num_devices_rule(monkeypatch, num_devices, visible, want):
    """The JAX package's rule (acezero_tpu/reconstruct/pipeline.py:69-80)
    for N > 1: the first N cards, clamped, and one device means no mesh;
    the CPU forms no mesh. A deliberate difference: 0 means one device, not
    every visible one, since several cards map and register slower than
    one card (PERF.md section 6, PR 14)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: visible > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: visible)
    mesh = tpipe.pipeline_mesh(num_devices, torch.device("cuda"))
    if want is None:
        assert mesh is None
    else:
        assert mesh.devices == tuple(torch.device("cuda", i) for i in range(want))
    assert tpipe.pipeline_mesh(num_devices, torch.device("cpu")) is None


def test_pipeline_refuses_a_mesh_off_its_device(tmp_path):
    cfg = AceZeroConfig(rgb_files=str(SCENE / "frame_0000.png"), results_folder=tmp_path)
    with pytest.raises(ValueError, match="primary"):
        tpipe.AceZeroPipeline(cfg, device="cpu", mesh=make_mesh(devices=["meta", "cpu"]))


def test_pipeline_passes_its_mesh_where_the_jax_pipeline_does(scene_dir, tmp_path, monkeypatch):
    """The control flow of tests/test_torch_pipeline.py (its fakes, loop
    closure on and drift-free, the final refit) with a 2-shard mesh: the
    seed map, its fast check, every registration round, every mapping
    round and the refit get the mesh (acezero_tpu/reconstruct/pipeline.py:
    343, 357, 580, 855, 953); loop closure runs on the primary."""
    import test_torch_pipeline as ttp

    seen = []
    real = {name: getattr(ttp._Script, name) for name in ("trainer", "register", "loop_close")}
    for name in real:
        def wrapped(self, *a, _name=name, **k):
            seen.append((_name, k.get("mesh"), k.get("device")))
            return real[_name](self, *a, **k)
        monkeypatch.setattr(ttp._Script, name, wrapped)
    mesh = _mesh(2)
    kw = {**_scene_kw(scene_dir, None), "try_seeds": 1, "seed_iterations": 321, "iterations": 654,
          "refit_iterations": 987, "iterations_max": 10, "loop_closure": True}
    calls, files, _ = ttp._flow(tpipe, tpipe, tpipe.AceZeroPipeline, AceZeroConfig, kw, [0.3, 0.3, 0.995, 0.9],
                                [False, False], monkeypatch, tmp_path / "t", device="cpu", mesh=mesh)
    assert [c["call"] for c in calls if c["call"] != "depth"] == [
        "train", "register", "register", "train", "register", "loop_close", "train", "register", "loop_close"]
    assert [n for n, m, _ in seen if m is mesh] == ["trainer", "register", "register", "trainer", "register",
                                                    "trainer", "register"]
    assert [(m, str(d)) for n, m, d in seen if n == "loop_close"] == [(None, "cpu")] * 2
    assert "poses_final.txt" in files


@pytest.mark.slow
def test_mini_loop_on_two_shard_mesh_matches_jax_mesh(scene_dir, tmp_path, monkeypatch):
    """The mini loop of test_mini_loop_matches_jax through the port's
    pipeline on a 2-shard mesh (every mapping step and registration chunk
    split over it) against the JAX pipeline on the conftest's 8-device
    mesh: the same artifacts and frames, both within the rate band."""
    steps, lanes = [], []
    real_step, real_lanes = tt.train_step_mesh, tdrv._lanes
    monkeypatch.setattr(tt, "train_step_mesh", lambda *a: steps.append(len(a[2])) or real_step(*a))
    monkeypatch.setattr(tdrv, "_lanes", lambda *a: lanes.append(len(real_lanes(*a))) or real_lanes(*a))
    path, focal = scene_dir
    argv = [str(path / "*.png"), str(tmp_path / "t"), "--depth_files", str(path / "*_depth.npy"),
            "--use_external_focal_length", str(focal), *MINI_FLAGS, "--device", "cpu"]
    from dataclasses import replace

    cfg = replace(ace_zero_cli.config_from_args(ace_zero_cli.build_parser().parse_args(argv)), **MINI_OVERRIDES)
    res_t = tpipe.AceZeroPipeline(cfg, device="cpu", mesh=_mesh(2)).run()
    # the seed map (20 steps) and one round (30), two shards a step; the
    # seed's fast check and both registration rounds on two lanes
    assert steps == [2] * 50 and lanes == [2, 2, 2]
    res_j = JPipeline(JConfig(**_scene_kw(scene_dir, tmp_path / "j"), **MINI, num_devices=0,
                              decode_cache_dir=None, base_seed=2089)).run()
    assert sorted(p.name for p in (tmp_path / "t").iterdir()) == sorted(p.name for p in (tmp_path / "j").iterdir())
    assert res_t["iterations"] == res_j["iterations"] == 1
    lines_t = (tmp_path / "t" / "poses_final.txt").read_text().splitlines()
    lines_j = (tmp_path / "j" / "poses_final.txt").read_text().splitlines()
    assert len(lines_t) == len(lines_j) == N
    assert [ln.split()[0] for ln in lines_t] == [ln.split()[0] for ln in lines_j]
    for res in (res_t, res_j):
        assert all(RATE_BAND[0] <= r <= RATE_BAND[1] for r in res["rate_history"]), res["rate_history"]
