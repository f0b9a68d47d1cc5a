"""The mapping engine: scene-coordinate head training on the device.

Counterpart of acezero_tpu/training/trainer.py. One training step samples a
batch of rows from the device-resident patch buffer, runs the head (the
chain through the `FusedHeadChain` kernels on the standard layout), the
differentiable pose and focal refinement and the reprojection loss with
validity masking, takes AdamW steps for the head, the pose refiner and the
focal, and advances the learning-rate schedule with its dynamic cooldown.
Reference semantics, as in the JAX package:
  - L1 pixel residual, hard clamp at 1000 px, depth window [0.1, 1000] m;
  - invalid pixels pulled towards a constant-depth (10 m) pseudo target
    through the unrefined focal, or towards the ground-truth scene
    coordinates when depth supervision exists;
  - the batch-inlier fraction (error < 10 px) feeds the cooldown trigger;
  - pose updates wait `pose_refinement_wait` steps; the MLP refiner adds
    0.1-weighted deltas and re-orthonormalises;
  - one shared focal refined as a relative scale (1 + g);
  - a non-finite loss skips the step (counted in `nan_steps`).

Steps past the schedule's `max_iterations` are no-ops (`active` gate) and
every gate is a device tensor: the host syncs only for the stop check,
once every `chunk_steps * sync_every_chunks` steps. Unlike the JAX
package, whose chunk length is fixed by its compiled program, the trainer
dispatches no step past the last `max_iterations` it read.
`use_fused_head` keeps the JAX package's field name and has no effect: the
standard head layout always takes the fused chain. The JAX package's
`pose_table_bucket` (a compiled-shape bucket) has no counterpart.

`buffer_host_spill` (`--training_buffer_cpu`) keeps the buffer rows in
pinned host memory (`_HostBatches`): each step's rows are drawn by the same
`torch.randint` call on the same generator as the device path's, gathered
on the host a few steps ahead by a worker thread and copied to the card on
a side stream that the step waits for. One seed therefore trains the same
bits with either buffer. The JAX package builds a whole chunk's batches at
once from a numpy generator of its own.
"""

from __future__ import annotations

import concurrent.futures as _futures
import contextlib
import logging
import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from acezero_tpu_torch.data.depth import seed_scene_coordinates
from acezero_tpu_torch.data.scene import SceneData
from acezero_tpu_torch.geometry.rotations import special_gramschmidt, special_procrustes
from acezero_tpu_torch.models.head import HeadConfig, head_apply_flat, init_head_params
from acezero_tpu_torch.models.posenet import init_posenet_params, posenet_apply
from acezero_tpu_torch.parallel.mesh import Mesh, broadcast_, gather_rows, reduce_sum, replicate, shard_rows
from acezero_tpu_torch.training.buffer import BufferConfig, fill_training_buffer
from acezero_tpu_torch.training.loss import ReproLossConfig, loss_hp, repro_loss_hp
from acezero_tpu_torch.training.optim import AdamWState, adamw_init, adamw_update, tree_leaves, tree_unflatten
from acezero_tpu_torch.training.schedule import (
    ScheduleConfig,
    ScheduleState,
    init_schedule,
    schedule_hp,
    schedule_lr_hp,
    schedule_update_hp,
)
from acezero_tpu_torch.utils.precision import no_tf32

_logger = logging.getLogger(__name__)


@dataclass(frozen=True)
class TrainConfig:
    batch_size: int = 5120
    schedule: ScheduleConfig = field(default_factory=ScheduleConfig)
    loss: ReproLossConfig = field(default_factory=ReproLossConfig)
    depth_min: float = 0.1
    depth_max: float = 1000.0
    depth_target: float = 10.0
    repro_loss_hard_clamp: float = 1000.0
    cooldown_trigger_px_threshold: float = 10.0
    pose_refinement: str = "none"  # none | naive | mlp
    pose_refinement_weight: float = 0.1
    pose_refinement_lr: float = 0.001
    pose_refinement_wait: int = 0
    refinement_ortho: str = "gram-schmidt"  # gram-schmidt | procrustes
    refine_calibration: bool = False
    refine_calibration_lr: float = 0.001
    # normalise the reprojection residual by the refined-focal ratio
    # (experimental in the JAX package; default off = reference semantics)
    focal_loss_normalize: bool = False
    use_depth: bool = False
    use_fused_head: bool = False  # name parity only: see the module note
    buffer_host_spill: bool = False  # `--training_buffer_cpu`: the buffer in host memory
    chunk_steps: int = 500
    iterations_output: int = 500
    sync_every_chunks: int = 4  # chunks per host sync (the stop check)


def train_hp(cfg: TrainConfig) -> dict:
    """The step's scalar hyperparameters, as the JAX package groups them."""
    return {
        "sched": schedule_hp(cfg.schedule),
        "loss": loss_hp(cfg.loss),
        "pose_wait": int(cfg.pose_refinement_wait),
        "pose_lr": float(cfg.pose_refinement_lr),
        "calib_lr": float(cfg.refine_calibration_lr),
    }


@dataclass
class TrainState:
    head_params: dict
    head_opt: AdamWState
    pose_params: dict
    pose_opt: AdamWState
    focal_g: torch.Tensor  # f32 scalar relative focal factor
    focal_opt: AdamWState
    sched: ScheduleState
    iteration: torch.Tensor  # int32 scalar
    nan_steps: torch.Tensor  # int32 scalar


def _orthonormalize(cfg: TrainConfig, R: torch.Tensor) -> torch.Tensor:
    if cfg.refinement_ortho == "procrustes":
        return special_procrustes(R)
    return special_gramschmidt(R)


def _refined_w2c(cfg: TrainConfig, pose_params: dict, w2c_rows: torch.Tensor, img_idx: torch.Tensor):
    """Apply the pose-refinement strategy to (B, 3, 4) original w2c rows."""
    if cfg.pose_refinement == "none":
        return w2c_rows
    if cfg.pose_refinement == "naive":
        rows = pose_params["pose_buffer"][img_idx]
        R = _orthonormalize(cfg, rows[:, :3, :3])
        return torch.cat([R, rows[:, :3, 3:4]], dim=-1)
    flat = w2c_rows.reshape(-1, 12)
    delta = posenet_apply(pose_params, flat)
    updated = (flat + cfg.pose_refinement_weight * delta).reshape(-1, 3, 4)
    R = _orthonormalize(cfg, updated[:, :3, :3])
    return torch.cat([R, updated[:, :3, 3:4]], dim=-1)


def _rotz(theta: torch.Tensor) -> torch.Tensor:
    c, s = torch.cos(theta), torch.sin(theta)
    z = torch.zeros_like(theta)
    o = torch.ones_like(theta)
    return torch.stack([c, -s, z, s, c, z, z, z, o], dim=-1).reshape(theta.shape + (3, 3))


def _loss_fn(trainable: tuple, batch: dict, ctx: dict, hp: dict, cfg: TrainConfig, head_cfg: HeadConfig,
             iteration: torch.Tensor, batch_size: int | None = None):
    """(loss, {"batch_inliers", "inliers"}) of one batch; differentiable in
    `trainable` = (head_params, pose_params, focal_g). The sums are divided
    by `batch_size`, by default the batch's own row count; a mesh part passes
    the global batch size, so that the parts' losses add up to the batch's."""
    head_params, pose_params, focal_g = trainable
    pred = head_apply_flat(head_params, head_cfg, batch["features"])  # (B, 3) f32
    B = pred.shape[0] if batch_size is None else batch_size

    w2c_rows = ctx["poses_w2c"][batch["img_idx"]]
    w2c_ref = _refined_w2c(cfg, pose_params, w2c_rows, batch["img_idx"])

    # compose the augmentation rotation: T_eff = Rz(theta) @ T_refined
    Rz = _rotz(batch["theta"])
    with no_tf32():
        R_eff = Rz @ w2c_ref[:, :3, :3]
        t_eff = (Rz @ w2c_ref[:, :3, 3:4])[..., 0]
        p_cam = (R_eff @ pred[..., None])[..., 0] + t_eff

    f_aug = ctx["focals"][batch["img_idx"]] * batch["scale"]  # unrefined
    f_ref = f_aug * (1.0 + focal_g) if cfg.refine_calibration else f_aug

    z = p_cam[:, 2]
    z_clamped = torch.clamp(z, min=cfg.depth_min)
    u = f_ref * p_cam[:, 0] / z_clamped + ctx["ppx"]
    v = f_ref * p_cam[:, 1] / z_clamped + ctx["ppy"]
    err = torch.abs(u - batch["target_px"][:, 0]) + torch.abs(v - batch["target_px"][:, 1])

    invalid = (z < cfg.depth_min) | (err > cfg.repro_loss_hard_clamp) | (z > cfg.depth_max)
    if cfg.use_depth:
        target = batch["target_crds"]
        dist = torch.linalg.vector_norm(target - pred, dim=-1)
        avail = torch.sum(torch.abs(target), dim=-1) > 1e-5
        invalid = invalid | ((dist > 0.1) & avail)

    valid = ~invalid
    err_loss = err
    if cfg.refine_calibration and cfg.focal_loss_normalize:
        err_loss = err / (1.0 + focal_g)
    loss_valid = repro_loss_hp(hp["loss"], err_loss, valid, iteration)
    inliers = torch.sum(valid & (err < cfg.cooldown_trigger_px_threshold))
    batch_inliers = inliers.to(torch.float32) / B

    if cfg.use_depth:
        loss_invalid = torch.sum(dist * (invalid & avail).to(torch.float32))
    else:
        # constant-depth pseudo target through the unrefined intrinsics
        tx = (batch["target_px"][:, 0] - ctx["ppx"]) / f_aug * cfg.depth_target
        ty = (batch["target_px"][:, 1] - ctx["ppy"]) / f_aug * cfg.depth_target
        target_cam = torch.stack([tx, ty, torch.full_like(tx, cfg.depth_target)], dim=-1)
        loss_invalid = torch.sum(torch.sum(torch.abs(target_cam - p_cam), dim=-1) * invalid.to(torch.float32))

    loss = (loss_valid + loss_invalid) / B
    return loss, {"batch_inliers": batch_inliers, "inliers": inliers}


def _with_grad(tree):
    """Fresh autograd leaves sharing the tree's storage."""
    return tree_unflatten(tree, [t.detach().requires_grad_(True) for t in tree_leaves(tree)])


def _trainable(state: TrainState) -> tuple:
    """What a mesh device needs of the state for its part's loss and
    gradients: the parameters and the iteration."""
    return state.head_params, state.pose_params, state.focal_g, state.iteration


def _part_loss_and_grads(params: tuple, batch: dict, ctx: dict, hp: dict, cfg: TrainConfig, head_cfg: HeadConfig,
                         batch_size: int | None = None):
    """(loss, aux, (g_head, g_pose, g_focal)) of a batch at `params` =
    `_trainable(state)`, all on the batch's device."""
    head_params, pose_params, focal_g, iteration = params
    trainable = (_with_grad(head_params), _with_grad(pose_params), focal_g.detach().requires_grad_(True))
    leaves = tree_leaves(trainable)
    with torch.enable_grad():
        loss, aux = _loss_fn(trainable, batch, ctx, hp, cfg, head_cfg, iteration, batch_size)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
    return loss.detach(), aux, tree_unflatten(trainable, grads)


def loss_and_grads(state: TrainState, batch: dict, ctx: dict, hp: dict, cfg: TrainConfig,
                   head_cfg: HeadConfig):
    """(loss, aux, (g_head, g_pose, g_focal)) at the state's parameters."""
    return _part_loss_and_grads(_trainable(state), batch, ctx, hp, cfg, head_cfg)


def train_step(state: TrainState, batch: dict, ctx: dict, hp: dict, cfg: TrainConfig,
               head_cfg: HeadConfig) -> tuple[TrainState, dict]:
    """One step; every gate is a device tensor (no host sync)."""
    loss, aux, grads = loss_and_grads(state, batch, ctx, hp, cfg, head_cfg)
    return _apply_step(state, loss, aux["batch_inliers"], grads, hp, cfg)


def train_step_mesh(state: TrainState, replicas: list, parts: list, ctxs: list, hp: dict, cfg: TrainConfig,
                    head_cfg: HeadConfig, mesh: Mesh) -> tuple[TrainState, dict]:
    """One data-parallel step: `parts` is the batch split by position over the
    mesh (`gather_rows`), `replicas` and `ctxs` hold each device's copy of
    `_trainable(state)` and of the context. Every device's part is
    dispatched before anything waits: its loss (its sums over the global
    batch size) and gradients at its replica, K1 and K2 on its device. The
    losses, inlier counts and gradients are summed on the primary in device
    order, so the finite gate and the cooldown statistic are global; AdamW
    and the schedule step once there, and the new parameters are copied
    into the replicas. One part gives the bits of `train_step`."""
    B = sum(p["features"].shape[0] for p in parts)
    outs = [_part_loss_and_grads(rep, part, ctx, hp, cfg, head_cfg, batch_size=B)
            for rep, part, ctx in zip(replicas, parts, ctxs) if part["features"].shape[0] > 0]
    loss, inliers, grads = reduce_sum([(o[0], o[1]["inliers"], o[2]) for o in outs], mesh.primary)
    state, stats = _apply_step(state, loss, inliers.to(torch.float32) / B, grads, hp, cfg)
    broadcast_(replicas, _trainable(state))
    return state, stats


def _apply_step(state: TrainState, loss: torch.Tensor, batch_inliers: torch.Tensor, grads, hp: dict,
                cfg: TrainConfig) -> tuple[TrainState, dict]:
    """The optimizer and schedule half of a step, from the batch's loss,
    inlier fraction and gradients."""
    g_head, g_pose, g_focal = grads
    active = state.iteration < state.sched.max_iterations
    finite = torch.isfinite(loss)
    do_update = active & finite

    lr = schedule_lr_hp(hp["sched"], state.sched, state.iteration)
    head_params, head_opt = adamw_update(state.head_params, g_head, state.head_opt, lr, enabled=do_update)
    pose_params, pose_opt = state.pose_params, state.pose_opt
    if cfg.pose_refinement != "none":
        pose_enabled = do_update & (state.iteration > hp["pose_wait"])
        pose_params, pose_opt = adamw_update(state.pose_params, g_pose, state.pose_opt, hp["pose_lr"],
                                             enabled=pose_enabled)
    focal_g, focal_opt = state.focal_g, state.focal_opt
    if cfg.refine_calibration:
        focal_g, focal_opt = adamw_update(state.focal_g, g_focal, state.focal_opt, hp["calib_lr"],
                                          enabled=do_update)

    sched_new = schedule_update_hp(hp["sched"], state.sched, state.iteration, batch_inliers)
    sched = ScheduleState(*(torch.where(active, n, o) for n, o in zip(sched_new, state.sched)))
    new_state = TrainState(
        head_params=head_params, head_opt=head_opt, pose_params=pose_params, pose_opt=pose_opt,
        focal_g=focal_g, focal_opt=focal_opt, sched=sched,
        iteration=state.iteration + active.to(torch.int32),
        nan_steps=state.nan_steps + (active & ~finite).to(torch.int32),
    )
    stats = {
        "loss": torch.where(active, loss, torch.full_like(loss, float("nan"))),
        "batch_inliers": batch_inliers,
        "lr": lr,
        "active": active,
    }
    return new_state, stats


class _HostBatches:
    """The batches of `num_steps` steps from a host-resident buffer, in step
    order. Row indices come from the device path's call, `torch.randint(0,
    M, (B,))` on `generator`, once a step (drawn DRAW_GROUP steps at a
    time, on the side stream, and fetched to the host together), or from
    `batch_indices`. A worker thread gathers each step's rows on the host
    AHEAD steps before the step into pinned staging rows and copies them to
    `device` on a side stream; `next()` makes the current stream wait for
    that copy. On the CPU the gathered rows are the batch."""

    AHEAD = 2  # steps gathered before the step that takes them
    DRAW_GROUP = 64  # steps whose indices are drawn and fetched together

    def __init__(self, buffer: dict, device: torch.device, generator, batch_size: int, num_steps: int,
                 batch_indices=None):
        self.buffer, self.device, self.generator = buffer, device, generator
        self.B, self.n = batch_size, num_steps
        self.M = buffer["features"].shape[0]
        self.batch_indices = batch_indices
        self.cuda = device.type == "cuda"
        self.side = torch.cuda.Stream(device) if self.cuda else None
        slots = self.AHEAD + 1
        self.staging = [{k: torch.empty((batch_size,) + tuple(v.shape[1:]), dtype=v.dtype, pin_memory=True)
                         for k, v in buffer.items()} for _ in range(slots)] if self.cuda else None
        self.copied = [None] * slots  # the H2D copy last made out of each staging slot
        self.drawn = None  # (first step, (steps, B) host indices) of the current draw group
        self.pool = _futures.ThreadPoolExecutor(max_workers=1)
        self.pending = deque(self.pool.submit(self._prepare, s) for s in range(min(self.AHEAD, num_steps)))
        self.submitted = len(self.pending)

    def _indices(self, s: int) -> torch.Tensor:
        if self.batch_indices is not None:
            return torch.as_tensor(self.batch_indices[s]).to(torch.int64)
        if self.drawn is None or s >= self.drawn[0] + len(self.drawn[1]):
            count = min(self.DRAW_GROUP, self.n - s)
            gen_dev = self.generator.device if self.generator is not None else self.device
            with torch.cuda.stream(self.side) if self.cuda else contextlib.nullcontext():
                idx = torch.stack([torch.randint(0, self.M, (self.B,), generator=self.generator, device=gen_dev)
                                   for _ in range(count)])
                self.drawn = (s, idx.cpu())
        return self.drawn[1][s - self.drawn[0]]

    def _prepare(self, s: int):
        idx = self._indices(s)
        if not self.cuda:
            return {k: torch.index_select(v, 0, idx) for k, v in self.buffer.items()}, None
        slot = s % len(self.staging)
        if self.copied[slot] is not None:
            self.copied[slot].synchronize()
        rows = self.staging[slot]
        for k, v in self.buffer.items():
            torch.index_select(v, 0, idx, out=rows[k])
        with torch.cuda.stream(self.side):
            batch = {k: t.to(self.device, non_blocking=True) for k, t in rows.items()}
            done = torch.cuda.Event()
            done.record(self.side)
        self.copied[slot] = done
        return batch, done

    def next(self) -> dict:
        batch, done = self.pending.popleft().result()
        if self.submitted < self.n:
            self.pending.append(self.pool.submit(self._prepare, self.submitted))
            self.submitted += 1
        if done is not None:
            current = torch.cuda.current_stream(self.device)
            current.wait_event(done)
            for t in batch.values():
                t.record_stream(current)
        return batch

    def close(self) -> None:
        for f in self.pending:
            f.cancel()
        self.pool.shutdown(wait=True)


def train_steps(state: TrainState, buffer, ctx, hp: dict, cfg: TrainConfig,
                head_cfg: HeadConfig, num_steps: int, generator: torch.Generator | None = None,
                batch_indices=None, mesh: Mesh | None = None) -> tuple[TrainState, dict]:
    """`num_steps` steps on batches of rows drawn uniformly (with
    replacement) from the buffer, or given as `batch_indices` (num_steps, B).
    With `cfg.buffer_host_spill` the buffer lies in host memory and the
    batches stream to the device (`_HostBatches`), drawn as the device path
    draws them. With a mesh, `buffer` is the list of row shards
    (`shard_rows`) and `ctx` the list of the context's replicas
    (`replicate`); the state lies on the primary, each step draws its global
    rows there as the one-device path does, gathers them split by position
    over the mesh (`gather_rows`) and runs `train_step_mesh` on replicas of
    the parameters made here. Returns the state and the stacked per-step
    stats, still on the device (the primary)."""
    if mesh is not None:
        if cfg.buffer_host_spill:
            raise ValueError("a host-spilled buffer is not sharded: train it without a mesh")
        M = buffer[0]["features"].shape[0] * mesh.size
        dev = mesh.primary
        replicas = replicate(_trainable(state), mesh)
    else:
        M = buffer["features"].shape[0]
        dev = ctx["poses_w2c"].device
    stream = None
    if cfg.buffer_host_spill:
        stream = _HostBatches(buffer, dev, generator, cfg.batch_size, num_steps, batch_indices)
    hist = []
    try:
        for i in range(num_steps):
            if stream is not None:
                state, stats = train_step(state, stream.next(), ctx, hp, cfg, head_cfg)
            else:
                if batch_indices is not None:
                    idx = torch.as_tensor(batch_indices[i], device=dev).to(torch.int64)
                else:
                    idx = torch.randint(0, M, (cfg.batch_size,), generator=generator, device=dev)
                if mesh is not None:
                    parts = gather_rows(buffer, idx, mesh)
                    state, stats = train_step_mesh(state, replicas, parts, ctx, hp, cfg, head_cfg, mesh)
                else:
                    state, stats = train_step(state, {k: v[idx] for k, v in buffer.items()}, ctx, hp, cfg, head_cfg)
            hist.append(stats)
    finally:
        if stream is not None:
            stream.close()
    return state, {k: torch.stack([s[k] for s in hist]) for k in hist[0]}


class MappingTrainer:
    """Drives one mapping round: buffer fill, then training in chunks.

    Runs on the encoder parameters' device. Random draws (head and refiner
    initialisation on the host, buffer fill and batch rows on the device)
    come from generators seeded with `base_seed`; the JAX package's draws
    differ, so runs agree in their metrics, not bit for bit.

    With a mesh (whose primary is the encoder's device) the buffer is filled
    on the primary, truncated to a multiple of the mesh size and sharded by
    rows, the context replicated, and `train_steps` runs data-parallel; the
    state stays on the primary, where `head_params` and `current_poses` are
    read. A host-spilled buffer is not sharded, as in the JAX package: the
    trainer then runs on the primary alone.
    """

    def __init__(self, scene: SceneData, encoder_params: dict, head_cfg: HeadConfig, cfg: TrainConfig,
                 buffer_cfg: BufferConfig, head_params: dict | None = None, base_seed: int = 2089,
                 frame_callback=None, mesh: Mesh | None = None):
        # optional `(iteration, poses_w2c (N, 3, 4) numpy) -> None` hook; with
        # it the trainer syncs every `chunk_steps` steps and calls it at each
        # sync that is `iterations_output` past the last call, and at the end
        self.frame_callback = frame_callback
        self.scene = scene
        self.cfg = cfg
        self.buffer_cfg = buffer_cfg
        self.head_cfg = head_cfg
        self.encoder_params = encoder_params
        self.device = encoder_params["conv1"]["w"].device
        self.mesh = None if cfg.buffer_host_spill else mesh
        if self.mesh is not None and self.mesh.primary != self.device:
            raise ValueError(f"the mesh's primary {self.mesh.primary} is not the encoder's device {self.device}")
        self.init_generator = torch.Generator().manual_seed(base_seed)
        self.generator = torch.Generator(device=self.device).manual_seed(base_seed)

        if head_params is None:
            head_params = init_head_params(self.init_generator, head_cfg, scene.mean_camera_center(),
                                           self.device)
        self.head_params_init = head_params

        if cfg.refine_calibration and not np.allclose(scene.focals_orig, scene.focals_orig[0], rtol=1e-5):
            raise ValueError("All images must share one focal length for calibration refinement")

        w2c = np.linalg.inv(scene.poses_c2w.astype(np.float64)).astype(np.float32)
        ppx, ppy = scene.principal_point
        self.ctx = {
            "poses_w2c": torch.from_numpy(np.ascontiguousarray(w2c[:, :3, :4])).to(self.device),
            "focals": torch.from_numpy(np.asarray(scene.focals_canvas, np.float32)).to(self.device),
            "ppx": torch.tensor(ppx, dtype=torch.float32, device=self.device),
            "ppy": torch.tensor(ppy, dtype=torch.float32, device=self.device),
        }
        self.mesh_ctx = replicate(self.ctx, self.mesh) if self.mesh is not None else None

    def _seed_target_maps(self) -> np.ndarray | None:
        if not self.cfg.use_depth:
            return None
        hc, wc = self.scene.canvas_hw
        maps = np.zeros((len(self.scene), hc // 8, wc // 8, 3), np.float32)
        for idx, depth_canvas in self.scene.depth_maps.items():
            maps[idx] = seed_scene_coordinates(depth_canvas, float(self.scene.focals_canvas[idx]),
                                               self.scene.poses_c2w[idx])
        return maps

    def build_buffer(self):
        """The filled buffer; with a mesh, its row shards (`shard_rows`)."""
        buffer = fill_training_buffer(
            self.encoder_params, self.scene.images.content(), self.scene.images.sizes, self.buffer_cfg,
            target_maps=self._seed_target_maps(), generator=self.generator, pad_rows_to_bucket=True,
            host_spill=self.cfg.buffer_host_spill,
        )
        if self.mesh is None:
            return buffer
        n = self.mesh.size
        aligned = (buffer["features"].shape[0] // n) * n
        return shard_rows({k: v[:aligned] for k, v in buffer.items()}, self.mesh)

    def build_state(self) -> TrainState:
        """Fresh optimizer, schedule and refiner state."""
        cfg = self.cfg
        if cfg.pose_refinement == "naive":
            pose_params = {"pose_buffer": self.ctx["poses_w2c"].clone()}
        elif cfg.pose_refinement == "mlp":
            pose_params = init_posenet_params(self.init_generator, device=self.device)
        else:
            pose_params = {}
        focal_g = torch.zeros((), dtype=torch.float32, device=self.device)
        return TrainState(
            head_params=self.head_params_init, head_opt=adamw_init(self.head_params_init),
            pose_params=pose_params, pose_opt=adamw_init(pose_params),
            focal_g=focal_g, focal_opt=adamw_init(focal_g),
            sched=init_schedule(cfg.schedule, self.device),
            iteration=torch.zeros((), dtype=torch.int32, device=self.device),
            nan_steps=torch.zeros((), dtype=torch.int32, device=self.device),
        )

    def _sync(self) -> None:
        for dev in dict.fromkeys(self.mesh.devices if self.mesh is not None else (self.device,)):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    def train(self) -> dict:
        t0 = time.time()
        buffer = self.build_buffer()
        self._sync()
        n_rows = sum(b["features"].shape[0] for b in buffer) if self.mesh is not None else buffer["features"].shape[0]
        fill_time = time.time() - t0
        _logger.info("Filled training buffer: %d rows in %.1fs", n_rows, fill_time)

        state = self.build_state()
        train_start = time.time()
        state, it, steps, log = self.train_to_budget(state, buffer, t0=t0)
        self._sync()
        train_time = time.time() - train_start

        cfg = self.cfg
        nan_steps = int(state.nan_steps)
        if nan_steps > 0:
            _logger.warning("Skipped %d NaN-loss steps", nan_steps)
        poses_w2c = self.current_poses(state)
        focal_orig = float(self.scene.focals_orig[0]) * (1.0 + float(state.focal_g))
        _logger.info("Mapping done: %d iterations, %d steps (buffer %.1fs, train %.1fs)", it, steps,
                     fill_time, train_time)
        return {
            "state": state,
            "head_params": state.head_params,
            "poses_w2c": poses_w2c,
            "focal_orig": focal_orig if cfg.refine_calibration else None,
            "iterations": it,
            "fill_time": fill_time,
            "train_time": train_time,
            "steps": steps,
            "buffer_rows": n_rows,
            "log": log,
        }

    def train_to_budget(self, state: TrainState, buffer: dict, t0: float | None = None):
        """Train from `state` until the schedule's max_iterations; returns
        (state, iteration, steps, log).

        Dispatches up to chunk_steps * sync_every_chunks steps per host sync
        (chunk_steps with a frame callback), never past the last known
        max_iterations (steps beyond it would be gated no-ops); the cooldown
        can still shrink it within a group.
        """
        cfg = self.cfg
        hp = train_hp(cfg)
        t0 = time.time() if t0 is None else t0
        steps = 0
        log = []
        group = cfg.chunk_steps * (1 if self.frame_callback is not None else max(1, cfg.sync_every_chunks))
        it, max_it = (int(v) for v in torch.stack([state.iteration, state.sched.max_iterations]).tolist())
        last_logged = last_callback = it
        while it < max_it:
            n = min(group, max_it - it)
            state, stats = train_steps(state, buffer, self.mesh_ctx if self.mesh is not None else self.ctx, hp, cfg,
                                       self.head_cfg, n, generator=self.generator, mesh=self.mesh)
            steps += n
            # one batched fetch per sync: the stop check and the group's stats
            it, max_it = (int(v) for v in torch.stack([state.iteration, state.sched.max_iterations]).tolist())
            hist = {k: stats[k].cpu().numpy() for k in ("loss", "batch_inliers", "active")}
            first_it = it - int(hist["active"].sum())
            for j in np.flatnonzero(hist["active"]):
                step_it = first_it + int(np.count_nonzero(hist["active"][: j + 1]))
                if step_it - last_logged >= cfg.iterations_output or step_it == it >= max_it:
                    entry = {"iteration": step_it, "loss": float(hist["loss"][j]),
                             "batch_inliers": float(hist["batch_inliers"][j]), "time": time.time() - t0}
                    log.append(entry)
                    _logger.info("Iteration %6d|%6d, loss %.1f, batch inliers %.1f%%", step_it, max_it,
                                 entry["loss"], entry["batch_inliers"] * 100)
                    last_logged = step_it
            if self.frame_callback is not None and (it - last_callback >= cfg.iterations_output or it >= max_it):
                self.frame_callback(it, self.current_poses(state))
                last_callback = it
        return state, it, steps, log

    @torch.no_grad()
    def current_poses(self, state: TrainState) -> np.ndarray:
        """All refined world-to-camera poses (N, 3, 4)."""
        w2c_rows = self.ctx["poses_w2c"]
        idx = torch.arange(w2c_rows.shape[0], device=self.device)
        with no_tf32():
            refined = _refined_w2c(self.cfg, state.pose_params, w2c_rows, idx)
        return refined.cpu().numpy()[: len(self.scene)]

