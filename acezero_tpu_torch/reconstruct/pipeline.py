"""The ACE0 reconstruction loop.

Counterpart of acezero_tpu/reconstruct/pipeline.py (`AceZeroPipeline`,
reference ace_zero.py:160-410): one process holds the scene (decoded once),
the encoder, the current head, the poses and the focal estimate, and writes
the same artifacts every round (`iteration*.pt` heads,
`poses_iteration*[_preliminary|_fastcheck].txt`, `poses_final.txt`), with
the same stage names for `utils.profiling.stage_report`:
  1. seed stage: `try_seeds` single-image seed maps (depth-supervised),
     scored by registration rate; the best seed wins;
  2. register all frames against the seed map;
  3. map on the confident frames (MLP pose and focal refinement, warm
     start) and register all frames, until the registration rate reaches
     `registration_threshold` or grows by less than
     `relative_registration_threshold`, or `iterations_max` is reached;
  4. loop closure (reconstruct/loopclose.py) on the registered poses, then
     one final refine round and the final refit (dyntanh, circle schedule,
     pose wait; poses frozen when loop closure applied corrections);
  5. more refit cycles: `final_refit_cycles - 1` on request, and up to
     `adaptive_refit_max_cycles` while loop closure measures drift;
  6. with `loopclose_final_graph`, when corrections were applied and the
     refits did not drain the drift, the corrected pose graph is the final
     estimate (`poses_iteration{n}_loopclosed.txt`).

Seed depth comes from `depth_files`, from a `depth_estimator` the caller
plugs in, or, as in the JAX package, from the learned seed-depth head
(`cfg.depth_network`, else the newest shipped head in `weights/`).
`--export_point_cloud` writes `pc_final.ply` from the final map
(export/point_cloud.py); `--training_buffer_cpu` keeps the training buffer
in host memory (training/trainer.py). `--render_visualization` renders the
progress video into `renderings/` (viz/): after every registration round
(the round's point cloud, 12 relocalization frames and the state pickle
`<iteration>_register.pkl`), one mapping frame every `iterations_output`
steps of each main-loop round, and the final 150-frame sweep, then
`reconstruction.mp4` when ffmpeg is present; each hook is timed as stage
`render`, which is carved out of the stage it runs in. `prewarm` does
nothing: it hides XLA compile latency, which the port does not have.

The data mesh (parallel/mesh.py) is built for `num_devices` N > 1 only: the
first N visible cards (clamped to them; fewer than two means no mesh). 0
means one device here, where the JAX package takes every visible device:
on several cards the mesh is still slower than one card. The mesh shards
the buffer rows of the seed map of `_map_seed` (not the seed lanes of
`_map_seeds_parallel`), of each mapping round and of the final refit, and
the frames of seed scoring and of every registration round; loop closure,
export and the visualizer run on the primary. `mesh=` passes a mesh
instead of the rule (the CPU tests pass a logical one: torch has one CPU
device).
"""

from __future__ import annotations

import logging
import shutil
import time
from dataclasses import replace
from pathlib import Path

import numpy as np
import torch

from acezero_tpu_torch import resolve_device
from acezero_tpu_torch.data.depth import DepthEstimator, depth_to_canvas, learned_depth_estimator, load_depth_file
from acezero_tpu_torch.data.images import read_rgb
from acezero_tpu_torch.data.scene import SceneData, load_scene
from acezero_tpu_torch.export.point_cloud import export_point_cloud_from_network, point_cloud_from_network
from acezero_tpu_torch.io.pose_files import PoseFileEntry, get_files_from_glob, registration_rates, write_pose_file
from acezero_tpu_torch.models import torch_io
from acezero_tpu_torch.models.encoder import init_encoder_params
from acezero_tpu_torch.models.head import HeadConfig
from acezero_tpu_torch.parallel.mesh import Mesh, make_mesh
from acezero_tpu_torch.reconstruct.config import AceZeroConfig
from acezero_tpu_torch.reconstruct.loopclose import LoopCloseConfig, loop_close_entries
from acezero_tpu_torch.registration.driver import RegistrationConfig, register_frames, register_frames_multi
from acezero_tpu_torch.registration.ransac import RansacConfig
from acezero_tpu_torch.training.buffer import BufferConfig
from acezero_tpu_torch.training.loss import ReproLossConfig
from acezero_tpu_torch.training.schedule import ScheduleConfig
from acezero_tpu_torch.training.trainer import MappingTrainer, TrainConfig, train_hp, train_steps
from acezero_tpu_torch.utils.profiling import stage, stage_report
from acezero_tpu_torch.viz import ReconstructionVisualizer, VizConfig

_logger = logging.getLogger(__name__)

WEIGHTS = Path(__file__).resolve().parents[2] / "weights"
SHIPPED_ENCODERS = ("tpu_encoder_v6.pt", "tpu_encoder_v5.pt", "tpu_encoder_v2.pt")
# depth heads read the features of the encoder they were trained on: v4 on
# v6, v3 on v5, v1 on v2 (the JAX package's order of preference)
SHIPPED_DEPTH_HEADS = ("tpu_depth_v4.pt", "tpu_depth_v3.pt", "tpu_depth_v1.pt")


def pipeline_mesh(num_devices: int, device: torch.device) -> Mesh | None:
    """The data mesh of `num_devices`: the first N visible cards for N > 1
    (clamped to them), else no mesh. Unlike the JAX rule, 0 means one
    device, not every visible one: several cards map and register slower
    than one (PERF.md). Only CUDA devices form a mesh (on the CPU there is
    one device); it starts at cuda:0."""
    if device.type != "cuda" or num_devices <= 1:
        return None
    n = min(num_devices, torch.cuda.device_count())
    return make_mesh(n) if n > 1 else None


class AceZeroPipeline:
    def __init__(self, cfg: AceZeroConfig, device=None, encoder_params: dict | None = None,
                 depth_estimator: DepthEstimator | None = None, mesh: Mesh | None = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.mesh = mesh if mesh is not None else pipeline_mesh(cfg.num_devices, self.device)
        if self.mesh is not None:
            if self.device.type != self.mesh.primary.type or self.device.index not in (None, self.mesh.primary.index):
                raise ValueError(f"the mesh's primary {self.mesh.primary} is not the pipeline's device "
                                 f"{self.device}; pass --num_devices 1 to run on {self.device} alone")
            self.device = self.mesh.primary
            _logger.info("Using a %d-device data mesh: %s", self.mesh.size, [str(d) for d in self.mesh.devices])
        self.out = Path(cfg.results_folder)
        self.out.mkdir(parents=True, exist_ok=True)

        if encoder_params is not None:
            self.encoder_params = encoder_params
        else:
            enc_path = None
            if cfg.encoder_path is not None and Path(cfg.encoder_path).exists():
                enc_path = Path(cfg.encoder_path)
            else:
                # the newest shipped scene-agnostic encoder, as the JAX package
                enc_path = next((WEIGHTS / c for c in SHIPPED_ENCODERS if (WEIGHTS / c).exists()), None)
            if enc_path is not None:
                self.encoder_params = torch_io.load_encoder(enc_path, self.device)
                _logger.info("Loaded pretrained encoder from %s", enc_path)
            else:
                _logger.warning("No pretrained encoder available — using random initialization. "
                                "Reconstruction quality will be substantially reduced.")
                self.encoder_params = init_encoder_params(torch.Generator().manual_seed(cfg.base_seed),
                                                          self.device)

        self.head_cfg = HeadConfig(num_head_blocks=cfg.num_head_blocks, use_homogeneous=cfg.use_homogeneous)

        use_heuristic = cfg.use_external_focal_length < 0 and cfg.calibration_files is None
        with stage("scene_load"):
            self.scene = load_scene(
                cfg.rgb_files,
                image_short_size=cfg.image_resolution,
                use_heuristic_focal_length=use_heuristic,
                external_focal_length=cfg.use_external_focal_length if cfg.use_external_focal_length >= 0 else None,
                calibration_files=cfg.calibration_files,
                num_workers=cfg.num_decode_workers,
                decode_cache_dir=cfg.decode_cache_dir,
            )
        _logger.info("Loaded %d images onto a %dx%d canvas.", len(self.scene), *self.scene.canvas_hw)

        self.depth_estimator = depth_estimator
        self.depth_files = get_files_from_glob(cfg.depth_files) if cfg.depth_files is not None else None
        if self.depth_files is None and self.depth_estimator is None:
            # a bare image-glob run: the learned seed-depth head, paired with
            # the encoder it was trained on
            candidates = [cfg.depth_network] if cfg.depth_network else [WEIGHTS / c for c in SHIPPED_DEPTH_HEADS]
            depth_net = next((Path(c) for c in candidates if Path(c).exists()), None)
            if depth_net is not None:
                self.depth_estimator = learned_depth_estimator(depth_net, encoder_params=self.encoder_params)
                _logger.info("Using learned seed-depth estimator: %s", depth_net)

        self.visualizer = None
        if cfg.render_visualization:
            self.visualizer = ReconstructionVisualizer(
                VizConfig(target_path=self.out / "renderings", marker_size=cfg.render_marker_size,
                          camera_z_offset=cfg.render_camera_z_offset, conf_threshold=cfg.registration_confidence),
                device=self.device)
        self._probe_memo = None  # see _loop_close

    # ------------------------------------------------------------- configs

    def _schedule(self, iterations: int, schedule: str | None = None, lr_max: float | None = None):
        cfg = self.cfg
        return ScheduleConfig(
            schedule=schedule or cfg.learning_rate_schedule,
            iterations=iterations,
            learning_rate_min=cfg.learning_rate_min,
            learning_rate_max=lr_max if lr_max is not None else cfg.learning_rate_max,
            warmup_iterations=cfg.learning_rate_warmup_iterations,
            warmup_learning_rate=cfg.learning_rate_warmup_learning_rate,
            cooldown_iterations=cfg.cooldown_iterations,
            cooldown_trigger_percent=cfg.cooldown_threshold,
        )

    def _buffer_cfg(self) -> BufferConfig:
        cfg = self.cfg
        return BufferConfig(
            max_buffer_size=cfg.max_training_buffer_size,
            samples_per_image=cfg.samples_per_image,
            max_dataset_passes=cfg.max_dataset_passes,
            use_aug=True,
            aug_rotation=cfg.aug_rotation,
            aug_black_white=cfg.aug_black_white,
        )

    def _base_train_cfg(self, iterations: int, use_depth: bool, refine: bool) -> TrainConfig:
        cfg = self.cfg
        return TrainConfig(
            batch_size=cfg.batch_size,
            schedule=self._schedule(iterations),
            loss=ReproLossConfig(total_iterations=iterations, soft_clamp=cfg.repro_loss_soft_clamp,
                                 soft_clamp_min=1.0, loss_type=cfg.repro_loss_type),
            repro_loss_hard_clamp=cfg.repro_loss_hard_clamp,
            pose_refinement=cfg.refinement if refine else "none",
            pose_refinement_lr=cfg.pose_refinement_lr,
            pose_refinement_wait=cfg.pose_refinement_wait,
            refinement_ortho=cfg.refinement_ortho,
            refine_calibration=cfg.refine_calibration if refine else False,
            use_depth=use_depth,
            buffer_host_spill=cfg.training_buffer_cpu,
            iterations_output=cfg.iterations_output,
            chunk_steps=cfg.chunk_steps,
        )

    def _refit_train_cfg(self, freeze_poses: bool = False) -> TrainConfig:
        """The final-refit recipe (reference ace_zero_util.get_refit_mapping_cmd
        :63-109): dyntanh loss, circle schedule at lr 0.005, poses frozen for
        the first final_refit_posewait steps (for the whole refit with
        `freeze_poses`)."""
        cfg = self.cfg
        return TrainConfig(
            batch_size=cfg.batch_size,
            schedule=self._schedule(cfg.refit_iterations, schedule="circle", lr_max=0.005),
            loss=ReproLossConfig(total_iterations=cfg.refit_iterations, soft_clamp=cfg.repro_loss_soft_clamp,
                                 soft_clamp_min=1.0, loss_type="dyntanh"),
            repro_loss_hard_clamp=cfg.repro_loss_hard_clamp,
            pose_refinement=cfg.refinement,
            pose_refinement_lr=cfg.pose_refinement_lr,
            pose_refinement_wait=cfg.refit_iterations if freeze_poses else cfg.final_refit_posewait,
            refinement_ortho=cfg.refinement_ortho,
            refine_calibration=cfg.refine_calibration,
            use_depth=False,
            buffer_host_spill=cfg.training_buffer_cpu,
            iterations_output=cfg.iterations_output,
            chunk_steps=cfg.chunk_steps,
        )

    def _registration_cfg(self, max_estimates: int = -1) -> RegistrationConfig:
        cfg = self.cfg
        return RegistrationConfig(
            ransac=RansacConfig(hypotheses=cfg.ransac_iterations, max_tries=16,
                                inlier_threshold=cfg.ransac_threshold, refinement_steps=cfg.refinement_steps),
            confidence_threshold=cfg.registration_confidence,
            max_estimates=max_estimates,
            frame_chunk=cfg.registration_frame_chunk,
            base_seed=cfg.random_seed,
            refit_tier1=cfg.refit_tier1,
        )

    def _rate(self, entries: list[PoseFileEntry]) -> float:
        return registration_rates([e.confidence for e in entries], [self.cfg.registration_confidence])[0]

    # --------------------------------------------------------------- seeds

    def _seed_depth_canvas(self, frame_idx: int) -> np.ndarray:
        h, w = self.scene.images.sizes[frame_idx]
        if self.depth_files is not None:
            depth = load_depth_file(self.depth_files[frame_idx])
        elif self.depth_estimator is not None:
            depth = self.depth_estimator(read_rgb(self.scene.rgb_files[frame_idx]))
        else:
            raise ValueError("Seed initialization needs depth: pass depth_files or a depth_estimator.")
        return depth_to_canvas(depth, (int(h), int(w)), self.scene.canvas_hw)

    def _seed_trainer(self, frame: int, train_cfg: TrainConfig, base_seed: int,
                      mesh: Mesh | None = None) -> MappingTrainer:
        """A MappingTrainer on the one seed frame at the identity pose, with
        its depth as supervision (sharded over `mesh` when given)."""
        seed_scene = self.scene.subset(np.asarray([frame]))
        seed_scene.poses_c2w = np.eye(4, dtype=np.float32)[None]
        seed_scene.pose_valid = np.ones(1, bool)
        seed_scene.depth_maps[0] = self._seed_depth_canvas(frame)
        return MappingTrainer(seed_scene, self.encoder_params, self.head_cfg, train_cfg, self._buffer_cfg(),
                              base_seed=base_seed, mesh=mesh)

    def _save_seed(self, si: int, head_params: dict, entries: list[PoseFileEntry]) -> None:
        iteration_id = f"iteration0_seed{si}"
        torch_io.save_head(self.out / f"{iteration_id}.pt", head_params, self.head_cfg)
        write_pose_file(self.out / f"poses_{iteration_id}_fastcheck.txt", entries)

    def _map_seed(self, seed_idx: int, seed_value: float) -> tuple[dict, float, str]:
        """One seed map trained to its budget, scored on up to 1000 frames."""
        cfg = self.cfg
        frame = int(seed_value * len(self.scene))
        _logger.info("Mapping seed %d: frame %d (%s)", seed_idx, frame, self.scene.rgb_files[frame])
        trainer = self._seed_trainer(frame, self._base_train_cfg(cfg.seed_iterations, use_depth=True, refine=False),
                                     cfg.base_seed + seed_idx, mesh=self.mesh)
        with stage("seed_mapping", trace=True):
            head_params = trainer.train()["head_params"]
        # fast seed scoring on <= 1000 frames (reference ace_zero_util.py:242-259)
        entries = register_frames(self.encoder_params, head_params, self.head_cfg, self.scene,
                                  self._registration_cfg(max_estimates=1000), device=self.device, mesh=self.mesh)
        self._save_seed(seed_idx, head_params, entries)
        rate = self._rate(entries)
        _logger.info("Seed %d registered %.1f%% of frames.", seed_idx, rate * 100)
        return head_params, rate, f"iteration0_seed{seed_idx}"

    def _map_seeds_parallel(self, seeds: np.ndarray) -> list[tuple[dict, float, str]]:
        """All candidate seed maps, one MappingTrainer per lane, trained one
        after another and scored together with one encoder pass per chunk.

        With early seed selection (`seed_selection_iterations`, on scenes of
        at least `seed_selection_min_frames` frames) every lane trains to
        the selection budget, the lanes are scored on
        `seed_selection_frames` frames at a 12-step refit cap, and only the
        winner continues to its full budget; the other heads keep their
        selection-time state in their `iteration0_seedN.pt`.
        """
        cfg = self.cfg
        train_cfg = self._base_train_cfg(cfg.seed_iterations, use_depth=True, refine=False)
        S = len(seeds)
        frames = [int(s * len(self.scene)) for s in seeds]
        with stage("seed_buffer_fill"):
            trainers = [self._seed_trainer(f, train_cfg, cfg.base_seed + si) for si, f in enumerate(frames)]
            buffers = [t.build_buffer() for t in trainers]
            states = [t.build_state() for t in trainers]

        sel_iters = cfg.seed_selection_iterations
        do_select = 0 < sel_iters < cfg.seed_iterations and S > 1 and len(self.scene) >= cfg.seed_selection_min_frames
        t0 = time.time()
        with stage("seed_training"):
            for si, trainer in enumerate(trainers):
                if do_select:
                    # the JAX package's whole chunks up to the selection budget
                    n = min(-(-sel_iters // train_cfg.chunk_steps) * train_cfg.chunk_steps, cfg.seed_iterations)
                    states[si], _ = train_steps(states[si], buffers[si], trainer.ctx, train_hp(train_cfg), train_cfg,
                                                self.head_cfg, n, generator=trainer.generator)
                else:
                    states[si] = trainer.train_to_budget(states[si], buffers[si])[0]
        iters = [int(st.iteration) for st in states]
        _logger.info("Trained %d seed maps: iterations %s in %.1fs", S, iters, time.time() - t0)

        max_est = cfg.seed_selection_frames if do_select else 1000
        score_cfg = self._registration_cfg(max_estimates=max_est)
        if do_select:
            # scoring only ranks the maps: a hard 12-step refit cap, no tiers
            score_cfg = replace(score_cfg, ransac=replace(score_cfg.ransac, refinement_steps=12), refit_tier1=0)
        head_list = [st.head_params for st in states]
        with stage("seed_scoring"):
            all_entries = register_frames_multi(self.encoder_params, head_list, self.head_cfg, self.scene,
                                                score_cfg, device=self.device, mesh=self.mesh)
        rates = [self._rate(entries) for entries in all_entries]

        if do_select:
            best = int(np.argmax(rates))
            _logger.info("Seed selection at %d iterations on %d frames: rates %s -> seed %d; "
                         "continuing only the winner.", sel_iters, max_est, [f"{r:.3f}" for r in rates], best)
            with stage("seed_training"):
                state_b, it_b, _, _ = trainers[best].train_to_budget(states[best], buffers[best])
            _logger.info("Winner seed %d trained to %d iterations.", best, it_b)
            head_list[best] = state_b.head_params

        results = []
        for si in range(S):
            self._save_seed(si, head_list[si], all_entries[si])
            _logger.info("Seed %d registered %.1f%% of frames.", si, rates[si] * 100)
            results.append((head_list[si], rates[si], f"iteration0_seed{si}"))
        return results

    # ----------------------------------------------------------------- run

    def _register_all(self, head_params: dict, iteration_id: str,
                      focal_override: float | None) -> list[PoseFileEntry]:
        with stage("registration", trace=True):
            entries = register_frames(self.encoder_params, head_params, self.head_cfg, self.scene,
                                      self._registration_cfg(), focal_override_orig=focal_override,
                                      device=self.device, mesh=self.mesh)
        with stage("artifacts"):
            write_pose_file(self.out / f"poses_{iteration_id}.txt", entries)
        if self.visualizer is not None:
            self._render_round(head_params, iteration_id, entries)
        return entries

    def _render_round(self, head_params: dict, iteration_id: str, entries: list[PoseFileEntry]) -> None:
        """The visualizer's hook after a registration round: the cloud of up
        to 64 confident frames from the current map (one K1 launch), the
        round's registrations, 12 relocalization frames revealing the
        queries group by group, and the state pickle."""
        with stage("render", carve=True):
            it_num = int(iteration_id.replace("iteration", "").split("_")[0] or 0) \
                if iteration_id.startswith("iteration") and iteration_id[9:10].isdigit() else 0
            confident = [e for e in entries if e.confidence >= self.cfg.registration_confidence]
            if confident:
                xyz, rgb = point_cloud_from_network(self.encoder_params, head_params, self.head_cfg, self.scene,
                                                    confident[:64])
                self.visualizer.update_point_cloud(xyz, rgb)
            for e in entries:
                self.visualizer.record_registration(e.rgb_file, e.confidence, it_num)
            poses = np.stack([e.pose_c2w for e in entries])
            confs = np.asarray([e.confidence for e in entries])
            n = len(entries)
            shown = 0
            for g in np.array_split(np.arange(n), min(12, n)):
                shown += len(g)
                self.visualizer.render_reloc_frame(poses[:shown], confs[:shown],
                                                   caption=f"{iteration_id}: {shown}/{n} images queried")
            self.visualizer.save_state(self.out / "renderings" / f"{iteration_id}_register.pkl")

    def _mapping_frame_callback(self, iteration_id: str, max_it: int):
        """The trainer's frame callback of a main-loop round: one mapping
        frame of the refined cameras."""
        def frame_cb(it, poses_w2c):
            with stage("render", carve=True):
                bottom = np.tile([[[0, 0, 0, 1.0]]], (len(poses_w2c), 1, 1))
                c2w = np.linalg.inv(np.concatenate([poses_w2c, bottom], axis=1))
                self.visualizer.render_mapping_frame(c2w, caption=f"{iteration_id} · step {it}",
                                                     progress=it / max(max_it, 1))
        return frame_cb

    def _loop_close(self, entries: list[PoseFileEntry], head_params: dict,
                    focal_estimate: float | None) -> tuple[list[PoseFileEntry], dict]:
        """Loop closure on the current map (reconstruct/loopclose.py), run
        right before a refit so the fresh network trains from corrected poses.
        Returns (entries, diagnostics): the entries unchanged when disabled,
        degenerate or drift-free; the diagnostics' median correction gates
        the adaptive refit cycles."""
        cfg = self.cfg
        if not cfg.loop_closure:
            return entries, {"skipped": "disabled"}
        rate_now = self._rate(entries)
        # probe memo: an earlier probe of this run measured drift well under
        # the gate and registration has not degraded since, so the refit in
        # between trained from those very poses: skip re-measuring (parity
        # with the JAX package, which documents it as a known shortcut)
        memo = self._probe_memo
        if memo is not None and rate_now >= memo["rate"] - 0.01:
            _logger.info("Loop-closure probe memo: previous probe was drift-free with margin "
                         "(%.2f cm / %.3f deg) and registration held — skipping.",
                         memo["median_corr_t"] * 100, memo["median_corr_rot_deg"])
            return entries, {**memo["diag"], "skipped": "probe_memo"}

        # drift pre-probe on an evenly strided subgraph (no BA); only when it
        # trips the drift gate does the full measurement run
        probe_n = cfg.loop_closure_probe_frames
        n_conf = sum(e.confidence >= cfg.registration_confidence for e in entries)
        if 0 < probe_n * 2 <= n_conf:
            with stage("loop_closure_probe", trace=True):
                _, probe_diag = loop_close_entries(
                    self.encoder_params, head_params, self.head_cfg, self.scene, entries,
                    conf_threshold=cfg.registration_confidence, focal_override_orig=focal_estimate,
                    cfg=replace(LoopCloseConfig(), ba="off"), max_frames=probe_n, device=self.device)
            # an inconclusive probe (degenerate subgraph) falls through
            if "skipped" not in probe_diag and not self._drift_detected(probe_diag):
                _logger.info("Loop-closure probe: no drift (median %.2f cm / %.3f deg) — skipping the full "
                             "measurement.", probe_diag.get("median_corr_t", 0.0) * 100,
                             probe_diag.get("median_corr_rot_deg", 0.0))
                probe_diag["skipped"] = "probe_no_drift"
                # memoize strongly drift-free probes (half the gate)
                t_gate = max(0.005 * probe_diag.get("scene_diag", 0.0), 0.01)
                corr_t = probe_diag.get("median_corr_t", 0.0)
                corr_r = probe_diag.get("median_corr_rot_deg", 0.0)
                if corr_t < 0.5 * t_gate and corr_r < 0.25:
                    self._probe_memo = {"rate": rate_now, "median_corr_t": corr_t, "median_corr_rot_deg": corr_r,
                                        "diag": dict(probe_diag)}
                return entries, probe_diag

        self._probe_memo = None  # geometry is about to be measured and corrected
        with stage("loop_closure", trace=True):
            return loop_close_entries(
                self.encoder_params, head_params, self.head_cfg, self.scene, entries,
                conf_threshold=cfg.registration_confidence, focal_override_orig=focal_estimate,
                max_frames=cfg.loop_closure_max_frames, device=self.device)

    def _drift_detected(self, lc_diag: dict) -> bool:
        """True when loop closure measured corrections too large for one
        refit to drain (the adaptive-cycle trigger): a median correction
        above 0.5% of the scene diagonal (at least 1 cm) or 0.5°."""
        if "skipped" in lc_diag:
            return False
        t_gate = max(0.005 * lc_diag.get("scene_diag", 0.0), 0.01)
        return lc_diag.get("median_corr_t", 0.0) > t_gate or lc_diag.get("median_corr_rot_deg", 0.0) > 0.5

    def _mapping_scene_from_entries(self, entries: list[PoseFileEntry]) -> SceneData:
        """The next round's mapping scene: the frames above the confidence
        bar, at their registered poses and focals."""
        cfg = self.cfg
        by_file = {f: i for i, f in enumerate(self.scene.rgb_files)}
        keep = [e for e in entries if e.confidence >= cfg.registration_confidence]
        if not keep:
            # beyond the reference (which would train on an empty set): the
            # most confident tenth keeps the loop trying to grow the map
            k = max(1, len(entries) // 10)
            keep = sorted(entries, key=lambda e: -e.confidence)[:k]
            _logger.warning("No frames above confidence %.0f — falling back to the %d most confident (best %.0f).",
                            cfg.registration_confidence, k, keep[0].confidence)
        indices = np.asarray([by_file[e.rgb_file] for e in keep])
        sub = self.scene.subset(indices, copy_canvases=False)
        sub.poses_c2w = np.stack([e.pose_c2w for e in keep]).astype(np.float32)
        sub.pose_valid = np.ones(len(keep), bool)
        sub.focals_orig = np.asarray([e.focal_length for e in keep], np.float32)
        sub.focals_canvas = sub.focals_orig * sub.images.scale_factors
        return sub

    def _train(self, mapping_scene: SceneData, train_cfg: TrainConfig, init_head: dict | None,
               base_seed: int, frame_callback=None) -> dict:
        with stage("mapping", trace=True):
            trainer = MappingTrainer(mapping_scene, self.encoder_params, self.head_cfg, train_cfg,
                                     self._buffer_cfg(), head_params=init_head, base_seed=base_seed,
                                     frame_callback=frame_callback, mesh=self.mesh)
            return trainer.train()

    def run(self) -> dict:
        cfg = self.cfg
        t_start = time.time()

        # ---------------- seed stage (or seed network) --------------------
        if cfg.seed_network is not None:
            iteration_id = Path(cfg.seed_network).stem
            _logger.info("Starting from seed network %s", cfg.seed_network)
            _, head_params = torch_io.load_head(cfg.seed_network, self.device)
        else:
            np.random.seed(cfg.random_seed)
            seeds = np.random.uniform(size=cfg.try_seeds)
            _logger.info("Trying seeds: %s", seeds)
            if cfg.seed_parallel and cfg.try_seeds > 1:
                results = self._map_seeds_parallel(seeds)
            else:
                results = [self._map_seed(i, s) for i, s in enumerate(seeds)]
            rates = [r[1] for r in results]
            best = int(np.argmax(rates))
            head_params, _, iteration_id = results[best]
            _logger.info("Selected seed %s with registration rate %.1f%%", iteration_id, rates[best] * 100)

        # register everything against the seed map (heuristic/external focal)
        entries = self._register_all(head_params, iteration_id, focal_override=None)
        max_rate = self._rate(entries)
        _logger.info("Seed map registered %.1f%% of all frames.", max_rate * 100)

        scheduled_to_stop_early = False
        focal_estimate: float | None = None
        iteration = 0
        lc_applied = False  # loop closure applied corrections before this refit
        rate_history = [max_rate]

        # ------------------------- main loop ------------------------------
        for iteration in range(1, cfg.iterations_max):
            iteration_id = f"iteration{iteration}"
            refit_round = scheduled_to_stop_early and cfg.final_refit
            with stage("scene_subset"):
                mapping_scene = self._mapping_scene_from_entries(entries)
            _logger.info("%s: mapping on %d confident frames%s", iteration_id, len(mapping_scene),
                         " (final refit)" if refit_round else "")
            if refit_round:
                # a fresh network (ace_zero.py:269-272)
                train_cfg = self._refit_train_cfg(freeze_poses=cfg.loopclose_refit_freeze_poses and lc_applied)
                init_head = None
            else:
                train_cfg = self._base_train_cfg(cfg.iterations, use_depth=False, refine=True)
                warm = cfg.warmstart and (iteration > 1 or cfg.seed_network is not None)
                init_head = head_params if warm else None
            frame_cb = None
            if self.visualizer is not None:
                frame_cb = self._mapping_frame_callback(iteration_id, train_cfg.schedule.iterations)
            result = self._train(mapping_scene, train_cfg, init_head, cfg.base_seed, frame_cb)
            head_params = result["head_params"]
            with stage("artifacts"):
                torch_io.save_head(self.out / f"{iteration_id}.pt", head_params, self.head_cfg)

            # preliminary poses: the refined world-to-camera poses, confidence inf
            focal_estimate = result["focal_orig"] or float(mapping_scene.focals_orig[0])
            prelim = [
                PoseFileEntry(rgb_file=mapping_scene.rgb_files[i],
                              pose_w2c=np.vstack([result["poses_w2c"][i], [0, 0, 0, 1]]),
                              focal_length=focal_estimate, confidence=float("inf"))
                for i in range(len(mapping_scene))
            ]
            with stage("artifacts"):
                write_pose_file(self.out / f"poses_{iteration_id}_preliminary.txt", prelim)

            entries = self._register_all(head_params, iteration_id, focal_override=focal_estimate)
            rate = self._rate(entries)
            _logger.info("%s: registered %.1f%% of all frames.", iteration_id, rate * 100)
            rate_history.append(rate)

            if scheduled_to_stop_early:
                break
            if rate >= cfg.registration_threshold or rate - max_rate < cfg.relative_registration_threshold:
                if not cfg.final_refine:
                    break
                _logger.info("Stopping criteria met — one final mapping round.")
                scheduled_to_stop_early = True
            if iteration >= cfg.iterations_max - 2:
                scheduled_to_stop_early = True
            if scheduled_to_stop_early:
                # drain the accumulated drift before the final refit retrains
                # the map from these poses
                entries, lc_diag = self._loop_close(entries, head_params, focal_estimate)
                lc_applied = "skipped" not in lc_diag and self._drift_detected(lc_diag)
            max_rate = max(rate, max_rate)

        # ---------------- extra refit cycles (drift drain) ----------------
        # refit -> register again while the recipe asks for it
        # (final_refit_cycles > 1) or loop closure measures drift one refit
        # cannot have drained (at most adaptive_refit_max_cycles); forward
        # scans measure millimetres and keep the reference's single pass
        extra = 0
        drift_converged = False  # left through a measured-no-drift break
        while cfg.final_refit:
            extra += 1
            explicit = extra < max(1, cfg.final_refit_cycles)
            if not explicit and not (cfg.loop_closure and extra <= cfg.adaptive_refit_max_cycles):
                break
            corrected, lc_diag = self._loop_close(entries, head_params, focal_estimate)
            if not explicit and not self._drift_detected(lc_diag):
                drift_converged = True
                break  # converged: keep the uncorrected (registration) poses
            lc_applied = "skipped" not in lc_diag and self._drift_detected(lc_diag)
            entries = corrected
            iteration += 1
            iteration_id = f"iteration{iteration}"
            mapping_scene = self._mapping_scene_from_entries(entries)
            freeze = cfg.loopclose_refit_freeze_poses and lc_applied
            _logger.info("%s: extra refit cycle %d on %d frames%s", iteration_id, extra, len(mapping_scene),
                         " (poses frozen: adopting loop-closure geometry)" if freeze else "")
            result = self._train(mapping_scene, self._refit_train_cfg(freeze_poses=freeze), None,
                                 cfg.base_seed + extra)
            head_params = result["head_params"]
            with stage("artifacts"):
                torch_io.save_head(self.out / f"{iteration_id}.pt", head_params, self.head_cfg)
            focal_estimate = result["focal_orig"] or focal_estimate
            entries = self._register_all(head_params, iteration_id, focal_override=focal_estimate)
            rate = self._rate(entries)
            _logger.info("%s: registered %.1f%% of all frames.", iteration_id, rate * 100)
            rate_history.append(rate)

        # ---------- final consistency choice (ring drift) ----------
        # when loop closure applied corrections and the refits did not drain
        # the drift, the refit map is a compromise registration re-anchors
        # onto: measure once more and emit the corrected pose graph instead.
        # Forward scans never apply corrections, so this costs them nothing.
        if cfg.final_refit and cfg.loop_closure and cfg.loopclose_final_graph and lc_applied \
                and not drift_converged:
            corrected, lc_diag = self._loop_close(entries, head_params, focal_estimate)
            if "skipped" not in lc_diag and self._drift_detected(lc_diag):
                _logger.info("Final drift check: refit cycles did not drain the measured drift (median %.2f cm "
                             "/ %.3f deg) — emitting the loop-closure-corrected pose graph as the final estimate.",
                             lc_diag.get("median_corr_t", 0.0) * 100, lc_diag.get("median_corr_rot_deg", 0.0))
                entries = corrected
                iteration_id = f"iteration{iteration}_loopclosed"
                with stage("artifacts"):
                    write_pose_file(self.out / f"poses_{iteration_id}.txt", entries)

        # ------------------------- outputs --------------------------------
        if self.visualizer is not None:
            _logger.info("Rendering final sweep.")
            with stage("render", carve=True):
                poses = np.stack([e.pose_c2w for e in entries])
                first_it = np.asarray([self.visualizer.registration_history.get(e.rgb_file, iteration)
                                       for e in entries], np.float32)
                self.visualizer.render_final_sweep(poses, first_it)
                self.visualizer.to_video(self.out / "reconstruction.mp4")

        total_time = time.time() - t_start
        shutil.copy(self.out / f"poses_{iteration_id}.txt", self.out / "poses_final.txt")
        rates = registration_rates([e.confidence for e in entries], [500, 1000, 2000, 4000])
        report = (
            "Time (min) | Iterations | Reg. Rate @500 | @1000 | @2000 | @4000\n"
            f"{total_time / 60:.1f} {iteration} "
            f"{rates[0] * 100:.1f}% {rates[1] * 100:.1f}% {rates[2] * 100:.1f}% {rates[3] * 100:.1f}%\n"
        )
        _logger.info(report)
        _logger.info("Stage breakdown:\n%s", stage_report())

        if cfg.export_point_cloud:
            with stage("export"):
                export_point_cloud_from_network(self.out / "pc_final.ply", self.encoder_params, head_params,
                                                self.head_cfg, self.scene, entries, dense=cfg.dense_point_cloud)
        return {
            "entries": entries,
            "head_params": head_params,
            "focal_estimate": focal_estimate,
            "iterations": iteration,
            "registration_rates": rates,
            "rate_history": rate_history,
            "time_seconds": total_time,
            "report": report,
            "pose_file": self.out / "poses_final.txt",
        }
