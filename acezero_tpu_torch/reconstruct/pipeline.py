"""The ACE0 reconstruction loop, loop closure off.

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
  4. one final refine round, then the final refit (dyntanh, circle
     schedule, pose wait), and `final_refit_cycles - 1` more refit cycles.

Left out of this slice, each raising NotImplementedError at construction:
loop closure (on by default), the learned seed-depth head (a run without
`depth_files` and without `seed_network`), calibration files, rendering,
point-cloud export and the host-spill training buffer. `prewarm` does
nothing: it hides XLA compile latency, which the port does not have.
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
from acezero_tpu_torch.data.depth import depth_to_canvas, load_depth_file
from acezero_tpu_torch.data.scene import SceneData, load_scene
from acezero_tpu_torch.io.pose_files import PoseFileEntry, get_files_from_glob, registration_rates, write_pose_file
from acezero_tpu_torch.models import torch_io
from acezero_tpu_torch.models.encoder import init_encoder_params
from acezero_tpu_torch.models.head import HeadConfig
from acezero_tpu_torch.reconstruct.config import AceZeroConfig
from acezero_tpu_torch.registration.driver import RegistrationConfig, register_frames, register_frames_multi
from acezero_tpu_torch.registration.ransac import RansacConfig
from acezero_tpu_torch.training.buffer import BufferConfig
from acezero_tpu_torch.training.loss import ReproLossConfig
from acezero_tpu_torch.training.schedule import ScheduleConfig
from acezero_tpu_torch.training.trainer import MappingTrainer, TrainConfig, train_hp, train_steps
from acezero_tpu_torch.utils.profiling import stage, stage_report

_logger = logging.getLogger(__name__)

WEIGHTS = Path(__file__).resolve().parents[2] / "weights"
SHIPPED_ENCODERS = ("tpu_encoder_v6.pt", "tpu_encoder_v5.pt", "tpu_encoder_v2.pt")


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to acezero_tpu_torch yet (ROADMAP.md, {item})")


class AceZeroPipeline:
    def __init__(self, cfg: AceZeroConfig, device=None, encoder_params: dict | None = None):
        # every branch this slice leaves out raises here, before any work
        if cfg.loop_closure:
            raise _not_ported("loop closure (pass --loop_closure false)", "section 1, loop closure")
        if cfg.depth_files is None and cfg.seed_network is None:
            raise _not_ported("the learned seed-depth head (pass --depth_files)", "section 1, learned seed depth")
        if cfg.calibration_files is not None:
            raise _not_ported("--calibration_files", "section 1, the rest of the host data path")
        if cfg.render_visualization:
            raise _not_ported("--render_visualization", "section 1, export and viz")
        if cfg.export_point_cloud:
            raise _not_ported("--export_point_cloud", "section 1, io/ply.py and export")
        if cfg.training_buffer_cpu:
            raise _not_ported("--training_buffer_cpu", "section 1, the host-spill buffer")

        self.cfg = cfg
        self.device = resolve_device(device)
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

        with stage("scene_load"):
            self.scene = load_scene(
                cfg.rgb_files,
                image_short_size=cfg.image_resolution,
                use_heuristic_focal_length=cfg.use_external_focal_length < 0,
                external_focal_length=cfg.use_external_focal_length if cfg.use_external_focal_length >= 0 else None,
                num_workers=cfg.num_decode_workers,
            )
        _logger.info("Loaded %d images onto a %dx%d canvas.", len(self.scene), *self.scene.canvas_hw)
        self.depth_files = get_files_from_glob(cfg.depth_files) if cfg.depth_files is not None else None

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
        depth = load_depth_file(self.depth_files[frame_idx])
        return depth_to_canvas(depth, (int(h), int(w)), self.scene.canvas_hw)

    def _seed_trainer(self, frame: int, train_cfg: TrainConfig, base_seed: int) -> MappingTrainer:
        """A MappingTrainer on the one seed frame at the identity pose, with
        its depth as supervision."""
        seed_scene = self.scene.subset(np.asarray([frame]))
        seed_scene.poses_c2w = np.eye(4, dtype=np.float32)[None]
        seed_scene.pose_valid = np.ones(1, bool)
        seed_scene.depth_maps[0] = self._seed_depth_canvas(frame)
        return MappingTrainer(seed_scene, self.encoder_params, self.head_cfg, train_cfg, self._buffer_cfg(),
                              base_seed=base_seed)

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
                                     cfg.base_seed + seed_idx)
        with stage("seed_mapping", trace=True):
            head_params = trainer.train()["head_params"]
        # fast seed scoring on <= 1000 frames (reference ace_zero_util.py:242-259)
        entries = register_frames(self.encoder_params, head_params, self.head_cfg, self.scene,
                                  self._registration_cfg(max_estimates=1000), device=self.device)
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
                                                score_cfg, device=self.device)
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
                                      device=self.device)
        with stage("artifacts"):
            write_pose_file(self.out / f"poses_{iteration_id}.txt", entries)
        return entries

    def _drift_detected(self, lc_diag: dict) -> bool:
        """True when loop closure measured corrections too large for one
        refit to drain (the JAX package's adaptive-cycle trigger): a median
        correction above 0.5% of the scene diagonal (at least 1 cm) or
        0.5°. Loop closure is not ported yet, so nothing calls it."""
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
               base_seed: int) -> dict:
        with stage("mapping", trace=True):
            trainer = MappingTrainer(mapping_scene, self.encoder_params, self.head_cfg, train_cfg,
                                     self._buffer_cfg(), head_params=init_head, base_seed=base_seed)
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
                train_cfg, init_head = self._refit_train_cfg(), None  # a fresh network (ace_zero.py:269-272)
            else:
                train_cfg = self._base_train_cfg(cfg.iterations, use_depth=False, refine=True)
                warm = cfg.warmstart and (iteration > 1 or cfg.seed_network is not None)
                init_head = head_params if warm else None
            result = self._train(mapping_scene, train_cfg, init_head, cfg.base_seed)
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
            max_rate = max(rate, max_rate)

        # ------- extra refit cycles (final_refit_cycles > 1; loop closure off) -------
        for extra in range(1, max(1, cfg.final_refit_cycles) if cfg.final_refit else 1):
            iteration += 1
            iteration_id = f"iteration{iteration}"
            mapping_scene = self._mapping_scene_from_entries(entries)
            _logger.info("%s: extra refit cycle %d on %d frames", iteration_id, extra, len(mapping_scene))
            result = self._train(mapping_scene, self._refit_train_cfg(), None, cfg.base_seed + extra)
            head_params = result["head_params"]
            with stage("artifacts"):
                torch_io.save_head(self.out / f"{iteration_id}.pt", head_params, self.head_cfg)
            focal_estimate = result["focal_orig"] or focal_estimate
            entries = self._register_all(head_params, iteration_id, focal_override=focal_estimate)
            rate = self._rate(entries)
            _logger.info("%s: registered %.1f%% of all frames.", iteration_id, rate * 100)
            rate_history.append(rate)

        # ------------------------- outputs --------------------------------
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
