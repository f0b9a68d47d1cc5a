"""Mapping CLI: train a scene head and write it with the preliminary poses.

Same flags and defaults as acezero_tpu/cli/train_ace_cli.py (the reference
train_ace.py), plus --device (default cuda). Trains from a pose-file glob,
an ACE pose file or a single-image pose seed, and writes the fp16 head
checkpoint plus `poses_<name>_preliminary.txt` beside it:

    python -m acezero_tpu_torch.cli.train_ace_cli '<scene>/*.png' /tmp/map.pt \
        --pose_files '<scene>/*_pose.txt' --use_external_focal_length 520 \
        --encoder_path weights/tpu_encoder_v6.pt

`--training_buffer_cpu true` keeps the training buffer in host memory
(training/trainer.py); the visualisation flags are accepted and ignored.
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path

import numpy as np
import torch

from acezero_tpu_torch import resolve_device
from acezero_tpu_torch.data.depth import depth_to_canvas, load_depth_file
from acezero_tpu_torch.data.scene import load_scene
from acezero_tpu_torch.io.pose_files import PoseFileEntry, get_files_from_glob, write_pose_file
from acezero_tpu_torch.models import torch_io
from acezero_tpu_torch.models.encoder import init_encoder_params
from acezero_tpu_torch.models.head import HeadConfig
from acezero_tpu_torch.training.buffer import BufferConfig
from acezero_tpu_torch.training.loss import ReproLossConfig
from acezero_tpu_torch.training.schedule import ScheduleConfig
from acezero_tpu_torch.training.trainer import MappingTrainer, TrainConfig

_logger = logging.getLogger(__name__)


def _strtobool(x: str) -> bool:
    return x.strip().lower() in ("1", "true", "yes", "y", "on")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Fast training of a scene coordinate regression network (PyTorch/CUDA).",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    p.add_argument("rgb_files", type=str)
    p.add_argument("output_map_file", type=Path)
    p.add_argument("--base_seed", type=int, default=2089)

    p.add_argument("--pose_files", type=str, default=None)
    p.add_argument("--use_ace_pose_file", type=Path, default=None)
    p.add_argument("--ace_pose_file_conf_threshold", type=float, default=1000)
    p.add_argument("--use_pose_seed", type=float, default=-1)
    p.add_argument("--depth_files", type=str, default=None)
    p.add_argument("--refine_calibration", type=_strtobool, default=False)
    p.add_argument("--refine_calibration_lr", type=float, default=0.001)
    p.add_argument("--use_heuristic_focal_length", type=_strtobool, default=False)
    p.add_argument("--use_external_focal_length", type=float, default=None)
    p.add_argument("--image_resolution", type=int, default=480)
    p.add_argument("--num_data_workers", type=int, default=12)

    p.add_argument("--encoder_path", type=Path, default=None)
    p.add_argument("--load_weights", type=Path, default=None)
    p.add_argument("--num_head_blocks", type=int, default=1)
    p.add_argument("--use_half", type=_strtobool, default=True)
    p.add_argument("--use_homogeneous", type=_strtobool, default=True)

    p.add_argument("--learning_rate_min", type=float, default=0.0005)
    p.add_argument("--learning_rate_max", type=float, default=0.005)
    p.add_argument("--learning_rate_schedule", type=str, default="circle", choices=["circle", "constant", "1cyclepoly"])
    p.add_argument("--learning_rate_warmup_iterations", type=int, default=1000)
    p.add_argument("--learning_rate_warmup_learning_rate", type=float, default=0.0005)
    p.add_argument("--learning_rate_cooldown_iterations", type=int, default=5000)
    p.add_argument("--learning_rate_cooldown_trigger_px_threshold", type=int, default=10)
    p.add_argument("--learning_rate_cooldown_trigger_percent_threshold", type=float, default=0.7)

    p.add_argument("--max_training_buffer_size", type=int, default=8_000_000)
    p.add_argument("--max_dataset_passes", type=int, default=10)
    p.add_argument("--samples_per_image", type=int, default=1024)
    p.add_argument("--training_buffer_cpu", type=_strtobool, default=False)

    p.add_argument("--batch_size", type=int, default=5120)
    p.add_argument("--iterations", type=int, default=25000)
    p.add_argument("--iterations_output", type=int, default=300)

    p.add_argument("--repro_loss_hard_clamp", type=int, default=1000)
    p.add_argument("--repro_loss_soft_clamp", type=int, default=50)
    p.add_argument("--repro_loss_soft_clamp_min", type=int, default=1)
    p.add_argument("--repro_loss_type", type=str, default="dyntanh", choices=["l1", "l1+sqrt", "l1+log", "tanh", "dyntanh"])
    p.add_argument("--repro_loss_schedule", type=str, default="circle", choices=["circle", "linear"])
    p.add_argument("--depth_min", type=float, default=0.1)
    p.add_argument("--depth_target", type=float, default=10)
    p.add_argument("--depth_max", type=float, default=1000)

    p.add_argument("--use_aug", type=_strtobool, default=True)
    p.add_argument("--aug_rotation", type=int, default=15)
    p.add_argument("--aug_scale", type=float, default=1.5)
    p.add_argument("--aug_black_white", type=float, default=0.1)

    p.add_argument("--pose_refinement", type=str, default="none", choices=["none", "naive", "mlp"])
    p.add_argument("--pose_refinement_weight", type=float, default=0.1)
    p.add_argument("--pose_refinement_wait", type=int, default=0)
    p.add_argument("--pose_refinement_lr", type=float, default=0.001)
    p.add_argument("--refinement_ortho", type=str, default="gram-schmidt", choices=["gram-schmidt", "procrustes"])

    # visualization flags (accepted for recipe compatibility; in this build
    # per-step rendering is handled by the in-process pipeline/viz tools)
    p.add_argument("--render_visualization", type=_strtobool, default=False)
    p.add_argument("--render_target_path", type=Path, default=Path("renderings"))
    p.add_argument("--use_existing_vis_buffer", type=Path, default=None)
    p.add_argument("--render_flipped_portrait", type=_strtobool, default=False)
    p.add_argument("--render_map_error_threshold", type=int, default=10)
    p.add_argument("--render_map_depth_filter", type=int, default=100)
    p.add_argument("--render_camera_z_offset", type=int, default=4)
    p.add_argument("--render_marker_size", type=float, default=0.03)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; the CPU runs only when asked for")
    return p


def main(argv: list[str] | None = None) -> dict:
    """Run the CLI; returns the trainer's result dict (the module's
    `__main__` exits 0 after it)."""
    logging.basicConfig(level=logging.INFO)
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)

    if args.use_pose_seed < 0 and args.use_ace_pose_file is None and args.pose_files is None:
        raise ValueError("Either use_pose_seed or use_ace_pose_file or pose_files has to be set.")
    if (
        not args.use_heuristic_focal_length
        and args.use_external_focal_length is None
        and args.use_ace_pose_file is None
    ):
        raise ValueError(
            "Either use_heuristic_focal_length or use_external_focal_length "
            "or use_ace_pose_file has to be set."
        )
    scene = load_scene(
        args.rgb_files,
        pose_files=args.pose_files,
        ace_pose_file=args.use_ace_pose_file,
        ace_pose_file_conf_threshold=args.ace_pose_file_conf_threshold,
        pose_seed=args.use_pose_seed,
        image_short_size=args.image_resolution,
        use_heuristic_focal_length=args.use_heuristic_focal_length,
        external_focal_length=args.use_external_focal_length,
        num_workers=args.num_data_workers,
    )

    use_depth = args.use_pose_seed >= 0 or args.depth_files is not None
    if use_depth:
        depth_files = get_files_from_glob(args.depth_files) if args.depth_files else None
        if depth_files is None:
            raise ValueError(
                "Depth supervision requested (pose seed) but no --depth_files; "
                "in-process depth estimators are available via the Python API."
            )
        # depth files match the FULL rgb glob by alphabetical index; the scene
        # may be a subset in another order, so map them by rgb file name
        all_rgb = get_files_from_glob(args.rgb_files)
        rgb_to_depth = {rgb: depth_files[i] for i, rgb in enumerate(all_rgb) if i < len(depth_files)}
        missing = 0
        for i, rgb in enumerate(scene.rgb_files):
            df = rgb_to_depth.get(rgb)
            if df is None:
                missing += 1
                continue
            h, w = scene.images.sizes[i]
            scene.depth_maps[i] = depth_to_canvas(load_depth_file(df), (int(h), int(w)), scene.canvas_hw)
        if missing:
            _logger.warning("No depth file matched %d of %d scene frames.", missing, len(scene))

    head_cfg = HeadConfig(num_head_blocks=args.num_head_blocks, use_homogeneous=args.use_homogeneous)
    if args.encoder_path is not None and Path(args.encoder_path).exists():
        encoder_params = torch_io.load_encoder(args.encoder_path, device)
    else:
        _logger.warning("No encoder checkpoint — random encoder weights.")
        encoder_params = init_encoder_params(torch.Generator().manual_seed(args.base_seed), device)

    head_params = None
    if args.load_weights is not None:
        head_cfg, head_params = torch_io.load_head(args.load_weights, device)

    cfg = TrainConfig(
        batch_size=args.batch_size,
        schedule=ScheduleConfig(
            schedule=args.learning_rate_schedule,
            iterations=args.iterations,
            learning_rate_min=args.learning_rate_min,
            learning_rate_max=args.learning_rate_max,
            warmup_iterations=args.learning_rate_warmup_iterations,
            warmup_learning_rate=args.learning_rate_warmup_learning_rate,
            cooldown_iterations=args.learning_rate_cooldown_iterations,
            cooldown_trigger_percent=args.learning_rate_cooldown_trigger_percent_threshold,
        ),
        loss=ReproLossConfig(
            total_iterations=args.iterations,
            soft_clamp=args.repro_loss_soft_clamp,
            soft_clamp_min=args.repro_loss_soft_clamp_min,
            loss_type=args.repro_loss_type,
            circle_schedule=args.repro_loss_schedule == "circle",
        ),
        depth_min=args.depth_min,
        depth_max=args.depth_max,
        depth_target=args.depth_target,
        repro_loss_hard_clamp=args.repro_loss_hard_clamp,
        cooldown_trigger_px_threshold=args.learning_rate_cooldown_trigger_px_threshold,
        pose_refinement=args.pose_refinement,
        pose_refinement_weight=args.pose_refinement_weight,
        pose_refinement_lr=args.pose_refinement_lr,
        pose_refinement_wait=args.pose_refinement_wait,
        refinement_ortho=args.refinement_ortho,
        refine_calibration=args.refine_calibration,
        refine_calibration_lr=args.refine_calibration_lr,
        use_depth=use_depth,
        buffer_host_spill=args.training_buffer_cpu,
        iterations_output=args.iterations_output,
    )
    buffer_cfg = BufferConfig(
        max_buffer_size=args.max_training_buffer_size,
        samples_per_image=args.samples_per_image,
        max_dataset_passes=args.max_dataset_passes,
        use_aug=args.use_aug,
        aug_rotation=args.aug_rotation,
        aug_scale_max=args.aug_scale,
        aug_black_white=args.aug_black_white,
    )

    trainer = MappingTrainer(scene, encoder_params, head_cfg, cfg, buffer_cfg,
                             head_params=head_params, base_seed=args.base_seed)
    result = trainer.train()

    out = Path(args.output_map_file)
    out.parent.mkdir(parents=True, exist_ok=True)
    torch_io.save_head(out, result["head_params"], head_cfg, half=args.use_half)

    focal = result["focal_orig"]
    prelim = [
        PoseFileEntry(
            rgb_file=scene.rgb_files[i],
            pose_w2c=np.vstack([result["poses_w2c"][i], [0, 0, 0, 1]]),
            focal_length=float(focal if focal is not None else scene.focals_orig[i]),
            confidence=float("inf"),
        )
        for i in range(len(scene))
    ]
    pose_file = out.parent / f"poses_{out.stem}_preliminary.txt"
    write_pose_file(pose_file, prelim)
    _logger.info("Saved head to %s and poses to %s", out, pose_file)
    return result


if __name__ == "__main__":
    main()
