"""Reconstruction CLI: the ACE0 loop of acezero_tpu_torch.reconstruct.

The flags and defaults of acezero_tpu/cli/ace_zero_cli.py (the reference
ace_zero.py:33-158), plus --device (default cuda). Loop closure runs by
default (`--loop_closure false` turns it off); the seed stage needs depth
files until the learned seed-depth head is ported:

    python -m acezero_tpu_torch.cli.ace_zero_cli '<scene>/*.png' out/ \
        --depth_files '<scene>/*_depth.npy' --use_external_focal_length 520 \
        --encoder_path weights/tpu_encoder_v6.pt

Writes the round artifacts and `poses_final.txt` into the results folder and
prints the report.
"""

from __future__ import annotations

import argparse
import logging
from dataclasses import replace
from pathlib import Path

from acezero_tpu_torch.reconstruct import AceZeroConfig, AceZeroPipeline


def _strtobool(x: str) -> bool:
    return x.strip().lower() in ("1", "true", "yes", "y", "on")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Run ACE0 reconstruction for a dataset or scene (PyTorch/CUDA).",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    parser.add_argument("rgb_files", type=str)
    parser.add_argument("results_folder", type=Path)
    parser.add_argument("--depth_files", type=str, default=None)
    parser.add_argument("--calibration_files", type=str, default=None,
                        help="per-frame focal-length file glob (scalar or 3x3 K;"
                             " the PGT 7-Scenes layout emits these)")

    g = parser.add_argument_group("main loop")
    g.add_argument("--iterations_max", type=int, default=100)
    g.add_argument("--registration_threshold", type=float, default=0.99)
    g.add_argument("--relative_registration_threshold", type=float, default=0.01)
    g.add_argument("--final_refine", type=_strtobool, default=True)
    g.add_argument("--final_refit", type=_strtobool, default=True)
    g.add_argument("--final_refit_posewait", type=int, default=5000)
    g.add_argument("--final_refit_cycles", type=int, default=1,
                   help="extra refit<->register cycles after convergence "
                        "(drains loop drift on ring captures; 1 = reference). "
                        "After the explicit budget, drift-gated adaptive "
                        "cycles may still run (capped by "
                        "--adaptive_refit_max_cycles; pass 0 there to get "
                        "exactly this many cycles)")
    g.add_argument("--refit_iterations", type=int, default=25000)
    g.add_argument("--loop_closure", type=_strtobool, default=True,
                   help="Sim(3) pose-graph loop closure before refit rounds "
                        "(drains ring/360 drift; beyond-reference)")
    g.add_argument("--loop_closure_max_frames", type=int, default=256)
    g.add_argument("--loop_closure_probe_frames", type=int, default=32,
                   help="drift pre-probe subgraph size; quiet probes skip "
                        "the full loop-closure measurement (0 disables)")
    g.add_argument("--adaptive_refit_max_cycles", type=int, default=3,
                   help="cap on drift-gated extra refit cycles (0 disables)")
    g.add_argument("--loopclose_refit_freeze_poses", type=_strtobool, default=True,
                   help="freeze the pose MLP during refits that follow applied "
                        "loop-closure corrections, so the fresh map adopts the "
                        "corrected geometry instead of co-relaxing it away")
    g.add_argument("--registration_confidence", type=int, default=500)
    g.add_argument("--try_seeds", type=int, default=5)
    g.add_argument("--seed_parallel_workers", type=int, default=3)
    g.add_argument("--seed_iterations", type=int, default=10000)
    g.add_argument("--seed_selection_iterations", type=int, default=2000,
                   help="score seed maps this early and train only the "
                        "winner to the full budget (0 = reference schedule)")
    g.add_argument("--seed_selection_frames", type=int, default=500)
    g.add_argument("--seed_selection_min_frames", type=int, default=200,
                   help="selection auto-disables on scenes smaller than this")
    g.add_argument("--seed_network", type=Path, default=None)
    g.add_argument("--warmstart", type=_strtobool, default=True)
    g.add_argument("--export_point_cloud", type=_strtobool, default=False)
    g.add_argument("--dense_point_cloud", type=_strtobool, default=False)

    g = parser.add_argument_group("pose refinement")
    g.add_argument("--refinement", type=str, default="mlp", choices=["mlp", "none", "naive"])
    g.add_argument("--refinement_ortho", type=str, default="gram-schmidt", choices=["gram-schmidt", "procrustes"])
    g.add_argument("--pose_refinement_wait", type=int, default=0)
    g.add_argument("--pose_refinement_lr", type=float, default=0.001)

    g = parser.add_argument_group("calibration refinement")
    g.add_argument("--refine_calibration", type=_strtobool, default=True)
    g.add_argument("--use_external_focal_length", type=float, default=-1)

    g = parser.add_argument_group("early stopping")
    g.add_argument("--learning_rate_schedule", type=str, default="1cyclepoly", choices=["circle", "constant", "1cyclepoly"])
    g.add_argument("--learning_rate_max", type=float, default=0.003)
    g.add_argument("--cooldown_iterations", type=int, default=5000)
    g.add_argument("--cooldown_threshold", type=float, default=0.7)
    g.add_argument("--iterations", type=int, default=25000,
                   help="per-round mapping iteration cap (extension; the reference "
                        "hardcodes train_ace.py's 25000 default)")

    g = parser.add_argument_group("ACE parameters")
    g.add_argument("--image_resolution", type=int, default=480)
    g.add_argument("--num_head_blocks", type=int, default=1)
    g.add_argument("--max_dataset_passes", type=int, default=10)
    g.add_argument("--repro_loss_type", type=str, default="tanh", choices=["l1", "l1+sqrt", "l1+log", "tanh", "dyntanh"])
    g.add_argument("--repro_loss_hard_clamp", type=int, default=1000)
    g.add_argument("--repro_loss_soft_clamp", type=int, default=50)
    g.add_argument("--aug_rotation", type=int, default=15)
    g.add_argument("--aug_black_white", type=float, default=0.1)
    g.add_argument("--num_data_workers", type=int, default=12)
    g.add_argument("--training_buffer_cpu", type=_strtobool, default=False)
    g.add_argument("--encoder_path", type=Path, default=None)
    g.add_argument("--depth_network", type=Path, default=None,
                   help="learned seed-depth head (.pt); default: weights/tpu_depth_v1.pt if present")

    g = parser.add_argument_group("registration")
    g.add_argument("--ransac_iterations", type=int, default=32)
    g.add_argument("--ransac_threshold", type=float, default=10)

    g = parser.add_argument_group("visualization (accepted; rendering is optional in this build)")
    g.add_argument("--render_visualization", type=_strtobool, default=False)
    g.add_argument("--render_flipped_portrait", type=_strtobool, default=False)
    g.add_argument("--render_marker_size", type=float, default=0.03)
    g.add_argument("--iterations_output", type=int, default=500)

    parser.add_argument("--random_seed", type=int, default=1305)
    parser.add_argument(
        "--num_devices",
        type=int,
        default=0,
        help="device-mesh size: 0 = all visible devices, 1 = single device, "
        "N > 1 = 1-D data mesh over the first N devices (name parity: the port runs on --device)",
    )
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device; the CPU runs only when asked for")
    return parser


def config_from_args(args: argparse.Namespace) -> AceZeroConfig:
    return AceZeroConfig(
        rgb_files=args.rgb_files,
        results_folder=args.results_folder,
        depth_files=args.depth_files,
        calibration_files=args.calibration_files,
        iterations_max=args.iterations_max,
        registration_threshold=args.registration_threshold,
        relative_registration_threshold=args.relative_registration_threshold,
        final_refine=args.final_refine,
        final_refit=args.final_refit,
        final_refit_posewait=args.final_refit_posewait,
        final_refit_cycles=args.final_refit_cycles,
        refit_iterations=args.refit_iterations,
        loop_closure=args.loop_closure,
        loop_closure_max_frames=args.loop_closure_max_frames,
        loop_closure_probe_frames=args.loop_closure_probe_frames,
        adaptive_refit_max_cycles=args.adaptive_refit_max_cycles,
        loopclose_refit_freeze_poses=args.loopclose_refit_freeze_poses,
        registration_confidence=args.registration_confidence,
        try_seeds=args.try_seeds,
        seed_iterations=args.seed_iterations,
        seed_selection_iterations=args.seed_selection_iterations,
        seed_selection_frames=args.seed_selection_frames,
        seed_selection_min_frames=args.seed_selection_min_frames,
        seed_network=args.seed_network,
        warmstart=args.warmstart,
        export_point_cloud=args.export_point_cloud,
        dense_point_cloud=args.dense_point_cloud,
        refinement=args.refinement,
        refinement_ortho=args.refinement_ortho,
        pose_refinement_wait=args.pose_refinement_wait,
        pose_refinement_lr=args.pose_refinement_lr,
        refine_calibration=args.refine_calibration,
        use_external_focal_length=args.use_external_focal_length,
        learning_rate_schedule=args.learning_rate_schedule,
        learning_rate_max=args.learning_rate_max,
        cooldown_iterations=args.cooldown_iterations,
        cooldown_threshold=args.cooldown_threshold,
        iterations=args.iterations,
        image_resolution=args.image_resolution,
        num_head_blocks=args.num_head_blocks,
        max_dataset_passes=args.max_dataset_passes,
        repro_loss_type=args.repro_loss_type,
        repro_loss_hard_clamp=args.repro_loss_hard_clamp,
        repro_loss_soft_clamp=args.repro_loss_soft_clamp,
        aug_rotation=args.aug_rotation,
        aug_black_white=args.aug_black_white,
        training_buffer_cpu=args.training_buffer_cpu,
        ransac_iterations=args.ransac_iterations,
        ransac_threshold=args.ransac_threshold,
        render_visualization=args.render_visualization,
        render_marker_size=args.render_marker_size,
        random_seed=args.random_seed,
        iterations_output=args.iterations_output,
        encoder_path=args.encoder_path,
        depth_network=args.depth_network,
        num_devices=args.num_devices,
    )


def config_from_args(args: argparse.Namespace) -> AceZeroConfig:
    return AceZeroConfig(
        rgb_files=args.rgb_files,
        results_folder=args.results_folder,
        depth_files=args.depth_files,
        calibration_files=args.calibration_files,
        iterations_max=args.iterations_max,
        registration_threshold=args.registration_threshold,
        relative_registration_threshold=args.relative_registration_threshold,
        final_refine=args.final_refine,
        final_refit=args.final_refit,
        final_refit_posewait=args.final_refit_posewait,
        final_refit_cycles=args.final_refit_cycles,
        refit_iterations=args.refit_iterations,
        loop_closure=args.loop_closure,
        loop_closure_max_frames=args.loop_closure_max_frames,
        loop_closure_probe_frames=args.loop_closure_probe_frames,
        adaptive_refit_max_cycles=args.adaptive_refit_max_cycles,
        loopclose_refit_freeze_poses=args.loopclose_refit_freeze_poses,
        registration_confidence=args.registration_confidence,
        try_seeds=args.try_seeds,
        seed_iterations=args.seed_iterations,
        seed_selection_iterations=args.seed_selection_iterations,
        seed_selection_frames=args.seed_selection_frames,
        seed_selection_min_frames=args.seed_selection_min_frames,
        seed_network=args.seed_network,
        warmstart=args.warmstart,
        export_point_cloud=args.export_point_cloud,
        dense_point_cloud=args.dense_point_cloud,
        refinement=args.refinement,
        refinement_ortho=args.refinement_ortho,
        pose_refinement_wait=args.pose_refinement_wait,
        pose_refinement_lr=args.pose_refinement_lr,
        refine_calibration=args.refine_calibration,
        use_external_focal_length=args.use_external_focal_length,
        learning_rate_schedule=args.learning_rate_schedule,
        learning_rate_max=args.learning_rate_max,
        cooldown_iterations=args.cooldown_iterations,
        cooldown_threshold=args.cooldown_threshold,
        iterations=args.iterations,
        image_resolution=args.image_resolution,
        num_head_blocks=args.num_head_blocks,
        max_dataset_passes=args.max_dataset_passes,
        repro_loss_type=args.repro_loss_type,
        repro_loss_hard_clamp=args.repro_loss_hard_clamp,
        repro_loss_soft_clamp=args.repro_loss_soft_clamp,
        aug_rotation=args.aug_rotation,
        aug_black_white=args.aug_black_white,
        training_buffer_cpu=args.training_buffer_cpu,
        ransac_iterations=args.ransac_iterations,
        ransac_threshold=args.ransac_threshold,
        render_visualization=args.render_visualization,
        render_marker_size=args.render_marker_size,
        random_seed=args.random_seed,
        iterations_output=args.iterations_output,
        encoder_path=args.encoder_path,
        depth_network=args.depth_network,
        num_devices=args.num_devices,
    )


def main(argv: list[str] | None = None, **overrides) -> dict:
    """Run the CLI and return the pipeline's result dict (the module's
    `__main__` exits 0 after it). `overrides` replace config fields that
    have no flag, as `dataclasses.replace` would."""
    logging.basicConfig(level=logging.INFO)
    args = build_parser().parse_args(argv)
    pipeline = AceZeroPipeline(replace(config_from_args(args), **overrides), device=args.device)
    result = pipeline.run()
    print(result["report"])
    return result


if __name__ == "__main__":
    main()
