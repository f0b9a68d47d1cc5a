"""Pose-evaluation CLI: % within 5 cm / 5° and median errors of an ACE pose
file against ground-truth 4x4 pose files, with the flags and defaults of
acezero_tpu/cli/eval_poses_cli.py (the reference eval_poses.py):

    python -m acezero_tpu_torch.cli.eval_poses_cli out/poses_final.txt '<scene>/*_pose.txt'

Scoring runs on the host; the command needs no card.
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path

from acezero_tpu_torch.evalpose import evaluate_poses
from acezero_tpu_torch.io.pose_files import load_pose_files_glob, read_pose_file


def _strtobool(x: str) -> bool:
    return x.strip().lower() in ("1", "true", "yes", "y", "on")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Compute pose error metrics for an ACE pose file.",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    p.add_argument("ace_pose_file", type=Path)
    p.add_argument("gt_pose_files", type=str)
    p.add_argument("--estimate_alignment", type=_strtobool, default=True)
    p.add_argument("--estimate_alignment_scale", type=_strtobool, default=True)
    p.add_argument("--estimate_alignment_conf_threshold", type=float, default=500)
    p.add_argument("--pose_error_thresh_t", type=float, default=0.05)
    p.add_argument("--pose_error_thresh_r", type=float, default=5)
    return p


def main(argv: list[str] | None = None) -> int:
    logging.basicConfig(level=logging.INFO)
    args = build_parser().parse_args(argv)
    errors = evaluate_poses(
        read_pose_file(args.ace_pose_file),
        load_pose_files_glob(args.gt_pose_files),
        do_alignment=args.estimate_alignment,
        estimate_scale=args.estimate_alignment_scale,
        alignment_conf_threshold=args.estimate_alignment_conf_threshold,
        thresh_t=args.pose_error_thresh_t,
        thresh_r=args.pose_error_thresh_r,
    )
    print(f"Accuracy: {errors.accuracy:.1f}%")
    print(f"Median Error: {errors.median_rot_deg:.1f}deg, {errors.median_trans_cm:.1f}cm")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
