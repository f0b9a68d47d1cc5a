"""Render the final reconstruction sweep from saved visualization state.

Counterpart of the root render_final_sweep.py, with the same flags plus
--device (default cuda): find the last `iterationX_register.pkl` state,
reconstruct each image's first registered iteration by scanning the pose
files backwards, and render a `--num_frames` orbit of the finished scene
into the renderings folder:

    python -m acezero_tpu_torch.cli.render_final_sweep_cli out/renderings [--device cpu]
"""

from __future__ import annotations

import argparse
import logging
import re
from pathlib import Path

import numpy as np

from acezero_tpu_torch.io.pose_files import read_pose_file
from acezero_tpu_torch.viz import ReconstructionVisualizer, VizConfig

_logger = logging.getLogger(__name__)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Render the final reconstruction sweep.")
    parser.add_argument("render_path", type=Path, help="renderings folder with *_register.pkl state")
    parser.add_argument("--render_marker_size", type=float, default=0.03)
    parser.add_argument("--num_frames", type=int, default=150)
    parser.add_argument("--device", type=str, default="cuda")
    return parser


def main(argv: list[str] | None = None) -> int:
    logging.basicConfig(level=logging.INFO)
    args = build_parser().parse_args(argv)

    states = sorted(args.render_path.glob("iteration*_register.pkl"),
                    key=lambda p: int(re.findall(r"iteration(\d+)", p.name)[0]))
    if not states:
        raise FileNotFoundError(f"No iteration*_register.pkl under {args.render_path}")
    last_state = states[-1]
    last_iter = int(re.findall(r"iteration(\d+)", last_state.name)[0])

    viz = ReconstructionVisualizer(VizConfig(target_path=args.render_path, marker_size=args.render_marker_size),
                                   device=args.device)
    viz.load_state(last_state)

    # per-image first-registered iteration by scanning pose files backwards
    out_dir = args.render_path.parent
    first_iter: dict[str, int] = {}
    for it in range(last_iter, 0, -1):
        pose_file = out_dir / f"poses_iteration{it}.txt"
        if not pose_file.exists():
            continue
        for e in read_pose_file(pose_file):
            if e.confidence >= viz.cfg.conf_threshold:
                first_iter[e.rgb_file] = it

    entries = read_pose_file(out_dir / f"poses_iteration{last_iter}.txt")
    poses = np.stack([e.pose_c2w for e in entries])
    its = np.asarray([first_iter.get(e.rgb_file, last_iter) for e in entries], np.float32)
    viz.render_final_sweep(poses, its, num_frames=args.num_frames)
    _logger.info("Rendered %d sweep frames into %s", args.num_frames, args.render_path)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
