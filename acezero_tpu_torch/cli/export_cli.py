"""Export CLIs: point clouds and camera meshes from reconstruction outputs.

Counterpart of acezero_tpu/cli/export_cli.py (the reference
export_point_cloud.py and export_cameras.py), with the same flags plus
--device (default cuda) on `point_cloud`:

    python -m acezero_tpu_torch.cli.export_cli point_cloud out.ply \
        --network out/iteration4.pt --pose_file out/poses_final.txt \
        --encoder_path weights/tpu_encoder_v6.pt [--device cpu]
    python -m acezero_tpu_torch.cli.export_cli point_cloud out.ply \
        --visualization_buffer out/renderings/iteration4_register.pkl
    python -m acezero_tpu_torch.cli.export_cli cameras out/poses_final.txt cameras.ply

`--network` predicts the scene coordinates of every frame of the pose file
above `--pose_file_conf_threshold` (the encoder and K1 on the card, 64
frames a launch) and selects the points as export/point_cloud.py does;
`--visualization_buffer` writes the visualizer state's cloud as it is.
"""

from __future__ import annotations

import argparse
import logging
import pickle
import sys
from pathlib import Path

import numpy as np
import torch

from acezero_tpu_torch import resolve_device
from acezero_tpu_torch.data.scene import load_scene
from acezero_tpu_torch.export.cameras import export_camera_meshes
from acezero_tpu_torch.export.point_cloud import export_point_cloud_from_network
from acezero_tpu_torch.io.ply import write_ply_points
from acezero_tpu_torch.io.pose_files import read_pose_file
from acezero_tpu_torch.models import torch_io
from acezero_tpu_torch.models.encoder import init_encoder_params

_logger = logging.getLogger(__name__)


def _strtobool(x: str) -> bool:
    return x.strip().lower() in ("1", "true", "yes", "y", "on")


def build_point_cloud_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Export an ACE0 point cloud to PLY.",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    p.add_argument("output_file", type=Path)
    p.add_argument("--visualization_buffer", type=Path, default=None,
                   help="export directly from a saved visualizer state pickle "
                        "instead of running network inference")
    p.add_argument("--network", type=Path, default=None)
    p.add_argument("--pose_file", type=Path, default=None)
    p.add_argument("--encoder_path", type=Path, default=None)
    p.add_argument("--rgb_files", type=str, default=None,
                   help="optional glob; defaults to the files named in the pose file")
    p.add_argument("--image_resolution", type=int, default=480)
    p.add_argument("--pose_file_conf_threshold", type=int, default=1000)
    p.add_argument("--dense_point_cloud", type=_strtobool, default=False)
    p.add_argument("--filter_depth", type=float, default=100.0)
    p.add_argument("--convention", type=str, default="opencv", choices=["opencv", "opengl"])
    p.add_argument("--device", type=str, default="cuda")
    return p


def build_cameras_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Export confidence-colored camera frustums to PLY.",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    p.add_argument("pose_file", type=Path)
    p.add_argument("output_file", type=Path)
    p.add_argument("--marker_size", type=float, default=0.03)
    p.add_argument("--confidence_max", type=float, default=2000)
    return p


def point_cloud_main(argv: list[str] | None = None) -> int:
    logging.basicConfig(level=logging.INFO)
    args = build_point_cloud_parser().parse_args(argv)

    if args.visualization_buffer is not None:
        # the reference export_point_cloud.py --visualization_buffer path: the
        # accumulated visualizer cloud, without running the network
        with open(args.visualization_buffer, "rb") as f:
            state = pickle.load(f)
        xyz = np.asarray(state["cloud_xyz"], np.float32)
        rgb = (np.asarray(state["cloud_rgb"]) * 255).clip(0, 255).astype(np.uint8)
        if args.convention == "opengl":
            xyz = xyz.copy()
            xyz[:, 1:] = -xyz[:, 1:]
        write_ply_points(args.output_file, xyz, rgb)
        _logger.info("Exported %d buffered points to %s", xyz.shape[0], args.output_file)
        return 0

    if args.network is None or args.pose_file is None:
        raise SystemExit("--network and --pose_file are required (or --visualization_buffer)")

    device = resolve_device(args.device)
    entries = read_pose_file(args.pose_file, confidence_threshold=args.pose_file_conf_threshold)
    scene = load_scene(
        args.rgb_files if args.rgb_files else None,
        ace_pose_file=args.pose_file,
        ace_pose_file_conf_threshold=args.pose_file_conf_threshold,
        image_short_size=args.image_resolution,
    )

    head_cfg, head_params = torch_io.load_head(args.network, device)
    if args.encoder_path is not None and Path(args.encoder_path).exists():
        encoder_params = torch_io.load_encoder(args.encoder_path, device)
    else:
        _logger.warning("No encoder checkpoint — random encoder weights.")
        encoder_params = init_encoder_params(torch.Generator().manual_seed(0), device)

    export_point_cloud_from_network(
        args.output_file,
        encoder_params,
        head_params,
        head_cfg,
        scene,
        entries,
        filter_depth=args.filter_depth,
        dense=args.dense_point_cloud,
        convention=args.convention,
    )
    return 0


def cameras_main(argv: list[str] | None = None) -> int:
    logging.basicConfig(level=logging.INFO)
    args = build_cameras_parser().parse_args(argv)
    entries = read_pose_file(args.pose_file)
    export_camera_meshes(args.output_file, entries, args.marker_size, args.confidence_max)
    _logger.info("Wrote %d camera frustums to %s", len(entries), args.output_file)
    return 0


def main(argv: list[str] | None = None) -> int:
    """`point_cloud ...` or `cameras ...`."""
    argv = sys.argv[1:] if argv is None else list(argv)
    commands = {"point_cloud": point_cloud_main, "cameras": cameras_main}
    if not argv or argv[0] not in commands:
        raise SystemExit(f"usage: python -m acezero_tpu_torch.cli.export_cli {{{','.join(commands)}}} ...")
    return commands[argv[0]](argv[1:])


if __name__ == "__main__":
    raise SystemExit(main())
