"""Registration CLI: relocalize all images matching a glob against a
trained scene map (head checkpoint) and write `poses_<session>.txt` next to
the network. Same flags and defaults as acezero_tpu/cli/register_cli.py,
plus --device (default cuda).

    python -m acezero_tpu_torch.cli.register_cli '<scene>/*.png' map.pt \
        --encoder_path weights/tpu_encoder_v6.pt --use_external_focal_length 520
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path

import torch

from acezero_tpu_torch import resolve_device
from acezero_tpu_torch.data.scene import load_scene
from acezero_tpu_torch.io.pose_files import write_pose_file
from acezero_tpu_torch.models import torch_io
from acezero_tpu_torch.models.encoder import init_encoder_params
from acezero_tpu_torch.registration.driver import RegistrationConfig, register_frames
from acezero_tpu_torch.registration.ransac import RansacConfig

_logger = logging.getLogger(__name__)


def _strtobool(x: str) -> bool:
    return x.strip().lower() in ("1", "true", "yes", "y", "on")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Register images against a trained scene map (PyTorch/CUDA).",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    parser.add_argument("rgb_files", type=str)
    parser.add_argument("network", type=Path, help="scene head checkpoint (.pt)")
    parser.add_argument("--encoder_path", type=Path, default=None)
    parser.add_argument("--session", "-sid", default="")
    parser.add_argument("--image_resolution", type=int, default=480)
    parser.add_argument("--num_data_workers", type=int, default=12)
    parser.add_argument("--hypotheses", "-hyps", type=int, default=64)
    parser.add_argument("--hypotheses_max_tries", type=int, default=16,
                        help="re-sampling attempts per hypothesis (a batched dimension)")
    parser.add_argument("--threshold", "-t", type=float, default=10)
    parser.add_argument("--inlieralpha", "-ia", type=float, default=100)
    parser.add_argument("--maxpixelerror", "-maxerrr", type=float, default=100)
    parser.add_argument("--render_visualization", type=_strtobool, default=False)
    parser.add_argument("--render_target_path", type=Path, default=Path("renderings"))
    parser.add_argument("--render_flipped_portrait", type=_strtobool, default=False)
    parser.add_argument("--render_pose_conf_threshold", type=int, default=5000)
    parser.add_argument("--render_map_depth_filter", type=int, default=10)
    parser.add_argument("--render_camera_z_offset", type=int, default=4)
    parser.add_argument("--render_marker_size", type=float, default=0.03)
    parser.add_argument("--base_seed", type=int, default=1305)
    parser.add_argument("--confidence_threshold", type=float, default=1000)
    parser.add_argument("--max_estimates", type=int, default=-1)
    parser.add_argument("--use_external_focal_length", type=float, default=-1)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device; the CPU runs only when asked for")
    return parser


def main(argv: list[str] | None = None) -> int:
    logging.basicConfig(level=logging.INFO)
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)

    use_heuristic = args.use_external_focal_length < 0
    scene = load_scene(
        args.rgb_files,
        image_short_size=args.image_resolution,
        use_heuristic_focal_length=use_heuristic,
        external_focal_length=(None if use_heuristic else args.use_external_focal_length),
        num_workers=args.num_data_workers,
    )
    head_cfg, head_params = torch_io.load_head(args.network, device)
    if args.encoder_path is not None and Path(args.encoder_path).exists():
        encoder_params = torch_io.load_encoder(args.encoder_path, device)
    else:
        _logger.warning("No encoder checkpoint — random encoder weights.")
        encoder_params = init_encoder_params(torch.Generator().manual_seed(args.base_seed), device)

    cfg = RegistrationConfig(
        ransac=RansacConfig(
            hypotheses=args.hypotheses,
            max_tries=args.hypotheses_max_tries,
            inlier_threshold=args.threshold,
            inlier_alpha=args.inlieralpha,
            max_reproj_error=args.maxpixelerror,
        ),
        confidence_threshold=args.confidence_threshold,
        max_estimates=args.max_estimates,
        base_seed=args.base_seed,
    )
    entries = register_frames(encoder_params, head_params, head_cfg, scene, cfg, device=device)

    out = Path(args.network).parent / f"poses_{args.session}.txt"
    write_pose_file(out, entries)
    _logger.info("Wrote %d poses to %s", len(entries), out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
