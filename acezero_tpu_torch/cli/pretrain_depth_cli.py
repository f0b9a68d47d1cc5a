"""Seed-depth head pretraining CLI.

Same flags and defaults as acezero_tpu/cli/pretrain_depth_cli.py, plus
--device (default cuda). Trains the seed-depth head (models/depthnet.py) on
the frozen encoder over the procedural corpus and writes it in the layout
of `weights/tpu_depth_v4.pt`, whose recipe is:

    python -m acezero_tpu_torch.cli.pretrain_depth_cli /tmp/depth.pt \
        --encoder_path weights/tpu_encoder_v6.pt --corpus v4
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path

from acezero_tpu_torch.pretrain.depth_pretrain import DepthPretrainConfig, pretrain_depth_head


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Pretrain the seed-depth head on synthetic scenes (PyTorch/CUDA).",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    p.add_argument("output", type=Path, help="output depth-head .pt path")
    p.add_argument("--encoder_path", type=Path, required=True)
    p.add_argument("--num_scenes", type=int, default=64)
    p.add_argument("--views_per_scene", type=int, default=16)
    p.add_argument("--image_height", type=int, default=240)
    p.add_argument("--image_width", type=int, default=320)
    p.add_argument("--steps", type=int, default=8000)
    p.add_argument("--batch_images", type=int, default=32)
    p.add_argument("--learning_rate", type=float, default=1e-3)
    p.add_argument("--seed", type=int, default=97)
    p.add_argument("--width_mult", type=int, default=1,
                   help="depth-head hidden-width multiplier (capacity probe)")
    p.add_argument("--corpus", choices=("v4", "v5"), default="v5",
                   help="corpus preset: v4 = the shipped default head's corpus "
                        "(reproduces weights/tpu_depth_v4.pt's recipe); v5 = octave/look mixtures")
    p.add_argument("--device", type=str, default="cuda", help="torch device (cuda or cpu)")
    return p


def main(argv: list[str] | None = None) -> dict:
    """Run the CLI; returns the result dict of `pretrain_depth_head`."""
    logging.basicConfig(level=logging.INFO)
    args = build_parser().parse_args(argv)
    cfg = DepthPretrainConfig(
        num_scenes=args.num_scenes,
        views_per_scene=args.views_per_scene,
        image_h=args.image_height,
        image_w=args.image_width,
        steps=args.steps,
        batch_images=args.batch_images,
        learning_rate=args.learning_rate,
        seed=args.seed,
        corpus=args.corpus,
        width_mult=args.width_mult,
    )
    result = pretrain_depth_head(cfg, args.encoder_path, args.output, device=args.device)
    print(f"final loss: {result['final_loss']:.4f}")
    return result


if __name__ == "__main__":
    main()
