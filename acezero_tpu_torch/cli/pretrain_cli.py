"""Encoder pretraining CLI.

Same flags and defaults as acezero_tpu/cli/pretrain_cli.py, plus --device
(default cuda). Trains the scene-agnostic encoder on procedurally rendered
scenes and writes an encoder state dict either package loads:

    python -m acezero_tpu_torch.cli.pretrain_cli /tmp/enc.pt --contrastive_weight 0.2

(`--candidates 3` trains three and keeps the best by the probes of
pretrain/encoder_eval.py, the recipe of weights/tpu_encoder_v6.pt.)
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path

from acezero_tpu_torch.pretrain import PretrainConfig, pretrain_encoder


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Pretrain the ACE feature encoder on synthetic scenes (PyTorch/CUDA).",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    p.add_argument("output", type=Path, help="output encoder .pt path")
    p.add_argument("--num_scenes", type=int, default=8)
    p.add_argument("--views_per_scene", type=int, default=24)
    p.add_argument("--image_height", type=int, default=192)
    p.add_argument("--image_width", type=int, default=256)
    p.add_argument("--steps", type=int, default=4000)
    p.add_argument("--batch_images", type=int, default=8)
    p.add_argument("--learning_rate", type=float, default=0.002)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--low_texture_frac", type=float, default=0.0,
                   help="fraction of texture-poor scenes in the corpus")
    p.add_argument("--photometric", action="store_true",
                   help="per-view exposure/vignette/noise nuisances")
    p.add_argument("--across_frac", type=float, default=0.0,
                   help="fraction of convergent-view (look=across) scenes")
    p.add_argument("--focal_min", type=float, default=0.7,
                   help="min per-scene focal as a fraction of image width")
    p.add_argument("--focal_max", type=float, default=1.4,
                   help="max per-scene focal as a fraction of image width")
    p.add_argument("--texture_octaves_max", type=int, default=1,
                   help="scenes draw 1..N texture octaves (multi-scale blocks)")
    p.add_argument("--coarse_supervision", action="store_true",
                   help="use the order-0 warped-map supervision instead of exact ray-cast GT")
    p.add_argument("--contrastive_weight", type=float, default=0.0,
                   help="correspondence-InfoNCE weight (same-scene view pairs)")
    p.add_argument("--pitch_frac", type=float, default=0.0,
                   help="fraction of corpus views tilted steeply toward floor/ceiling")
    p.add_argument("--far_pair_frac", type=float, default=0.0,
                   help="fraction of contrastive pairs at arbitrary ring separation")
    p.add_argument("--candidates", type=int, default=1,
                   help="train N candidate encoders (different training seeds, shared corpus) and "
                        "keep the best by the feature-matching + short-fit quality probes")
    p.add_argument("--device", type=str, default="cuda", help="torch device (cuda or cpu)")
    return p


def main(argv: list[str] | None = None) -> dict:
    """Run the CLI; returns the result dict of `pretrain_encoder` (or of
    `pretrain_encoder_select` with --candidates > 1)."""
    logging.basicConfig(level=logging.INFO)
    args = build_parser().parse_args(argv)
    cfg = PretrainConfig(
        num_scenes=args.num_scenes,
        views_per_scene=args.views_per_scene,
        image_h=args.image_height,
        image_w=args.image_width,
        steps=args.steps,
        batch_images=args.batch_images,
        learning_rate=args.learning_rate,
        seed=args.seed,
        low_texture_frac=args.low_texture_frac,
        photometric=args.photometric,
        across_frac=args.across_frac,
        focal_min=args.focal_min,
        focal_max=args.focal_max,
        texture_octaves_max=args.texture_octaves_max,
        exact_supervision=not args.coarse_supervision,
        contrastive_weight=args.contrastive_weight,
        pitch_frac=args.pitch_frac,
        far_pair_frac=args.far_pair_frac,
    )
    if args.candidates > 1:
        from acezero_tpu_torch.pretrain.encoder_pretrain import pretrain_encoder_select

        return pretrain_encoder_select(cfg, n_candidates=args.candidates, output_path=args.output,
                                       device=args.device)
    return pretrain_encoder(cfg, output_path=args.output, device=args.device)


if __name__ == "__main__":
    main()
