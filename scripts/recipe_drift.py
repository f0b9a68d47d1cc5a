#!/usr/bin/env python3
"""Does the mapping recipe drift further in the PyTorch port than in the JAX
package? Both packages' MappingTrainer, on the CPU, with the pipeline's
mapping recipe (1cyclepoly at 0.003, tanh loss, MLP pose refinement and
focal refinement) on the 60 chesslike_a frames, started from their shipped
poses and f = 520 px, at a reduced size. Per run, one JSON line: the
refined poses' median error against the shipped poses as they are and
after a Sim(3) alignment (evalpose, the JAX package's for both), the
aligned accuracy at 5 cm / 5°, the alignment's scale, and the refined
focal. Several base seeds give each package's run-to-run spread.

    JAX_PLATFORMS=cpu python scripts/recipe_drift.py --seeds 2089 2090 2091 --out drift.jsonl
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
SCENE = ROOT / "results" / "heldout" / "scenes" / "chesslike_a"
ENCODER = ROOT / "weights" / "tpu_encoder_v6.pt"
FOCAL = 520.0


def _rot_deg(Ra, Rb):
    return float(np.degrees(np.arccos(np.clip((np.trace(Ra @ Rb.T) - 1) / 2, -1, 1))))


def score(files, poses_w2c, focal, gts):
    from acezero_tpu.evalpose import estimate_alignment, evaluate_poses
    from acezero_tpu.io.pose_files import PoseFileEntry

    entries = [PoseFileEntry(f, np.vstack([p, [0, 0, 0, 1]]), focal, float("inf")) for f, p in zip(files, poses_w2c)]
    c2w = [e.pose_c2w for e in entries]
    raw_r = [_rot_deg(c[:3, :3], gts[f][:3, :3]) for c, f in zip(c2w, files)]
    raw_t = [float(np.linalg.norm(c[:3, 3] - gts[f][:3, 3])) for c, f in zip(c2w, files)]
    order = sorted(range(len(files)), key=lambda i: files[i])
    err = evaluate_poses(entries, [gts[files[i]] for i in order])
    _, scale = estimate_alignment(np.stack([c2w[i] for i in order]), np.stack([gts[files[i]] for i in order]),
                                  np.full(len(files), np.inf))
    # a least-squares Sim(3) over all camera centres (no RANSAC, no inlier
    # bar): what is left after it is what no gauge of the loss explains
    from acezero_tpu.geometry.kabsch import kabsch_umeyama

    gt_c2w = np.stack([gts[f] for f in files])
    T, s = (np.asarray(v, np.float64) for v in kabsch_umeyama(gt_c2w[:, :3, 3], np.stack(c2w)[:, :3, 3],
                                                               estimate_scale=True))
    centres = gt_c2w[:, :3, 3] @ T[:3, :3].T + T[:3, 3]
    lsq_t = np.linalg.norm(centres - np.stack(c2w)[:, :3, 3], axis=1) / s
    R = T[:3, :3] / s
    lsq_r = [_rot_deg(c[:3, :3], R @ g[:3, :3]) for c, g in zip(c2w, gt_c2w)]
    extent = float(np.median(np.linalg.norm(gt_c2w[:, :3, 3] - gt_c2w[:, :3, 3].mean(0), axis=1)))
    return {"raw_median_rot_deg": float(np.median(raw_r)), "raw_median_trans_m": float(np.median(raw_t)),
            "aligned_pct_5cm_5deg": err.accuracy, "aligned_median_rot_deg": err.median_rot_deg,
            "aligned_median_trans_cm": err.median_trans_cm, "alignment_scale": scale,
            "lsq_sim3_scale": float(s), "lsq_median_trans_m": float(np.median(lsq_t)),
            "lsq_median_rot_deg": float(np.median(lsq_r)), "gt_median_radius_m": extent, "focal": focal}


def run(package: str, seed: int, args) -> dict:
    sched = dict(schedule="1cyclepoly", iterations=args.iterations, learning_rate_max=0.003,
                 warmup_iterations=args.warmup, cooldown_iterations=args.cooldown)
    loss = dict(total_iterations=args.iterations, loss_type="tanh")
    train = dict(batch_size=args.batch_size, pose_refinement="mlp", refine_calibration=True,
                 chunk_steps=args.chunk_steps, iterations_output=args.iterations)
    buffer = dict(samples_per_image=args.samples_per_image)
    rgb, poses = str(SCENE / "frame_*.png"), str(SCENE / "frame_*_pose.txt")
    t0 = time.time()
    if package == "jax":
        import jax

        from acezero_tpu.data.scene import load_scene
        from acezero_tpu.models import torch_io
        from acezero_tpu.models.head import HeadConfig
        from acezero_tpu.training.buffer import BufferConfig
        from acezero_tpu.training.loss import ReproLossConfig
        from acezero_tpu.training.schedule import ScheduleConfig
        from acezero_tpu.training.trainer import MappingTrainer, TrainConfig

        scene = load_scene(rgb, pose_files=poses, image_short_size=args.image_resolution,
                           external_focal_length=FOCAL, num_workers=4)
        enc = jax.tree.map(jax.numpy.asarray, torch_io.load_encoder(ENCODER))
    else:
        from acezero_tpu_torch.data.scene import load_scene
        from acezero_tpu_torch.models import torch_io
        from acezero_tpu_torch.models.head import HeadConfig
        from acezero_tpu_torch.training.buffer import BufferConfig
        from acezero_tpu_torch.training.loss import ReproLossConfig
        from acezero_tpu_torch.training.schedule import ScheduleConfig
        from acezero_tpu_torch.training.trainer import MappingTrainer, TrainConfig

        scene = load_scene(rgb, pose_files=poses, image_short_size=args.image_resolution,
                           external_focal_length=FOCAL, num_workers=4)
        enc = torch_io.load_encoder(ENCODER, "cpu")
    cfg = TrainConfig(schedule=ScheduleConfig(**sched), loss=ReproLossConfig(**loss), **train)
    result = MappingTrainer(scene, enc, HeadConfig(), cfg, BufferConfig(**buffer), base_seed=seed).train()
    gts = {f: np.loadtxt(f[: -len(".png")] + "_pose.txt") for f in scene.rgb_files}
    out = score(scene.rgb_files, np.asarray(result["poses_w2c"]), float(result["focal_orig"]), gts)
    return {"package": package, "base_seed": seed, "iterations": int(result["iterations"]),
            "seconds": time.time() - t0, **out}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--packages", nargs="+", default=["jax", "torch"], choices=["jax", "torch"])
    ap.add_argument("--seeds", nargs="+", type=int, default=[2089, 2090, 2091])
    ap.add_argument("--image_resolution", type=int, default=120)
    ap.add_argument("--iterations", type=int, default=600)
    ap.add_argument("--warmup", type=int, default=100)
    ap.add_argument("--cooldown", type=int, default=150)
    ap.add_argument("--batch_size", type=int, default=1024)
    ap.add_argument("--samples_per_image", type=int, default=256)
    ap.add_argument("--chunk_steps", type=int, default=100)
    ap.add_argument("--out", type=Path, default=None, help="append the JSON lines to this file too")
    args = ap.parse_args(argv)
    for package in args.packages:
        for seed in args.seeds:
            line = json.dumps(run(package, seed, args))
            print(line, flush=True)
            if args.out is not None:
                with open(args.out, "a") as f:
                    f.write(line + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
