#!/usr/bin/env python3
"""The reconstruction loop on chesslike_a with the budgets of chip_smoke.py's
phase `pipeline`: does the PyTorch port's registration rate track the JAX
package's round by round, and how far does it spread over base seeds?

Both packages run AceZeroPipeline (loop closure off, the shipped v6
encoder, the scene's depth files, f = 520 px) with the same config; the JAX
package on one CPU device. `--size reduced` (a 240-pixel short side, so a
quarter of the cells, the confidence bar scaled with them, a smaller batch
and buffer) keeps a run to minutes on the CPU; `--size full` is the phase's
own configuration, for the port on the card. One JSON line per run: the
rate history, the rate at the bar, the refined focal, the aligned 5 cm / 5°
accuracy of poses_final.txt (the port's evalpose, which
tests/test_torch_evalpose.py holds to the JAX package's) and the seconds.

    JAX_PLATFORMS=cpu python scripts/pipeline_parity.py --seeds 2089 --out parity.jsonl
    python3 scripts/pipeline_parity.py --packages torch --device cuda --size full --seeds 2089 2090 \
        --set iterations_max=6
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
SCENE = ROOT / "results" / "heldout" / "scenes" / "chesslike_a"
# chip_smoke.py's PIPELINE_CUTS and PIPELINE_OVERRIDES
CUTS = {"try_seeds": 3, "seed_iterations": 1000, "iterations": 2000, "cooldown_iterations": 500,
        "refit_iterations": 2000, "final_refit_posewait": 500, "iterations_max": 4,
        "learning_rate_warmup_iterations": 200}
SIZES = {"reduced": {"image_resolution": 240, "registration_confidence": 125, "batch_size": 1024,
                     "samples_per_image": 256},
         "full": {}}


def run(package: str, seed: int, cuts: dict, size: dict, folder: Path, device: str) -> dict:
    kw = dict(rgb_files=str(SCENE / "frame_*.png"), results_folder=folder,
              depth_files=str(SCENE / "frame_*_depth.npy"), use_external_focal_length=520.0,
              encoder_path=ROOT / "weights" / "tpu_encoder_v6.pt", loop_closure=False, base_seed=seed,
              **cuts, **size)
    t0 = time.time()
    if package == "jax":
        import jax

        jax.config.update("jax_platforms", "cpu")
        from acezero_tpu.reconstruct import AceZeroConfig, AceZeroPipeline

        result = AceZeroPipeline(AceZeroConfig(**kw, num_devices=1, decode_cache_dir=None)).run()
    else:
        from acezero_tpu_torch.reconstruct import AceZeroConfig, AceZeroPipeline

        result = AceZeroPipeline(AceZeroConfig(**kw), device=device).run()
    seconds = time.time() - t0
    from acezero_tpu_torch.evalpose import evaluate_poses
    from acezero_tpu_torch.io.pose_files import load_pose_files_glob, read_pose_file

    bar = size.get("registration_confidence", 500)
    err = evaluate_poses(read_pose_file(folder / "poses_final.txt"), load_pose_files_glob(str(SCENE / "frame_*_pose.txt")),
                         alignment_conf_threshold=bar)
    confs = [e.confidence for e in result["entries"]]
    return {"package": package, "device": device if package == "torch" else "cpu", "base_seed": seed, "cuts": cuts,
            "size": size, "seconds": seconds, "rounds": result["iterations"], "rate_history": result["rate_history"],
            "rate_at_bar": float(np.mean(np.asarray(confs) > bar)),
            "focal": result["focal_estimate"], "aligned_pct_5cm_5deg": err.accuracy,
            "aligned_median_rot_deg": err.median_rot_deg, "aligned_median_trans_cm": err.median_trans_cm}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--packages", nargs="+", default=["torch", "jax"], choices=["jax", "torch"])
    ap.add_argument("--seeds", nargs="+", type=int, default=[2089])
    ap.add_argument("--set", nargs="*", default=[], metavar="FIELD=INT",
                    help="replace budgets of CUTS, e.g. iterations_max=6 seed_iterations=3000")
    ap.add_argument("--size", default="reduced", choices=sorted(SIZES))
    ap.add_argument("--device", default="cpu", help="the port's device")
    ap.add_argument("--out", type=Path, default=None, help="append the JSON lines to this file too")
    args = ap.parse_args(argv)
    cuts = {**CUTS, **{k: int(v) for k, v in (kv.split("=", 1) for kv in args.set)}}
    card = None
    if args.device.startswith("cuda"):
        import subprocess

        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    for package in args.packages:
        for seed in args.seeds:
            with tempfile.TemporaryDirectory() as tmp:
                line = json.dumps({**run(package, seed, cuts, SIZES[args.size], Path(tmp), args.device),
                                   "card": card if package == "torch" else None})
            print(line, flush=True)
            if args.out is not None:
                with open(args.out, "a") as f:
                    f.write(line + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
