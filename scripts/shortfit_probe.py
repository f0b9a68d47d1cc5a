#!/usr/bin/env python3
"""The port's short scene-map fit probe (`pretrain/encoder_eval.py`,
`shortfit_score`) at several schedules and encoders, on the card.

Each run is `iterations:warmup:cooldown` (the JAX package's probe is
6000:500:1000); each encoder is a state-dict path or `random` (the port's
initialisation from seed 0, an encoder that learned nothing). One JSON line
a run: inlier10 (percent of cells within 10 px), the median reprojection
px, seconds, and K1/K2 launches.

    python scripts/shortfit_probe.py --runs 6000:500:1000 1000:83:167 \\
        --encoders weights/tpu_encoder_v6.pt random
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", nargs="+", default=["6000:500:1000"])
    ap.add_argument("--encoders", nargs="+", default=[str(ROOT / "weights" / "tpu_encoder_v6.pt")])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from acezero_tpu_torch.models.encoder import init_encoder_params
    from acezero_tpu_torch.models.torch_io import load_encoder
    from acezero_tpu_torch.ops import fused_head as fh
    from acezero_tpu_torch.pretrain.encoder_eval import shortfit_score

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip() if args.device == "cuda" else "cpu"
    out = []
    for enc_name in args.encoders:
        enc = (init_encoder_params(torch.Generator().manual_seed(0), args.device) if enc_name == "random"
               else load_encoder(enc_name, args.device))
        for run in args.runs:
            iterations, warmup, cooldown = (int(x) for x in run.split(":"))
            fh.LAUNCHES = fh.LAUNCHES_BWD = 0
            t0 = time.perf_counter()
            inl, med = shortfit_score(enc, iterations=iterations, warmup_iterations=warmup,
                                      cooldown_iterations=cooldown)
            rec = {"encoder": Path(enc_name).name, "iterations": iterations, "warmup": warmup,
                   "cooldown": cooldown, "inlier10": inl, "med_px": med, "seconds": time.perf_counter() - t0,
                   "k1_launches": fh.LAUNCHES, "k2_launches": fh.LAUNCHES_BWD, "device": smi}
            print(json.dumps(rec), flush=True)
            out.append(rec)
    return out


if __name__ == "__main__":
    main()
