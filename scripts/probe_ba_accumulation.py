#!/usr/bin/env python3
"""The cost of the track BA's accumulation on the card, by how it sums.

`acezero_tpu_torch/reconstruct/ba.py` adds each track chunk's Hessian
blocks and gradients into H and g by frame index, with repeated indices.
This probe times, in a fresh process per variant, a first and two warm
accumulations of 294,912 (6, 6) blocks into 3,600 keys, a loop_close_core
call and three `refine_poses_ba` calls on exact drifted maps of 16
chesslike_a frames (chip_smoke.drifted_chesslike), and whether the three BA
results have the same bits:
  - segment: the port's fixed-order segment sum (`ba._ordered_add`);
  - index_put: `index_put_(accumulate=True)` under deterministic algorithms;
  - index_add: `index_add_` (atomic adds on the card).

    python3 scripts/probe_ba_accumulation.py            # every variant, a process each
    python3 scripts/probe_ba_accumulation.py segment    # one variant
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
VARIANTS = ("segment", "index_put", "index_add")


def run(variant: str) -> dict:
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    import chip_smoke
    from acezero_tpu_torch.reconstruct import ba
    from acezero_tpu_torch.reconstruct import loopclose as lc

    if variant != "segment":
        ba._segments = lambda keys: keys

        def add(target, keys, values):
            values = values.reshape((-1,) + target.shape[1:])
            if variant == "index_add":
                target.index_add_(0, keys, values)
                return
            was, warn = torch.are_deterministic_algorithms_enabled(), torch.is_deterministic_algorithms_warn_only_enabled()
            torch.use_deterministic_algorithms(True)
            try:
                target.index_put_((keys,), values, accumulate=True)
            finally:
                torch.use_deterministic_algorithms(was, warn_only=warn)

        ba._ordered_add = add

    def clock():
        torch.cuda.synchronize()
        return time.perf_counter()

    dev = "cuda"
    out = {"variant": variant}
    n, E = 60, 8192 * 36
    gen = torch.Generator(device=dev).manual_seed(0)
    keys = torch.randint(0, n * n, (E,), device=dev, generator=gen)
    vals = torch.randn(E, 6, 6, device=dev, generator=gen)
    H = torch.zeros(n * n, 6, 6, device=dev)
    for i in range(3):
        t0 = clock()
        ba._ordered_add(H, ba._segments(keys), vals)
        out[f"add_s_{i}"] = clock() - t0
    maps, feats, w2c, focals, hw = chip_smoke.drifted_chesslike(np, 16, 8)
    t0 = clock()
    res = lc.loop_close_core(torch.from_numpy(maps).to(dev), torch.from_numpy(feats).to(dev),
                             torch.ones(maps.shape[:3], dtype=torch.bool, device=dev), w2c, np.full(16, 2000.0),
                             focals, hw, 500.0)
    out["loop_close_core_s"] = clock() - t0
    data = res[3]["ba_data"]
    e = len(data["pairs"])
    runs = []
    for i in range(3):
        t0 = clock()
        w2c_ba, diag = ba.refine_poses_ba(w2c, focals, (hw[1] / 2.0, hw[0] / 2.0), data["pairs"],
                                          np.broadcast_to(data["u_src"][None], (e,) + data["u_src"].shape),
                                          data["u_tgt"], data["ok"], device=dev)
        out[f"ba_s_{i}"] = clock() - t0
        runs.append(w2c_ba)
    out["ba_tracks"] = diag.get("n_tracks")
    out["ba_repeat_bit_equal"] = all(np.array_equal(runs[0], r) for r in runs[1:])
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv:
        print(json.dumps(run(argv[0])), flush=True)
        return 0
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({"card": card}), flush=True)
    rc = 0
    for variant in VARIANTS:  # a fresh process each: the first call's cost is part of the answer
        rc |= subprocess.run([sys.executable, __file__, variant], timeout=600).returncode
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
