#!/usr/bin/env python3
"""Loop closure of both packages at full size on the CPU, on one head.

    # each package's loop_close_entries on the 60 chesslike_a frames at their
    # shipped poses (all above the bar), against a head trained on them
    python scripts/loopclose_parity.py run --package jax   --head MAP.pt --out lc_jax.pkl
    python scripts/loopclose_parity.py run --package torch --head MAP.pt --out lc_torch.pkl
    # per-frame correction differences: the two runs end to end, then the
    # port's loop_close_core on the JAX run's coordinate maps and features
    # (identical inputs); and the pairwise fits of 40 of the edges
    python scripts/loopclose_parity.py compare lc_jax.pkl lc_torch.pkl

The JAX side runs as the JAX package's tests run it (JAX on the CPU); the
port on the CPU. `pair_chunk` 16 bounds the memory of both (the results do
not depend on it). A run takes a few minutes.
"""

from __future__ import annotations

import argparse
import glob
import pickle
import sys
import time
from dataclasses import replace
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
SCENE = ROOT / "results" / "heldout" / "scenes" / "chesslike_a"
FOCAL = 520.0


def _gts():
    files = sorted(glob.glob(str(SCENE / "frame_*.png")))
    return {f: np.loadtxt(f[: -len(".png")] + "_pose.txt") for f in files}


def run(package: str, head_path: str, out: str) -> None:
    gts = _gts()
    captured = {}
    t0 = time.time()
    if package == "jax":
        import jax

        jax.config.update("jax_platforms", "cpu")
        import jax.numpy as jnp

        import acezero_tpu.reconstruct.loopclose as lc
        from acezero_tpu.data.scene import load_scene
        from acezero_tpu.io.pose_files import PoseFileEntry
        from acezero_tpu.models import torch_io

        scene = load_scene(str(SCENE / "frame_*.png"), external_focal_length=FOCAL, num_workers=4)
        enc = jax.tree.map(jnp.asarray, torch_io.load_encoder(ROOT / "weights" / "tpu_encoder_v6.pt"))
        head_cfg, head = torch_io.load_head(head_path)
        head = jax.tree.map(jnp.asarray, head)
        extra = {}
    else:
        import acezero_tpu_torch.reconstruct.loopclose as lc
        from acezero_tpu_torch.data.scene import load_scene
        from acezero_tpu_torch.io.pose_files import PoseFileEntry
        from acezero_tpu_torch.models import torch_io

        scene = load_scene(str(SCENE / "frame_*.png"), external_focal_length=FOCAL, num_workers=4)
        enc = torch_io.load_encoder(ROOT / "weights" / "tpu_encoder_v6.pt")
        head_cfg, head = torch_io.load_head(head_path)
        extra = {"device": "cpu"}
    real_core = lc.loop_close_core

    def core(*a, **k):
        captured["inputs"] = tuple(np.asarray(x) for x in a[:3])
        captured["outputs"] = real_core(*a, **k)
        return captured["outputs"]

    lc.loop_close_core = core
    entries = [PoseFileEntry(f, np.linalg.inv(gts[f]), FOCAL, 2000.0) for f in scene.rgb_files]
    corrected, diag = lc.loop_close_entries(enc, head, head_cfg, scene, entries, 500.0,
                                            cfg=replace(lc.LoopCloseConfig(), pair_chunk=16), **extra)
    seconds = time.time() - t0
    s, R, t, core_diag = captured["outputs"]
    moved = [float(np.linalg.norm(e.pose_c2w[:3, 3] - gts[e.rgb_file][:3, 3])) for e in corrected]
    print(package, f"{seconds:.1f} s", {k: v for k, v in diag.items() if k != "ba_data"})
    print("median camera move (cm):", np.median(moved) * 100)
    with open(out, "wb") as fh:
        pickle.dump({"package": package, "inputs": captured["inputs"], "s": s, "R": R, "t": t,
                     "core_diag": core_diag, "diag": diag, "w2c": np.stack([e.pose_w2c for e in entries])}, fh)


def _angles(Ra, Rb):
    from scipy.spatial.transform import Rotation

    rel = np.asarray(Ra, np.float64) @ np.swapaxes(np.asarray(Rb, np.float64), -1, -2)
    return np.degrees(np.linalg.norm(Rotation.from_matrix(rel).as_rotvec(), axis=-1))


def _frame_diffs(name, a, b):
    dt = np.linalg.norm(a["t"] - b["t"], axis=1)
    dr = _angles(a["R"], b["R"])
    print(f"{name}: edges {a['core_diag'].get('edges')} vs {b['core_diag'].get('edges')}; per-frame translation "
          f"p50 {np.median(dt):.6f} p90 {np.quantile(dt, 0.9):.6f} max {dt.max():.6f}; rotation (deg) "
          f"p50 {np.median(dr):.5f} p90 {np.quantile(dr, 0.9):.5f} max {dr.max():.5f}")


def compare(path_j: str, path_t: str) -> None:
    import torch

    import acezero_tpu_torch.reconstruct.loopclose as tlc

    a, b = (pickle.load(open(p, "rb")) for p in (path_j, path_t))
    print("scene diagonal", a["core_diag"]["scene_diag"])
    print("coordinate maps, max difference between the packages:",
          float(np.abs(a["inputs"][0].astype(np.float64) - b["inputs"][0]).max()))
    _frame_diffs("end to end (each package's own maps)", a, b)
    n = len(a["w2c"])
    c, f, m = (torch.from_numpy(np.asarray(x)) for x in a["inputs"])
    s, R, t, d = tlc.loop_close_core(c, f, m, a["w2c"], np.full(n, 2000.0), np.full(n, FOCAL, np.float32),
                                     (480, 640), 500.0, replace(tlc.LoopCloseConfig(), pair_chunk=16))
    _frame_diffs("identical inputs (the JAX run's maps)", a, {"t": t, "R": R, "core_diag": d})

    # the pairwise fits of every fifth edge (at most 40), both packages
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    import acezero_tpu.reconstruct.loopclose as jlc
    from acezero_tpu.geometry.projection import get_pixel_grid

    cfg = jlc.LoopCloseConfig()
    coords, feats, mask = (np.asarray(x) for x in a["inputs"])
    w2c = a["w2c"].astype(np.float32)
    valid = np.asarray(jlc.map_validity(jnp.asarray(coords), jnp.asarray(mask), jnp.asarray(w2c),
                                        jnp.full(n, FOCAL), 320.0, 240.0, get_pixel_grid(60, 80, 8), cfg.depth_min,
                                        cfg.depth_max, cfg.own_reproj_px))
    pairs = d["ba_data"]["pairs"][::5][:40]
    i, j = pairs[:, 0], pairs[:, 1]
    src = coords[:, ::2, ::2].reshape(n, -1, 3)
    srcf = feats[:, ::2, ::2].reshape(n, -1, feats.shape[-1])
    srcv = valid[:, ::2, ::2].reshape(n, -1)
    args = (src[i], srcf[i], srcv[i], coords[j], feats[j], valid[j], w2c[j], np.full(len(pairs), FOCAL, np.float32))
    sigma = cfg.sigma_floor_rel * a["core_diag"]["scene_diag"]
    rj = {k: np.asarray(v) for k, v in jlc.pairwise_sim3(*[jnp.asarray(x) for x in args], 320.0, 240.0, sigma,
                                                        cfg).items()}
    rt = {k: v.numpy() for k, v in tlc.pairwise_sim3(*[torch.from_numpy(np.asarray(x)) for x in args], 320.0, 240.0,
                                                     sigma, tlc.LoopCloseConfig()).items()}
    dt = np.linalg.norm(rj["t"] - rt["t"], axis=1)
    dr = _angles(rj["R"], rt["R"])
    print(f"pairwise fits of {len(pairs)} edges, identical inputs: translation p50 {np.median(dt):.2e} "
          f"p90 {np.quantile(dt, 0.9):.2e} max {dt.max():.2e}; rotation (deg) p50 {np.median(dr):.2e} "
          f"p90 {np.quantile(dr, 0.9):.2e} max {dr.max():.2e}; matches differing "
          f"{float(np.mean(rj['m_ok'] != rt['m_ok'])):.4f}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("run")
    r.add_argument("--package", choices=("jax", "torch"), required=True)
    r.add_argument("--head", required=True)
    r.add_argument("--out", required=True)
    c = sub.add_parser("compare")
    c.add_argument("jax_pickle")
    c.add_argument("torch_pickle")
    args = ap.parse_args()
    if args.cmd == "run":
        run(args.package, args.head, args.out)
    else:
        compare(args.jax_pickle, args.torch_pickle)


if __name__ == "__main__":
    main()
