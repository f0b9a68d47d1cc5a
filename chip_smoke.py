#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (acezero_tpu_torch).

    python3 chip_smoke.py

Needs one NVIDIA card (Hopper, for the sm_90a kernels) and nvcc; exits
non-zero without a result when CUDA is absent or the port is not beside
this script. Every phase prints a flushed JSON line when it starts and when
it ends, with its wall seconds; the first failure raises and ends the run.

Phases:
  0 device    the card, its power limit, the torch/CUDA versions
  1 build     nvcc builds every kernel of the path from csrc/
  2 kernels   each kernel against its plain PyTorch version on the card, at
              the main path's shapes, with times (CUDA events, median)
  3 registrar ground-truth scene coordinates of the 60 chesslike_a frames
              (shipped depth + pose) -> the port's estimate_poses_batch
              recovers the shipped poses
  4 slice     the register CLI end to end on the 60 frames at 480x640 with
              the shipped encoder and head; kernel launch counts are zeroed
              just before and read just after
  5 report    one JSON line describing every kernel, then the card's
              nvidia-smi line, then the final status line
"""

from __future__ import annotations

import contextlib
import glob
import json
import logging
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SCENE = ROOT / "results" / "heldout" / "scenes" / "chesslike_a"
ENCODER = ROOT / "weights" / "tpu_encoder_v6.pt"
HEAD = ROOT / "results" / "heldout" / "sweep_a_warmstart" / "iteration2.pt"
FOCAL = 520.0

# H100 SXM published peaks (dense bf16 tensor cores; HBM3)
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

K1_TOL = 1e-2  # relative Frobenius error of the bf16 chain output
ONE_BLOCK_TAGS = (0, 0, 1, 0, 0, 1, 0, 0)
# (case, rows B, residual tags): the registration shape (60x80 cells x 64
# frames, num_head_blocks=1), a ragged B, and num_head_blocks 0 and 2
K1_CASES = [("registration", 307_200, ONE_BLOCK_TAGS), ("ragged", 3 * 4800 + 37, ONE_BLOCK_TAGS),
            ("blocks0", 4800 * 4, (0, 0, 1, 0, 0)),
            ("blocks2", 4800 * 4, (0, 0, 1, 0, 0, 1, 0, 0, 1, 0, 0))]
FRAMES = "frame_*.png"
N_FRAMES = 60
DEVICE = "cuda"


def emit(**fields) -> None:
    print(json.dumps(fields), flush=True)


@contextlib.contextmanager
def phase(name: str, record: dict):
    emit(phase=name, event="start")
    t0 = time.perf_counter()
    try:
        yield record
    except BaseException as exc:
        emit(phase=name, event="failed", seconds=time.perf_counter() - t0,
             error=f"{type(exc).__name__}: {exc}"[:2000], **record)
        raise
    emit(phase=name, event="end", seconds=time.perf_counter() - t0, **record)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "unavailable"


def time_ms(fn, torch, warmup: int = 3, reps: int = 10) -> float:
    """Median of `reps` CUDA-event timings of one call each, after warm-up."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def k1_inputs(torch, B: int, tags, seed: int):
    import numpy as np

    rng = np.random.default_rng(seed)
    L = len(tags)
    x = torch.from_numpy((rng.normal(size=(B, 512)) * 0.5).astype(np.float32)).to(DEVICE, torch.bfloat16)
    w = torch.from_numpy((rng.uniform(-1, 1, (L, 512, 512)) / 512**0.5).astype(np.float32))
    b = torch.from_numpy((rng.uniform(-1, 1, (L, 512)) / 512**0.5).astype(np.float32))
    return x, w.to(DEVICE, torch.bfloat16), b.to(DEVICE)


def chain(torch, x, tags, pre):
    """The residual chain with `pre(h, l)` as layer l's f32 pre-activation."""
    res = h = x
    for l, is_res in enumerate(tags):
        a = torch.relu(pre(h, l)).to(torch.bfloat16)
        if is_res:
            res = res + a
            h = res
        else:
            h = a
    return h


def library_chain(torch, x, w, b, tags):
    """The same function as unfused cuBLAS calls: bf16 tensor-core GEMMs
    with f32 output (torch.mm out_dtype), then bias, ReLU and bf16 rounding.
    A yardstick only, never called by the port."""
    return chain(torch, x, tags, lambda h, l: torch.mm(h, w[l], out_dtype=torch.float32) + b[l])


def exact_chain(torch, x, w, b, tags):
    """The chain with f64 sums and the kernel's bf16 rounding points."""
    return chain(torch, x, tags, lambda h, l: (h.double() @ w[l].double() + b[l].double()).float())


def k1_bound(B: int, L: int):
    flops = 2.0 * B * 512 * 512 * L
    nbytes = 2 * B * 512 * 2 + L * 512 * 512 * 2 + L * 512 * 4
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def synced_clock(torch) -> float:
    torch.cuda.synchronize()
    return time.perf_counter()


def rot_err_deg(np, Ra, Rb) -> float:
    return float(np.degrees(np.arccos(np.clip((np.trace(Ra @ Rb.T) - 1) / 2, -1, 1))))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this smoke test runs on an NVIDIA card",
              file=sys.stderr)
        return 2
    if not (ROOT / "acezero_tpu_torch" / "ops" / "csrc").is_dir():
        print(f"chip_smoke: the acezero_tpu_torch package is not beside {__file__}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import numpy as np

    from acezero_tpu_torch.cli import register_cli
    from acezero_tpu_torch.geometry import backproject_depth, get_pixel_grid
    from acezero_tpu_torch.io.pose_files import read_pose_file
    from acezero_tpu_torch.models import torch_io
    from acezero_tpu_torch.models.encoder import encoder_apply
    from acezero_tpu_torch.models.head import head_apply_flat, head_epilogue
    from acezero_tpu_torch.ops import build
    from acezero_tpu_torch.ops import fused_head as fh
    from acezero_tpu_torch.registration.driver import _canvas_prologue
    from acezero_tpu_torch.registration.ransac import RansacConfig, estimate_poses_batch
    from acezero_tpu_torch.data.scene import load_scene

    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    with phase("device", {}) as rec:
        rec.update(kind=kind, count=torch.cuda.device_count(), nvidia_smi=smi,
                   torch=torch.__version__, cuda=torch.version.cuda,
                   capability=list(torch.cuda.get_device_capability(0)), python=sys.version.split()[0])
        require(torch.version.cuda is not None, "torch is not built for CUDA")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    with phase("build", {}) as rec:
        t0 = time.perf_counter()
        build.build([fh.KERNEL])
        rec["seconds_nvcc"] = time.perf_counter() - t0
        log = build.build_info[fh.KERNEL]["log"]
        rec["ptxas"] = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln][:6]

    k1 = {}
    with phase("kernels", {}) as rec:
        results = []
        for i, (name, B, tags) in enumerate(K1_CASES):
            x, w, b = k1_inputs(torch, B, tags, seed=i)
            out = fh.fused_head_chain(x, w, b, tags)
            torch.cuda.synchronize()
            ref = fh.fused_head_chain_plain(x, w, b, tags).float()
            diff = out.float() - ref
            rel = float(diff.norm() / ref.norm())
            entry = {"case": name, "B": B, "L": len(tags), "rel_err": rel,
                     "max_abs_err": float(diff.abs().max()),
                     "finite": bool(torch.isfinite(out.float()).all())}
            results.append(entry)
            require(entry["finite"] and rel <= K1_TOL, f"K1 {name}: rel err {rel} > {K1_TOL}")
            if i == 0:
                entry["kernel_ms"] = time_ms(lambda: fh.fused_head_chain(x, w, b, tags), torch)
                entry["plain_ms"] = time_ms(lambda: fh.fused_head_chain_plain(x, w, b, tags), torch)
                entry["library_ms"] = time_ms(lambda: library_chain(torch, x, w, b, tags), torch)
                entry["bound_ms"], entry["bound_by"] = k1_bound(B, len(tags))
                k1 = entry
            del x, w, b, out, ref, diff
        rec["cases"] = results
        torch.cuda.empty_cache()

    with phase("registrar", {}) as rec:
        frames = sorted(glob.glob(str(SCENE / FRAMES)))
        require(len(frames) == N_FRAMES, f"expected {N_FRAMES} chesslike_a frames, found {len(frames)}")
        grid = get_pixel_grid(60, 80, 8, device=DEVICE)
        coords, masks, gts = [], [], []
        for f in frames:
            stem = f[: -len(".png")]
            depth = torch.from_numpy(np.load(stem + "_depth.npy")[4::8, 4::8].astype(np.float32)).to(DEVICE)
            gt = np.loadtxt(stem + "_pose.txt")
            gts.append(gt)
            pose = torch.from_numpy(gt.astype(np.float32)).to(DEVICE)
            coords.append(backproject_depth(depth, FOCAL, 320.0, 240.0, pose, grid))
            masks.append((depth > 0) & (depth <= 1000.0))
        n = len(frames)
        t0 = time.perf_counter()
        out = estimate_poses_batch(
            torch.stack(coords), torch.stack(masks), grid, torch.full((n,), FOCAL, device=DEVICE),
            torch.full((n,), 320.0, device=DEVICE), torch.full((n,), 240.0, device=DEVICE),
            RansacConfig(), generator=torch.Generator(device=DEVICE).manual_seed(1305))
        torch.cuda.synchronize()
        rec["estimate_seconds"] = time.perf_counter() - t0
        poses = out["pose_c2w"].double().cpu().numpy()
        r_err = [rot_err_deg(np, poses[i, :3, :3], gts[i][:3, :3]) for i in range(n)]
        t_err = [float(np.linalg.norm(poses[i, :3, 3] - gts[i][:3, 3])) for i in range(n)]
        rec.update(frames=n, valid=int(out["valid"].sum()), median_rot_deg=statistics.median(r_err),
                   median_trans_mm=statistics.median(t_err) * 1e3, max_rot_deg=max(r_err),
                   max_trans_mm=max(t_err) * 1e3)
        require(bool(out["valid"].all()), "a frame had no valid hypothesis")
        require(rec["median_rot_deg"] <= 0.1, f"median rotation error {rec['median_rot_deg']} deg")
        require(rec["median_trans_mm"] <= 2.0, f"median translation error {rec['median_trans_mm']} mm")

    with phase("slice", {}) as rec:
        class Capture(logging.Handler):
            def __init__(self):
                super().__init__()
                self.registered = None

            def emit(self, record):
                if record.msg.startswith("Registered %d frames in"):
                    self.registered = record.args

        cap = Capture()
        logging.getLogger("acezero_tpu_torch.registration.driver").addHandler(cap)
        with tempfile.TemporaryDirectory() as tmp:
            net = Path(tmp) / "iteration2.pt"
            shutil.copy(HEAD, net)
            argv = [str(SCENE / FRAMES), str(net), "--encoder_path", str(ENCODER),
                    "--use_external_focal_length", str(FOCAL), "--session", "smoke", "--device", DEVICE]
            fh.LAUNCHES = 0
            t0 = time.perf_counter()
            rc = register_cli.main(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = fh.LAUNCHES
            require(rc == 0, f"register_cli returned {rc}")
            lines = (Path(tmp) / "poses_smoke.txt").read_text().splitlines()
            entries = read_pose_file(Path(tmp) / "poses_smoke.txt")
        require(launches > 0, "the main path never launched fused_head_fwd")
        require(len(lines) == N_FRAMES and all(len(ln.split()) == 10 for ln in lines),
                f"pose file is not {N_FRAMES} lines of 10 tokens")
        require(all(np.isfinite(e.pose_w2c).all() for e in entries), "non-finite pose")
        reg_seconds = cap.registered[1] if cap.registered else float("nan")
        rec.update(cli_seconds=wall, register_seconds=reg_seconds, frames=len(entries),
                   frames_per_s=len(entries) / reg_seconds, cli_frames_per_s=len(entries) / wall,
                   fused_head_fwd_launches=launches, kind=kind, nvidia_smi=smi,
                   inliers_median=statistics.median(e.confidence for e in entries))

        # Scene coordinates of the same features through K1, the plain chain,
        # cuBLAS (yardstick) and the exact chain (f64 sums, the same bf16
        # rounding points). Tensor cores accumulate in f32 with truncation, so
        # K1 and cuBLAS flip a bf16 rounding in about 2% of the cells where an
        # IEEE f32 sum flips in under 1%; a flip moves a cell by millimetres.
        # The checks: K1 equals the exact chain in at least 95% of the cells,
        # and its coordinates are within 2^-9 (bf16's unit roundoff) of the
        # exact ones, relative Frobenius. A wrong kernel changes nearly every
        # cell.
        scene = load_scene(str(SCENE / FRAMES), external_focal_length=FOCAL)
        enc = torch_io.load_encoder(ENCODER, DEVICE)
        head_cfg, head = torch_io.load_head(HEAD, DEVICE)
        with torch.inference_mode():
            t0 = synced_clock(torch)
            images, mask_lr, grid, ppx, ppy = _canvas_prologue(
                torch.from_numpy(scene.images.canvases).to(DEVICE),
                torch.from_numpy(scene.images.sizes.astype(np.int64)).to(DEVICE), 8)
            feats = encoder_apply(enc, images).reshape(-1, 512).to(torch.bfloat16)
            t1 = synced_clock(torch)
            w, b, tags = fh.head_params_to_stack(head, head_cfg)
            hidden = {"k1": fh.fused_head_chain(feats, w, b, tags),
                      "plain": fh.fused_head_chain_plain(feats, w, b, tags),
                      "library": library_chain(torch, feats, w, b, tags),
                      "exact": exact_chain(torch, feats, w, b, tags)}
            coords = {k: head_epilogue(head, head_cfg, v) for k, v in hidden.items()}
            t2 = synced_clock(torch)
            via_k1 = head_apply_flat(head, head_cfg, feats)
            t3 = synced_clock(torch)
        # time split of one pass over the 60 frames (pass-1 refit cap)
        n = len(scene)
        estimate_poses_batch(via_k1.reshape(n, *mask_lr.shape[1:], 3), mask_lr, grid,
                             torch.as_tensor(scene.focals_canvas, device=DEVICE), ppx, ppy,
                             RansacConfig(), max_refine_steps=16,
                             generator=torch.Generator(device=DEVICE).manual_seed(1305))
        t4 = synced_clock(torch)
        rec["split_seconds"] = {"encoder": t1 - t0, "head": t3 - t2, "registrar": t4 - t3}
        require(bool(torch.equal(via_k1, coords["k1"])), "head_apply_flat does not go through K1")
        require(bool(torch.isfinite(via_k1).all()), "non-finite scene coordinates")
        stats = {}
        for a, bb in (("k1", "plain"), ("k1", "exact"), ("plain", "exact"), ("library", "exact"),
                      ("k1", "library")):
            d = torch.linalg.vector_norm(coords[a] - coords[bb], dim=-1).float()
            q = torch.quantile(d, torch.tensor([0.5, 0.9, 0.99, 0.999], device=d.device)).tolist()
            stats[f"{a}_vs_{bb}"] = {
                "p50_mm": q[0] * 1e3, "p90_mm": q[1] * 1e3, "p99_mm": q[2] * 1e3, "p999_mm": q[3] * 1e3,
                "max_mm": float(d.max()) * 1e3, "cells_differing": float((d > 0).float().mean()),
                "hidden_elems_differing": float((hidden[a] != hidden[bb]).float().mean()),
                "rel_err": float((coords[a] - coords[bb]).norm() / coords[bb].norm()),
            }
        rec["coords"] = stats
        rec["coords_abs_m_p50"] = float(torch.quantile(torch.linalg.vector_norm(coords["exact"], dim=-1), 0.5))
        k1_exact = stats["k1_vs_exact"]
        require(k1_exact["cells_differing"] <= 0.05,
                f"K1 coordinates differ from the exact chain in {k1_exact['cells_differing']:.2%} of cells")
        require(k1_exact["rel_err"] <= 2**-9, f"K1 coordinates: relative error {k1_exact['rel_err']}")

    with phase("report", {}):
        emit(kernels=[{
            "name": "fused_head_fwd",
            "route": "cuda",
            "source": "acezero_tpu_torch/ops/csrc/fused_head_fwd.cu",
            "replaces": "acezero_tpu/ops/fused_head.py:108",
            "replaces_function": "acezero_tpu/ops/fused_head.py::_forward_kernel",
            "launches": launches,
            "max_abs_err": k1["max_abs_err"],
            "rel_err": k1["rel_err"],
            "ms": k1["kernel_ms"],
            "kernel_ms": k1["kernel_ms"],
            "plain_ms": k1["plain_ms"],
            "bound_ms": k1["bound_ms"],
            "bound_by": k1["bound_by"],
            "library_ms": k1["library_ms"],
            "shape": {"B": k1["B"], "L": k1["L"]},
        }])
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                              "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
