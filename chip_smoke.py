#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (acezero_tpu_torch).

    python3 chip_smoke.py                          # every phase
    python3 chip_smoke.py --phases build,kernels   # a subset, in the order below

Needs one NVIDIA card (Hopper, for the sm_90a kernels) and nvcc; exits
non-zero without a result when CUDA is absent or the port is not beside
this script. Every phase prints a flushed JSON line when it starts and when
it ends, with its wall seconds; the first failure raises and ends the run.

Phases:
  0 device    the card, its power limit, the torch/CUDA versions
  1 build     nvcc builds every kernel of the paths from csrc/, in parallel
  2 kernels   each kernel against its plain PyTorch version on the card, at
              the main paths' shapes and the tile edges, with times (CUDA
              events, median) and resources: K1 (head chain forward) and K2
              (its backward), and the autograd Function's weight gradients
              against autograd of the plain chain
  3 registrar ground-truth scene coordinates of the 60 chesslike_a frames
              (shipped depth + pose) -> the port's estimate_poses_batch
              recovers the shipped poses
  4 slice     the register CLI end to end on the 60 frames at 480x640 with
              the shipped encoder and head; kernel launch counts are zeroed
              just before and read just after
  5 mapping   the train CLI end to end on the 60 frames and their shipped
              poses at full width (batch 5,120, 614,400 buffer rows): the
              pipeline's mapping recipe, then the same schedule with the
              poses held fixed, counts zeroed just before each run and read
              just after; then the register CLI relocalizes the 60 frames
              against the fixed-pose map
  6 profile   where a mapping step's time goes, for each mapping run's
              configuration: host ms per step over 30 unprofiled steps, then
              device ms, kernels and the top device ops per step over 30
              steps under torch.profiler
  7 pipeline  the reconstruction CLI (acezero_tpu_torch.cli.ace_zero_cli,
              loop closure off) end to end on the 60 frames with their depth
              files at full width and cut budgets (PIPELINE_CUTS): seed
              stage, mapping and registration rounds, final refit; counts
              zeroed just before and read just after; poses_final.txt
              scored against the shipped poses after a Sim(3) alignment
  8 report    one JSON line describing every kernel, then the card's
              nvidia-smi line, then the final status line

Phase `device` always runs (it turns TF32 off for the comparisons). With a
subset the report carries null for what the skipped phases measure, and the
status line is printed all the same.
"""

from __future__ import annotations

import argparse
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

PHASES = ("device", "build", "kernels", "registrar", "slice", "mapping", "profile", "pipeline", "report")

# H100 SXM published peaks (dense bf16 tensor cores; HBM3)
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

K1_TOL = 1e-2  # relative Frobenius error of the bf16 chain output
ONE_BLOCK_TAGS = (0, 0, 1, 0, 0, 1, 0, 0)
H100_SMS = 132
# (case, rows B, residual tags): the registration shape (60x80 cells x 64
# frames, num_head_blocks=1), a ragged B, num_head_blocks 0 and 2, the
# mapping shape; the tile edges (one row, one full tile, one row past it);
# one layer with and without the residual add; a full card (one 64-row tile
# per SM of an H100); and a persistent grid whose tile count is no multiple
# of the SMs (2 x 132 + 1 full tiles and a ragged one)
K1_CASES = [("registration", 307_200, ONE_BLOCK_TAGS), ("ragged", 3 * 4800 + 37, ONE_BLOCK_TAGS),
            ("blocks0", 4800 * 4, (0, 0, 1, 0, 0)),
            ("blocks2", 4800 * 4, (0, 0, 1, 0, 0, 1, 0, 0, 1, 0, 0)),
            ("mapping", 5120, ONE_BLOCK_TAGS),
            ("B1", 1, ONE_BLOCK_TAGS), ("B64", 64, ONE_BLOCK_TAGS), ("B65", 65, ONE_BLOCK_TAGS),
            ("L1", 5120, (0,)), ("L1res", 5120 + 37, (1,)), ("fill132", H100_SMS * 64, ONE_BLOCK_TAGS),
            ("persistent", (2 * H100_SMS + 1) * 64 + 37, ONE_BLOCK_TAGS)]
# the main paths' shapes, and one tile and a full card to tell the fill from
# the per-tile pipeline
K1_TIMED = ("registration", "mapping", "B64", "fill132")
# K2 (the chain's backward): dx, gpre and acts_in against the plain version,
# relative Frobenius. Both round to bf16 at the same points, but a tensor-core
# sum and an IEEE f32 sum flip single bf16 roundings and, rarely, ReLU masks,
# and the walk back compounds them over the layers. On these inputs, on an
# H100, the plain version itself is 0.3-0.8% from the exact chain (f64 sums,
# the same rounding points), and K2, bit-identical to the cuBLAS chain, is
# 0.5-1.2% from it and 0.6-1.2% from the plain version, the most at L = 11.
# A wrong kernel (transpose, mask, residual, ragged edge) is off by O(1).
K2_TOL = 2e-2
K2_GRAD_TOL = 2e-2  # dW, db of the autograd Function against autograd of the plain chain
# the mapping shape (batch 5,120, num_head_blocks=1), a ragged B, and
# num_head_blocks 0 and 2
# num_head_blocks 0 and 2; the tile edges (one row, one full tile, one row
# past it); one layer with and without the residual join (the walk back
# starts on a residual layer only there); and a full card (one 64-row tile
# per SM of an H100), timed with B = 64 to tell the fill from the per-tile
# pipeline
K2_CASES = [("mapping", 5120, ONE_BLOCK_TAGS), ("ragged", 5120 + 37, ONE_BLOCK_TAGS),
            ("blocks0", 5120, (0, 0, 1, 0, 0)), ("blocks2", 5120, (0, 0, 1, 0, 0, 1, 0, 0, 1, 0, 0)),
            ("B1", 1, ONE_BLOCK_TAGS), ("B64", 64, ONE_BLOCK_TAGS), ("B65", 65, ONE_BLOCK_TAGS),
            ("L1", 5120, (0,)), ("L1res", 5120 + 37, (1,)), ("fill132", H100_SMS * 64, ONE_BLOCK_TAGS)]
K2_TIMED = ("mapping", "B64", "fill132")  # kernel_ms of each; plain and library at the mapping shape
# phase mapping, two runs of the train CLI: the pipeline's mapping recipe
# (AceZeroPipeline._base_train_cfg: 1cyclepoly at 0.003, tanh, MLP pose and
# focal refinement), then the same schedule on the frames' fixed poses for the
# map that must relocalize them (pose refinement moves and rescales the map's
# frame as a whole, so a refined map is not in the shipped poses' frame).
# Iteration budgets, warm-up and cooldown are cut to fit the phase.
MAPPING_SCHEDULE = ["--learning_rate_schedule", "1cyclepoly", "--learning_rate_max", "0.003",
                    "--repro_loss_type", "tanh"]
MAPPING_RUNS = {
    "recipe": MAPPING_SCHEDULE + ["--pose_refinement", "mlp", "--refine_calibration", "true",
                                  "--iterations", "2000", "--learning_rate_warmup_iterations", "300",
                                  "--learning_rate_cooldown_iterations", "500", "--iterations_output", "300"],
    "fixed_poses": MAPPING_SCHEDULE + ["--iterations", "9000", "--learning_rate_warmup_iterations", "500",
                                       "--learning_rate_cooldown_iterations", "1500", "--iterations_output", "1000"],
}
RELOC_SHARE = 0.5  # frames the fixed-pose map must relocalize within 5 cm / 5 deg
# phase profile: warm-up and profiled steps at the mapping runs' full-size
# configuration (TrainConfig / BufferConfig overrides, canvas short side)
PROFILE_STEPS = (20, 30)
PROFILE_TRAIN, PROFILE_BUFFER, PROFILE_SHORT_SIDE = {}, {}, 480
# phase pipeline: the reconstruction CLI at full width (480-pixel short side,
# batch 5,120, the 512-wide head with one extra block, the default buffer)
# with the budgets cut to fit the phase; the warm-up has no CLI flag and is
# set on the config that config_from_args built
PIPELINE_CUTS = {"try_seeds": 3, "seed_iterations": 1000, "iterations": 2000, "cooldown_iterations": 500,
                 "refit_iterations": 2000, "final_refit_posewait": 500, "iterations_max": 4}
PIPELINE_OVERRIDES = {"learning_rate_warmup_iterations": 200}
# The floor of frames registered at confidence 500 by the loop. At these
# budgets neither package reaches RELOC_SHARE: the JAX package registers
# 30.0% on this configuration (scripts/pipeline_parity.py, on the CPU) and
# the port 30.0-33.3% over three base seeds on the card, where the same loop
# at the full default budgets reaches 76.7% in five rounds. The floor sits
# three frames under the reference; a loop whose rounds do not train stays
# at the seed map's 3-12%.
PIPELINE_SHARE = 0.25
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


def stream_ms(fn, torch, launches: int = 20, reps: int = 5) -> float:
    """Median over `reps` of the CUDA-event time of `launches` back-to-back
    calls, per call: the device's time with the host's launch cost hidden
    (time_ms, one call between two events, counts the host's time to launch
    where the device waits for it)."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
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


def k2_inputs(torch, B: int, tags, seed: int):
    import numpy as np

    x, w, b = k1_inputs(torch, B, tags, seed)
    g = np.random.default_rng(seed + 100).normal(size=(B, 512)) * 1e-2
    return x, w, b, torch.from_numpy(g.astype(np.float32)).to(DEVICE, torch.bfloat16)


def chain_backward(torch, x, w, b, g, tags, pre, back):
    """The chain's recompute-backward with `pre(h, l)` as layer l's f32
    pre-activation and `back(gpre, l)` as the f32 product gpre @ W[l]^T:
    (dx, gpre, acts_in) at the kernel's rounding points."""
    acts, masks = [], []
    res = h = x
    for l, is_res in enumerate(tags):
        acts.append(h)
        p = pre(h, l)
        masks.append(p > 0)
        a = torch.relu(p).float().to(torch.bfloat16)
        if is_res:
            res = res + a
            h = res
        else:
            h = a
    g = g.to(torch.bfloat16)
    g_res = torch.zeros_like(g)
    gpre = [None] * len(tags)
    for l in reversed(range(len(tags))):
        if tags[l]:
            g = g + g_res
            g_res = g
        gpre[l] = torch.where(masks[l], g, torch.zeros_like(g))
        g = back(gpre[l], l).float().to(torch.bfloat16)
    return g + g_res, torch.stack(gpre), torch.stack(acts)


def library_chain_backward(torch, x, w, b, g, tags):
    """K2's function as cuBLAS calls (bf16 tensor-core GEMMs with f32 output)
    plus rounding, mask and residual bookkeeping. A yardstick only."""
    return chain_backward(torch, x, w, b, g, tags,
                          lambda h, l: torch.mm(h, w[l], out_dtype=torch.float32) + b[l],
                          lambda gp, l: torch.mm(gp, w[l].t(), out_dtype=torch.float32))


def exact_chain_backward(torch, x, w, b, g, tags):
    """K2's function with f64 sums and the same bf16 rounding points."""
    return chain_backward(torch, x, w, b, g, tags,
                          lambda h, l: h.double() @ w[l].double() + b[l].double(),
                          lambda gp, l: gp.double() @ w[l].double().t())


def rel_err(a, b) -> float:
    return float((a.double() - b.double()).norm() / b.double().norm())


def k2_bound(B: int, L: int):
    """Recompute forward + walk back: 4 B C^2 L operations; bytes: x, g, dx,
    gpre and acts_in once each, W once (dW runs outside the kernel)."""
    flops = 4.0 * B * 512 * 512 * L
    nbytes = (3 * B * 512 + 2 * L * B * 512) * 2 + L * 512 * 512 * 2
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


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


def parse_phases(argv) -> list[str]:
    """The phases to run, in PHASES order, `device` always among them. An
    unknown name is an error (argparse exits with status 2)."""
    ap = argparse.ArgumentParser(description="On-card smoke test of the PyTorch/CUDA port.")
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma-separated subset of {','.join(PHASES)} (default: all)")
    args = ap.parse_args(argv)
    names = {p.strip() for p in args.phases.split(",") if p.strip()}
    unknown = sorted(names - set(PHASES))
    if unknown or not names:
        ap.error(f"unknown phase(s) {unknown}; choose from {','.join(PHASES)}")
    return [p for p in PHASES if p in names or p == "device"]


def main(argv=None) -> int:
    phases = parse_phases(sys.argv[1:] if argv is None else argv)
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

    from acezero_tpu_torch.cli import ace_zero_cli, register_cli, train_ace_cli
    from acezero_tpu_torch.evalpose import estimate_alignment, evaluate_poses
    from acezero_tpu_torch.geometry import backproject_depth, get_pixel_grid
    from acezero_tpu_torch.io.pose_files import read_pose_file, registration_rates
    from acezero_tpu_torch.models import torch_io
    from acezero_tpu_torch.models.encoder import encoder_apply
    from acezero_tpu_torch.models.head import HeadConfig, head_apply_flat, head_epilogue
    from acezero_tpu_torch.ops import build
    from acezero_tpu_torch.ops import fused_head as fh
    from acezero_tpu_torch.registration.driver import _canvas_prologue
    from acezero_tpu_torch.registration.ransac import RansacConfig, estimate_poses_batch
    from acezero_tpu_torch.data.scene import load_scene
    from acezero_tpu_torch.training import BufferConfig, MappingTrainer, ReproLossConfig, ScheduleConfig, TrainConfig
    from acezero_tpu_torch.training.trainer import train_hp, train_steps
    from acezero_tpu_torch.utils import profiling

    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    with phase("device", {}) as rec:
        rec.update(kind=kind, count=torch.cuda.device_count(), nvidia_smi=smi,
                   torch=torch.__version__, cuda=torch.version.cuda,
                   capability=list(torch.cuda.get_device_capability(0)), python=sys.version.split()[0])
        require(torch.version.cuda is not None, "torch is not built for CUDA")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    if "build" in phases:
        with phase("build", {}) as rec:
            t0 = time.perf_counter()
            build.build([fh.KERNEL, fh.KERNEL_BWD])
            rec["seconds_nvcc"] = time.perf_counter() - t0
            for name in (fh.KERNEL, fh.KERNEL_BWD):
                log = build.build_info[name]["log"]
                rec[f"ptxas_{name}"] = [ln.strip() for ln in log.splitlines()
                                        if "registers" in ln or "spill" in ln or "warpgroup" in ln or "wgmma" in ln][:8]

    k1, k2 = {}, {}  # timed cases, by name
    launches = map_launches = None  # launch counts of phases slice and mapping
    if "kernels" in phases:
        with phase("kernels", {}) as rec:
            results = []
            sms = torch.cuda.get_device_properties(0).multi_processor_count
            info = fh.forward_kernel_info()
            rec["k1_resources"] = {**info, "sms": sms}
            require(info["local_bytes"] == 0, f"K1 uses {info['local_bytes']} bytes of stack or spill a thread")
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
                if name in K1_TIMED:
                    entry["rel_err_vs_library"] = rel_err(out, library_chain(torch, x, w, b, tags))
                    entry["kernel_ms"] = time_ms(lambda: fh.fused_head_chain(x, w, b, tags), torch)
                    entry["kernel_ms_stream"] = stream_ms(lambda: fh.fused_head_chain(x, w, b, tags), torch)
                    # the host's launch cost where the device waits for it
                    entry["launch_overhead_ms"] = entry["kernel_ms"] - entry["kernel_ms_stream"]
                    entry["plain_ms"] = time_ms(lambda: fh.fused_head_chain_plain(x, w, b, tags), torch)
                    entry["library_ms"] = time_ms(lambda: library_chain(torch, x, w, b, tags), torch)
                    entry["bound_ms"], entry["bound_by"] = k1_bound(B, len(tags))
                    tiles = -(-B // info["tile_rows"])
                    flops = 2.0 * B * 512**2 * len(tags)
                    entry.update(tflops=flops / (entry["kernel_ms"] * 1e-3) / 1e12,
                                 tflops_stream=flops / (entry["kernel_ms_stream"] * 1e-3) / 1e12,
                                 tiles=tiles, sm_fill=tiles / sms)
                    k1[name] = entry
                del x, w, b, out, ref, diff
            rec["cases"] = results

            results = []
            info = fh.backward_kernel_info()
            rec["k2_resources"] = {**info, "sms": sms}
            for i, (name, B, tags) in enumerate(K2_CASES):
                x, w, b, g = k2_inputs(torch, B, tags, seed=10 + i)
                out = fh.fused_head_chain_backward(x, w, b, g, tags)
                torch.cuda.synchronize()
                ref = fh.fused_head_chain_backward_plain(x, w, b, g, tags)
                exact = exact_chain_backward(torch, x, w, b, g, tags)
                entry = {"case": name, "B": B, "L": len(tags),
                         "finite": all(bool(torch.isfinite(t.float()).all()) for t in out)}
                for k, o, r, e in zip(("dx", "gpre", "acts_in"), out, ref, exact):
                    entry[f"rel_err_{k}"] = rel_err(o, r)
                    entry[f"rel_err_{k}_vs_exact"] = rel_err(o, e)
                    entry[f"plain_rel_err_{k}_vs_exact"] = rel_err(r, e)
                entry["max_abs_err"] = max(float((o.float() - r.float()).abs().max()) for o, r in zip(out, ref))
                entry["rel_err"] = max(entry[f"rel_err_{k}"] for k in ("dx", "gpre", "acts_in"))
                # the autograd Function's dW, db against autograd of the plain chain
                grads = []
                for fn in (lambda *a: fh.FusedHeadChain.apply(*a, tags), lambda *a: fh.fused_head_chain_plain(*a, tags)):
                    wf = w.float().requires_grad_(True)
                    bf = b.clone().requires_grad_(True)
                    (fn(x, wf, bf).float() * g.float()).sum().backward()
                    grads.append((wf.grad, bf.grad))
                entry["rel_err_dW"] = rel_err(grads[0][0], grads[1][0])
                entry["rel_err_db"] = rel_err(grads[0][1], grads[1][1])
                results.append(entry)
                require(entry["finite"] and entry["rel_err"] <= K2_TOL,
                        f"K2 {name}: rel err {entry['rel_err']} > {K2_TOL}")
                require(entry["rel_err_dW"] <= K2_GRAD_TOL and entry["rel_err_db"] <= K2_GRAD_TOL,
                        f"K2 {name}: dW/db rel err {entry['rel_err_dW']}/{entry['rel_err_db']} > {K2_GRAD_TOL}")
                if name in K2_TIMED:
                    entry["kernel_ms"] = time_ms(lambda: fh.fused_head_chain_backward(x, w, b, g, tags), torch)
                    entry["kernel_ms_stream"] = stream_ms(lambda: fh.fused_head_chain_backward(x, w, b, g, tags), torch)
                    entry["bound_ms"], entry["bound_by"] = k2_bound(B, len(tags))
                    tiles = -(-B // info["tile_rows"])
                    entry.update(tflops=4.0 * B * 512**2 * len(tags) / (entry["kernel_ms"] * 1e-3) / 1e12,
                                 tflops_stream=4.0 * B * 512**2 * len(tags) / (entry["kernel_ms_stream"] * 1e-3) / 1e12,
                                 smem_bytes=info["smem_bytes"], tiles=tiles, sm_fill=tiles / sms,
                                 ms_per_tile_wave=entry["kernel_ms"] / -(-tiles // sms))
                    k2[name] = entry
                if name == "mapping":
                    lib = library_chain_backward(torch, x, w, b, g, tags)
                    entry["rel_err_dx_vs_library"] = rel_err(out[0], lib[0])
                    entry["plain_ms"] = time_ms(lambda: fh.fused_head_chain_backward_plain(x, w, b, g, tags), torch)
                    entry["library_ms"] = time_ms(lambda: library_chain_backward(torch, x, w, b, g, tags), torch)
                    entry["weight_grads_ms"] = time_ms(lambda: fh.chain_weight_grads(out[1], out[2]), torch)
                    del lib
                del x, w, b, g, out, ref, exact, grads
            rec["k2_cases"] = results
            torch.cuda.empty_cache()

    if "registrar" in phases:
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

    if "slice" in phases:
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
                fh.LAUNCHES = fh.LAUNCHES_BWD = 0
                t0 = time.perf_counter()
                rc = register_cli.main(argv)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                launches = fh.LAUNCHES
                require(fh.LAUNCHES_BWD == 0, "registration launched the backward kernel")
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

    if "mapping" in phases:
        with phase("mapping", {}) as rec:
            gts = {f: np.loadtxt(f[: -len(".png")] + "_pose.txt") for f in sorted(glob.glob(str(SCENE / FRAMES)))}

            def pose_errors(entries):
                r = [rot_err_deg(np, e.pose_c2w[:3, :3], gts[e.rgb_file][:3, :3]) for e in entries]
                t = [float(np.linalg.norm(e.pose_c2w[:3, 3] - gts[e.rgb_file][:3, 3])) for e in entries]
                return r, t

            map_launches = {"fwd": 0, "bwd": 0}
            rec.update(kind=kind, nvidia_smi=smi)
            with tempfile.TemporaryDirectory() as tmp:
                for name, extra in MAPPING_RUNS.items():
                    net = Path(tmp) / f"{name}.pt"
                    argv = [str(SCENE / FRAMES), str(net), "--pose_files", str(SCENE / FRAMES.replace(".png", "_pose.txt")),
                            "--use_external_focal_length", str(FOCAL), "--encoder_path", str(ENCODER),
                            "--device", DEVICE, *extra]
                    fh.LAUNCHES = fh.LAUNCHES_BWD = 0
                    t0 = time.perf_counter()
                    result = train_ace_cli.main(argv)
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
                    fwd, bwd = fh.LAUNCHES, fh.LAUNCHES_BWD
                    map_launches["fwd"] += fwd
                    map_launches["bwd"] += bwd
                    prelim_path = Path(tmp) / f"poses_{name}_preliminary.txt"
                    prelim = prelim_path.read_text().splitlines()
                    prelim_entries = read_pose_file(prelim_path)
                    prelim_r, prelim_t = pose_errors(prelim_entries)
                    # after a Sim(3) alignment onto the shipped poses, since
                    # pose refinement moves the map's frame as a whole
                    aligned = evaluate_poses(prelim_entries, [gts[f] for f in sorted(gts)])
                    log = result["log"]
                    steps = result["steps"]
                    rec[name] = {
                        "cli_seconds": wall, "fill_seconds": result["fill_time"], "train_seconds": result["train_time"],
                        "steps": steps, "iterations": result["iterations"], "steps_per_s": steps / result["train_time"],
                        "buffer_rows": result["buffer_rows"], "fused_head_fwd_launches": fwd,
                        "fused_head_bwd_launches": bwd, "first_log": log[0] if log else None,
                        "last_log": log[-1] if log else None, "log": log, "focal_refined": result["focal_orig"],
                        "prelim_median_rot_deg": statistics.median(prelim_r),
                        "prelim_median_trans_mm": statistics.median(prelim_t) * 1e3,
                        "aligned_within_5cm_5deg_pct": aligned.accuracy,
                        "aligned_median_rot_deg": aligned.median_rot_deg,
                        "aligned_median_trans_cm": aligned.median_trans_cm, "aligned": aligned.aligned,
                    }
                    require(bwd == steps, f"{name}: K2 launched {bwd} times for {steps} steps")
                    require(fwd >= steps, f"{name}: K1 launched {fwd} times for {steps} steps")
                    require(len(log) >= 2 and all(np.isfinite(e["loss"]) for e in log), f"{name}: missing or non-finite losses")
                    require(log[-1]["loss"] < log[0]["loss"], f"{name}: loss did not fall: {log[0]['loss']} -> {log[-1]['loss']}")
                    require(len(prelim) == N_FRAMES and all(len(ln.split()) == 10 for ln in prelim),
                            f"{name}: preliminary pose file is not {N_FRAMES} lines of 10 tokens")

                # relocalize the 60 frames against the map trained on their poses
                argv = [str(SCENE / FRAMES), str(Path(tmp) / "fixed_poses.pt"), "--encoder_path", str(ENCODER),
                        "--use_external_focal_length", str(FOCAL), "--session", "reloc", "--device", DEVICE]
                t0 = time.perf_counter()
                require(register_cli.main(argv) == 0, "register_cli failed on the trained map")
                entries = read_pose_file(Path(tmp) / "poses_reloc.txt")
                rec["reloc_seconds"] = time.perf_counter() - t0
            r_err, t_err = pose_errors(entries)
            good = sum(1 for a, t in zip(r_err, t_err) if a <= 5.0 and t <= 0.05)
            rec.update(reloc_frames=len(entries), reloc_within_5cm_5deg=good,
                       reloc_median_rot_deg=statistics.median(r_err), reloc_median_trans_mm=statistics.median(t_err) * 1e3,
                       reloc_inliers_median=statistics.median(e.confidence for e in entries))
            require(len(entries) == N_FRAMES, f"registered {len(entries)} of {N_FRAMES} frames")
            require(good >= RELOC_SHARE * N_FRAMES,
                    f"the trained map relocalizes {good} of {N_FRAMES} frames within 5 cm / 5 deg")

    if "profile" in phases:
        with phase("profile", {}) as rec:
            from torch.autograd import DeviceType
            from torch.profiler import ProfilerActivity, profile

            scene = load_scene(str(SCENE / FRAMES), pose_files=str(SCENE / FRAMES.replace(".png", "_pose.txt")),
                               external_focal_length=FOCAL, image_short_size=PROFILE_SHORT_SIDE)
            enc = torch_io.load_encoder(ENCODER, DEVICE)
            warm, n = PROFILE_STEPS
            for name, refine in (("recipe", True), ("fixed_poses", False)):
                cfg = TrainConfig(schedule=ScheduleConfig(learning_rate_max=0.003), loss=ReproLossConfig(loss_type="tanh"),
                                  pose_refinement="mlp" if refine else "none", refine_calibration=refine, **PROFILE_TRAIN)
                trainer = MappingTrainer(scene, enc, HeadConfig(), cfg, BufferConfig(**PROFILE_BUFFER))
                buffer = trainer.build_buffer()
                state = trainer.build_state()
                hp = train_hp(cfg)
                state, _ = train_steps(state, buffer, trainer.ctx, hp, cfg, HeadConfig(), warm, generator=trainer.generator)
                # host time per step without the profiler (its start-up and
                # bookkeeping slow the host), device time per step under it
                t0 = synced_clock(torch)
                state, _ = train_steps(state, buffer, trainer.ctx, hp, cfg, HeadConfig(), n, generator=trainer.generator)
                host_ms = (synced_clock(torch) - t0) / n * 1e3
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    state, _ = train_steps(state, buffer, trainer.ctx, hp, cfg, HeadConfig(), n, generator=trainer.generator)
                    torch.cuda.synchronize()
                # kernel events only: the CPU ops that launched them carry the same time
                events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
                device_ms = sum(e.self_device_time_total for e in events) / 1e3 / n
                top = sorted(events, key=lambda e: -e.self_device_time_total)[:6]
                rec[name] = {"host_ms_per_step": host_ms, "device_ms_per_step": device_ms,
                             "device_busy_share": device_ms / host_ms,
                             "kernels_per_step": sum(e.count for e in events) / n,
                             "top_device_ms_per_step": {e.key[:80]: e.self_device_time_total / 1e3 / n for e in top}}
                del trainer, buffer, state

    pipe_launches = None  # launch counts of phase pipeline
    if "pipeline" in phases:
        with phase("pipeline", {}) as rec:
            rec.update(kind=kind, nvidia_smi=smi, cuts={**PIPELINE_CUTS, **PIPELINE_OVERRIDES})
            flags = [f"--{k}={v}" for k, v in PIPELINE_CUTS.items()]
            with tempfile.TemporaryDirectory() as tmp:
                argv = [str(SCENE / FRAMES), tmp, "--depth_files", str(SCENE / FRAMES.replace(".png", "_depth.npy")),
                        "--use_external_focal_length", str(FOCAL), "--encoder_path", str(ENCODER),
                        "--loop_closure", "false", *flags, "--device", DEVICE]
                profiling.reset_stages()
                fh.LAUNCHES = fh.LAUNCHES_BWD = 0
                t0 = time.perf_counter()
                result = ace_zero_cli.main(argv, **PIPELINE_OVERRIDES)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                pipe_launches = {"fwd": fh.LAUNCHES, "bwd": fh.LAUNCHES_BWD}
                lines = (Path(tmp) / "poses_final.txt").read_text().splitlines()
                entries = read_pose_file(Path(tmp) / "poses_final.txt")
                artifacts = sorted(p.name for p in Path(tmp).iterdir())
            gts = [np.loadtxt(f[: -len(".png")] + "_pose.txt") for f in sorted(glob.glob(str(SCENE / FRAMES)))]
            errors = evaluate_poses(entries, gts)
            by_name = sorted(entries, key=lambda e: e.rgb_file)
            _, scale = estimate_alignment(np.stack([e.pose_c2w for e in by_name]), np.stack(gts),
                                          np.asarray([e.confidence for e in by_name]))
            rates = registration_rates([e.confidence for e in entries], [500, 1000, 2000, 4000])
            rec.update(
                wall_seconds=wall, stage_seconds={k: v[0] for k, v in profiling.stage_totals().items()},
                stage_calls={k: v[1] for k, v in profiling.stage_totals().items()},
                rounds=result["iterations"], rate_history=result["rate_history"],
                registration_rates=dict(zip(("500", "1000", "2000", "4000"), rates)),
                focal_estimate=result["focal_estimate"], artifacts=artifacts,
                aligned_within_5cm_5deg_pct=errors.accuracy, aligned=errors.aligned, alignment_scale=scale,
                median_rot_deg=errors.median_rot_deg, median_trans_cm=errors.median_trans_cm,
                fused_head_fwd_launches=pipe_launches["fwd"], fused_head_bwd_launches=pipe_launches["bwd"],
                registered_half=rates[0] >= RELOC_SHARE, report=result["report"])
            require(len(lines) == N_FRAMES and all(len(ln.split()) == 10 for ln in lines),
                    f"poses_final.txt is not {N_FRAMES} lines of 10 tokens")
            require(all(np.isfinite(e.pose_w2c).all() for e in entries), "non-finite pose in poses_final.txt")
            require(pipe_launches["fwd"] > 0, "the pipeline never launched fused_head_fwd")
            require(pipe_launches["bwd"] > 0, "the pipeline never launched fused_head_bwd")
            require(rates[0] >= PIPELINE_SHARE,
                    f"the pipeline registered {rates[0]:.1%} of the frames at confidence 500")

    if "report" in phases:
        with phase("report", {}):
            def pick(entry, *keys):
                return {k: entry.get(k) for k in keys}

            fields = ("max_abs_err", "rel_err", "kernel_ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
            k1_reg, k1_map, k2_map = k1.get("registration", {}), k1.get("mapping", {}), k2.get("mapping", {})
            fwd = map_launches["fwd"] if map_launches else 0
            bwd = map_launches["bwd"] if map_launches else 0
            pipe_fwd = pipe_launches["fwd"] if pipe_launches else 0
            pipe_bwd = pipe_launches["bwd"] if pipe_launches else 0
            emit(kernels=[{
                "name": "fused_head_fwd",
                "route": "cuda",
                "source": "acezero_tpu_torch/ops/csrc/fused_head_fwd.cu",
                "replaces": "acezero_tpu/ops/fused_head.py:108",
                "replaces_function": "acezero_tpu/ops/fused_head.py::_forward_kernel",
                "launches": (launches or 0) + fwd + pipe_fwd,
                "launches_by_path": {"register": launches, "mapping": fwd if map_launches else None,
                                     "pipeline": pipe_fwd if pipe_launches else None},
                **pick(k1_reg, *fields),
                "ms": k1_reg.get("kernel_ms"),
                "shape": pick(k1_reg, "B", "L"),
                **pick(k1_reg, "kernel_ms_stream", "launch_overhead_ms", "rel_err_vs_library", "tflops",
                       "tflops_stream", "sm_fill"),
                "mapping_shape": pick(k1_map, "B", "L", "kernel_ms", "kernel_ms_stream", "launch_overhead_ms",
                                      "plain_ms", "library_ms", "bound_ms", "bound_by", "rel_err",
                                      "rel_err_vs_library"),
                "other_shapes": {name: pick(e, "B", "L", "kernel_ms", "kernel_ms_stream", "tflops", "sm_fill")
                                 for name, e in k1.items() if name not in ("registration", "mapping")},
            }, {
                "name": "fused_head_bwd",
                "route": "cuda",
                "source": "acezero_tpu_torch/ops/csrc/fused_head_bwd.cu",
                "replaces": "acezero_tpu/ops/fused_head.py:112",
                "replaces_function": "acezero_tpu/ops/fused_head.py::_backward_kernel",
                "launches": bwd + pipe_bwd,
                "launches_by_path": {"register": 0, "mapping": bwd if map_launches else None,
                                     "pipeline": pipe_bwd if pipe_launches else None},
                **pick(k2_map, *fields, "kernel_ms_stream", "tflops", "tflops_stream", "smem_bytes", "sm_fill"),
                "ms": k2_map.get("kernel_ms"),
                "shape": pick(k2_map, "B", "L"),
                "other_shapes": {name: pick(e, "B", "L", "kernel_ms", "kernel_ms_stream", "tflops", "sm_fill")
                                 for name, e in k2.items() if name != "mapping"},
            }])

    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                              "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
