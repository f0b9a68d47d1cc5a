"""Where the backward kernel's time goes, on the card.

    python3 -m acezero_tpu_torch.ops.probe_bwd [--rows 5120 64] [--out FILE]

Builds variants of `csrc/fused_head_bwd.cu` (nvcc, in parallel, into a
temporary directory, `-I csrc/` for the shared `hopper.cuh`), runs each in its own process at L = 8 (one extra head
block) for each B in `--rows`, and prints one JSON line per variant and B:

  kernel     the kernel as the port builds it, held against the plain version
  profile    the kernel with clock64() spans, summed per tile and averaged over
             the tiles: forward and backward GEMMs, forward and backward
             epilogues, waits on the W ring, wgmma waits with barriers
  ring_only  timing only: W streamed through the TMA ring with no wgmma, no
             epilogue and no stores
  no_ring    timing only: the ring's loads and waits after its first three
             slabs removed (the GEMMs reuse stale W): compute, epilogues and
             stores without the W traffic

Times are CUDA events around 20 back-to-back launches (`ms`, per launch) and
around single launches (`ms_call`, median of 10, host launch cost included).
The timing-only variants compute garbage. Each variant is a text patch of the
source; a patch that no longer applies raises. The card's name and power
limit go on the first line. Nothing here is used by the port. The
machinery (patching, building, timing, the command line) serves the forward
kernel's probe too (`probe_fwd.py`).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

SOURCE = Path(__file__).resolve().parent / "csrc" / "fused_head_bwd.cu"
TAGS = (0, 0, 1, 0, 0, 1, 0, 0)

_NO_MMA = ("wgmma_m64n256k16<TRANS_B>(acc, da, db, (s | kk) != 0);", "(void)da; (void)db;")
_NO_EPILOGUE = ("for (int j = 0; j < 32; ++j)", "for (int j = 0; j < 0; ++j)")
_NO_STORES = ("if ((s & 1) == 0 && tid == 0) {", "if (false) {")
_NO_RING = [
    ("        mbar_wait(ring.full + slot * 8, (n / STAGES) & 1);\n",
     "        if (n < STAGES) mbar_wait(ring.full + slot * 8, (n / STAGES) & 1);\n"),
    ("if (tid == 0 && n + 2 < ring.total)", "if (false)"),
    ("if (tid == 0 && n0 + SLABS + 2 < ring.total)", "if (false)"),
]
_PROFILE = [
    ("int tid, int wg) {\n    // a fresh", "int tid, int wg, long long& tw, long long& tb) {\n    // a fresh"),
    ("        mbar_wait(ring.full + slot * 8, (n / STAGES) & 1);\n",
     "        { long long q0 = clock64(); mbar_wait(ring.full + slot * 8, (n / STAGES) & 1); tw += clock64() - q0; }\n"),
    ("            wgmma_wait<1>();  // slab n - 1 retired in this warpgroup\n            __syncthreads();  // ... and in the other\n",
     "            long long q1 = clock64();\n            wgmma_wait<1>();\n            __syncthreads();\n            tb += clock64() - q1;\n"),
    ("    wgmma_wait<0>();\n    fence_acc(acc);\n    if (tid == 0) tma_store_wait_read();\n    __syncthreads();\n",
     "    long long q2 = clock64();\n    wgmma_wait<0>();\n    fence_acc(acc);\n    if (tid == 0) tma_store_wait_read();\n"
     "    __syncthreads();\n    tb += clock64() - q2;\n"),
    ("    float acc[128];\n",
     "    float acc[128];\n    long long tw = 0, tb = 0, t_fg = 0, t_fe = 0, t_bg = 0, t_be = 0, t_all = clock64();\n"),
    ("        layer_gemm<1>(acc,", "        long long c0 = clock64();\n        layer_gemm<1>(acc,"),
    ("&acts_map, l, row0, tid, wg);", "&acts_map, l, row0, tid, wg, tw, tb);\n        long long c1 = clock64(); t_fg += c1 - c0;"),
    ("        h_is_res = is_res;\n", "        h_is_res = is_res;\n        t_fe += clock64() - c1;\n"),
    ("        layer_gemm<0>(acc,", "        long long c0 = clock64();\n        layer_gemm<0>(acc,"),
    ("&gpre_map, l, row0, tid, wg);", "&gpre_map, l, row0, tid, wg, tw, tb);\n        long long c1 = clock64(); t_bg += c1 - c0;"),
    ("        __syncthreads();\n    }\n\n    // ---- 3. dx",
     "        __syncthreads();\n        t_be += clock64() - c1;\n    }\n\n    // ---- 3. dx"),
    ('    if (tid == 0) asm volatile("cp.async.bulk.wait_group 0;\\n" ::: "memory");\n}\n',
     '    if (tid == 0) asm volatile("cp.async.bulk.wait_group 0;\\n" ::: "memory");\n'
     "    if ((tid & 127) == 0) {\n        unsigned long long* o = probe_clocks + (blockIdx.x * 2 + wg) * 8;\n"
     "        o[0] = clock64() - t_all; o[1] = t_fg; o[2] = t_fe; o[3] = t_bg; o[4] = t_be; o[5] = tw; o[6] = tb;\n"
     "    }\n}\n"),
    ("namespace {\n\nconstexpr int THREADS = 256;",
     "__device__ unsigned long long probe_clocks[1024 * 16];\nnamespace {\n\nconstexpr int THREADS = 256;"),
    ('}  // extern "C"\n',
     "int probe_clocks_read(unsigned long long* out, int n) {\n"
     "    return (int)cudaMemcpyFromSymbol(out, probe_clocks, size_t(n) * 8);\n}\n"
     '}  // extern "C"\n'),
]
VARIANTS = {
    "kernel": [],
    "profile": _PROFILE,
    "ring_only": [_NO_MMA, _NO_EPILOGUE, _NO_STORES],
    "no_ring": _NO_RING,
}
TIMING_ONLY = {"ring_only", "no_ring"}
PROFILE_SPANS = ("all", "fwd_gemm", "fwd_epilogue", "bwd_gemm", "bwd_epilogue", "ring_wait", "mma_wait_and_barrier")


def apply_patches(text: str, patches, label: str) -> str:
    """`text` with every (old, new) patch applied; a patch whose old text is
    missing raises rather than leave a variant half-patched."""
    for old, new in patches:
        if old not in text:
            raise ValueError(f"probe variant {label!r}: patch no longer applies: {old[:60]!r}")
        text = text.replace(old, new)
    return text


def variant_source(name: str, source: str | None = None) -> str:
    """The source of variant `name`: every patch must apply."""
    return apply_patches(SOURCE.read_text() if source is None else source, VARIANTS[name], name)


def build_variants(tmp: Path, sources: dict[str, str]) -> dict[str, Path]:
    """Compile each variant source into `tmp` (nvcc, all at once; `-I` the
    kernels' directory for their shared headers)."""
    from acezero_tpu_torch.ops import build

    procs = {}
    for name, text in sources.items():
        src = tmp / f"{name}.cu"
        src.write_text(text)
        lib = tmp / f"{name}.so"
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o", str(lib), str(src)]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"probe variant {name}: nvcc exit {p.returncode}\n{log}")
        libs[name] = lib
    return libs


def time_launches(run, torch) -> dict:
    """CUDA-event times of `run`: per launch over 20 back to back (`ms`) and
    the median of 10 single launches (`ms_call`), after 3 warm-ups."""
    for _ in range(3):
        run()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(20):
        run()
    end.record()
    end.synchronize()
    calls = []
    for _ in range(10):
        s0, e0 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s0.record()
        run()
        e0.record()
        e0.synchronize()
        calls.append(s0.elapsed_time(e0))
    return {"ms": start.elapsed_time(end) / 20, "ms_call": sorted(calls)[len(calls) // 2]}


def read_clocks(lib, n: int):
    """The profile variant's first n clock words, as a numpy array."""
    import numpy as np

    buf = (ctypes.c_ulonglong * n)()
    rc = lib.probe_clocks_read(buf, n)
    if rc != 0:
        raise RuntimeError(f"probe_clocks_read: CUDA error {rc}")
    return np.array(list(buf), dtype=np.float64)


def _run_variant(name: str, lib_path: str, rows: list[int]) -> None:
    import numpy as np
    import torch

    from acezero_tpu_torch.ops import fused_head as fh

    torch.backends.cuda.matmul.allow_tf32 = False
    lib = ctypes.CDLL(lib_path)
    fn = lib.fused_head_bwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.POINTER(ctypes.c_int)] + [ctypes.c_void_p] * 4 + \
                  [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fh._launcher_bwd = lambda: fn
    L = len(TAGS)
    for B in rows:
        rng = np.random.default_rng(B)
        x = torch.from_numpy((rng.normal(size=(B, 512)) * 0.5).astype(np.float32)).cuda().bfloat16()
        w = torch.from_numpy((rng.uniform(-1, 1, (L, 512, 512)) / 512**0.5).astype(np.float32)).cuda().bfloat16()
        b = torch.from_numpy((rng.uniform(-1, 1, (L, 512)) / 512**0.5).astype(np.float32)).cuda()
        g = torch.from_numpy((rng.normal(size=(B, 512)) * 1e-2).astype(np.float32)).cuda().bfloat16()
        run = lambda: fh.fused_head_chain_backward(x, w, b, g, TAGS)  # noqa: E731
        line = {"variant": name, "B": B, "L": L}
        out = run()
        torch.cuda.synchronize()
        if name not in TIMING_ONLY:
            ref = fh.fused_head_chain_backward_plain(x, w, b, g, TAGS)
            line["rel_err"] = max(float((o.double() - r.double()).norm() / r.double().norm())
                                  for o, r in zip(out, ref))
        line.update(time_launches(run, torch))
        if name == "profile":
            run()
            torch.cuda.synchronize()
            tiles = -(-B // fh.TILE_ROWS)
            spans = read_clocks(lib, tiles * 16).reshape(tiles * 2, 8)
            line["clocks_per_tile"] = {k: float(spans[:, i].mean()) for i, k in enumerate(PROFILE_SPANS)}
        print(json.dumps(line), flush=True)


def probe_main(module: str, description: str, sources, run_variant, default_rows, argv=None) -> int:
    """The probe's command line: build every variant of `sources()` and run
    each in its own process (`python -m module --variant NAME --lib PATH`),
    which calls `run_variant(name, lib_path, rows)` and prints JSON lines."""
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--rows", type=int, nargs="+", default=default_rows, help="batch rows B to time")
    ap.add_argument("--out", type=Path, help="also write the JSON lines here")
    ap.add_argument("--variant", help=argparse.SUPPRESS)
    ap.add_argument("--lib", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.variant:
        run_variant(args.variant, args.lib, args.rows)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    lines = [json.dumps({"device": smi})]
    print(lines[0], flush=True)
    failed = False
    with tempfile.TemporaryDirectory() as tmp:
        for name, lib in build_variants(Path(tmp), sources()).items():
            r = subprocess.run([sys.executable, "-m", module, "--variant", name,
                                "--lib", str(lib), "--rows", *map(str, args.rows)],
                               capture_output=True, text=True, timeout=300)
            out = [ln for ln in r.stdout.splitlines() if ln.startswith("{")]
            if r.returncode != 0:
                failed = True
                out.append(json.dumps({"variant": name, "error": r.stderr[-2000:]}))
            for ln in out:
                print(ln, flush=True)
            lines += out
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("\n".join(lines) + "\n")
    return 1 if failed else 0


def main(argv=None) -> int:
    return probe_main("acezero_tpu_torch.ops.probe_bwd", __doc__.split("\n\n")[0],
                      lambda: {name: variant_source(name) for name in VARIANTS}, _run_variant, [5120, 64], argv)


if __name__ == "__main__":
    sys.exit(main())
