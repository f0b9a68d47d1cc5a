"""Where the forward kernel's time goes, on the card.

    python3 -m acezero_tpu_torch.ops.probe_fwd [--rows 5120 64 8448 307200] [--out FILE]

The counterpart of `probe_bwd.py` for `csrc/fused_head_fwd.cu`, and built on
its machinery (text patches, parallel nvcc builds into a temporary
directory, one process per variant, CUDA-event timing). Runs each variant
at L = 8 (one extra head block) for each B in `--rows` and prints one JSON
line per variant and B:

  kernel         the kernel as the port builds it, held against the plain version
  profile        the kernel with clock64() spans, summed per block and divided
                 by the block's tiles: GEMMs, epilogues, waits on the W ring,
                 wgmma waits with barriers, and the tile's start (the previous
                 out leaving the buffer, x arriving, the residual stream read)
  ring_only      timing only: W streamed through the TMA ring, x loaded and out
                 stored, with no wgmma and no epilogue
  no_ring        timing only: the ring's loads and waits after its first slabs
                 removed (the GEMMs reuse stale W): compute, epilogues, x and out
                 without the W traffic
  ring3, ring4,  the kernel with a W ring of 3, 4 or 5 slabs of 32 KiB
  ring5
  grid_per_tile  the kernel launched with one block per tile instead of the
                 persistent grid of at most one block per SM
  w_boxes8       the kernel with each W slab loaded as 8 TMA boxes of one
                 column atom (32 x 64) instead of one box

`ms` is per launch over 20 back-to-back launches, `ms_call` the median of
10 single launches. The timing-only variants compute garbage. A patch that
no longer applies raises. The card's name and power limit go on the first
line. Nothing here is used by the port.
"""

from __future__ import annotations

import ctypes
import json
import sys
from pathlib import Path

from acezero_tpu_torch.ops.probe_bwd import apply_patches, probe_main, read_clocks, time_launches

SOURCE = Path(__file__).resolve().parent / "csrc" / "fused_head_fwd.cu"
TAGS = (0, 0, 1, 0, 0, 1, 0, 0)
RING_SLABS = 5  # the kernel's W ring depth (STAGES)

_NO_MMA = ("wgmma_m64n256k16<1>(acc, da, db, (s | kk) != 0);", "(void)da; (void)db;")
_NO_EPILOGUE = ("for (int j = 0; j < 32; ++j) {", "for (int j = 0; j < 0; ++j) {")
_NO_RING = [
    ("        mbar_wait(ring.full + slot * 8, (n / STAGES) & 1);\n",
     "        if (n < STAGES) mbar_wait(ring.full + slot * 8, (n / STAGES) & 1);\n"),
    ("if (tid == 0 && n - 1 + STAGES < ring.total)", "if (false)"),
    ("if (tid == 0 && n0 + SLABS - 1 + STAGES < ring.total)", "if (false)"),
]
_PROFILE = [
    ("int tid, int wg) {\n    // a fresh", "int tid, int wg, long long& tw, long long& tb) {\n    // a fresh"),
    ("        mbar_wait(ring.full + slot * 8, (n / STAGES) & 1);\n",
     "        { long long q0 = clock64(); mbar_wait(ring.full + slot * 8, (n / STAGES) & 1); tw += clock64() - q0; }\n"),
    ("            wgmma_wait<1>();  // slab n - 1 retired in this warpgroup\n"
     "            __syncthreads();  // ... and in the other\n",
     "            long long q1 = clock64();\n            wgmma_wait<1>();\n            __syncthreads();\n"
     "            tb += clock64() - q1;\n"),
    ("    wgmma_wait<0>();\n    fence_acc(acc);\n",
     "    long long q2 = clock64();\n    wgmma_wait<0>();\n    fence_acc(acc);\n"),
    ("  // the layer's bias, staged during the GEMM\n    __syncthreads();\n",
     "  // the layer's bias, staged during the GEMM\n    __syncthreads();\n    tb += clock64() - q2;\n"),
    ("    float acc[128];\n",
     "    float acc[128];\n    long long tw = 0, tb = 0, t_g = 0, t_e = 0, t_x = 0, t_all = clock64();\n"),
    ("        if (tid == 0) {\n            tma_store_wait_read();",
     "        long long cx = clock64();\n        if (tid == 0) {\n            tma_store_wait_read();"),
    ("act + acc_off(k >> 1, k & 1));\n", "act + acc_off(k >> 1, k & 1));\n        t_x += clock64() - cx;\n"),
    ("            layer_gemm(acc, a, ring, n0, &w_map, tid, wg);\n",
     "            long long c0 = clock64();\n            layer_gemm(acc, a, ring, n0, &w_map, tid, wg, tw, tb);\n"
     "            long long c1 = clock64();\n            t_g += c1 - c0;\n"),
    ("            fence_proxy_async();\n            __syncthreads();\n        }\n",
     "            fence_proxy_async();\n            __syncthreads();\n            t_e += clock64() - c1;\n        }\n"),
    ("    if (tid == 0) tma_store_wait();\n}\n",
     "    if (tid == 0) tma_store_wait();\n"
     "    if ((tid & 127) == 0) {\n        unsigned long long* o = probe_clocks + (blockIdx.x * 2 + wg) * 8;\n"
     "        o[0] = clock64() - t_all; o[1] = t_g; o[2] = t_e; o[3] = tw; o[4] = tb; o[5] = t_x; o[6] = my_tiles;\n"
     "    }\n}\n"),
    ("namespace {\n\nconstexpr int THREADS = 256;",
     "__device__ unsigned long long probe_clocks[1024 * 16];\nnamespace {\n\nconstexpr int THREADS = 256;"),
    ('}  // extern "C"\n',
     "int probe_clocks_read(unsigned long long* out, int n) {\n"
     "    return (int)cudaMemcpyFromSymbol(out, probe_clocks, size_t(n) * 8);\n}\n"
     '}  // extern "C"\n'),
]


def _ring(slabs: int):
    return [(f"constexpr int STAGES = {RING_SLABS};", f"constexpr int STAGES = {slabs};")]


VARIANTS = {
    "kernel": [],
    "profile": _PROFILE,
    "ring_only": [_NO_MMA, _NO_EPILOGUE],
    "no_ring": _NO_RING,
    "ring3": _ring(3),
    "ring4": _ring(4),
    "ring5": _ring(5),
    "grid_per_tile": [("const int grid = tiles < sms ? tiles : sms;", "const int grid = tiles;")],
    "w_boxes8": [
        ("    tma_load_4d(ring.slots + slot * SLAB_BYTES, w_map, bar, 0, s * KS, 0, l);\n",
         "    for (int c = 0; c < C / 64; ++c)\n"
         "        tma_load_3d(ring.slots + slot * SLAB_BYTES + c * BOX_BYTES, w_map, bar, c * 64, s * KS, l);\n"),
        ("CUresult r = atom_map(enc, &w_map, w, L, C, KS);",
         "CUresult r = layer_map(enc, &w_map, w, L, C, 64, KS, CU_TENSOR_MAP_SWIZZLE_128B);"),
    ],
}
TIMING_ONLY = {"ring_only", "no_ring"}
PROFILE_SPANS = ("all", "gemm", "epilogue", "ring_wait", "mma_wait_and_barrier", "tile_start")


def variant_source(name: str, source: str | None = None) -> str:
    """The source of variant `name`: every patch must apply."""
    return apply_patches(SOURCE.read_text() if source is None else source, VARIANTS[name], name)


def _run_variant(name: str, lib_path: str, rows: list[int]) -> None:
    import numpy as np
    import torch

    from acezero_tpu_torch.ops import fused_head as fh

    torch.backends.cuda.matmul.allow_tf32 = False
    lib = ctypes.CDLL(lib_path)
    fn = lib.fused_head_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p,
                                           ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fh._launcher = lambda: fn
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    L = len(TAGS)
    for B in rows:
        rng = np.random.default_rng(B)
        x = torch.from_numpy((rng.normal(size=(B, 512)) * 0.5).astype(np.float32)).cuda().bfloat16()
        w = torch.from_numpy((rng.uniform(-1, 1, (L, 512, 512)) / 512**0.5).astype(np.float32)).cuda().bfloat16()
        b = torch.from_numpy((rng.uniform(-1, 1, (L, 512)) / 512**0.5).astype(np.float32)).cuda()
        run = lambda: fh.fused_head_chain(x, w, b, TAGS)  # noqa: E731
        line = {"variant": name, "B": B, "L": L}
        out = run()
        torch.cuda.synchronize()
        if name not in TIMING_ONLY:
            ref = fh.fused_head_chain_plain(x, w, b, TAGS)
            line["rel_err"] = float((out.double() - ref.double()).norm() / ref.double().norm())
        line.update(time_launches(run, torch))
        if name == "profile":
            run()
            torch.cuda.synchronize()
            grid = min(-(-B // fh.TILE_ROWS), sms)
            spans = read_clocks(lib, grid * 16).reshape(grid * 2, 8)
            tiles = spans[:, 6].sum()  # both warpgroups of every block
            line["clocks_per_tile"] = {k: float(spans[:, i].sum() / tiles) for i, k in enumerate(PROFILE_SPANS)}
        print(json.dumps(line), flush=True)


def main(argv=None) -> int:
    return probe_main("acezero_tpu_torch.ops.probe_fwd", __doc__.split("\n\n")[0],
                      lambda: {name: variant_source(name) for name in VARIANTS}, _run_variant,
                      [5120, 64, 8448, 307_200], argv)


if __name__ == "__main__":
    sys.exit(main())
