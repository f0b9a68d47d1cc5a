"""Build the port's CUDA kernels with nvcc, and its host C++ libraries with
the host compiler, and load them with ctypes.

Each `csrc/<name>.cu` exposes a plain `extern "C"` launcher and becomes its
own shared library, `_build/<name>-<hash>.so`, where the hash covers the
source, every shared header `csrc/*.cuh` and the compiler flags: a library
is rebuilt only when one of them changes. Builds happen on first use, never
at import, and all requested sources compile in parallel.

A host library (`load_host`: a `.cpp` source anywhere in the package, such
as io/csrc/jpeg.cpp or data/csrc/canvas.cpp) is built with `c++` (the
compiler nvcc drives) and HOST_FLAGS, so that it gives the same bits on
every host: no -ffast-math or -march=native, and -ffp-contract=off, so
that a host whose baseline has fused multiply-add (aarch64) cannot fuse
the canvas pass's float32 products and sums and drift from its numpy
version (the JPEG codec is integer code). It lands in
`_build/<stem>-<hash>.so`, the hash over the source and the flags.

Every library is written to a temporary name and renamed, so concurrent
processes never load a half-written file. There is no fallback: a missing
`nvcc` or `c++` or a failed build raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

HOST_FLAGS = ("-O2", "-std=c++17", "-ffp-contract=off", "-shared", "-fPIC")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# per kernel: {"seconds": build wall time (0.0 when cached), "log": nvcc output}
build_info: dict[str, dict] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the port's "
        "CUDA kernels are built from source on the machine with the card"
    )


def _target(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):  # the shared headers a source may include
        h.update(header.name.encode())
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: list[str]) -> dict[str, Path]:
    """Compile every named source that is not built yet, all at once."""
    targets = {n: _target(n) for n in names}
    todo = {n: t for n, t in targets.items() if not t.exists()}
    for n in targets:
        if n not in todo:
            build_info.setdefault(n, {"seconds": 0.0, "log": "cached"})
    if not todo:
        return targets
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for n, t in todo.items():
        tmp = t.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for n, (tmp, p) in procs.items():
        log, _ = p.communicate()
        build_info[n] = {"seconds": time.perf_counter() - t0, "log": log}
        if p.returncode != 0:
            failed.append(f"{n}: nvcc exit {p.returncode}\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, todo[n])
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return targets


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = build([name])[name]
            lib = ctypes.CDLL(str(path))
            _libs[name] = lib
        return lib


def _host_compiler() -> str:
    found = shutil.which("c++")
    if found is None:
        raise RuntimeError("c++ not found on PATH: the port's host libraries are built from source with it")
    return found


def host_target(src: Path) -> Path:
    h = hashlib.sha256(Path(src).read_bytes())
    h.update(" ".join(HOST_FLAGS).encode())
    return BUILD_DIR / f"{Path(src).stem}-{h.hexdigest()[:16]}.so"


def build_host(src: Path) -> Path:
    """Compile a host C++ source into its library unless it is built."""
    src = Path(src)
    target = host_target(src)
    if target.exists():
        build_info.setdefault(src.stem, {"seconds": 0.0, "log": "cached"})
        return target
    cxx = _host_compiler()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    t0 = time.perf_counter()
    p = subprocess.run([cxx, *HOST_FLAGS, "-o", str(tmp), str(src)], stdout=subprocess.PIPE,
                       stderr=subprocess.STDOUT, text=True)
    version = subprocess.run([cxx, "--version"], capture_output=True, text=True).stdout.splitlines()[:1]
    build_info[src.stem] = {"seconds": time.perf_counter() - t0, "log": p.stdout,
                            "compiler": version[0] if version else cxx}
    if p.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"host build of {src.name} failed: c++ exit {p.returncode}\n{p.stdout}")
    os.replace(tmp, target)
    return target


def load_host(src: Path) -> ctypes.CDLL:
    """The loaded library of a host C++ source, built on first use."""
    key = str(Path(src).resolve())
    with _lock:
        lib = _libs.get(key)
        if lib is None:
            lib = ctypes.CDLL(str(build_host(src)))
            _libs[key] = lib
        return lib
