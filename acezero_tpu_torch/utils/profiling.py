"""Stage timers and optional torch.profiler traces.

Counterpart of acezero_tpu/utils/profiling.py, with the same stage names
and report format. `stage` synchronizes the CUDA device before it reads
the clock on entry and on exit, so a stage's time is the time of its
device work, not of its dispatch. With ACEZERO_TRACE_DIR set,
`stage(name, trace=True)` writes a torch.profiler trace (Chrome trace JSON)
of the stage to `<ACEZERO_TRACE_DIR>/<name>/`.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from collections import defaultdict

import torch

_logger = logging.getLogger(__name__)

_STAGE_TOTALS: dict[str, float] = defaultdict(float)
_STAGE_COUNTS: dict[str, int] = defaultdict(int)


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def _trace(path: str):
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(path, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
        _sync()
    prof.export_chrome_trace(os.path.join(path, f"trace_{time.strftime('%Y%m%d_%H%M%S')}_{os.getpid()}.json"))


_OPEN: list[list[float]] = []  # seconds carved out of each open stage, innermost last


@contextlib.contextmanager
def stage(name: str, trace: bool = False, carve: bool = False):
    """Time a pipeline stage; optionally capture a device trace of it. A
    stage with `carve` is taken out of the stages it runs inside (the
    render hook inside `mapping`); other nested stages count in both."""
    trace_dir = os.environ.get("ACEZERO_TRACE_DIR")
    ctx = _trace(os.path.join(trace_dir, name)) if trace and trace_dir else contextlib.nullcontext()
    _sync()
    t0 = time.time()
    carved = [0.0]
    _OPEN.append(carved)
    try:
        with ctx:
            yield
        _sync()
    finally:
        _OPEN.pop()
    dt = time.time() - t0
    if carve:
        for outer in _OPEN:
            outer[0] += dt
    _STAGE_TOTALS[name] += dt - carved[0]
    _STAGE_COUNTS[name] += 1
    _logger.debug("stage %s: %.2fs", name, dt)


def stage_totals() -> dict[str, tuple[float, int]]:
    """{stage: (total seconds, calls)}."""
    return {name: (_STAGE_TOTALS[name], _STAGE_COUNTS[name]) for name in _STAGE_TOTALS}


def stage_report() -> str:
    """Human-readable per-stage totals."""
    lines = ["stage                          total_s  calls"]
    for name in sorted(_STAGE_TOTALS, key=lambda n: -_STAGE_TOTALS[n]):
        lines.append(f"{name:30s} {_STAGE_TOTALS[name]:8.1f} {_STAGE_COUNTS[name]:6d}")
    return "\n".join(lines)


def reset_stages() -> None:
    _STAGE_TOTALS.clear()
    _STAGE_COUNTS.clear()
