#!/usr/bin/env python3
"""Write the fixtures that hold the port's Nerfstudio runner downscale to
PIL's where there is no PIL (the card's machine):

- tests/data/runner/palette.png and bilevel.png: the runner sources of
  modes P and 1 (chip_smoke.RUNNER_SOURCES) as PIL's own files, saved by
  PIL from chip_smoke.runner_source's pixels; and the GIF sources (P, L,
  P with chip_smoke.RUNNER_GIF_TRANSPARENCY's index), saved by PIL;
- tests/data/runner/pil_digests.json: for each runner source, the sha256
  of chip_smoke.runner_source's pixels, and what the JAX runner's
  downscale (PIL's `resize(BILINEAR)` and `save`) makes of the source that
  chip_smoke.write_runner_sources writes: the frame's new size, focal and
  principal point, the output's bytes (a JPEG, TGA, SGI, PCX or QOI),
  and but for a JPEG its mode, its pixels as PIL opens it and its
  `convert("RGB")` (a mode-P output's indices, a mode-1 output's bits; for
  a GIF also the palette, as chip_smoke.palette_digest, and the
  transparency index).

    python3 scripts/make_runner_fixtures.py

tests/test_torch_jpeg.py checks the digests against PIL, the JAX runner
and the port on every run, so the file cannot go stale; chip_smoke.py's
phase render checks the port against them on the card.
"""

from __future__ import annotations

import hashlib
import json
import sys
import tempfile
from pathlib import Path

import numpy as np
from PIL import Image

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

OUT = chip_smoke.RUNNER_FIXTURES


def write_fixtures() -> None:
    """The P, 1 and GIF sources, saved by PIL."""
    OUT.mkdir(parents=True, exist_ok=True)
    for name, (kind, _) in chip_smoke.RUNNER_SOURCES.items():
        if kind == "P":
            img = Image.fromarray(chip_smoke.runner_source(np, name), "P")
            img.putpalette([c for rgb in chip_smoke.RUNNER_PALETTE for c in rgb])
            if name in chip_smoke.RUNNER_GIF_TRANSPARENCY:
                img.info["transparency"] = chip_smoke.RUNNER_GIF_TRANSPARENCY[name]
            img.save(OUT / name)
        elif kind == "1" or name.endswith(".gif"):
            Image.fromarray(chip_smoke.runner_source(np, name)).save(OUT / name)


def digests(work: Path) -> dict:
    """PIL's results for every runner source, the sources written into `work`."""
    from acezero_tpu.export import nerfstudio_runner as jrunner

    paths = chip_smoke.write_runner_sources(np, work / "sources")
    frames = chip_smoke.runner_downscale(jrunner, paths, work / "jax")
    out = {}
    for name, fr in frames.items():
        entry = {"source_sha256": chip_smoke.array_digest(chip_smoke.runner_source(np, name)),
                 **{k: fr[k] for k in ("w", "h", "fl_x", "fl_y", "cx", "cy")}}
        if name.endswith(chip_smoke.RUNNER_BYTES_SUFFIXES):
            entry["bytes_sha256"] = hashlib.sha256(Path(fr["file_path"]).read_bytes()).hexdigest()
        if not name.endswith(".jpg"):
            with Image.open(fr["file_path"]) as img:
                arr = np.asarray(img)
                entry.update(mode=img.mode, shape=list(arr.shape), sha256=chip_smoke.array_digest(arr),
                             rgb_sha256=chip_smoke.array_digest(np.asarray(img.convert("RGB"))))
                if name.endswith(".gif"):
                    entry.update(palette=chip_smoke.palette_digest(np, img.getpalette()),
                                 transparency=img.info.get("transparency"))
        out[name] = entry
    return out


def main() -> None:
    write_fixtures()
    with tempfile.TemporaryDirectory() as tmp:
        table = digests(Path(tmp))
    (OUT / "pil_digests.json").write_text(json.dumps(table, indent=1, sort_keys=True) + "\n")
    committed = sum(k in ("P", "1") or n.endswith(".gif") for n, (k, _) in chip_smoke.RUNNER_SOURCES.items())
    print(f"wrote {len(table)} digests and {committed} fixtures to {OUT}")


if __name__ == "__main__":
    main()
