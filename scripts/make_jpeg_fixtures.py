#!/usr/bin/env python3
"""Write the JPEG fixtures that hold the port's codec to PIL's bits where
there is no PIL (the card's machine): small JPEGs made by PIL under
tests/data/jpeg/, one for each kind of file the decoder reads, and
tests/data/jpeg/pil_digests.json with

- "files": for each fixture, the shape and the sha256 of PIL's decoded
  array (`np.asarray(Image.open(path))`);
- "roundtrip": for each of chip_smoke.JPEG_ROUNDTRIP's frames
  (chip_smoke.jpeg_roundtrip_frame), the sha256 of the bytes PIL writes at
  that quality and subsampling and of PIL's decode of them.

    python3 scripts/make_jpeg_fixtures.py

tests/test_torch_jpeg.py checks the digests against PIL on every run, so
the file cannot go stale; chip_smoke.py's phase jpeg checks the port
against them on the card.
"""

from __future__ import annotations

import hashlib
import io
import json
import sys
from pathlib import Path

import numpy as np
from PIL import Image

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

OUT = chip_smoke.JPEG_FIXTURES
# name: (height, width, PIL mode, save options)
FIXTURES = {
    "gray_q75.jpg": (48, 64, "L", {"quality": 75}),
    "gray_progressive.jpg": (37, 53, "L", {"quality": 90, "progressive": True}),
    "rgb444_q95.jpg": (48, 64, "RGB", {"quality": 95, "subsampling": "4:4:4"}),
    "rgb422_q50.jpg": (37, 53, "RGB", {"quality": 50, "subsampling": "4:2:2"}),
    "rgb420_q75.jpg": (37, 53, "RGB", {"quality": 75, "subsampling": "4:2:0"}),
    "rgb420_q100.jpg": (48, 64, "RGB", {"quality": 100, "subsampling": "4:2:0"}),
    "rgb420_progressive.jpg": (37, 53, "RGB", {"quality": 90, "progressive": True}),
    "rgb444_progressive.jpg": (48, 64, "RGB", {"quality": 75, "subsampling": "4:4:4", "progressive": True}),
    "rgb420_optimize.jpg": (48, 64, "RGB", {"quality": 90, "optimize": True}),
    "rgb420_restart_blocks3.jpg": (37, 53, "RGB", {"quality": 75, "restart_marker_blocks": 3}),
    "rgb444_restart_rows1.jpg": (17, 33, "RGB", {"quality": 95, "subsampling": "4:4:4", "restart_marker_rows": 1}),
    "rgb420_7x9.jpg": (7, 9, "RGB", {"quality": 75}),
}


def fixture_image(h: int, w: int, mode: str, seed: int) -> Image.Image:
    """A smooth ramp plus noise, from a seed."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w]
    base = np.stack([xx * 255 / max(w - 1, 1), yy * 255 / max(h - 1, 1), (xx + yy) * 127 / max(h + w - 2, 1)], -1)
    img = Image.fromarray(np.clip(base + rng.normal(0, 20, (h, w, 3)), 0, 255).astype(np.uint8))
    return img.convert("L") if mode == "L" else img


def pil_jpeg_bytes(img: np.ndarray, quality: int, subsampling: str) -> bytes:
    """PIL's file for `img`, as Image.fromarray(img).save(path, ...) writes
    it (a gray image takes no subsampling option, as a plain save)."""
    buf = io.BytesIO()
    kw = {} if img.ndim == 2 else {"subsampling": subsampling}
    Image.fromarray(img).save(buf, format="JPEG", quality=quality, **kw)
    return buf.getvalue()


def digests() -> dict:
    files = {}
    for name in FIXTURES:
        arr = np.asarray(Image.open(OUT / name))
        files[name] = {"shape": list(arr.shape), "sha256": chip_smoke.array_digest(arr)}
    roundtrip = []
    for i, (quality, subsampling) in enumerate(chip_smoke.JPEG_ROUNDTRIP):
        img = chip_smoke.jpeg_roundtrip_frame(np, i)
        data = pil_jpeg_bytes(img, quality, subsampling)
        arr = np.asarray(Image.open(io.BytesIO(data)))
        roundtrip.append({"frame": i, "quality": quality, "subsampling": subsampling, "shape": list(arr.shape),
                          "bytes_sha256": hashlib.sha256(data).hexdigest(),
                          "sha256": chip_smoke.array_digest(arr)})
    return {"files": files, "roundtrip": roundtrip}


def main() -> None:
    OUT.mkdir(parents=True, exist_ok=True)
    for i, (name, (h, w, mode, opts)) in enumerate(FIXTURES.items()):
        fixture_image(h, w, mode, seed=i).save(OUT / name, **opts)
    (OUT / "pil_digests.json").write_text(json.dumps(digests(), indent=1) + "\n")
    total = sum(p.stat().st_size for p in OUT.iterdir())
    print(f"wrote {len(FIXTURES)} fixtures and pil_digests.json to {OUT} ({total} bytes)")


if __name__ == "__main__":
    main()
