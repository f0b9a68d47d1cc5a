"""Novel-view-synthesis benchmark wrapper (Nerfstudio CLI orchestration).

Counterpart of acezero_tpu/export/nerfstudio_runner.py (the reference
benchmarks/run_benchmark.py + run_nerfstudio.py): convert an ACE pose file
to transforms.json, cap the test set and downscale the images to at most
640 pixels a side, shell out to `ns-train nerfacto|splatfacto` and
`ns-eval`, and collect PSNR/SSIM/LPIPS from eval.json. Nerfstudio is an
external dependency that this module never installs; without its CLIs it
raises RuntimeError naming the missing one.

The downscale is PIL's bilinear resize of 8-bit gray or RGB PNGs
(data/images.py::pil_resize_bilinear) written by io/png.py. There is no
JPEG codec here: a JPEG (or any other source) that needs downscaling
raises ValueError, where the JAX package resizes it with PIL.
"""

from __future__ import annotations

import json
import logging
import shutil
import subprocess
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from acezero_tpu_torch.data.images import pil_resize_bilinear, read_png
from acezero_tpu_torch.export.nerf import export_transforms_json
from acezero_tpu_torch.io.png import image_size, write_png

_logger = logging.getLogger(__name__)

MAX_TEST_IMAGES = 1000  # reference run_benchmark.py:96-114
MAX_IMAGE_SIDE = 640  # reference auto-downscales to <=640 px
PRELOAD_MAX_FRAMES = 3500  # preload-to-GPU heuristic, run_benchmark.py:244-252


@dataclass
class NerfBenchmarkConfig:
    method: str = "nerfacto"  # nerfacto | splatfacto
    downscale: bool = True
    max_test_images: int = MAX_TEST_IMAGES
    extra_train_args: tuple = ()


def _require_cli(name: str) -> str:
    path = shutil.which(name)
    if path is None:
        raise RuntimeError(
            f"`{name}` not found on PATH. The view-synthesis benchmark needs a "
            "Nerfstudio installation (the reference runs it in a dedicated "
            "conda environment, scripts/reconstruct_7scenes.sh)."
        )
    return path


def _resized_png(src: Path, new_w: int, new_h: int) -> np.ndarray:
    """PIL's `Image.open(src).resize((new_w, new_h), BILINEAR)` of an 8-bit
    gray or RGB PNG."""
    try:
        img = read_png(src)
    except ValueError as exc:
        raise ValueError(f"{src} needs downscaling, and only PNGs can be decoded here (there is no JPEG codec): "
                         f"{exc}; downscale the images beforehand or pass downscale=False") from exc
    if img.dtype != np.uint8 or not (img.ndim == 2 or img.shape[2] == 3):
        raise ValueError(f"{src}: only 8-bit gray or RGB PNGs can be downscaled here, got {img.dtype} {img.shape}")
    return pil_resize_bilinear(img, new_h, new_w)


def _downscale_images(transforms_path: Path, workdir: Path) -> None:
    with open(transforms_path) as f:
        transforms = json.load(f)
    img_dir = workdir / "images_downscaled"
    img_dir.mkdir(exist_ok=True)
    for frame in transforms["frames"]:
        src = Path(frame["file_path"])
        width, height = image_size(src)
        scale = MAX_IMAGE_SIDE / max(width, height)
        if scale >= 1.0:
            continue
        new_size = (round(width * scale), round(height * scale))
        dst = img_dir / src.name
        write_png(dst, _resized_png(src, *new_size))
        for key, factor in (("fl_x", scale), ("fl_y", scale), ("cx", scale), ("cy", scale)):
            frame[key] = frame[key] * factor
        frame["w"], frame["h"] = new_size
        # update filename references in splits
        for split_key in ("train_filenames", "test_filenames"):
            transforms[split_key] = [str(dst) if f == frame["file_path"] else f for f in transforms[split_key]]
        frame["file_path"] = str(dst)
    with open(transforms_path, "w") as f:
        json.dump(transforms, f)


def run_benchmark(
    pose_file: str | Path,
    images_glob_pattern: str,
    output_dir: str | Path,
    cfg: NerfBenchmarkConfig = NerfBenchmarkConfig(),
    split_file: str | Path | None = None,
) -> dict:
    """Full benchmark: convert -> ns-train -> ns-eval -> metrics dict."""
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)

    transforms_path = export_transforms_json(pose_file, images_glob_pattern, output_dir, split_file=split_file)

    with open(transforms_path) as f:
        transforms = json.load(f)
    if len(transforms["test_filenames"]) > cfg.max_test_images:
        transforms["test_filenames"] = transforms["test_filenames"][: cfg.max_test_images]
        with open(transforms_path, "w") as f:
            json.dump(transforms, f)

    if cfg.downscale:
        _downscale_images(transforms_path, output_dir)

    ns_train = _require_cli("ns-train")
    ns_eval = _require_cli("ns-eval")

    n_frames = len(transforms["frames"])
    train_cmd = [
        ns_train,
        cfg.method,
        "--data", str(output_dir),
        "--output-dir", str(output_dir / "runs"),
        "--experiment-name", cfg.method,
        "--timestamp", "run",
        "--viewer.quit-on-train-completion", "True",
        "--pipeline.datamanager.images-on-gpu",
        "True" if n_frames <= PRELOAD_MAX_FRAMES else "False",
        *cfg.extra_train_args,
        "nerfstudio-data",
        "--eval-mode", "filename",
    ]
    _logger.info("Running: %s", " ".join(train_cmd))
    subprocess.run(train_cmd, check=True)

    run_dir = output_dir / "runs" / cfg.method / cfg.method / "run"
    eval_json = run_dir / "eval.json"
    eval_cmd = [ns_eval, "--load-config", str(run_dir / "config.yml"), "--output-path", str(eval_json)]
    _logger.info("Running: %s", " ".join(eval_cmd))
    subprocess.run(eval_cmd, check=True)

    with open(eval_json) as f:
        results = json.load(f)["results"]
    _logger.info("Benchmark %s: psnr %.2f ssim %.3f lpips %.3f", cfg.method, results.get("psnr", -1),
                 results.get("ssim", -1), results.get("lpips", -1))
    return results


def collect_results(results_root: str | Path) -> dict[str, dict]:
    """Walk scene subfolders and collect eval.json metrics (the reference
    scripts/show_benchmark_results.py behavior)."""
    out = {}
    for eval_json in sorted(Path(results_root).glob("**/eval.json")):
        with open(eval_json) as f:
            out[str(eval_json.parent)] = json.load(f).get("results", {})
    return out
