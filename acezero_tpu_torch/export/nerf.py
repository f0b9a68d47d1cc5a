"""Nerfstudio `transforms.json` export from ACE pose files.

Counterpart of acezero_tpu/export/nerf.py (the reference benchmark
preprocessing, benchmarks/preprocess_data.py), with the frame size read by
io/png.py::image_size instead of PIL:
  - w2c pose-file entries -> OpenGL (Blender) cam-to-world matrices
    (y/z axis flip applied in camera frame);
  - every globbed frame appears in `frames` even without a pose (identity
    transform, heuristic focal, confidence 0);
  - test split = every 8th frame (offset 4) of the alphabetically sorted
    list, or a precomputed split file {"train_filenames", "test_filenames"};
  - train frames with confidence < `train_conf_threshold` (1000) are
    dropped from `train_filenames`;
  - an adjacent `pc_final.ply` is copied and referenced as `ply_file_path`.
"""

from __future__ import annotations

import glob as _glob
import json
import logging
import shutil
from pathlib import Path

import numpy as np

from acezero_tpu_torch.io.png import image_size
from acezero_tpu_torch.io.pose_files import PoseFileEntry, read_pose_file

_logger = logging.getLogger(__name__)

_CV_TO_GL = np.diag([1.0, -1.0, -1.0, 1.0])


def opencv_to_opengl_c2w(c2w: np.ndarray) -> np.ndarray:
    """OpenCV cam-to-world -> OpenGL cam-to-world (camera-frame y/z flip)."""
    return c2w @ _CV_TO_GL


def _frame_dict(entry: PoseFileEntry) -> dict:
    return {
        "file_path": entry.rgb_file,
        "transform_matrix": opencv_to_opengl_c2w(entry.pose_c2w).tolist(),
        "confidence_score": entry.confidence,
        "fl_x": entry.focal_length,
        "fl_y": entry.focal_length,
    }


def _identity_frame(file_path: str, height: int) -> dict:
    return {
        "file_path": file_path,
        "transform_matrix": np.eye(4).tolist(),
        "fl_x": height * 0.7,
        "fl_y": height * 0.7,
        "confidence_score": 0.0,
    }


def _default_split(frames: list[dict], sample_interval: int = 8) -> dict:
    frames_sorted = sorted(frames, key=lambda f: f["file_path"])
    test_idxs = set(range(sample_interval // 2, len(frames_sorted), sample_interval))
    return {
        "train": [f for i, f in enumerate(frames_sorted) if i not in test_idxs],
        "test": [f for i, f in enumerate(frames_sorted) if i in test_idxs],
    }


def _precomputed_split(frames: list[dict], split_file: Path) -> dict:
    with open(split_file) as f:
        split = json.load(f)
    train_set = set(split["train_filenames"])
    test_set = set(split["test_filenames"])
    out = {"train": [], "test": []}
    for frame in frames:
        if frame["file_path"] in train_set:
            out["train"].append(frame)
        elif frame["file_path"] in test_set:
            out["test"].append(frame)
        else:
            raise ValueError(f"Frame {frame['file_path']} not in split file {split_file}")
    return out


def export_transforms_json(
    pose_file: str | Path,
    images_glob_pattern: str,
    output_dir: str | Path,
    split_file: str | Path | None = None,
    train_conf_threshold: float = 1000.0,
) -> Path:
    """Write `<output_dir>/transforms.json`; returns its path."""
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)

    entries = read_pose_file(pose_file)
    by_file = {e.rgb_file: e for e in entries}

    files = _glob.glob(images_glob_pattern)
    if not files:
        raise FileNotFoundError(f"No frames matching {images_glob_pattern}")

    resolutions = {image_size(f)[::-1] for f in files}
    if len(resolutions) != 1:
        raise ValueError(f"Expected a single frame resolution, got {resolutions}")
    height, width = next(iter(resolutions))

    frames = []
    for f in files:
        if f in by_file:
            frame = _frame_dict(by_file[f])
        else:
            _logger.warning("No pose for frame %s; using identity.", f)
            frame = _identity_frame(f, height)
        frame.update({"k1": 0.0, "k2": 0.0, "p1": 0.0, "p2": 0.0, "cx": width / 2.0, "cy": height / 2.0,
                      "w": width, "h": height})
        frames.append(frame)

    split = _precomputed_split(frames, Path(split_file)) if split_file else _default_split(frames)
    split["train"] = [f for f in split["train"] if f["confidence_score"] >= train_conf_threshold]
    if not split["train"]:
        raise ValueError("No train frames above the confidence threshold.")

    transforms = {
        "frames": frames,
        "train_filenames": [f["file_path"] for f in split["train"]],
        "val_filenames": [],
        "test_filenames": [f["file_path"] for f in split["test"]],
    }

    pc_file = Path(pose_file).parent / "pc_final.ply"
    if pc_file.exists():
        shutil.copy(pc_file, output_dir / "pc_final.ply")
        transforms["ply_file_path"] = "pc_final.ply"

    out = output_dir / "transforms.json"
    with open(out, "w") as f:
        json.dump(transforms, f)
    _logger.info("Wrote %s (%d frames, %d train / %d test)", out, len(frames), len(transforms["train_filenames"]),
                 len(transforms["test_filenames"]))
    return out
