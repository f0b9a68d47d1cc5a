"""Scene dataset container and loader.

Counterpart of acezero_tpu/data/scene.py for the branches registration
uses: an RGB glob, optionally a glob of 4x4 cam-to-world pose files, and
the focal length from an external value or the heuristic (70% of the
original image diagonal). Focals are kept both in original pixels and in
resized canvas pixels.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass

import numpy as np

from acezero_tpu_torch.data.images import DecodedImages, decode_to_canvas, heuristic_focal_length
from acezero_tpu_torch.io.pose_files import get_files_from_glob, is_pose_valid, load_pose_files_glob

_logger = logging.getLogger(__name__)


@dataclass
class SceneData:
    """Per-scene host state."""

    rgb_files: list[str]
    images: DecodedImages
    poses_c2w: np.ndarray  # (N, 4, 4) float32, identity when unknown
    pose_valid: np.ndarray  # (N,) bool
    focals_canvas: np.ndarray  # (N,) float32, canvas-pixel focal lengths
    focals_orig: np.ndarray  # (N,) float32, original-pixel focal lengths

    def __len__(self) -> int:
        return len(self.rgb_files)

    @property
    def canvas_hw(self) -> tuple[int, int]:
        return self.images.canvas_hw


def load_scene(
    rgb_files: str,
    pose_files: str | None = None,
    image_short_size: int = 480,
    use_heuristic_focal_length: bool = False,
    external_focal_length: float | None = None,
    canvas_hw: tuple[int, int] | None = None,
    num_workers: int = 16,
) -> SceneData:
    """Load a scene: files from `rgb_files`, poses from `pose_files` (frames
    with a non-finite pose are dropped), focal from `external_focal_length`
    or the heuristic."""
    files = get_files_from_glob(rgb_files)
    if pose_files is not None:
        poses = load_pose_files_glob(pose_files)
        if len(poses) != len(files):
            raise ValueError(f"{len(files)} rgb files but {len(poses)} pose files for {pose_files}")
        keep = [i for i, p in enumerate(poses) if is_pose_valid(p)]
        if len(keep) < len(files):
            _logger.warning("Dropping %d invalid poses", len(files) - len(keep))
        files = [files[i] for i in keep]
        poses = [poses[i] for i in keep]
        pose_valid = np.ones(len(files), bool)
    else:
        poses = [np.eye(4) for _ in files]
        pose_valid = np.zeros(len(files), bool)
    if external_focal_length is None and not use_heuristic_focal_length:
        raise ValueError(
            "No focal length available: provide external_focal_length or enable "
            "use_heuristic_focal_length."
        )

    images = decode_to_canvas(files, short_size=image_short_size, canvas_hw=canvas_hw,
                              num_workers=num_workers)
    n = len(files)
    focals = np.zeros(n, np.float32)
    focals_orig = np.zeros(n, np.float32)
    for i in range(n):
        if external_focal_length is not None:
            focal_orig = external_focal_length
        else:
            h0, w0 = images.orig_sizes[i]
            focal_orig = heuristic_focal_length(int(h0), int(w0))
        focals_orig[i] = focal_orig
        focals[i] = focal_orig * images.scale_factors[i]

    return SceneData(
        rgb_files=files,
        images=images,
        poses_c2w=np.asarray(poses, np.float32).reshape(n, 4, 4),
        pose_valid=pose_valid,
        focals_canvas=focals,
        focals_orig=focals_orig,
    )
