"""Scene dataset container and loader.

Counterpart of acezero_tpu/data/scene.py for these data definitions:
  - an RGB glob, optionally with a glob of 4x4 cam-to-world pose files;
  - an RGB glob with an ACE pose file and a confidence filter (the file
    names the frames and carries their poses and focal lengths);
  - a single-image pose seed (identity pose);
with the focal length from an external value, the heuristic (70% of the
original image diagonal), or the ACE pose file, in that order. Focals are
kept both in original pixels and in resized canvas pixels. Per-frame
calibration files are not ported yet.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from acezero_tpu_torch.data.images import DecodedImages, decode_to_canvas, heuristic_focal_length
from acezero_tpu_torch.io.pose_files import (
    get_files_from_glob,
    is_pose_valid,
    load_pose_files_glob,
    read_pose_file,
)

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
    # canvas-resolution metric depth per frame index (depth supervision)
    depth_maps: dict[int, np.ndarray] = field(default_factory=dict)

    def __len__(self) -> int:
        return len(self.rgb_files)

    @property
    def canvas_hw(self) -> tuple[int, int]:
        return self.images.canvas_hw

    @property
    def principal_point(self) -> tuple[float, float]:
        h, w = self.canvas_hw
        return w / 2.0, h / 2.0

    def mean_camera_center(self) -> np.ndarray:
        """Mean translation of the valid cam-to-world poses (the head's
        scene-mean buffer)."""
        valid = self.pose_valid & np.isfinite(self.poses_c2w).all(axis=(1, 2))
        if valid.sum() == 0:
            return np.zeros(3, np.float32)
        return self.poses_c2w[valid, :3, 3].mean(axis=0).astype(np.float32)

    def subset(self, indices, copy_canvases: bool = True) -> "SceneData":
        """The scene restricted to `indices`.

        copy_canvases=False skips the (k, H, W) host gather of the canvases:
        the subset's `images.canvases` is an all-zero stub and its content is
        read through `images.content()` from the root canvases, which the
        subset shares. The trainer and the registration driver read it so.
        """
        indices = np.asarray(indices)
        images = self.images
        if copy_canvases:
            canvases, root, root_indices = images.content(indices), None, None
        else:
            hc, wc = images.canvas_hw
            canvases = np.broadcast_to(np.zeros((1, hc, wc), np.uint8), (len(indices), hc, wc))
            if images.root is None:
                root, root_indices = images.canvases, indices
            else:
                root, root_indices = images.root, images.root_indices[indices]
        return SceneData(
            rgb_files=[self.rgb_files[i] for i in indices],
            images=DecodedImages(
                canvases=canvases,
                sizes=images.sizes[indices],
                orig_sizes=images.orig_sizes[indices],
                scale_factors=images.scale_factors[indices],
                root=root,
                root_indices=root_indices,
            ),
            poses_c2w=self.poses_c2w[indices],
            pose_valid=self.pose_valid[indices],
            focals_canvas=self.focals_canvas[indices],
            focals_orig=self.focals_orig[indices],
            depth_maps={j: self.depth_maps[i] for j, i in enumerate(indices) if i in self.depth_maps},
        )


def load_scene(
    rgb_files: str,
    pose_files: str | None = None,
    ace_pose_file: str | Path | None = None,
    ace_pose_file_conf_threshold: float | None = 1000.0,
    pose_seed: float = -1.0,
    image_short_size: int = 480,
    use_heuristic_focal_length: bool = False,
    external_focal_length: float | None = None,
    canvas_hw: tuple[int, int] | None = None,
    num_workers: int = 16,
) -> SceneData:
    """Load a scene following the reference's data-definition precedence:
    an ACE pose file (entries above the confidence threshold) over the RGB
    glob with `pose_files` (frames with a non-finite pose are dropped) over
    the bare glob; `pose_seed` >= 0 then keeps the single frame at that
    fraction of the list, with an identity pose."""
    focal_per_file: dict[str, float] = {}
    if ace_pose_file is not None:
        entries = read_pose_file(ace_pose_file, confidence_threshold=ace_pose_file_conf_threshold)
        files = [e.rgb_file for e in entries]
        poses = [e.pose_c2w for e in entries]
        focal_per_file = {e.rgb_file: e.focal_length for e in entries}
        pose_valid = np.ones(len(files), bool)
        if not files:
            raise ValueError(f"No entries above confidence threshold in {ace_pose_file}")
    else:
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

    if pose_seed > -1:
        seed_index = int(pose_seed * len(files))
        _logger.info("Seed dataset: image %d (%s)", seed_index, files[seed_index])
        files = [files[seed_index]]
        poses = [np.eye(4)]
        pose_valid = np.ones(1, bool)

    images = decode_to_canvas(files, short_size=image_short_size, canvas_hw=canvas_hw,
                              num_workers=num_workers)
    n = len(files)
    focals = np.zeros(n, np.float32)
    focals_orig = np.zeros(n, np.float32)
    for i, f in enumerate(files):
        if external_focal_length is not None:
            focal_orig = external_focal_length
        elif use_heuristic_focal_length:
            h0, w0 = images.orig_sizes[i]
            focal_orig = heuristic_focal_length(int(h0), int(w0))
        elif f in focal_per_file:
            focal_orig = focal_per_file[f]
        else:
            raise ValueError(
                "No focal length available: provide external_focal_length, enable "
                "use_heuristic_focal_length, or load from an ACE pose file."
            )
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
