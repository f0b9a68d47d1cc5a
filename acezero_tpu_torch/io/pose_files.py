"""ACE pose-file I/O, byte-compatible with the reference text format.

Counterpart of acezero_tpu/io/pose_files.py. One line per frame:

    rgb_file qw qx qy qz tx ty tz focal_length confidence

with the pose stored world-to-camera. The quaternion conversion is written
out here in float64 numpy with the same operations, branch choice and
normalisation as scipy's `Rotation.from_matrix(m).as_quat()`, so the text
is byte-identical to the JAX package's writer.
"""

from __future__ import annotations

import glob as _glob
import math
from dataclasses import dataclass
from pathlib import Path
from typing import Iterable

import numpy as np


@dataclass
class PoseFileEntry:
    """One line of an ACE pose file."""

    rgb_file: str
    pose_w2c: np.ndarray  # (4, 4)
    focal_length: float
    confidence: float

    @property
    def pose_c2w(self) -> np.ndarray:
        return np.linalg.inv(self.pose_w2c)


def _matrix_to_quat_xyzw(m: np.ndarray) -> np.ndarray:
    """Unit quaternion (x, y, z, w) of a 3x3 rotation, as scipy computes it:
    project a non-orthogonal matrix with an SVD, pick the largest of the
    diagonal and the trace, normalise by the square root of the sum of
    squares."""
    m = np.asarray(m, np.float64)
    if np.linalg.det(m) <= 0:
        raise ValueError(f"Non-positive determinant in rotation matrix: {m}")
    if not np.all(np.isclose(m @ m.T, np.eye(3), atol=1e-12)):
        u, _, vt = np.linalg.svd(m, full_matrices=False)
        m = u @ vt
    tr = m[0, 0] + m[1, 1] + m[2, 2]
    choice = int(np.argmax([m[0, 0], m[1, 1], m[2, 2], tr]))
    if choice == 0:
        q = [1 - tr + 2 * m[0, 0], m[1, 0] + m[0, 1], m[2, 0] + m[0, 2], m[2, 1] - m[1, 2]]
    elif choice == 1:
        q = [m[1, 0] + m[0, 1], 1 - tr + 2 * m[1, 1], m[2, 1] + m[1, 2], m[0, 2] - m[2, 0]]
    elif choice == 2:
        q = [m[2, 0] + m[0, 2], m[2, 1] + m[1, 2], 1 - tr + 2 * m[2, 2], m[1, 0] - m[0, 1]]
    else:
        q = [m[2, 1] - m[1, 2], m[0, 2] - m[2, 0], m[1, 0] - m[0, 1], 1 + tr]
    norm = math.sqrt(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3])
    return np.array([c / norm for c in q])


def _quat_xyzw_to_matrix(q) -> np.ndarray:
    x, y, z, w = np.asarray(q, np.float64) / np.linalg.norm(q)
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ]
    )


def format_pose_line(
    rgb_file: str, pose_w2c: np.ndarray, focal_length: float, confidence: float
) -> str:
    """One pose-file line, exactly like the reference writer."""
    pose = np.asarray(pose_w2c, dtype=np.float64)
    q_xyzw = _matrix_to_quat_xyzw(pose[:3, :3])
    t = pose[:3, 3]
    return (
        f"{rgb_file} "
        f"{q_xyzw[3]} {q_xyzw[0]} {q_xyzw[1]} {q_xyzw[2]} "
        f"{t[0]} {t[1]} {t[2]} {focal_length} {confidence}\n"
    )


def write_pose_file(path: str | Path, entries: Iterable[PoseFileEntry]) -> None:
    with open(path, "w") as f:
        for e in entries:
            f.write(format_pose_line(e.rgb_file, e.pose_w2c, e.focal_length, e.confidence))


def read_pose_file(path: str | Path, confidence_threshold: float | None = None) -> list[PoseFileEntry]:
    """Parse an ACE pose file (10 tokens a line, quaternion w first,
    world-to-camera); optionally drop low-confidence entries."""
    entries: list[PoseFileEntry] = []
    with open(path, "r") as f:
        for line in f:
            tokens = line.split()
            if not tokens:
                continue
            if len(tokens) != 10:
                raise ValueError(
                    f"Expected 10 tokens per pose-file line, got {len(tokens)}: {line!r}"
                )
            confidence = float(tokens[9])
            if confidence_threshold is not None and confidence < confidence_threshold:
                continue
            qw, qx, qy, qz = (float(t) for t in tokens[1:5])
            pose = np.eye(4)
            pose[:3, :3] = _quat_xyzw_to_matrix([qx, qy, qz, qw])
            pose[:3, 3] = [float(t) for t in tokens[5:8]]
            entries.append(
                PoseFileEntry(
                    rgb_file=tokens[0], pose_w2c=pose,
                    focal_length=float(tokens[8]), confidence=confidence,
                )
            )
    return entries


def load_pose_matrix(path: str | Path) -> np.ndarray:
    """A single 4x4 pose matrix text file (cam-to-world by convention)."""
    pose = np.loadtxt(path).astype(np.float64)
    if pose.shape != (4, 4):
        raise ValueError(f"Expected 4x4 pose in {path}, got shape {pose.shape}")
    return pose


def load_pose_files_glob(pattern: str) -> list[np.ndarray]:
    """All 4x4 pose files matching a glob, sorted alphabetically."""
    return [load_pose_matrix(p) for p in sorted(_glob.glob(pattern))]


def load_focal_length(path: str | Path) -> float:
    """A focal length from a scalar file or a 3x3 K (K[0, 0])."""
    data = np.loadtxt(path)
    if data.size > 1:
        return float(np.atleast_2d(data)[0, 0])
    return float(data)


def get_files_from_glob(pattern: str) -> list[str]:
    """Sorted files of a glob (alphabetical order pairs every sidecar)."""
    files = sorted(_glob.glob(pattern))
    if not files:
        raise FileNotFoundError(f"No files found for glob pattern: {pattern}")
    return files


def is_pose_valid(pose: np.ndarray) -> bool:
    return bool(np.isfinite(pose).all())
