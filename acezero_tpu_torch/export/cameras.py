"""Camera-frustum mesh export: one confidence-colored pyramid per pose.

Counterpart of acezero_tpu/export/cameras.py, byte for byte: a PLY mesh
with a small frustum for every pose-file entry, colored green (high
confidence) to red (zero), for quick inspection in any mesh viewer.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from acezero_tpu_torch.io.ply import write_ply_mesh
from acezero_tpu_torch.io.pose_files import PoseFileEntry

_FRUSTUM_FACES = np.array([[0, 1, 2], [0, 2, 3], [0, 3, 4], [0, 4, 1], [1, 2, 3], [1, 3, 4]])


def _frustum_vertices(size: float) -> np.ndarray:
    """5 vertices of a camera pyramid in camera space (apex at origin, +z)."""
    s = size
    return np.array([[0.0, 0.0, 0.0], [-s, -0.75 * s, 1.6 * s], [s, -0.75 * s, 1.6 * s], [s, 0.75 * s, 1.6 * s],
                     [-s, 0.75 * s, 1.6 * s]])


def _confidence_color(conf: float, conf_max: float = 2000.0) -> np.ndarray:
    t = min(max(conf / conf_max, 0.0), 1.0)
    return np.array([int(255 * (1 - t)), int(255 * t), 40], np.uint8)


def export_camera_meshes(path: str | Path, entries: list[PoseFileEntry], marker_size: float = 0.03,
                         conf_max: float = 2000.0) -> None:
    base_v = _frustum_vertices(marker_size)
    verts, faces, colors = [], [], []
    for i, e in enumerate(entries):
        c2w = e.pose_c2w
        verts.append(base_v @ c2w[:3, :3].T + c2w[:3, 3])
        faces.append(_FRUSTUM_FACES + 5 * i)
        colors.append(np.tile(_confidence_color(e.confidence, conf_max), (5, 1)))
    write_ply_mesh(path, np.concatenate(verts), np.concatenate(faces), vertex_colors=np.concatenate(colors))
