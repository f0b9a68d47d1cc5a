"""Binary and ASCII PLY writers for point clouds and triangle meshes.

Counterpart of acezero_tpu/io/ply.py: the same header lines and records,
byte for byte (x, y, z float32, then red, green, blue uint8 when colours
are given; faces as a uchar count and three int32 indices).
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np


def write_ply_points(path: str | Path, xyz: np.ndarray, rgb: np.ndarray | None = None,
                     binary: bool = True) -> None:
    """Write a point cloud PLY. xyz: (n, 3) float; rgb: (n, 3) uint8 or None."""
    xyz = np.asarray(xyz, dtype=np.float32)
    n = xyz.shape[0]
    has_color = rgb is not None
    if has_color:
        rgb = np.asarray(rgb)
        if rgb.dtype != np.uint8:
            rgb = np.clip(rgb, 0, 255).astype(np.uint8)

    header = ["ply", "format binary_little_endian 1.0" if binary else "format ascii 1.0", f"element vertex {n}",
              "property float x", "property float y", "property float z"]
    if has_color:
        header += ["property uchar red", "property uchar green", "property uchar blue"]
    header.append("end_header")

    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        if binary:
            if has_color:
                rec = np.zeros(n, dtype=[("xyz", np.float32, 3), ("rgb", np.uint8, 3)])
                rec["xyz"] = xyz
                rec["rgb"] = rgb
                f.write(rec.tobytes())
            else:
                f.write(xyz.astype("<f4").tobytes())
        else:
            for i in range(n):
                line = f"{xyz[i, 0]} {xyz[i, 1]} {xyz[i, 2]}"
                if has_color:
                    line += f" {rgb[i, 0]} {rgb[i, 1]} {rgb[i, 2]}"
                f.write((line + "\n").encode("ascii"))


def write_ply_mesh(path: str | Path, vertices: np.ndarray, faces: np.ndarray,
                   vertex_colors: np.ndarray | None = None) -> None:
    """Write a triangle mesh PLY (binary). vertices (n, 3) f32, faces (m, 3) int."""
    vertices = np.asarray(vertices, dtype=np.float32)
    faces = np.asarray(faces, dtype=np.int32)
    n, m = vertices.shape[0], faces.shape[0]
    has_color = vertex_colors is not None
    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}",
              "property float x", "property float y", "property float z"]
    if has_color:
        vertex_colors = np.clip(np.asarray(vertex_colors), 0, 255).astype(np.uint8)
        header += ["property uchar red", "property uchar green", "property uchar blue"]
    header += [f"element face {m}", "property list uchar int vertex_indices", "end_header"]

    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        if has_color:
            rec = np.zeros(n, dtype=[("xyz", np.float32, 3), ("rgb", np.uint8, 3)])
            rec["xyz"] = vertices
            rec["rgb"] = vertex_colors
            f.write(rec.tobytes())
        else:
            f.write(vertices.astype("<f4").tobytes())
        f.write(b"".join(struct.pack("<Biii", 3, int(a), int(b), int(c)) for a, b, c in faces))


def read_ply_points(path: str | Path) -> tuple[np.ndarray, np.ndarray | None]:
    """(xyz (n, 3) float32, rgb (n, 3) uint8 or None) of a binary point PLY
    that write_ply_points wrote."""
    data = Path(path).read_bytes()
    end = data.index(b"end_header\n") + len(b"end_header\n")
    header = data[:end].decode("ascii").splitlines()
    if header[0] != "ply" or header[1] != "format binary_little_endian 1.0":
        raise ValueError(f"{path}: not a binary little-endian PLY")
    n = int(next(ln.split()[2] for ln in header if ln.startswith("element vertex")))
    has_color = "property uchar red" in header
    dtype = [("xyz", "<f4", 3)] + ([("rgb", np.uint8, 3)] if has_color else [])
    rec = np.frombuffer(data, dtype=dtype, count=n, offset=end)
    return rec["xyz"].copy(), rec["rgb"].copy() if has_color else None
