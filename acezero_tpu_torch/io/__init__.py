from acezero_tpu_torch.io.jpeg import read_jpeg, write_jpeg
from acezero_tpu_torch.io.ply import read_ply_points, write_ply_mesh, write_ply_points
from acezero_tpu_torch.io.png import image_size, write_png
from acezero_tpu_torch.io.pose_files import (
    PoseFileEntry,
    format_pose_line,
    get_files_from_glob,
    load_focal_length,
    load_pose_matrix,
    read_pose_file,
    registration_rates,
    write_pose_file,
)

__all__ = [
    "PoseFileEntry", "format_pose_line", "get_files_from_glob", "load_focal_length",
    "load_pose_matrix", "read_pose_file", "registration_rates", "write_pose_file", "read_ply_points",
    "write_ply_mesh", "write_ply_points", "image_size", "write_png", "read_jpeg", "write_jpeg",
]
