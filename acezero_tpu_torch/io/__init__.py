from acezero_tpu_torch.io.bmp import read_bmp, write_bmp
from acezero_tpu_torch.io.formats import image_size, pil_mode
from acezero_tpu_torch.io.gif import read_gif, write_gif
from acezero_tpu_torch.io.jpeg import read_jpeg, write_jpeg
from acezero_tpu_torch.io.ply import read_ply_points, write_ply_mesh, write_ply_points
from acezero_tpu_torch.io.png import write_png
from acezero_tpu_torch.io.pnm import read_pnm, write_pnm
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
from acezero_tpu_torch.io.tiff import read_tiff, write_tiff

__all__ = [
    "PoseFileEntry", "format_pose_line", "get_files_from_glob", "load_focal_length",
    "load_pose_matrix", "read_pose_file", "registration_rates", "write_pose_file", "read_ply_points",
    "write_ply_mesh", "write_ply_points", "image_size", "pil_mode", "write_png", "read_jpeg", "write_jpeg",
    "read_tiff", "write_tiff", "read_bmp", "write_bmp", "read_pnm", "write_pnm", "read_gif", "write_gif",
]
