from acezero_tpu_torch.geometry.projection import (
    OUTPUT_SUBSAMPLE,
    backproject_depth,
    get_pixel_grid,
    make_intrinsics,
    project_points,
)
from acezero_tpu_torch.geometry.rotations import (
    matrix_to_quat_wxyz,
    matrix_to_rodrigues,
    quat_wxyz_to_matrix,
    rodrigues_to_matrix,
    rotation_angle,
    special_gramschmidt,
    special_procrustes,
)
from acezero_tpu_torch.geometry.transforms import compose_se3, invert_se3, make_se3, to_homogeneous

__all__ = [
    "OUTPUT_SUBSAMPLE", "backproject_depth", "get_pixel_grid", "make_intrinsics",
    "project_points", "matrix_to_quat_wxyz", "matrix_to_rodrigues", "quat_wxyz_to_matrix",
    "rodrigues_to_matrix", "rotation_angle", "special_gramschmidt", "special_procrustes", "compose_se3",
    "invert_se3", "make_se3", "to_homogeneous",
]
