from acezero_tpu_torch.registration.lm import lm_pnp, reprojection_errors
from acezero_tpu_torch.registration.p3p import p3p_grunert, solve_quartic
from acezero_tpu_torch.registration.ransac import (
    RansacConfig,
    draw_hypothesis_indices,
    estimate_pose,
    estimate_poses_batch,
)

__all__ = [
    "p3p_grunert", "solve_quartic", "lm_pnp", "reprojection_errors", "RansacConfig",
    "draw_hypothesis_indices", "estimate_pose", "estimate_poses_batch",
]
