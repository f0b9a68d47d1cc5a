from acezero_tpu_torch.evalpose.alignment import estimate_alignment
from acezero_tpu_torch.evalpose.evaluate import PoseErrors, evaluate_poses

__all__ = ["estimate_alignment", "evaluate_poses", "PoseErrors"]
