from acezero_tpu_torch.reconstruct.config import AceZeroConfig
from acezero_tpu_torch.reconstruct.pipeline import AceZeroPipeline

__all__ = ["AceZeroConfig", "AceZeroPipeline"]
