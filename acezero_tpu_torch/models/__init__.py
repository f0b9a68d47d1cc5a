from acezero_tpu_torch.models import torch_io
from acezero_tpu_torch.models.encoder import ENCODER_OUT_CHANNELS, encoder_apply, init_encoder_params
from acezero_tpu_torch.models.head import HeadConfig, head_apply_flat, head_apply_image, init_head_params
from acezero_tpu_torch.models.posenet import init_posenet_params, posenet_apply

__all__ = ["init_encoder_params", "encoder_apply", "ENCODER_OUT_CHANNELS", "HeadConfig", "init_head_params",
           "head_apply_flat", "head_apply_image", "init_posenet_params", "posenet_apply", "torch_io"]
