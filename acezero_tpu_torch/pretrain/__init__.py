"""Pretraining of the encoder and the seed-depth head on synthetic scenes.

Counterpart of acezero_tpu/pretrain/: `encoder_pretrain` (the shared
encoder with per-scene heads), `depth_pretrain` (the seed-depth head on the
frozen encoder) and `encoder_eval` (the probes that pick a candidate).
"""

from acezero_tpu_torch.pretrain.encoder_pretrain import PretrainConfig, pretrain_encoder

__all__ = ["PretrainConfig", "pretrain_encoder"]
