"""Scene-coordinate regressor: frozen encoder + scene head bundle.

Counterpart of acezero_tpu/models/regressor.py (the reference `Regressor`,
ace_network.py:152-270): the `create_*` constructors of the reference's
factory surface (from an encoder, from split encoder and head files) and
the forward, whose head goes through `head_apply_flat` (K1 on the card).
An explicit `torch.Generator` takes the place of the JAX package's keys;
the parameters live on `device` (the card unless the CPU is asked for).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from pathlib import Path

import torch

from acezero_tpu_torch import resolve_device
from acezero_tpu_torch.models import torch_io
from acezero_tpu_torch.models.encoder import ENCODER_OUT_CHANNELS, encoder_apply, init_encoder_params
from acezero_tpu_torch.models.head import HeadConfig, head_apply_flat, head_apply_image, init_head_params

OUTPUT_SUBSAMPLE = 8  # total encoder stride; reference ace_network.py:159


@dataclass
class Regressor:
    encoder_params: dict
    head_params: dict
    head_cfg: HeadConfig

    # --- constructors -----------------------------------------------------

    @classmethod
    def create_new(cls, generator: torch.Generator, mean, num_head_blocks: int = 1, use_homogeneous: bool = True,
                   num_encoder_features: int = 512, device=None) -> "Regressor":
        if num_encoder_features != ENCODER_OUT_CHANNELS:
            raise ValueError(f"the port's encoder has {ENCODER_OUT_CHANNELS} output channels, "
                             f"not {num_encoder_features}")
        device = resolve_device(device)
        cfg = HeadConfig(num_head_blocks=num_head_blocks, use_homogeneous=use_homogeneous,
                         in_channels=num_encoder_features)
        return cls(encoder_params=init_encoder_params(generator, device),
                   head_params=init_head_params(generator, cfg, mean, device), head_cfg=cfg)

    @classmethod
    def create_from_encoder(cls, generator: torch.Generator, encoder_params: dict, mean, num_head_blocks: int = 1,
                            use_homogeneous: bool = True) -> "Regressor":
        w = encoder_params["res2_conv3"]["w"]  # (out, in, kh, kw)
        cfg = HeadConfig(num_head_blocks=num_head_blocks, use_homogeneous=use_homogeneous, in_channels=w.shape[0])
        return cls(encoder_params=encoder_params, head_params=init_head_params(generator, cfg, mean, w.device),
                   head_cfg=cfg)

    @classmethod
    def create_from_split_state_dict(cls, encoder_pt: str | Path, head_pt: str | Path, device=None) -> "Regressor":
        device = resolve_device(device)
        head_cfg, head_params = torch_io.load_head(head_pt, device)
        return cls(encoder_params=torch_io.load_encoder(encoder_pt, device), head_params=head_params,
                   head_cfg=head_cfg)

    def with_new_head(self, generator: torch.Generator, mean) -> "Regressor":
        """Fresh head on the same encoder (used by the final refit)."""
        device = self.encoder_params["conv1"]["w"].device
        return replace(self, head_params=init_head_params(generator, self.head_cfg, mean, device))

    # --- forward ----------------------------------------------------------

    def get_features(self, images_nhwc: torch.Tensor, compute_dtype=torch.bfloat16) -> torch.Tensor:
        return encoder_apply(self.encoder_params, images_nhwc, compute_dtype)

    def get_scene_coordinates_flat(self, features: torch.Tensor, compute_dtype=torch.bfloat16) -> torch.Tensor:
        return head_apply_flat(self.head_params, self.head_cfg, features, compute_dtype)

    def get_scene_coordinates_image(self, features_nhwc: torch.Tensor, compute_dtype=torch.bfloat16) -> torch.Tensor:
        return head_apply_image(self.head_params, self.head_cfg, features_nhwc, compute_dtype)

    def forward(self, images_nhwc: torch.Tensor, compute_dtype=torch.bfloat16) -> torch.Tensor:
        """(N, H, W, 1) images -> (N, H/8, W/8, 3) scene coordinates."""
        return self.get_scene_coordinates_image(self.get_features(images_nhwc, compute_dtype), compute_dtype)

    # --- artifacts --------------------------------------------------------

    def save_head(self, path: str | Path) -> None:
        torch_io.save_head(path, self.head_params, self.head_cfg)
