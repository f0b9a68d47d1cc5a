"""Scene-coordinate regression head: the per-scene map network.

Counterpart of acezero_tpu/models/head.py. All layers are dense layers over
the feature axis. On the standard layout (no `head_skip`), the 512-wide
residual chain runs through `ops.fused_head.fused_head_chain`: the Hopper
kernel for CUDA tensors, its plain version for CPU tensors. fc3 and the
homogeneous epilogue follow in torch.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from acezero_tpu_torch.models.common import dense, relu


@dataclass(frozen=True)
class HeadConfig:
    num_head_blocks: int = 1
    use_homogeneous: bool = True
    in_channels: int = 512
    head_channels: int = 512
    homogeneous_min_scale: float = 0.01
    homogeneous_max_scale: float = 4.0


def _chain_eager(params: dict, features: torch.Tensor, compute_dtype) -> torch.Tensor:
    x = relu(dense(features, params["res3_conv1"], compute_dtype))
    x = relu(dense(x, params["res3_conv2"], compute_dtype))
    x = relu(dense(x, params["res3_conv3"], compute_dtype))
    if "head_skip" in params:
        res = dense(features, params["head_skip"], compute_dtype) + x
    else:
        res = features.to(compute_dtype) + x
    for block in params["blocks"]:
        x = relu(dense(res, block["c0"], compute_dtype))
        x = relu(dense(x, block["c1"], compute_dtype))
        x = relu(dense(x, block["c2"], compute_dtype))
        res = res + x
    sc = relu(dense(res, params["fc1"], compute_dtype))
    return relu(dense(sc, params["fc2"], compute_dtype))


def head_apply_flat(
    params: dict, cfg: HeadConfig, features: torch.Tensor, compute_dtype=torch.bfloat16
) -> torch.Tensor:
    """(B, C) features -> (B, 3) scene coordinates in float32."""
    if "head_skip" in params or compute_dtype != torch.bfloat16:
        hidden = _chain_eager(params, features, compute_dtype)
    else:
        # local import: ops.fused_head imports HeadConfig from this module
        from acezero_tpu_torch.ops.fused_head import fused_head_chain, head_params_to_stack

        w, b, res_after = head_params_to_stack(params, cfg)
        hidden = fused_head_chain(features.to(torch.bfloat16).contiguous(), w, b, res_after)
    return head_epilogue(params, cfg, hidden, compute_dtype)


def head_epilogue(
    params: dict, cfg: HeadConfig, hidden: torch.Tensor, compute_dtype=torch.bfloat16
) -> torch.Tensor:
    """Final projection + homogeneous dehomogenization + scene-mean offset."""
    sc = dense(hidden, params["fc3"], compute_dtype).float()
    if cfg.use_homogeneous:
        max_inv_scale = 1.0 / cfg.homogeneous_max_scale
        min_inv_scale = 1.0 / cfg.homogeneous_min_scale
        h_beta = math.log(2.0) / (1.0 - max_inv_scale)
        h = F.softplus(h_beta * sc[..., 3]) / h_beta + max_inv_scale
        h = torch.clamp(h, max=min_inv_scale)
        sc = sc[..., :3] / h[..., None]
    return sc + params["mean"].float()


def head_apply_image(
    params: dict, cfg: HeadConfig, features_nhwc: torch.Tensor, compute_dtype=torch.bfloat16
) -> torch.Tensor:
    """(N, h, w, C) feature maps -> (N, h, w, 3) scene coordinates."""
    n, h, w, c = features_nhwc.shape
    out = head_apply_flat(params, cfg, features_nhwc.reshape(n * h * w, c), compute_dtype)
    return out.reshape(n, h, w, 3)
