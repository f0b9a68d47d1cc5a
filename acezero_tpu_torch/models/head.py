"""Scene-coordinate regression head: the per-scene map network.

Counterpart of acezero_tpu/models/head.py. All layers are dense layers over
the feature axis. On the standard layout (no `head_skip`, bf16 compute),
the 512-wide residual chain runs through the autograd Function
`ops.fused_head.FusedHeadChain` on every device: forward and backward are
the Hopper kernels for CUDA tensors and their plain versions for CPU
tensors, so the CPU tests run the same VJP arithmetic as the card. fc3 and
the homogeneous epilogue follow in torch.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from acezero_tpu_torch.models.common import dense, init_dense, relu


@dataclass(frozen=True)
class HeadConfig:
    num_head_blocks: int = 1
    use_homogeneous: bool = True
    in_channels: int = 512
    head_channels: int = 512
    homogeneous_min_scale: float = 0.01
    homogeneous_max_scale: float = 4.0


def init_head_params(generator: torch.Generator, cfg: HeadConfig, mean, device="cpu") -> dict:
    """Torch-default initialised head; `mean` is the scene-mean buffer (3,).
    Layers draw from `generator` in the JAX package's order (its draws
    differ; tests cross JAX's own initialisation with `params_from_jax`)."""
    c = cfg.head_channels
    params: dict = {
        "res3_conv1": init_dense(generator, cfg.in_channels, c, device),
        "res3_conv2": init_dense(generator, c, c, device),
        "res3_conv3": init_dense(generator, c, c, device),
        "fc1": init_dense(generator, c, c, device),
        "fc2": init_dense(generator, c, c, device),
        "fc3": init_dense(generator, c, 4 if cfg.use_homogeneous else 3, device),
        "blocks": [
            {f"c{j}": init_dense(generator, c, c, device) for j in range(3)}
            for _ in range(cfg.num_head_blocks)
        ],
        "mean": torch.as_tensor(mean, dtype=torch.float32).reshape(3).to(device),
    }
    if cfg.in_channels != cfg.head_channels:
        params["head_skip"] = init_dense(generator, cfg.in_channels, c, device)
    return params


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
        from acezero_tpu_torch.ops.fused_head import FusedHeadChain, head_params_to_stack

        # f32 stack: the weight gradient reaches the f32 parameters unrounded
        w, b, res_after = head_params_to_stack(params, cfg, w_dtype=torch.float32)
        hidden = FusedHeadChain.apply(features.to(torch.bfloat16).contiguous(), w, b, res_after)
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
