"""Frozen convolutional feature encoder (stride 8, 512 channels).

Counterpart of acezero_tpu/models/encoder.py. The public function takes
and returns NHWC like the JAX package; inside, the permuted view is a
channels-last NCHW tensor, which cuDNN runs without copies.
"""

from __future__ import annotations

import torch

from acezero_tpu_torch.models.common import conv2d, relu

ENCODER_OUT_CHANNELS = 512

# (name, kh, kw, cin, cout, stride)
LAYERS = [
    ("conv1", 3, 3, 1, 32, 1),
    ("conv2", 3, 3, 32, 64, 2),
    ("conv3", 3, 3, 64, 128, 2),
    ("conv4", 3, 3, 128, 256, 2),
    ("res1_conv1", 3, 3, 256, 256, 1),
    ("res1_conv2", 1, 1, 256, 256, 1),
    ("res1_conv3", 3, 3, 256, 256, 1),
    ("res2_conv1", 3, 3, 256, 512, 1),
    ("res2_conv2", 1, 1, 512, 512, 1),
    ("res2_conv3", 3, 3, 512, ENCODER_OUT_CHANNELS, 1),
    ("res2_skip", 1, 1, 256, ENCODER_OUT_CHANNELS, 1),
]


def init_encoder_params(generator: torch.Generator, device="cpu") -> dict:
    """Torch-default (kaiming-uniform, a=sqrt(5)) random encoder weights."""
    params = {}
    for name, kh, kw, cin, cout, _ in LAYERS:
        bound = 1.0 / (cin * kh * kw) ** 0.5
        w = torch.rand((cout, cin, kh, kw), generator=generator) * 2 * bound - bound
        b = torch.rand((cout,), generator=generator) * 2 * bound - bound
        params[name] = {"w": w.to(device), "b": b.to(device)}
    return params


def encoder_apply(params: dict, images_nhwc: torch.Tensor, compute_dtype=torch.bfloat16) -> torch.Tensor:
    """(N, H, W, 1) normalized grayscale -> (N, H/8, W/8, C) features."""
    x = images_nhwc.permute(0, 3, 1, 2)
    x = relu(conv2d(x, params["conv1"], 1, compute_dtype))
    x = relu(conv2d(x, params["conv2"], 2, compute_dtype))
    x = relu(conv2d(x, params["conv3"], 2, compute_dtype))
    res = relu(conv2d(x, params["conv4"], 2, compute_dtype))

    x = relu(conv2d(res, params["res1_conv1"], 1, compute_dtype))
    x = relu(conv2d(x, params["res1_conv2"], 1, compute_dtype))
    x = relu(conv2d(x, params["res1_conv3"], 1, compute_dtype))
    res = res + x

    x = relu(conv2d(res, params["res2_conv1"], 1, compute_dtype))
    x = relu(conv2d(x, params["res2_conv2"], 1, compute_dtype))
    x = relu(conv2d(x, params["res2_conv3"], 1, compute_dtype))

    out = conv2d(res, params["res2_skip"], 1, compute_dtype) + x
    return out.permute(0, 2, 3, 1)
