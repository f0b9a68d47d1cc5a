"""Pose-refinement MLP: predicts additive deltas for 3x4 camera poses.

Counterpart of acezero_tpu/models/posenet.py (the reference PoseNetwork
with 0 extra blocks and 128 channels): the flattened 3x4 world-to-camera
pose (12 values) in, a 12-value delta out, all in float32.
"""

from __future__ import annotations

import torch

from acezero_tpu_torch.models.common import dense, init_dense, relu

POSENET_CHANNELS = 128


def init_posenet_params(generator: torch.Generator, channels: int = POSENET_CHANNELS, device="cpu") -> dict:
    c = channels
    return {
        "conv1": init_dense(generator, 12, c, device),
        "conv2": init_dense(generator, c, c, device),
        "conv3": init_dense(generator, c, c, device),
        "head_skip": init_dense(generator, 12, c, device),
        "fc1": init_dense(generator, c, c, device),
        "fc2": init_dense(generator, c, c, device),
        "fc3": init_dense(generator, c, 12, device),
    }


def posenet_apply(params: dict, poses_flat: torch.Tensor) -> torch.Tensor:
    """(B, 12) flattened poses -> (B, 12) predicted deltas (float32)."""
    f32 = torch.float32
    x = relu(dense(poses_flat, params["conv1"], f32))
    x = relu(dense(x, params["conv2"], f32))
    x = relu(dense(x, params["conv3"], f32))
    res = dense(poses_flat, params["head_skip"], f32) + x
    out = relu(dense(res, params["fc1"], f32))
    out = relu(dense(out, params["fc2"], f32))
    return dense(out, params["fc3"], f32)
