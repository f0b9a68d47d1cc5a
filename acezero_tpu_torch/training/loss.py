"""Reprojection losses: masked, fixed-shape versions of the reference zoo.

Counterpart of acezero_tpu/training/loss.py. Every variant returns the sum
over the valid pixels (the caller divides by the batch size); `dyntanh`
anneals the soft clamp from `soft_clamp` to `soft_clamp_min` over training,
optionally on the circle schedule. The JAX package makes the loss kind a
traced scalar so that recipes share one compiled program; the port runs
eagerly, so `ReproLossHP` holds plain Python values and only the selected
variant is computed. The iteration may be a device tensor.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

LOSS_TYPES = ("tanh", "dyntanh", "l1", "l1+sqrt", "l1+logl1")


@dataclass(frozen=True)
class ReproLossConfig:
    total_iterations: int = 25000
    soft_clamp: float = 50.0
    soft_clamp_min: float = 1.0
    loss_type: str = "dyntanh"
    circle_schedule: bool = True  # reference repro_loss_schedule == 'circle'


class ReproLossHP(NamedTuple):
    kind: int  # index into LOSS_TYPES
    total_iters: float
    soft_clamp: float
    soft_clamp_min: float
    circle_schedule: bool


def loss_hp(cfg: ReproLossConfig) -> ReproLossHP:
    kind = "l1+logl1" if cfg.loss_type == "l1+log" else cfg.loss_type
    if kind not in LOSS_TYPES:
        raise ValueError(f"Unknown loss type {cfg.loss_type!r}; expected one of {LOSS_TYPES}")
    return ReproLossHP(LOSS_TYPES.index(kind), float(cfg.total_iterations), float(cfg.soft_clamp),
                       float(cfg.soft_clamp_min), bool(cfg.circle_schedule))


def dyntanh_weight_hp(hp: ReproLossHP, iteration) -> torch.Tensor:
    """Annealed soft-clamp weight (reference ace_loss.py:57-66), in float32.
    The knobs stay Python floats (rounded to float32): no device tensor is
    made from them, which would sync the host."""
    f32 = np.float32
    it = torch.as_tensor(iteration).to(torch.float32)
    t = torch.clamp(it / float(max(f32(hp.total_iters), f32(1.0))), 0.0, 1.0)
    if hp.circle_schedule:
        sw = 1.0 - torch.sqrt(torch.clamp(1.0 - t * t, min=0.0))
    else:
        sw = t
    return (1.0 - sw) * float(f32(hp.soft_clamp)) + float(f32(hp.soft_clamp_min))


def _weighted_tanh_sum(errs, mask, weight) -> torch.Tensor:
    return weight * torch.sum(torch.tanh(errs / weight) * mask)


def repro_loss_hp(hp: ReproLossHP, errs: torch.Tensor, valid_mask: torch.Tensor, iteration) -> torch.Tensor:
    """The loss variant hp.kind: (B,) errors, (B,) validity -> scalar sum."""
    mask = valid_mask.to(errs.dtype)
    kind = LOSS_TYPES[hp.kind]
    if kind == "tanh":
        return _weighted_tanh_sum(errs, mask, float(np.float32(hp.soft_clamp)))
    if kind == "dyntanh":
        return _weighted_tanh_sum(errs, mask, dyntanh_weight_hp(hp, iteration).to(errs.device))
    big = errs > hp.soft_clamp
    loss_small = torch.sum(errs * mask * (~big))
    if kind == "l1":
        return loss_small
    if kind == "l1+sqrt":
        return loss_small + torch.sum(torch.sqrt(hp.soft_clamp * torch.clamp(errs, min=1e-12)) * mask * big)
    return loss_small + torch.sum(torch.log1p(hp.soft_clamp * errs) * mask * big)


def repro_loss(cfg: ReproLossConfig, errs: torch.Tensor, valid_mask: torch.Tensor, iteration) -> torch.Tensor:
    """Sum of the configured robust loss over the valid pixels."""
    return repro_loss_hp(loss_hp(cfg), errs, valid_mask, iteration)
