"""Learning-rate schedules with the early-stopping cooldown as device state.

Counterpart of acezero_tpu/training/schedule.py (the reference's three
schedules, ace_schedule.py):

  constant    stay at learning_rate_min;
  circle      torch OneCycleLR(max_lr, total_steps, cos anneal, pct_start 0.3,
              div_factor 25, final_div_factor 1e4);
  1cyclepoly  linear warm-up to max over `warmup_iterations`, hold, then a
              linear cooldown to min over `cooldown_iterations`, triggered by
              reaching (max_iterations - cooldown) or by the minimum of the
              last 100 batches' inlier fractions exceeding
              `cooldown_trigger_percent`; the trigger shrinks max_iterations.

The state (cooldown flag and start, max_iterations, the rolling statistic
buffer and its pointer) lives in device tensors and is updated without a
host sync. The schedule kind and its knobs are plain Python values
(`ScheduleHP`): the port runs eagerly and needs no traced scalars, and no
knob ever becomes a device tensor (each such copy would sync the host).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

SCHEDULE_KINDS = ("constant", "circle", "1cyclepoly")


@dataclass(frozen=True)
class ScheduleConfig:
    schedule: str = "1cyclepoly"  # constant | circle | 1cyclepoly
    iterations: int = 25000
    learning_rate_min: float = 0.0005
    learning_rate_max: float = 0.005
    warmup_iterations: int = 1000
    warmup_learning_rate: float = 0.0005
    cooldown_iterations: int = 5000
    cooldown_trigger_percent: float = 0.7
    cooldown_buffer_size: int = 100


class ScheduleState(NamedTuple):
    in_cooldown: torch.Tensor  # bool
    cooldown_start: torch.Tensor  # int32, valid when in_cooldown
    max_iterations: torch.Tensor  # int32, shrinks when cooldown triggers
    stat_buffer: torch.Tensor  # (buffer_size,) rolling batch-inlier fractions
    stat_ptr: torch.Tensor  # int32 rolling write index


class ScheduleHP(NamedTuple):
    kind: int  # index into SCHEDULE_KINDS
    total: float
    lr_min: float
    lr_max: float
    warmup_iters: float
    warmup_lr: float
    cooldown_iters: float
    trigger: float


def schedule_hp(cfg: ScheduleConfig) -> ScheduleHP:
    if cfg.schedule not in SCHEDULE_KINDS:
        raise ValueError(f"Unknown learning rate schedule: {cfg.schedule}")
    return ScheduleHP(SCHEDULE_KINDS.index(cfg.schedule), float(cfg.iterations), float(cfg.learning_rate_min),
                      float(cfg.learning_rate_max), float(cfg.warmup_iterations),
                      float(cfg.warmup_learning_rate), float(cfg.cooldown_iterations),
                      float(cfg.cooldown_trigger_percent))


def init_schedule(cfg: ScheduleConfig, device="cpu") -> ScheduleState:
    return ScheduleState(
        in_cooldown=torch.zeros((), dtype=torch.bool, device=device),
        cooldown_start=torch.full((), cfg.iterations, dtype=torch.int32, device=device),
        max_iterations=torch.full((), cfg.iterations, dtype=torch.int32, device=device),
        stat_buffer=torch.zeros((cfg.cooldown_buffer_size,), dtype=torch.float32, device=device),
        stat_ptr=torch.zeros((), dtype=torch.int32, device=device),
    )


def _f32(x) -> float:
    """`x` rounded to float32, as a Python float: an op between a float32
    tensor and it computes with exactly the JAX package's float32 constant,
    and no tensor is created (a host-to-device copy would sync the host)."""
    return float(np.float32(x))


def schedule_lr_hp(hp: ScheduleHP, state: ScheduleState, iteration: torch.Tensor) -> torch.Tensor:
    """Learning rate (f32 device scalar) at `iteration` (int32 device scalar).
    The arithmetic is the JAX package's, in float32; constants that the JAX
    package derives on the device from its float32 knobs are derived here in
    numpy float32."""
    it = iteration.to(torch.float32)
    kind = SCHEDULE_KINDS[hp.kind]
    f32 = np.float32
    lr_min, lr_max = f32(hp.lr_min), f32(hp.lr_max)
    if kind == "constant":
        return torch.full_like(it, float(lr_min))
    if kind == "circle":
        total = f32(hp.total)
        initial_lr = lr_max / f32(25.0)
        final_lr = initial_lr / f32(1e4)
        up_steps = f32(0.3) * total - f32(1.0)
        down_steps = (total - f32(1.0)) - up_steps

        def cos_anneal(start, end, pct):
            return float(end) + float(f32(start - end) / f32(2.0)) * (torch.cos(math.pi * pct) + 1.0)

        pct_up = torch.clamp(it / float(max(up_steps, f32(1.0))), 0.0, 1.0)
        pct_down = torch.clamp((it - float(up_steps)) / float(max(down_steps, f32(1.0))), 0.0, 1.0)
        return torch.where(it <= float(up_steps), cos_anneal(initial_lr, lr_max, pct_up),
                           cos_anneal(lr_max, final_lr, pct_down))
    warmup_iters = f32(hp.warmup_iters)
    warmup_frac = torch.clamp(it / float(max(warmup_iters, f32(1.0))), 0.0, 1.0)
    sf = f32(hp.warmup_lr) / lr_max
    lr_warm = float(lr_max) * (float(sf) + float(f32(1.0) - sf) * warmup_frac)
    cd_elapsed = (iteration - state.cooldown_start).to(torch.float32)
    cd_frac = torch.clamp(cd_elapsed / float(max(f32(hp.cooldown_iters), f32(1.0))), 0.0, 1.0)
    ef = lr_min / lr_max
    lr_cool = float(lr_max) * (1.0 + float(ef - f32(1.0)) * cd_frac)
    in_cd = state.in_cooldown & (iteration >= state.cooldown_start)
    return torch.where(in_cd, lr_cool, torch.where(it < float(warmup_iters), lr_warm, torch.full_like(it, float(lr_max))))


def schedule_update_hp(hp: ScheduleHP, state: ScheduleState, iteration: torch.Tensor,
                       batch_inliers: torch.Tensor) -> ScheduleState:
    """Post-step update: the cooldown trigger check, then the rolling
    statistic push (reference ace_schedule.py:72-126). Only 1cyclepoly owns a
    cooldown; the other kinds pass the state through."""
    if SCHEDULE_KINDS[hp.kind] != "1cyclepoly":
        return state
    it = iteration.to(torch.float32)
    cooldown = _f32(hp.cooldown_iters)
    past_warmup = it >= _f32(hp.warmup_iters)
    by_duration = it >= (state.max_iterations.to(torch.float32) - cooldown)
    by_dynamic = torch.min(state.stat_buffer) > _f32(hp.trigger)
    trigger = (~state.in_cooldown) & past_warmup & (by_duration | by_dynamic)

    in_cooldown = state.in_cooldown | trigger
    cooldown_start = torch.where(trigger, iteration, state.cooldown_start).to(torch.int32)
    max_iterations = torch.where(trigger, (it + cooldown).to(torch.int32), state.max_iterations)
    n = state.stat_buffer.shape[0]
    slot = torch.arange(n, device=iteration.device) == state.stat_ptr
    stat_buffer = torch.where(slot, batch_inliers.to(torch.float32), state.stat_buffer)
    stat_ptr = ((state.stat_ptr + 1) % n).to(torch.int32)
    return ScheduleState(in_cooldown, cooldown_start, max_iterations, stat_buffer, stat_ptr)


def schedule_lr(cfg: ScheduleConfig, state: ScheduleState, iteration: torch.Tensor) -> torch.Tensor:
    return schedule_lr_hp(schedule_hp(cfg), state, iteration)


def schedule_update(cfg: ScheduleConfig, state: ScheduleState, iteration: torch.Tensor,
                    batch_inliers: torch.Tensor) -> ScheduleState:
    return schedule_update_hp(schedule_hp(cfg), state, iteration, batch_inliers)
