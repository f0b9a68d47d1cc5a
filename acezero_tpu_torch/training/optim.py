"""AdamW with torch-default hyperparameters over parameter trees.

Counterpart of acezero_tpu/training/optim.py: betas (0.9, 0.999), eps 1e-8,
decoupled weight decay 0.01 scaled by the learning rate, with the JAX
package's arithmetic (bias corrections applied to m and v before the
square root, eps after it). `torch.optim.AdamW` places eps differently and
cannot gate a step on a device flag, so it is not used. `enabled` is a
device bool: a disabled step leaves parameters, moments and the step count
exactly as they were (`torch.where`), with no host sync.

Trees are dicts and lists of tensors, or a single tensor; updates return new
trees (nothing is modified in place). `clip_global_norm` and
`clip_per_row_norm` are the pretraining's gradient clips.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def tree_unflatten(like, leaves):
    """A tree shaped like `like` holding `leaves` (in tree_leaves order)."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return [build(v) for v in t]
        return next(it)

    return build(like)


@dataclass
class AdamWState:
    step: torch.Tensor  # int32 scalar
    mu: Any
    nu: Any


def adamw_init(params) -> AdamWState:
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else "cpu"
    zeros = [torch.zeros_like(p, dtype=torch.float32) for p in leaves]
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=device),
        mu=tree_unflatten(params, zeros),
        nu=tree_unflatten(params, [z.clone() for z in zeros]),
    )


def adamw_update(params, grads, state: AdamWState, lr, beta1: float = 0.9, beta2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 0.01, enabled=True):
    """One AdamW step -> (new params, new state). `lr` and `enabled` may be
    device scalars; a disabled step is an exact no-op."""
    p_l = tree_leaves(params)
    if not p_l:
        return params, state
    g_l, m_l, v_l = tree_leaves(grads), tree_leaves(state.mu), tree_leaves(state.nu)
    device = p_l[0].device
    keep = torch.as_tensor(enabled, device=device)
    if not torch.is_tensor(lr):
        # a Python learning rate stays a float32-rounded Python float: making
        # it a device tensor would sync the host
        lr = float(np.float32(lr))
        decay = float(np.float32(1.0) - np.float32(lr) * np.float32(weight_decay))
    else:
        decay = 1.0 - lr * weight_decay
    step = state.step + keep.to(torch.int32)
    t = torch.clamp(step, min=1).to(torch.float32)
    bc1 = 1.0 - beta1**t
    bc2 = 1.0 - beta2**t

    # one flat vector per tree: a handful of kernels per step, not a
    # handful per leaf; the returned leaves are views into the flat results
    sizes = [p.numel() for p in p_l]
    flat = [torch.cat([t.reshape(-1).float() for t in ts]) for ts in (p_l, g_l, m_l, v_l)]
    p, g, m, v = flat
    m_new = beta1 * m + (1.0 - beta1) * g
    v_new = beta2 * v + (1.0 - beta2) * (g * g)
    m_hat = m_new / bc1
    v_hat = v_new / bc2
    p_new = p * decay - lr * m_hat / (torch.sqrt(v_hat) + eps)
    out = [torch.where(keep, new, old) for new, old in ((p_new, p), (m_new, m), (v_new, v))]
    trees = [tree_unflatten(params, [t.view(ref.shape) for t, ref in zip(o.split(sizes), p_l)]) for o in out]
    return trees[0], AdamWState(step=step, mu=trees[1], nu=trees[2])


def clip_global_norm(grads, max_norm: float):
    """(grads scaled so their global L2 norm is at most `max_norm`, the norm
    before clipping); the scale stays on the device."""
    leaves = tree_leaves(grads)
    gn = torch.sqrt(sum(torch.sum(leaf.float() ** 2) for leaf in leaves))
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return tree_unflatten(grads, [(leaf * scale).to(leaf.dtype) for leaf in leaves]), gn


def clip_per_row_norm(grads, max_norm: float):
    """Clip a stacked tree (leading axis: independent models, e.g. the
    pretraining's per-scene heads) row by row: (clipped tree, (S,) norms).
    One diverging row cannot shrink the others' update through a shared
    scale."""
    leaves = tree_leaves(grads)
    sq = sum(torch.sum((leaf.float() ** 2).reshape(leaf.shape[0], -1), dim=1) for leaf in leaves)
    gn = torch.sqrt(sq)
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return tree_unflatten(grads, [(leaf * scale.reshape((-1,) + (1,) * (leaf.dim() - 1))).to(leaf.dtype)
                                  for leaf in leaves]), gn
