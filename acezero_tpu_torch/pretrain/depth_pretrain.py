"""Seed-depth head pretraining on the procedural corpus.

Counterpart of acezero_tpu/pretrain/depth_pretrain.py. Trains
`models.depthnet` (a small conv head on the frozen encoder) to predict
stride-8 depth with the scale-invariant log loss plus the gradient-matching
term: the seed depth of a bare reconstruction. The encoder is frozen: its
features are computed under `torch.no_grad()`, and only the head trains
(AdamW, weight decay 1e-4).

The learning-rate table and the batch order are numpy draws, as in the JAX
package, so both packages train on the same batches; the head's
initialisation comes from a torch generator seeded with `cfg.seed` (the
tests pass the JAX package's to `train_chunk`).
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from acezero_tpu_torch import resolve_device
from acezero_tpu_torch.data.augment import normalize_images
from acezero_tpu_torch.data.synthetic import render_scene
from acezero_tpu_torch.models.depthnet import (
    depth_head_apply,
    gradient_matching_loss,
    init_depth_head_params,
    silog_loss,
)
from acezero_tpu_torch.models.encoder import encoder_apply
from acezero_tpu_torch.models.torch_io import load_encoder, save_encoder
from acezero_tpu_torch.training.optim import adamw_init, adamw_update, tree_leaves, tree_unflatten
from acezero_tpu_torch.training.trainer import _with_grad

_logger = logging.getLogger(__name__)


@dataclass(frozen=True)
class DepthPretrainConfig:
    num_scenes: int = 64
    views_per_scene: int = 16
    image_h: int = 240
    image_w: int = 320
    steps: int = 8000
    batch_images: int = 32
    learning_rate: float = 1e-3
    warmup_steps: int = 100
    silog_lambda: float = 0.85
    grad_loss_weight: float = 0.5
    low_texture_frac: float = 0.2
    photometric: bool = True
    seed: int = 97
    chunk_steps: int = 100
    # corpus preset: "v4" is the shipped head's corpus (weights/tpu_depth_v4.pt:
    # single-octave textures, across/outward ring looks, draw for draw);
    # "v5" the octave and look mixtures below
    corpus: str = "v5"
    width_mult: int = 1  # depth-head hidden-width multiplier
    texture_octaves_probs: tuple = ((1, 0.2), (2, 0.2), (3, 0.6))
    look_probs: tuple = (("sweep", 0.3), ("across", 0.35), ("outward", 0.35))


def _draw(rng, choices_probs):
    vals = [v for v, _ in choices_probs]
    probs = np.array([p for _, p in choices_probs], np.float64)
    return vals[int(rng.choice(len(vals), p=probs / probs.sum()))]


def build_depth_corpus(cfg: DepthPretrainConfig):
    """(images (N, h, w) uint8, stride-8 depth at the cell centres (N, h/8,
    w/8) float32), numpy."""
    images, depths = [], []
    corpus_rng = np.random.default_rng(cfg.seed)
    for s in range(cfg.num_scenes):
        strength = 1.0
        if corpus_rng.random() < cfg.low_texture_frac:
            strength = float(corpus_rng.uniform(0.3, 0.6))
        if cfg.corpus == "v4":
            look = "across" if corpus_rng.random() < 0.4 else "outward"
            octaves = 1
        else:
            look = _draw(corpus_rng, cfg.look_probs)
            octaves = _draw(corpus_rng, cfg.texture_octaves_probs)
        scene = render_scene(cfg.views_per_scene, h=cfg.image_h, w=cfg.image_w, seed=cfg.seed + 1000 + s,
                             texture_strength=strength, photometric=cfg.photometric, look=look,
                             texture_octaves=octaves)
        images.append(scene.images_u8)
        depths.append(scene.depth)
    images = np.concatenate(images)
    depths = np.concatenate(depths).astype(np.float32)
    return images, depths[:, 4::8, 4::8]


def lr_table(cfg: DepthPretrainConfig) -> np.ndarray:
    """(steps,) float32 learning rates: linear warm-up from 2%, then cosine."""
    lr_full = np.full(cfg.steps, cfg.learning_rate, np.float32)
    warm = min(cfg.warmup_steps, cfg.steps)
    lr_full[:warm] *= np.linspace(0.02, 1.0, warm)
    tail = np.arange(cfg.steps - warm)
    lr_full[warm:] *= 0.5 * (1.0 + np.cos(np.pi * tail / max(1, len(tail))))
    return lr_full


def train_chunk(params: dict, opt, encoder_params: dict, images_u8: torch.Tensor, gt_d8: torch.Tensor,
                order: torch.Tensor, lr_tab, lam: float, grad_w: float):
    """One step per row of `order` (steps, batch) corpus indices, at the
    rates of `lr_tab` (steps,) -> (params, opt, (steps,) losses on the
    device)."""
    losses = []
    for s in range(order.shape[0]):
        idx = order[s]
        with torch.no_grad():
            feats = encoder_apply(encoder_params, normalize_images(images_u8.index_select(0, idx)))
        gt = gt_d8.index_select(0, idx)
        trainable = _with_grad(params)
        with torch.enable_grad():
            pred = depth_head_apply(trainable, feats)
            valid = gt > 0
            loss = silog_loss(pred, gt, valid, lam=lam) + grad_w * gradient_matching_loss(pred, gt, valid)
            grads = torch.autograd.grad(loss, tree_leaves(trainable))
        params, opt = adamw_update(params, tree_unflatten(params, grads), opt, float(lr_tab[s]),
                                   weight_decay=1e-4)
        losses.append(loss.detach())
    return params, opt, torch.stack(losses)


def pretrain_depth_head(cfg: DepthPretrainConfig, encoder_path: str | Path, out_path: str | Path,
                        device=None) -> dict:
    """Train the head on `device` (cuda unless told otherwise) and write it
    to `out_path`.

    Returns {"params", "final_loss" (the last chunk's mean), "chunk_losses"
    (every chunk's mean), "corpus" ({"images", "gt_d8"}, the numpy corpus
    it trained on), "seconds", "corpus_seconds", "train_seconds"}.
    """
    dev = resolve_device(device)
    t0 = time.time()
    encoder_params = load_encoder(encoder_path, dev)
    images, gt_d8 = build_depth_corpus(cfg)
    n = len(images)
    corpus_seconds = time.time() - t0
    _logger.info("Depth corpus: %d images (%d scenes) in %.1fs.", n, cfg.num_scenes, corpus_seconds)

    params = init_depth_head_params(torch.Generator().manual_seed(cfg.seed), width_mult=cfg.width_mult,
                                    device=dev)
    opt = adamw_init(params)
    images_dev = torch.from_numpy(images).to(dev)
    gt_dev = torch.from_numpy(gt_d8).to(dev)

    rng = np.random.default_rng(cfg.seed)
    lr_full = lr_table(cfg)
    t_train = time.time()
    done = 0
    chunk_losses = []
    while done < cfg.steps:
        m = min(cfg.chunk_steps, cfg.steps - done)
        order = torch.from_numpy(rng.integers(0, n, (m, cfg.batch_images))).to(dev)
        params, opt, losses = train_chunk(params, opt, encoder_params, images_dev, gt_dev, order,
                                          lr_full[done: done + m], cfg.silog_lambda, cfg.grad_loss_weight)
        chunk_losses.append(float(losses.mean()))
        done += m
        _logger.info("depth pretrain %d/%d: loss %.4f", done, cfg.steps, chunk_losses[-1])
    train_seconds = time.time() - t_train

    save_encoder(out_path, params)
    _logger.info("Saved depth head to %s (%.1f min).", out_path, (time.time() - t0) / 60)
    return {"params": params, "final_loss": chunk_losses[-1], "chunk_losses": chunk_losses,
            "corpus": {"images": images, "gt_d8": gt_d8}, "seconds": time.time() - t0, "corpus_seconds": corpus_seconds, "train_seconds": train_seconds}
