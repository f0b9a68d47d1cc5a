"""Device-resident training patch buffer.

Counterpart of acezero_tpu/training/buffer.py: augment -> encoder ->
mask-weighted patch sampling, one plain loop over chunks of `image_chunk`
images per dataset pass, written into a structure-of-arrays buffer on the
device. Each pass visits the images in `np.random.default_rng(p)
.permutation(n)` order, as in the JAX package; `samples_per_image` cells are
drawn with replacement per image, uniformly over the cells whose centre lies
in the warped content mask (uniformly over all cells for an all-masked
image). Rows keep what varies per sample: features, target pixel, target
scene coordinates, image index, augmentation theta and scale.

The row count is padded to a power-of-two bucket and the pad is filled
cyclically from the real rows, as in the JAX package (the trainer draws
batch rows uniformly over the padded count, so the pad changes the row
distribution and is kept). With `host_spill` (`--training_buffer_cpu`) the
rows are written to host memory (pinned when the encoder is on the card),
each chunk as it is made; the trainer gathers its batches there. Unlike the
JAX package's host buffer, it keeps the bucket pad, so both buffers hold
the same rows and one seed draws the same batches from either.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from acezero_tpu_torch.data.augment import augment_batch, warp_target_map
from acezero_tpu_torch.models.encoder import encoder_apply


@dataclass(frozen=True)
class BufferConfig:
    max_buffer_size: int = 8_000_000
    samples_per_image: int = 1024
    max_dataset_passes: int = 10
    use_aug: bool = True
    aug_rotation: float = 15.0
    aug_scale_max: float = 1.5
    aug_black_white: float = 0.1  # brightness/contrast jitter half-range
    image_chunk: int = 32  # images encoded per chunk
    subsample: int = 8


def plan_buffer_size(cfg: BufferConfig, num_images: int) -> tuple[int, int]:
    """(total_rows, passes) under the reference budget."""
    per_pass = num_images * cfg.samples_per_image
    passes = min(cfg.max_dataset_passes, max(1, -(-cfg.max_buffer_size // per_pass)))
    total = min(cfg.max_buffer_size, passes * per_pass)
    return total, passes


def next_bucket(n: int, minimum: int = 1) -> int:
    """Round up to the next power of two (at least `minimum`)."""
    b = max(minimum, 1)
    while b < n:
        b *= 2
    return b


def buffer_alloc_rows(cfg: BufferConfig, num_images: int, pad_rows_to_bucket: bool = True) -> tuple[int, int]:
    """(total_rows, allocated_rows) of a fill (the JAX package's mesh
    alignment `devices_pad` has no counterpart yet)."""
    total, _ = plan_buffer_size(cfg, num_images)
    total = (total // cfg.samples_per_image) * cfg.samples_per_image
    alloc = next_bucket(total, 4096) if pad_rows_to_bucket else total
    return total, alloc


def allocate_buffer(alloc: int, feat_dim: int, device="cpu", pin_memory: bool = False) -> dict:
    """Zero-initialised structure-of-arrays patch buffer on `device` (host
    memory pinned for asynchronous copies with `pin_memory`)."""
    shapes = {"features": ((alloc, feat_dim), torch.bfloat16), "target_px": ((alloc, 2), torch.float32),
              "target_crds": ((alloc, 3), torch.float32), "img_idx": ((alloc,), torch.int32),
              "theta": ((alloc,), torch.float32), "scale": ((alloc,), torch.float32)}
    buffer = {k: torch.zeros(shape, dtype=dtype, device=device, pin_memory=pin_memory)
              for k, (shape, dtype) in shapes.items()}
    buffer["scale"].fill_(1.0)
    return buffer


def _fill_chunk(encoder_params: dict, images_u8: torch.Tensor, sizes: torch.Tensor,
                target_maps: torch.Tensor | None, cfg: BufferConfig, generator: torch.Generator | None,
                draws: dict | None) -> dict:
    """One image chunk: augment, encode, sample patches. `draws` may carry
    the chunk's aug params ({thetas, scales, brightness, contrast}) and
    `cell_idx` (B, S); otherwise both come from `generator`."""
    B, H, W = images_u8.shape
    S, sub = cfg.samples_per_image, cfg.subsample
    hs, ws = H // sub, W // sub
    draws = draws or {}
    aug_params = {k: draws[k] for k in ("thetas", "scales", "brightness", "contrast") if k in draws}
    aug = augment_batch(
        images_u8, sizes,
        aug_rotation_deg=cfg.aug_rotation if cfg.use_aug else 0.0,
        aug_scale_min=1.0 / cfg.aug_scale_max, aug_scale_max=cfg.aug_scale_max,
        aug_black_white=cfg.aug_black_white, enabled=cfg.use_aug,
        generator=generator, params=aug_params or None,
    )
    feats = encoder_apply(encoder_params, aug["images"])  # (B, hs, ws, C) bf16

    # feature-resolution mask: nearest sample at each cell centre
    off = sub // 2
    mask_lr = aug["masks"][:, off::sub, off::sub].reshape(B, hs * ws)
    if "cell_idx" in draws:
        cell_idx = draws["cell_idx"].to(images_u8.device, torch.int64)
    else:
        weights = mask_lr.to(torch.float32)
        weights = torch.where(mask_lr.any(dim=1, keepdim=True), weights, torch.ones_like(weights))
        cell_idx = torch.multinomial(weights, S, replacement=True, generator=generator)

    feats_flat = feats.reshape(B, hs * ws, -1)
    rows_feat = torch.gather(feats_flat, 1, cell_idx[..., None].expand(B, S, feats_flat.shape[-1]))
    cy = torch.div(cell_idx, ws, rounding_mode="floor").to(torch.float32)
    cx = (cell_idx % ws).to(torch.float32)
    px = torch.stack([(cx + 0.5) * sub, (cy + 0.5) * sub], dim=-1)
    if target_maps is None:
        rows_crds = torch.zeros((B, S, 3), dtype=torch.float32, device=images_u8.device)
    else:
        warped = warp_target_map(target_maps, aug["thetas"], aug["scales"]).reshape(B, hs * ws, 3)
        rows_crds = torch.gather(warped, 1, cell_idx[..., None].expand(B, S, 3))
    return {
        "features": rows_feat.to(torch.bfloat16).reshape(B * S, -1),
        "target_px": px.reshape(B * S, 2),
        "target_crds": rows_crds.reshape(B * S, 3),
        "theta": aug["thetas"].repeat_interleave(S),
        "scale": aug["scales"].repeat_interleave(S),
    }


@torch.no_grad()
def fill_training_buffer(
    encoder_params: dict,
    images_u8,
    sizes,
    cfg: BufferConfig,
    target_maps=None,
    generator: torch.Generator | None = None,
    pad_rows_to_bucket: bool = False,
    draws=None,
    host_spill: bool = False,
) -> dict:
    """Fill the patch buffer from a scene's canvases.

    images_u8: (N, H, W) uint8 canvases and sizes (N, 2) content sizes, host
    arrays or tensors; target_maps: optional (N, hs, ws, 3) world-coordinate
    targets (depth supervision), None for self-supervised rounds.
    `draws(pass_index, chunk_index, image_indices) -> dict` may supply each
    chunk's random draws (see `_fill_chunk`); otherwise they come from
    `generator`. Returns a dict of tensors on the encoder's device (on the
    host with `host_spill`): features (M, C) bf16, target_px (M, 2),
    target_crds (M, 3), img_idx (M,) int32, theta (M,), scale (M,).
    """
    device = encoder_params["conv1"]["w"].device
    images = torch.as_tensor(np.asarray(images_u8)).to(device)
    sizes_t = torch.as_tensor(np.asarray(sizes)).to(device)
    n = images.shape[0]
    _, passes = plan_buffer_size(cfg, n)
    total, alloc = buffer_alloc_rows(cfg, n, pad_rows_to_bucket)
    feat_dim = encoder_params["res2_conv3"]["w"].shape[0]
    S = cfg.samples_per_image
    if host_spill:
        buffer = allocate_buffer(alloc, feat_dim, "cpu", pin_memory=device.type == "cuda")
    else:
        buffer = allocate_buffer(alloc, feat_dim, device)
    targets = None if target_maps is None else torch.as_tensor(np.asarray(target_maps, np.float32)).to(device)

    chunk = cfg.image_chunk
    row = 0
    for p in range(passes):
        if row >= total:
            break
        order = np.random.default_rng(p).permutation(n)
        for ci, c0 in enumerate(range(0, n, chunk)):
            idx = order[c0: c0 + chunk]
            idx_t = torch.as_tensor(idx, device=device)
            rows = _fill_chunk(
                encoder_params, images[idx_t], sizes_t[idx_t],
                None if targets is None else targets[idx_t], cfg, generator,
                None if draws is None else draws(p, ci, idx),
            )
            rows["img_idx"] = idx_t.to(torch.int32).repeat_interleave(S)
            n_rows = min(len(idx) * S, total - row)
            for k, v in rows.items():
                buffer[k][row: row + n_rows].copy_(v[:n_rows])
            row += n_rows
            if row >= total:
                break

    # cyclic fill of the bucket pad from the real rows, in power-of-two
    # blocks copied from row 0 as the JAX package does; nothing to copy
    # from an empty fill
    pos = row
    while row > 0 and pos < alloc:
        cap = min(row, alloc - pos, 1 << 20)
        ncopy = 1 << (cap.bit_length() - 1)
        for v in buffer.values():
            v[pos: pos + ncopy] = v[:ncopy]
        pos += ncopy
    return buffer
