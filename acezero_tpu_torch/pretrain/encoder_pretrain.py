"""Encoder pretraining: multi-scene scene-coordinate regression.

Counterpart of acezero_tpu/pretrain/encoder_pretrain.py. The shared encoder
trains jointly with one scene head per corpus scene on procedurally
rendered rooms (`data/synthetic.py`) with exact ground-truth coordinates:

  - corpus: the synthetic scenes, rendered in a pool of `spawn` workers
    (each scene's draws come from its own seed, so the corpus is the same
    bits as the JAX package's `fork` pool; `fork` is unsafe in a process
    that already runs CUDA and threads);
  - model: the encoder (cuDNN bf16 convolutions, trained) and a stack of
    per-scene heads (every leaf with a leading scene axis, `mean` included).
    Each image of a batch runs its own scene's head: one `head_apply_image`,
    so one K1 launch forward and one K2 launch backward per image. The
    gather from the stack is differentiable, so two images of one scene add
    their gradients;
  - loss: masked L2 to the coordinates ray-cast at the augmented camera
    (`data/scene_raycast.py`; or the order-0 warped stride-8 map with
    `exact_supervision=False`), the tanh reprojection loss through the
    augmented camera, and optionally a symmetric InfoNCE over exact
    cross-view cell correspondences of same-scene view pairs;
  - update: a finite-loss gate (a device bool, no host sync), global-norm
    clipping of the encoder's gradient and per-scene clipping of the heads',
    then AdamW on each (the encoder at `encoder_lr_scale` times the rate).

Every random draw (batch rows, augmentation) comes from an explicit
`torch.Generator` on the device, or is passed in (`draws`), which is how
the tests feed the JAX package's draws. The result is written as an
encoder state dict the JAX package's `load_encoder` reads.
"""

from __future__ import annotations

import logging
import multiprocessing as mp
import time
from concurrent.futures import ProcessPoolExecutor
from dataclasses import dataclass, replace
from functools import partial
from pathlib import Path

import numpy as np
import torch

from acezero_tpu_torch import resolve_device
from acezero_tpu_torch.data.augment import augment_batch, warp_target_map
from acezero_tpu_torch.data.scene_raycast import pad_occ_boxes, render_coord_grid_batch
from acezero_tpu_torch.data.synthetic import render_scene, scene_coordinate_maps
from acezero_tpu_torch.models.encoder import encoder_apply, init_encoder_params
from acezero_tpu_torch.models.head import HeadConfig, head_apply_image, init_head_params
from acezero_tpu_torch.models.torch_io import save_encoder
from acezero_tpu_torch.training.optim import (
    adamw_init,
    adamw_update,
    clip_global_norm,
    clip_per_row_norm,
    tree_leaves,
    tree_unflatten,
)
from acezero_tpu_torch.training.trainer import _rotz, _with_grad
from acezero_tpu_torch.utils.precision import no_tf32

_logger = logging.getLogger(__name__)

SUB = 8  # the encoder's output stride
AUG_ROTATION_DEG, AUG_SCALE_MIN, AUG_SCALE_MAX = 15.0, 2.0 / 3.0, 1.5
STATS = ("loss", "coord_l2", "repro", "contrast")


@dataclass(frozen=True)
class PretrainConfig:
    num_scenes: int = 8
    views_per_scene: int = 24
    image_h: int = 192
    image_w: int = 256
    steps: int = 4000
    batch_images: int = 8
    learning_rate: float = 0.002  # head learning rate
    encoder_lr_scale: float = 0.1  # encoder trains slower than the heads
    encoder_weight_decay: float = 0.0  # decay on a dying-ReLU path kills channels
    warmup_steps: int = 200
    head_blocks: int = 0
    coord_loss_weight: float = 1.0
    repro_loss_weight: float = 0.02
    repro_soft_clamp: float = 25.0
    use_aug: bool = True
    seed: int = 42
    chunk_steps: int = 100
    # corpus hardness: texture-poor scenes, photometric nuisances, and the
    # share of convergent-view scenes
    low_texture_frac: float = 0.0
    photometric: bool = False
    across_frac: float = 0.0
    # corpus diversity: per-scene focal range (x W), texture octaves, and
    # exact ray-cast supervision for the augmented camera (the order-0 warp
    # of the stride-8 map misaligns it by about 3 px at the median)
    focal_min: float = 0.7
    focal_max: float = 1.4
    texture_octaves_max: int = 1
    exact_supervision: bool = True
    max_occ_boxes: int = 4
    # correspondence InfoNCE: batches become same-scene view pairs (2i,
    # 2i+1); cells whose exact points coincide are positives
    contrastive_weight: float = 0.0
    contrastive_tau_pos: float = 0.075  # meters, the floor of the adaptive radius
    contrastive_temp: float = 0.1
    grad_clip_norm: float = 10.0  # 0 disables; heads clip per scene
    # viewpoint diversity: views tilted toward floor or ceiling, and
    # contrastive pairs at any ring separation
    pitch_frac: float = 0.0
    far_pair_frac: float = 0.0


def _render_corpus_scene(views: int, kwargs: dict):
    return render_scene(views, **kwargs)


def build_corpus(cfg: PretrainConfig, workers: int | None = None) -> dict:
    """Render the synthetic corpus (numpy): images, ground-truth coordinate
    maps, poses, focals, scene ids and the geometry the ray cast needs.

    The per-scene parameters are drawn in sequence from one generator (a
    stable stream); the scenes render in `workers` spawned processes (by
    default one per core but one, at most one per scene; 1 renders here).
    """
    corpus_rng = np.random.default_rng(cfg.seed)
    scene_kwargs = []
    for s in range(cfg.num_scenes):
        strength = 1.0
        if corpus_rng.random() < cfg.low_texture_frac:
            strength = float(corpus_rng.uniform(0.25, 0.6))
        look = "across" if corpus_rng.random() < cfg.across_frac else "outward"
        focal = float(corpus_rng.uniform(cfg.focal_min, cfg.focal_max) * cfg.image_w)
        octaves = int(corpus_rng.integers(1, cfg.texture_octaves_max + 1))
        scene_kwargs.append(dict(h=cfg.image_h, w=cfg.image_w, seed=cfg.seed + s, focal=focal,
                                 texture_strength=strength, photometric=cfg.photometric, look=look,
                                 texture_octaves=octaves, pitch_frac=cfg.pitch_frac))

    if workers is None:
        workers = min(cfg.num_scenes, max(1, (mp.cpu_count() or 2) - 1))
    render = partial(_render_corpus_scene, cfg.views_per_scene)
    if workers <= 1:
        scenes = [render(kw) for kw in scene_kwargs]
    else:
        with ProcessPoolExecutor(max_workers=workers, mp_context=mp.get_context("spawn")) as pool:
            scenes = list(pool.map(render, scene_kwargs))

    V = cfg.views_per_scene
    ids = np.repeat(np.arange(cfg.num_scenes, dtype=np.int32), V)
    occ_padded = pad_occ_boxes([sc.occ_boxes for sc in scenes], cfg.max_occ_boxes)  # (S, K, 2, 3)
    return {
        "images_u8": np.concatenate([sc.images_u8 for sc in scenes]),
        "coords": np.concatenate([scene_coordinate_maps(sc) for sc in scenes]).astype(np.float32),
        "w2c": np.concatenate([np.linalg.inv(sc.poses_c2w.astype(np.float64)).astype(np.float32)
                               for sc in scenes]),
        "c2w": np.concatenate([sc.poses_c2w.astype(np.float32) for sc in scenes]),
        "focals": np.concatenate([np.full(V, sc.focal, np.float32) for sc in scenes]),
        "scene_ids": ids,
        "box_half": np.concatenate([np.full(V, sc.box_half, np.float32) for sc in scenes]),
        "occ_boxes": occ_padded[ids],  # (N_views, K, 2, 3)
    }


def corpus_to_device(corpus: dict, cfg: PretrainConfig, device) -> dict:
    """The corpus arrays the training step reads, on `device`."""
    keys = ["images_u8", "coords", "w2c", "focals", "scene_ids"]
    if cfg.exact_supervision:
        if "box_half" not in corpus:
            raise ValueError(
                "exact_supervision=True needs corpus geometry (box_half/occ_boxes/c2w from build_corpus); "
                "pass exact_supervision=False for external corpora without it")
        keys += ["c2w", "box_half", "occ_boxes"]
    data = {k: torch.from_numpy(np.ascontiguousarray(corpus[k])).to(device) for k in keys}
    data["scene_ids"] = data["scene_ids"].long()
    data["sizes"] = torch.tensor([[cfg.image_h, cfg.image_w]], dtype=torch.int32).to(device)
    return data


def _stack_heads(generator: torch.Generator, head_cfg: HeadConfig, means, device="cpu") -> dict:
    """Per-scene heads, initialised in scene order from `generator`, stacked:
    every leaf gains a leading scene axis."""
    heads = [init_head_params(generator, head_cfg, m, device) for m in means]
    return tree_unflatten(heads[0], [torch.stack(ls) for ls in zip(*(tree_leaves(h) for h in heads))])


def scene_means(corpus: dict, num_scenes: int) -> list:
    """Each scene's mean camera centre (the heads' `mean` buffers), f32."""
    means = []
    for s in range(num_scenes):
        m = corpus["scene_ids"] == s
        c2w_t = np.linalg.inv(corpus["w2c"][m].astype(np.float64))[:, :3, 3]
        means.append(c2w_t.mean(axis=0).astype(np.float32))
    return means


def init_params(cfg: PretrainConfig, corpus: dict, device="cpu") -> dict:
    """{"encoder", "heads"}: torch-default initialisation from `cfg.seed`
    (the JAX package draws from its own key; the tests cross its
    initialisation with `params_from_jax`)."""
    gen = torch.Generator().manual_seed(cfg.seed)
    return {"encoder": init_encoder_params(gen, device),
            "heads": _stack_heads(gen, HeadConfig(num_head_blocks=cfg.head_blocks),
                                  scene_means(corpus, cfg.num_scenes), device)}


def _lr_at(cfg: PretrainConfig, step: int) -> float:
    """The head learning rate at `step`: linear warm-up, then a cosine down
    to 5%, in float32 arithmetic as the JAX package computes it, returned as
    a Python float (a device tensor made here would sync the host)."""
    f = np.float32
    one = f(1.0)
    warm = min(max(f(step) / f(max(cfg.warmup_steps, 1)), f(0.0)), one)
    t = min(max(f(step - cfg.warmup_steps) / f(max(cfg.steps - cfg.warmup_steps, 1)), f(0.0)), one)
    cos = f(0.5) * (one + np.cos(f(np.pi) * t))
    return float(f(cfg.learning_rate) * warm * (f(0.05) + f(0.95) * cos))


def sample_batch(cfg: PretrainConfig, n_total: int, generator: torch.Generator, device) -> torch.Tensor:
    """A step's corpus rows (B,): independent views, or with the contrastive
    loss same-scene pairs (2i, 2i+1) of ring neighbours (at most 4 views,
    about 45 degrees, apart), a `far_pair_frac` share of them at any
    separation."""
    def randint(lo, hi, n):
        return torch.randint(lo, hi, (n,), generator=generator, device=device)

    if cfg.contrastive_weight <= 0.0:
        return randint(0, n_total, cfg.batch_images)
    P, V = cfg.batch_images // 2, cfg.views_per_scene
    scene_sel = randint(0, cfg.num_scenes, P)
    off1 = randint(0, V, P)
    delta = randint(1, max(1, min(4, V // 8)) + 1, P)
    sign = (torch.rand((P,), generator=generator, device=device) < 0.5).long() * 2 - 1
    off2 = (off1 + sign * delta) % V
    if cfg.far_pair_frac > 0.0:
        off_far = randint(1, V, P)
        use_far = torch.rand((P,), generator=generator, device=device) < cfg.far_pair_frac
        off2 = torch.where(use_far, (off1 + off_far) % V, off2)
    return (scene_sel[:, None] * V + torch.stack([off1, off2], -1)).reshape(-1)


def _contrastive_loss(feats, gt, mask, tau, cfg: PretrainConfig) -> torch.Tensor:
    """Symmetric InfoNCE over exact cross-view cell correspondences.

    feats (B, hs, ws, C) with B = 2P same-scene pairs (2i, 2i+1); gt (B, hs,
    ws, 3) exact coordinates; mask (B, hs, ws) valid cells; tau (B, hs, ws)
    per-cell positive radius in meters. The two `-inf` selects stay as the
    JAX package has them: a column with no valid cell is NaN in the
    forward pass, and the inner select drops its gradient; the positives'
    mean is a select too (what XLA makes of the JAX package's product with
    the mask), so the non-positive cells' infinities never reach it.
    """
    B = feats.shape[0]
    N = feats.shape[1] * feats.shape[2]
    f = feats.reshape(B, N, -1).float()
    f = f / (torch.sqrt(torch.sum(f * f, dim=-1, keepdim=True)) + 1e-6)
    g = gt.reshape(B, N, 3)
    m = mask.reshape(B, N)
    fa, fb = f[0::2], f[1::2]  # (P, N, C)
    ga, gb = g[0::2], g[1::2]
    ma, mb = m[0::2], m[1::2]
    tau_a = tau.reshape(B, N)[0::2]

    # the explicit difference (a matmul form rounds otherwise and may move argmin)
    d2 = torch.sum((ga[:, :, None, :] - gb[:, None, :, :]) ** 2, dim=-1)
    d2 = torch.where(mb[:, None, :], d2, torch.full_like(d2, float("inf")))  # invalid B cells never match
    dmin2, jstar = torch.min(d2, dim=2)  # the first minimum, as jnp.argmin
    pos_a = (dmin2 < tau_a**2) & ma  # (P, N)

    sim = torch.einsum("pnc,pmc->pnm", fa, fb) / cfg.contrastive_temp
    neg_inf = torch.full_like(sim, float("-inf"))
    sim = torch.where(mb[:, None, :], sim, neg_inf)
    logp_ab = torch.log_softmax(sim, dim=2)
    ce_ab = -torch.take_along_dim(logp_ab, jstar[..., None], dim=2)[..., 0]

    sim_t = torch.where(ma[:, :, None], sim, neg_inf)
    logp_ba = torch.log_softmax(sim_t, dim=1)
    ce_ba = -torch.take_along_dim(logp_ba, jstar[..., None], dim=2)[..., 0]

    n_pos = torch.clamp(pos_a.float().sum(), min=1.0)
    return torch.where(pos_a, (ce_ab + ce_ba) * 0.5, torch.zeros_like(ce_ab)).sum() / n_pos


def _loss_fn(params: dict, data: dict, batch_idx: torch.Tensor, cfg: PretrainConfig, head_cfg: HeadConfig,
             generator, aug_params):
    """(loss, (coord_l2, repro, contrast)) of one batch; differentiable in
    `params`. Runs with TF32 off (the caller's `no_tf32`)."""
    B = batch_idx.shape[0]
    imgs = data["images_u8"].index_select(0, batch_idx)
    aug = augment_batch(imgs, data["sizes"].expand(B, 2), AUG_ROTATION_DEG, AUG_SCALE_MIN, AUG_SCALE_MAX,
                        enabled=cfg.use_aug, generator=generator, params=aug_params)
    feats = encoder_apply(params["encoder"], aug["images"])  # (B, hs, ws, C) bf16

    # each image through its scene's head: the gather is one index_select a
    # leaf (its backward sums the images of one scene), then one view a image
    sid = data["scene_ids"].index_select(0, batch_idx)
    heads_b = tree_leaves(params["heads"])
    per_image = [leaf.index_select(0, sid).unbind(0) for leaf in heads_b]
    coords_pred = torch.cat([
        head_apply_image(tree_unflatten(params["heads"], [leaf[i] for leaf in per_image]), head_cfg, f[None])
        for i, f in enumerate(feats.unbind(0))])  # (B, hs, ws, 3) f32

    off = SUB // 2
    focal_b = data["focals"].index_select(0, batch_idx)
    f_aug = (focal_b * aug["scales"])[:, None, None]
    with torch.no_grad():
        if cfg.exact_supervision:
            # exact GT: ray-cast the scene at the augmented camera
            # (c2w' = c2w @ Rz(-theta), f' = s * f)
            ca, sa = torch.cos(-aug["thetas"]), torch.sin(-aug["thetas"])
            z, o = torch.zeros_like(ca), torch.ones_like(ca)
            Rz_inv = torch.stack([ca, -sa, z, z, sa, ca, z, z, z, z, o, z, z, z, z, o], -1).reshape(-1, 4, 4)
            c2w_aug = data["c2w"].index_select(0, batch_idx) @ Rz_inv
            gt = render_coord_grid_batch(
                data["box_half"].index_select(0, batch_idx), data["occ_boxes"].index_select(0, batch_idx),
                c2w_aug, focal_b * aug["scales"], cfg.image_w / 2.0, cfg.image_h / 2.0,
                cfg.image_h // SUB, cfg.image_w // SUB, SUB)
            mask = aug["masks"][:, off::SUB, off::SUB]
        else:
            # the stride-8 maps warped with the same augmentation (order 0, zeros invalid)
            gt = warp_target_map(data["coords"].index_select(0, batch_idx), aug["thetas"], aug["scales"])
            mask = aug["masks"][:, off::SUB, off::SUB] & (torch.sum(torch.abs(gt), dim=-1) > 1e-5)
    n_valid = torch.clamp(mask.float().sum(), min=1.0)
    zero = torch.zeros((), dtype=torch.float32, device=gt.device)

    coord_l2 = torch.where(mask, torch.sum((coords_pred - gt) ** 2, dim=-1), zero).sum() / n_valid

    # reprojection through the augmented camera: w2c' = Rz(theta) @ w2c
    w2c = data["w2c"].index_select(0, batch_idx)
    Rz = _rotz(aug["thetas"])
    R_eff = Rz @ w2c[:, :3, :3]
    t_eff = torch.einsum("bij,bj->bi", Rz, w2c[:, :3, 3])
    p_cam = torch.einsum("bij,bhwj->bhwi", R_eff, coords_pred) + t_eff[:, None, None, :]
    z = torch.clamp(p_cam[..., 2], min=0.1)
    hs, ws = coords_pred.shape[1:3]
    gx = (torch.arange(ws, device=z.device) + 0.5) * SUB
    gy = (torch.arange(hs, device=z.device) + 0.5) * SUB
    u = f_aug * p_cam[..., 0] / z + cfg.image_w / 2.0
    v = f_aug * p_cam[..., 1] / z + cfg.image_h / 2.0
    err = torch.abs(u - gx[None, None, :]) + torch.abs(v - gy[None, :, None])
    w = cfg.repro_soft_clamp
    repro = torch.where(mask, w * torch.tanh(err / w), zero).sum() / n_valid

    loss = cfg.coord_loss_weight * coord_l2 + cfg.repro_loss_weight * repro
    contrast = zero
    if cfg.contrastive_weight > 0.0:
        # per-cell positive radius: 1.25 stride-8 cell spacings at the cell's
        # depth (8 z / f'), at least contrastive_tau_pos
        with torch.no_grad():
            z_cam = (torch.einsum("bij,bhwj->bhwi", w2c[:, :3, :3], gt) + w2c[:, :3, 3][:, None, None, :])[..., 2]
            spacing = SUB * torch.clamp(z_cam, min=0.1) / f_aug
            tau = torch.clamp(1.25 * spacing, min=cfg.contrastive_tau_pos)
        contrast = _contrastive_loss(feats, gt, mask, tau, cfg)
        loss = loss + cfg.contrastive_weight * contrast
    return loss, (coord_l2, repro, contrast)


def pretrain_chunk(params: dict, opt_state: tuple, data: dict, step0: int, cfg: PretrainConfig,
                   head_cfg: HeadConfig, generator: torch.Generator | None = None, draws: list | None = None):
    """`cfg.chunk_steps` training steps (or one per entry of `draws`) ->
    (params, opt_state, stats): stats maps loss, coord_l2, repro and
    contrast to (steps,) device tensors. Nothing syncs the host.

    `draws`, when given, holds each step's {"batch_idx": (B,), "aug":
    {thetas, scales, brightness, contrast}} in place of draws from
    `generator` (a generator on the data's device).
    """
    n_total = data["images_u8"].shape[0]
    device = data["images_u8"].device
    stats = {k: [] for k in STATS}
    with no_tf32():
        for i in range(cfg.chunk_steps if draws is None else len(draws)):
            d = None if draws is None else draws[i]
            batch_idx = (sample_batch(cfg, n_total, generator, device) if d is None
                         else torch.as_tensor(d["batch_idx"]).to(device, torch.int64))
            aug_params = None if d is None else {k: torch.as_tensor(v).to(device) for k, v in d["aug"].items()}
            trainable = {"encoder": _with_grad(params["encoder"]), "heads": _with_grad(params["heads"])}
            leaves = tree_leaves(trainable)
            with torch.enable_grad():
                loss, terms = _loss_fn(trainable, data, batch_idx, cfg, head_cfg, generator, aug_params)
                grads = tree_unflatten(trainable, torch.autograd.grad(loss, leaves))
            lr = _lr_at(cfg, step0 + i)
            finite = torch.isfinite(loss)
            if cfg.grad_clip_norm > 0.0:
                # heads clip per scene: one diverging head cannot shrink the
                # others' update through a shared scale
                grads = {"encoder": clip_global_norm(grads["encoder"], cfg.grad_clip_norm)[0],
                         "heads": clip_per_row_norm(grads["heads"], cfg.grad_clip_norm)[0]}
            # the heads learn fast; the shared encoder updates gently and
            # without weight decay (decayed dead-ReLU channels never recover)
            enc_opt, head_opt = opt_state
            enc_lr = float(np.float32(lr) * np.float32(cfg.encoder_lr_scale))
            enc_params, enc_opt = adamw_update(params["encoder"], grads["encoder"], enc_opt, enc_lr,
                                               weight_decay=cfg.encoder_weight_decay, enabled=finite)
            head_params, head_opt = adamw_update(params["heads"], grads["heads"], head_opt, lr, enabled=finite)
            params = {"encoder": enc_params, "heads": head_params}
            opt_state = (enc_opt, head_opt)
            for k, v in zip(STATS, (loss,) + terms):
                stats[k].append(v.detach())
    return params, opt_state, {k: torch.stack(v) for k, v in stats.items()}


def pretrain_encoder(cfg: PretrainConfig = PretrainConfig(), output_path: str | Path | None = None,
                     corpus: dict | None = None, device=None) -> dict:
    """Run the pretraining on `device` (cuda unless told otherwise).

    Returns {"encoder", "history" (each chunk's last step, as the JAX
    package logs it), "chunk_means" (each chunk's mean of every term),
    "corpus" (the numpy corpus it trained on), "seconds", "corpus_seconds",
    "train_seconds", "steps"}.
    """
    dev = resolve_device(device)
    t0 = time.time()
    if corpus is None:
        _logger.info("Rendering corpus: %d scenes x %d views at %dx%d", cfg.num_scenes, cfg.views_per_scene,
                     cfg.image_h, cfg.image_w)
        corpus = build_corpus(cfg)
    data = corpus_to_device(corpus, cfg, dev)
    corpus_seconds = time.time() - t0
    _logger.info("Corpus ready in %.1fs", corpus_seconds)

    head_cfg = HeadConfig(num_head_blocks=cfg.head_blocks)
    params = init_params(cfg, corpus, dev)
    opt_state = (adamw_init(params["encoder"]), adamw_init(params["heads"]))
    generator = torch.Generator(device=dev).manual_seed(cfg.seed)

    t_train = time.time()
    step = 0
    history, chunk_means = [], []
    while step < cfg.steps:
        params, opt_state, stats = pretrain_chunk(params, opt_state, data, step, cfg, head_cfg,
                                                  generator=generator)
        step += cfg.chunk_steps
        # one fetch a chunk: the last step's terms and the chunk's means
        vals = torch.stack([stats[k][-1] for k in STATS] + [stats[k].mean() for k in STATS]).tolist()
        last = dict(zip(STATS, vals[: len(STATS)]))
        history.append(last)
        chunk_means.append(dict(zip(STATS, vals[len(STATS):])))
        _logger.info("pretrain step %5d/%d  loss %.4f  coord_l2 %.4f  repro %.2f  contrast %.3f  (%.0fs)",
                     step, cfg.steps, last["loss"], last["coord_l2"], last["repro"], last["contrast"],
                     time.time() - t0)
    train_seconds = time.time() - t_train

    encoder = params["encoder"]
    if output_path is not None:
        save_encoder(output_path, encoder)
        _logger.info("Saved pretrained encoder to %s", output_path)
    return {"encoder": encoder, "history": history, "chunk_means": chunk_means, "corpus": corpus,
            "seconds": time.time() - t0, "corpus_seconds": corpus_seconds, "train_seconds": train_seconds,
            "steps": step}


def pretrain_encoder_select(cfg: PretrainConfig = PretrainConfig(), n_candidates: int = 3,
                            output_path: str | Path | None = None, device=None) -> dict:
    """Train several candidate encoders and keep the best by measured quality.

    Candidates share one corpus and differ in the seed of their training
    (`cfg.seed + 101 c`); each is checkpointed as `<output>.cand<c>.pt` when
    it completes and scored by `encoder_eval.evaluate_encoder` (feature
    matching and a short map fit), not by its training loss.
    """
    from acezero_tpu_torch.pretrain import encoder_eval

    corpus = build_corpus(cfg)
    best = None
    results = []
    for c in range(n_candidates):
        ccfg = replace(cfg, seed=cfg.seed + 101 * c)
        cand_path = Path(output_path).with_suffix(f".cand{c}.pt") if output_path is not None else None
        res = pretrain_encoder(ccfg, corpus=corpus, output_path=cand_path, device=device)
        scores = encoder_eval.evaluate_encoder(res["encoder"])
        _logger.info("candidate %d/%d: match %.1f%% shortfit %.1f%% -> combined %.1f", c + 1, n_candidates,
                     scores.match_at_10cm, scores.shortfit_inlier10 or float("nan"), scores.combined)
        results.append({"seed": ccfg.seed, "scores": scores})
        if best is None or scores.combined > best[1].combined:
            best = (res, scores)
    res, scores = best
    if output_path is not None:
        save_encoder(output_path, res["encoder"])
        _logger.info("Saved best candidate (match %.1f%%, shortfit %.1f%%) to %s", scores.match_at_10cm,
                     scores.shortfit_inlier10 or float("nan"), output_path)
    return {"encoder": res["encoder"], "scores": scores, "candidates": results}
