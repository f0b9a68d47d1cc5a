"""Encoder quality probes: training-free matching and a short map fit.

Counterpart of acezero_tpu/pretrain/encoder_eval.py. Pretraining runs of
one recipe land far apart, and reconstruction quality follows these probes
better than the pretraining loss, so candidates are chosen by them:

  match_score     cross-view nearest-neighbour feature matching accuracy on
                  held-out synthetic scenes (no training): how distinctive
                  the features are, what registration needs;
  shortfit_score  a short scene-map fit (`MappingTrainer`, so K1 and K2 at
                  the mapping shape) on a held-out scene, scored by its
                  reprojection: how fittable the features are, what mapping
                  needs.

Both use generator seeds from 8000 up, which no corpus uses. The features
come from the encoder's device; the matching arithmetic is the JAX
package's numpy. The short fit writes its frames with `io/png.write_png`.
"""

from __future__ import annotations

import logging
import tempfile
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from acezero_tpu_torch.data.augment import normalize_images
from acezero_tpu_torch.data.synthetic import render_scene, scene_coordinate_maps
from acezero_tpu_torch.models.encoder import encoder_apply

_logger = logging.getLogger(__name__)

# seeds 8000+ reserved for encoder evaluation
EVAL_SCENES = [
    dict(seed=8001, look="across", focal=520.0, n_occluders=2),
    dict(seed=8002, look="across", focal=700.0, n_occluders=1),
]


@dataclass
class EncoderScores:
    match_at_10cm: float  # percent
    shortfit_inlier10: float | None = None  # percent cells < 10 px
    shortfit_med_px: float | None = None

    @property
    def combined(self) -> float:
        """Selection score: fittability dominates, matching tie-breaks."""
        if self.shortfit_inlier10 is None:
            return self.match_at_10cm
        return self.shortfit_inlier10 + 0.25 * self.match_at_10cm


def _device(encoder_params: dict) -> torch.device:
    return encoder_params["conv1"]["w"].device


def match_score(encoder_params: dict, n_views: int = 24, h: int = 480, w: int = 640, tau_vis: float = 0.05,
                tau_match: float = 0.10) -> float:
    """Cross-view nearest-neighbour feature matching accuracy (percent) on
    the evaluation scenes, on the encoder's device."""
    accs = []
    for kw in EVAL_SCENES:
        sc = render_scene(n_views, h=h, w=w, **kw)
        gt = scene_coordinate_maps(sc)
        with torch.no_grad():
            x = normalize_images(torch.from_numpy(sc.images_u8).to(_device(encoder_params)))
            f = encoder_apply(encoder_params, x).float().cpu().numpy()
        # adjacent ring views overlap; distant ones often do not
        for a in range(0, n_views - 1, max(1, n_views // 4)):
            b = a + 1
            fa = f[a].reshape(-1, f.shape[-1])
            fb = f[b].reshape(-1, f.shape[-1])
            fa = fa / (np.linalg.norm(fa, axis=1, keepdims=True) + 1e-9)
            fb = fb / (np.linalg.norm(fb, axis=1, keepdims=True) + 1e-9)
            nn = (fa @ fb.T).argmax(1)
            ga = gt[a].reshape(-1, 3)
            gb = gt[b].reshape(-1, 3)
            d_gt = np.linalg.norm(ga[:, None, :] - gb[None, :, :], axis=-1)
            vis = d_gt.min(1) < tau_vis
            if vis.sum() < 50:
                continue
            d = np.linalg.norm(ga - gb[nn], axis=1)
            accs.append((d[vis] < tau_match).mean())
    return float(np.mean(accs) * 100.0) if accs else float("nan")


def shortfit_score(encoder_params: dict, iterations: int = 6000, n_views: int = 40, h: int = 480,
                   w: int = 640, warmup_iterations: int = 500,
                   cooldown_iterations: int = 1000) -> tuple[float, float]:
    """(inlier10 percent, median reprojection px) of a short scene-map fit
    on the first evaluation scene, on the encoder's device.

    The schedule's warm-up and cooldown default to the JAX package's fixed
    500 and 1,000 iterations; `scripts/shortfit_probe.py` sets them to
    measure what the schedule does to a cut fit."""
    from acezero_tpu_torch.data.canvas_geom import content_mask
    from acezero_tpu_torch.data.scene import load_scene
    from acezero_tpu_torch.geometry.projection import get_pixel_grid
    from acezero_tpu_torch.io.png import write_png
    from acezero_tpu_torch.models.head import HeadConfig, head_apply_image
    from acezero_tpu_torch.training.buffer import BufferConfig
    from acezero_tpu_torch.training.loss import ReproLossConfig
    from acezero_tpu_torch.training.schedule import ScheduleConfig
    from acezero_tpu_torch.training.trainer import MappingTrainer, TrainConfig

    dev = _device(encoder_params)
    sc = render_scene(n_views, h=h, w=w, **EVAL_SCENES[0])
    with tempfile.TemporaryDirectory() as td:
        tdp = Path(td)
        for i in range(n_views):
            write_png(tdp / f"f_{i:04d}.png", sc.images_u8[i])
            np.savetxt(tdp / f"f_{i:04d}_pose.txt", sc.poses_c2w[i])
        scene = load_scene(str(tdp / "*.png"), pose_files=str(tdp / "*_pose.txt"),
                           external_focal_length=float(sc.focal))
    head_cfg = HeadConfig(num_head_blocks=1)
    cfg = TrainConfig(
        batch_size=5120,
        schedule=ScheduleConfig(schedule="1cyclepoly", iterations=iterations, learning_rate_max=0.003,
                                warmup_iterations=warmup_iterations, cooldown_iterations=cooldown_iterations),
        loss=ReproLossConfig(total_iterations=iterations, loss_type="tanh"),
        pose_refinement="none",
        refine_calibration=False,
    )
    res = MappingTrainer(scene, encoder_params, head_cfg, cfg, BufferConfig()).train()

    H, W = scene.images.canvas_hw
    grid = get_pixel_grid(H // 8, W // 8).numpy()
    canvases = scene.images.content()
    meds, inl = [], []
    for i in range(0, n_views, max(1, n_views // 6)):
        with torch.no_grad():
            img = torch.from_numpy(canvases[i: i + 1]).to(dev)
            m = content_mask(H, W, torch.from_numpy(np.asarray(scene.images.sizes[i: i + 1])).to(dev))
            x = torch.where(m[..., None], normalize_images(img), torch.zeros((), device=dev))
            feats = encoder_apply(encoder_params, x)
            coords = head_apply_image(res["head_params"], head_cfg, feats).float().cpu().numpy()[0]
        w2c = np.linalg.inv(scene.poses_c2w[i].astype(np.float64))
        pc = coords.reshape(-1, 3) @ w2c[:3, :3].T + w2c[:3, 3]
        z = np.maximum(pc[:, 2], 1e-6)
        u = scene.focals_canvas[i] * pc[:, 0] / z + W / 2.0
        v = scene.focals_canvas[i] * pc[:, 1] / z + H / 2.0
        re = np.hypot(u - grid[..., 0].ravel(), v - grid[..., 1].ravel())
        meds.append(np.median(re))
        inl.append((re < 10).mean() * 100)
    return float(np.mean(inl)), float(np.median(meds))


def evaluate_encoder(encoder_params: dict, with_shortfit: bool = True) -> EncoderScores:
    m = match_score(encoder_params)
    if not with_shortfit:
        return EncoderScores(match_at_10cm=m)
    inl, med = shortfit_score(encoder_params)
    _logger.info("encoder eval: match@10cm %.1f%%, shortfit inl10 %.1f%% (med %.1f px)", m, inl, med)
    return EncoderScores(match_at_10cm=m, shortfit_inlier10=inl, shortfit_med_px=med)
