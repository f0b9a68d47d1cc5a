"""Procedural multi-view scene generator (textured room interiors).

Counterpart of acezero_tpu/data/synthetic.py, the same numpy code draw for
draw (the port keeps its own copy: it imports nothing of the JAX package).
It renders the encoder-pretraining corpus (`pretrain/encoder_pretrain.py`),
the seed-depth corpus (`pretrain/depth_pretrain.py`) and the held-out
scenes of the encoder probes (`pretrain/encoder_eval.py`).

Geometry: cameras inside an axis-aligned box; each pixel ray is intersected
with the interior and shaded by a per-scene random multi-frequency 3D
texture (smooth sinusoid mixture + quantized block pattern), giving
perfectly multi-view-consistent images with exact depth. Every draw comes
from one numpy generator seeded per scene, in a fixed order: the octave
draws (`_make_texture`) and the pitch draws (`render_scene`) follow the
base draws, so scenes with `octaves=1` and `pitch_frac=0` keep their
historical bits (the shipped `weights/tpu_depth_v4.pt` was trained on
them).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class SyntheticScene:
    images_u8: np.ndarray  # (N, h, w) grayscale
    poses_c2w: np.ndarray  # (N, 4, 4)
    depth: np.ndarray  # (N, h, w) camera-z depth
    focal: float
    # scene geometry (for analytic re-rendering of supervision under
    # augmented virtual cameras — see render_coord_grid): interior AABB
    # half-extent and occluder boxes (K, 2, 3) as (lo, hi) corners.
    box_half: float = 0.0
    occ_boxes: np.ndarray | None = None


def _make_texture(
    rng: np.random.Generator,
    block_amp: float = 0.35,
    strength: float = 1.0,
    octaves: int = 1,
):
    """`strength` < 1 produces texture-poor surfaces (flat walls with faint
    structure) — the hard regime for feature learning. `octaves` > 1 adds
    finer hashed-block layers at 3x/9x the base frequency (real scenes have
    multi-scale structure; single-scale blocks leave patch interiors blank).
    Extra octave draws happen *after* the base draws so octaves=1 scenes are
    bit-identical to the historical generator output."""
    n_waves = 6
    freqs = np.exp(rng.uniform(np.log(0.8), np.log(30.0), n_waves))
    dirs = rng.normal(size=(n_waves, 3))
    dirs *= (freqs / np.linalg.norm(dirs, axis=1))[:, None]
    phases = rng.uniform(0, 2 * np.pi, n_waves)
    amps = rng.uniform(0.05, 0.15, n_waves) * strength
    block_amp = block_amp * strength
    block_scale = rng.uniform(1.0, 6.0)
    hx, hy, hz = rng.integers(1, 1 << 30, 3)
    extra = []
    for o in range(1, octaves):
        e_scale = block_scale * (3.0**o) * rng.uniform(0.8, 1.25)
        e_amp = block_amp * rng.uniform(0.25, 0.5) / o
        e_hash = rng.integers(1, 1 << 30, 3)
        extra.append((e_scale, e_amp, e_hash))

    def texture(points: np.ndarray) -> np.ndarray:
        val = np.full(points.shape[:-1], 0.5)
        for k in range(n_waves):
            val = val + amps[k] * np.sin(points @ dirs[k] + phases[k])
        blocks = np.floor(points * block_scale).astype(np.int64)
        hashed = ((blocks[..., 0] * hx) ^ (blocks[..., 1] * hy) ^ (blocks[..., 2] * hz)) % 256
        val = (1 - block_amp) * val + block_amp * (hashed / 255.0)
        for e_scale, e_amp, (ex, ey, ez) in extra:
            eb = np.floor(points * e_scale).astype(np.int64)
            eh = ((eb[..., 0] * ex) ^ (eb[..., 1] * ey) ^ (eb[..., 2] * ez)) % 256
            val = val + e_amp * (eh / 255.0 - 0.5)
        return np.clip(val, 0.0, 1.0)

    return texture


def _look_at(position: np.ndarray, target: np.ndarray) -> np.ndarray:
    """cam-to-world rotation, +z toward target, OpenCV convention."""
    z = target - position
    z = z / np.linalg.norm(z)
    up = np.array([0.0, -1.0, 0.0])
    if abs(np.dot(up, z)) > 0.95:
        up = np.array([1.0, 0.0, 0.0])
    x = np.cross(up, z)
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    return np.stack([x, y, z], axis=1)


def _ray_box_entry(origin, d_world, lo, hi):
    """Entry/exit distances of rays into an AABB; entry=inf when missed."""
    with np.errstate(divide="ignore", invalid="ignore"):
        t0 = (lo - origin) / d_world
        t1 = (hi - origin) / d_world
    t_near = np.minimum(t0, t1)
    t_far = np.maximum(t0, t1)
    t_entry = np.max(np.where(np.isfinite(t_near), t_near, -np.inf), axis=-1)
    t_exit = np.min(np.where(np.isfinite(t_far), t_far, np.inf), axis=-1)
    hit = (t_entry <= t_exit) & (t_exit > 0) & (t_entry > 1e-3)
    return np.where(hit, t_entry, np.inf)


def render_scene(
    n_views: int,
    h: int = 96,
    w: int = 128,
    focal: float | None = None,
    seed: int = 0,
    spread: float | None = None,
    box_half: float | None = None,
    n_occluders: int | None = None,
    look: str = "outward",
    texture_strength: float = 1.0,
    photometric: bool = False,
    texture_octaves: int = 1,
    pitch_frac: float = 0.0,
) -> SyntheticScene:
    """`look`: camera orientation pattern — "outward" (panorama-like ring,
    weakly conditioned view graph), "across" (convergent views through the
    room center: strong parallax overlap), or "sweep" (forward-facing arc:
    cameras on the back half of the ring all looking at the front wall —
    the 7-Scenes-style handheld-scan regime with no loop to close).

    `texture_strength` < 1 renders texture-poor surfaces; `photometric=True`
    adds per-view exposure gain, vignetting, and sensor noise — non-multi-
    view-consistent nuisances that real cameras have and the pure texture
    renderer lacks (pretraining realism knobs; defaults leave the hermetic
    test scenes bit-identical)."""
    rng = np.random.default_rng(seed)
    if focal is None:
        focal = float(rng.uniform(0.7, 1.4) * w)
    if box_half is None:
        box_half = float(rng.uniform(2.0, 4.0))
    if spread is None:
        spread = 0.25 * box_half
    if n_occluders is None:
        n_occluders = int(rng.integers(0, 4))
    texture = _make_texture(rng, strength=texture_strength, octaves=texture_octaves)
    occ_textures = [
        _make_texture(rng, block_amp=0.5, strength=texture_strength, octaves=texture_octaves)
        for _ in range(n_occluders)
    ]
    # interior occluder boxes: depth discontinuities + close-range structure
    occ_boxes = []
    for _ in range(n_occluders):
        for _try in range(20):
            center = rng.uniform(-0.65 * box_half, 0.65 * box_half, 3)
            half = rng.uniform(0.08, 0.3, 3) * box_half
            # keep boxes clear of the camera ring around the room center
            if np.linalg.norm(center) - float(np.max(half)) > 0.45 * box_half:
                occ_boxes.append((center - half, center + half))
                break
    cx, cy = w / 2.0, h / 2.0

    images = np.zeros((n_views, h, w), np.uint8)
    depths = np.zeros((n_views, h, w), np.float32)
    poses = np.zeros((n_views, 4, 4), np.float32)

    uu, vv = np.meshgrid(np.arange(w) + 0.5, np.arange(h) + 0.5)
    d_cam = np.stack([(uu - cx) / focal, (vv - cy) / focal, np.ones_like(uu)], axis=-1)

    for i in range(n_views):
        if look == "sweep":
            # forward-facing arc: back-half positions, front-wall targets
            angle = np.pi * (0.75 + 0.5 * i / max(n_views - 1, 1)) + rng.normal() * 0.03
        else:
            angle = 2 * np.pi * i / n_views + rng.normal() * 0.05
        position = np.array(
            [
                spread * np.cos(angle) + rng.normal() * 0.1,
                rng.normal() * 0.2,
                spread * np.sin(angle) + rng.normal() * 0.1,
            ]
        )
        if look == "across":
            target = rng.normal(size=3) * 0.15 * box_half  # through the center
        elif look == "sweep":
            # look toward the front wall (the arc faces -x after the 3pi/4
            # offset above... front = +x here: angle centered at pi means
            # positions at x<0, so targets sit on the +x wall region)
            target = np.array(
                [
                    0.8 * box_half,
                    rng.normal() * 0.25 * box_half,
                    rng.normal() * 0.35 * box_half,
                ]
            )
        else:
            target = position + np.array([np.cos(angle), rng.normal() * 0.2, np.sin(angle)])
        if pitch_frac > 0.0:
            # tilt a fraction of views steeply toward floor/ceiling: grazing
            # surface views are where viewpoint-invariance is hardest (the
            # registration failures cluster on floor-dominant frames), and a
            # level-ring corpus never shows them. Draws happen after the
            # per-view base draws, so pitch_frac=0 scenes stay bit-identical.
            if rng.random() < pitch_frac:
                target = target + np.array(
                    [0.0, rng.uniform(-1.2, 1.2) * box_half, 0.0]
                )
        R = _look_at(position, target)

        T = np.eye(4)
        T[:3, :3] = R
        T[:3, 3] = position
        poses[i] = T

        d_world = d_cam @ R.T
        t_exit = np.full((h, w), np.inf)
        for axis in range(3):
            d = d_world[..., axis]
            with np.errstate(divide="ignore", invalid="ignore"):
                t_lo = (-box_half - position[axis]) / d
                t_hi = (box_half - position[axis]) / d
            t_far = np.maximum(t_lo, t_hi)
            t_far = np.where(np.isfinite(t_far), t_far, np.inf)
            t_exit = np.minimum(t_exit, t_far)

        t_hit = t_exit
        tex_id = np.full((h, w), -1, np.int8)
        for bi, (lo, hi) in enumerate(occ_boxes):
            t_box = _ray_box_entry(position, d_world, lo, hi)
            closer = t_box < t_hit
            t_hit = np.where(closer, t_box, t_hit)
            tex_id = np.where(closer, np.int8(bi), tex_id)

        points = position + d_world * t_hit[..., None]
        shade = texture(points)
        for bi, occ_tex in enumerate(occ_textures):
            m = tex_id == bi
            if m.any():
                shade[m] = occ_tex(points[m])
        if photometric:
            gain = rng.uniform(0.75, 1.25)
            r2 = ((uu - cx) ** 2 + (vv - cy) ** 2) / (cx**2 + cy**2)
            vignette = 1.0 - rng.uniform(0.0, 0.35) * r2
            shade = np.clip(
                shade * gain * vignette + rng.normal(size=shade.shape) * rng.uniform(0.0, 0.02),
                0.0,
                1.0,
            )
        images[i] = (shade * 255).astype(np.uint8)
        depths[i] = t_hit  # camera-z depth (d_cam z-component is 1)

    occ_arr = (
        np.stack([np.stack(b) for b in occ_boxes]).astype(np.float32)
        if occ_boxes
        else np.zeros((0, 2, 3), np.float32)
    )
    return SyntheticScene(
        images_u8=images,
        poses_c2w=poses,
        depth=depths,
        focal=focal,
        box_half=float(box_half),
        occ_boxes=occ_arr,
    )


def scene_coordinate_maps(scene: SyntheticScene, subsample: int = 8) -> np.ndarray:
    """Exact GT world-coordinate maps (N, h/sub, w/sub, 3) at cell centers.

    Ray-casts the scene geometry at the framework's cell-center pixel
    coordinates ((k + 0.5) * subsample, matching
    geometry.projection.get_pixel_grid) instead of resampling the rendered
    depth maps — depth samples sit at index+0.5 coordinates, and that
    half-pixel offset is a systematic ~cm-scale bias that golden tests of
    sheet alignment cannot tolerate."""
    n, h, w = scene.depth.shape
    hs, ws = h // subsample, w // subsample
    ys = (np.arange(hs) + 0.5) * subsample
    xs = (np.arange(ws) + 0.5) * subsample
    xx, yy = np.meshgrid(xs, ys)
    cx, cy = w / 2.0, h / 2.0
    d_cam = np.stack(
        [(xx - cx) / scene.focal, (yy - cy) / scene.focal, np.ones_like(xx)], axis=-1
    )
    bh = float(scene.box_half)
    out = np.empty((n, hs, ws, 3), np.float32)
    for i in range(n):
        R = scene.poses_c2w[i, :3, :3].astype(np.float64)
        pos = scene.poses_c2w[i, :3, 3].astype(np.float64)
        d_world = d_cam @ R.T
        t_exit = np.full((hs, ws), np.inf)
        for axis in range(3):
            d = d_world[..., axis]
            with np.errstate(divide="ignore", invalid="ignore"):
                t_lo = (-bh - pos[axis]) / d
                t_hi = (bh - pos[axis]) / d
            t_far = np.maximum(t_lo, t_hi)
            t_far = np.where(np.isfinite(t_far), t_far, np.inf)
            t_exit = np.minimum(t_exit, t_far)
        t_hit = t_exit
        for lo, hi in scene.occ_boxes:
            t_box = _ray_box_entry(pos, d_world, lo, hi)
            t_hit = np.where(t_box < t_hit, t_box, t_hit)
        out[i] = (pos + t_hit[..., None] * d_world).astype(np.float32)
    return out
