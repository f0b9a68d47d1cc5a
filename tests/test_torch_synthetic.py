"""The port's synthetic corpus and its exact ray cast against acezero_tpu.

Tolerances: `render_scene` and `scene_coordinate_maps` are the same numpy
code with the same draws, so every array is bit-equal. The ray cast runs in
float32 in both packages, with the same operations except the three-term
products d_cam @ R^T and c2w @ Rz^-1, which torch and XLA may sum in
another order (a few ulps of the ray direction); over rays of up to 10 m
that is under 1e-5 m, held at 2e-5 m (the boxes are 4-8 m across).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acezero_tpu.data import scene_raycast as jrc
from acezero_tpu.data import synthetic as jsyn
from acezero_tpu_torch.data import scene_raycast as trc
from acezero_tpu_torch.data import synthetic as tsyn

RAY_TOL = 2e-5

# (look, photometric, texture_octaves, pitch_frac, texture_strength)
SCENE_CASES = [
    ("outward", False, 1, 0.0, 1.0),
    ("across", True, 1, 0.0, 0.4),
    ("sweep", False, 2, 0.0, 1.0),
    ("outward", True, 3, 0.5, 1.0),
    ("across", False, 2, 0.5, 0.5),
    ("sweep", True, 1, 0.3, 1.0),
]


@pytest.mark.parametrize("look,photometric,octaves,pitch_frac,strength", SCENE_CASES)
def test_render_scene_and_coordinate_maps_bit_equal(look, photometric, octaves, pitch_frac, strength):
    kw = dict(h=48, w=64, seed=11 + octaves, look=look, photometric=photometric, texture_octaves=octaves,
              pitch_frac=pitch_frac, texture_strength=strength)
    want, got = jsyn.render_scene(5, **kw), tsyn.render_scene(5, **kw)
    for field in ("images_u8", "poses_c2w", "depth", "occ_boxes"):
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype and np.array_equal(a, b), field
    assert (got.focal, got.box_half) == (want.focal, want.box_half)
    np.testing.assert_array_equal(tsyn.scene_coordinate_maps(got), jsyn.scene_coordinate_maps(want))
    np.testing.assert_array_equal(tsyn.scene_coordinate_maps(got, 4), jsyn.scene_coordinate_maps(want, 4))


def test_explicit_arguments_and_helpers_bit_equal():
    kw = dict(h=32, w=48, seed=3, focal=40.0, spread=0.5, box_half=2.5, n_occluders=3)
    want, got = jsyn.render_scene(3, **kw), tsyn.render_scene(3, **kw)
    assert np.array_equal(got.images_u8, want.images_u8) and np.array_equal(got.depth, want.depth)
    pts = np.random.default_rng(0).normal(size=(50, 3))
    tex = [m._make_texture(np.random.default_rng(5), block_amp=0.5, strength=0.7, octaves=3)(pts)
           for m in (jsyn, tsyn)]
    np.testing.assert_array_equal(tex[0], tex[1])
    for pos, tgt in (([0.1, 0.2, 0.3], [1.0, 0.0, 2.0]), ([0.0, 0.0, 0.0], [0.0, 5.0, 0.1])):
        np.testing.assert_array_equal(tsyn._look_at(np.array(pos), np.array(tgt)),
                                      jsyn._look_at(np.array(pos), np.array(tgt)))
    d = np.random.default_rng(1).normal(size=(20, 3))
    d[0] = [0.0, 1.0, 0.0]  # an axis-parallel ray (division by zero inside)
    args = (np.zeros(3), d, np.array([-0.5, -0.5, 1.0]), np.array([0.5, 0.5, 2.0]))
    np.testing.assert_array_equal(tsyn._ray_box_entry(*args), jsyn._ray_box_entry(*args))


def test_pad_occ_boxes_equal():
    boxes = [np.zeros((0, 2, 3), np.float32), None,
             np.arange(12, dtype=np.float32).reshape(2, 2, 3), np.ones((4, 2, 3), np.float32)]
    got, want = trc.pad_occ_boxes(boxes, 4), jrc.pad_occ_boxes(boxes, 4)
    assert got.dtype == want.dtype == np.float32 and np.array_equal(got, want)
    assert trc.PAD_BOX_COORD == jrc.PAD_BOX_COORD == 1.0e9


def _augmented_cameras(n_scenes=3, views=4, h=64, w=96, seed=0):
    """Scenes with 0-3 occluders padded to 4 slots, and each view's camera
    rotated about its axis and rescaled as the pretraining augments it."""
    rng = np.random.default_rng(seed)
    scenes = [jsyn.render_scene(views, h=h, w=w, seed=seed + s, n_occluders=s, look="across")
              for s in range(n_scenes)]
    occ = jrc.pad_occ_boxes([sc.occ_boxes for sc in scenes], 4)
    box_half = np.repeat([sc.box_half for sc in scenes], views).astype(np.float32)
    occ_b = np.repeat(occ, views, axis=0)
    c2w = np.concatenate([sc.poses_c2w for sc in scenes]).astype(np.float32)
    focal = np.repeat([sc.focal for sc in scenes], views).astype(np.float32)
    theta = rng.uniform(-0.26, 0.26, len(c2w)).astype(np.float32)
    scale = rng.uniform(2 / 3, 1.5, len(c2w)).astype(np.float32)
    c, s = np.cos(-theta), np.sin(-theta)
    rz = np.zeros((len(c2w), 4, 4), np.float32)
    rz[:, 0, 0], rz[:, 0, 1], rz[:, 1, 0], rz[:, 1, 1] = c, -s, s, c
    rz[:, 2, 2] = rz[:, 3, 3] = 1.0
    return box_half, occ_b, np.einsum("bij,bjk->bik", c2w, rz), focal * scale, scenes


def test_render_coord_grid_batch_matches_jax_on_augmented_cameras():
    h, w = 64, 96
    box_half, occ, c2w, focal, scenes = _augmented_cameras(h=h, w=w)
    want = np.asarray(jrc.render_coord_grid_batch(jnp.asarray(box_half), jnp.asarray(occ), jnp.asarray(c2w),
                                                  jnp.asarray(focal), jnp.float32(w / 2), jnp.float32(h / 2),
                                                  h // 8, w // 8, 8))
    got = trc.render_coord_grid_batch(*(torch.from_numpy(a) for a in (box_half, occ, c2w, focal)), w / 2, h / 2,
                                      h // 8, w // 8, 8).numpy()
    assert got.shape == want.shape == (len(c2w), h // 8, w // 8, 3) and np.isfinite(got).all()
    assert np.abs(got - want).max() <= RAY_TOL
    # the occluders win some cells: the padded slots do not hide them
    walls = np.abs(np.abs(got) - box_half[:, None, None, None]).min(-1) < 1e-4
    assert (~walls).any() and walls.any()
    # unaugmented cameras give the renderer's own maps
    sc = scenes[2]
    grid = trc.render_coord_grid(sc.box_half, occ[8], torch.from_numpy(sc.poses_c2w[1]), sc.focal, w / 2, h / 2,
                                 h // 8, w // 8).numpy()
    assert np.abs(grid - tsyn.scene_coordinate_maps(sc)[1]).max() <= 1e-4
