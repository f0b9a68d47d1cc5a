"""The port's warp, augmentation and depth helpers against acezero_tpu.

Tolerances: the warp computes the same function with the same f32
operations except the summation order of its resize products (batched
GEMMs in both), so it agrees to 1e-5 on the tests/test_warp.py inputs.
Augmented images add the photometric jitter (a masked mean summed in
another order): 1e-4. Masks compare coordinates against the content
rectangle analytically; they may differ only where a source coordinate lies
within 1e-4 of a mask edge. The nearest-sampled target maps and the depth
helpers are exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
from PIL import Image
import pytest
import torch

from acezero_tpu.data import augment as ja
from acezero_tpu.data import depth as jd
from acezero_tpu.data.warp import affine_warp_batch as j_warp
from acezero_tpu_torch.data import augment as ta
from acezero_tpu_torch.data import depth as td
from acezero_tpu_torch.data.warp import affine_warp_batch as t_warp

H, W = 96, 128


def _smooth_image(rng):  # tests/test_warp.py:19-21
    small = rng.normal(size=(12, 16))
    return np.asarray(jax.image.resize(jnp.asarray(small), (H, W), "cubic"), np.float32)


def _ramp():  # tests/test_warp.py:37-39
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    return 0.013 * (xx + 0.5) + 0.007 * (yy + 0.5) + 0.3


WARP_CASES = {
    "identity": ([0.0], [1.0]),
    "ramp": ([0.2, -0.26, 0.1, -0.05, 0.25], [0.8, 1.4, 0.67, 1.5, 1.0]),
    "smooth": ([0.2, -0.26, 0.1], [1.0, 1.3, 1.45]),
}


@pytest.mark.parametrize("case", sorted(WARP_CASES))
def test_affine_warp_matches_jax(case, rng):
    thetas, scales = (np.asarray(v, np.float32) for v in WARP_CASES[case])
    img = _ramp() if case == "ramp" else _smooth_image(rng)
    x = np.tile(img[None], (len(thetas), 1, 1))
    want = np.asarray(j_warp(jnp.asarray(x), jnp.asarray(thetas), jnp.asarray(scales), 15.0, 1.5))
    got = t_warp(torch.from_numpy(x), torch.from_numpy(thetas), torch.from_numpy(scales), 15.0, 1.5).numpy()
    assert got.shape == want.shape == (len(thetas), H, W)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def _jax_draws(key, n, rot=15.0, smin=1 / 1.5, smax=1.5, bw=0.1):
    """The draws augment_batch makes from `key` (acezero_tpu/data/augment.py:123-139)."""
    k_theta, k_scale, k_bright, k_contrast = jax.random.split(key, 4)
    u = lambda k, lo, hi: np.asarray(jax.random.uniform(k, (n,), minval=lo, maxval=hi))
    return {"thetas": u(k_theta, -1.0, 1.0) * np.float32(rot * np.pi / 180.0), "scales": u(k_scale, smin, smax),
            "brightness": u(k_bright, 1.0 - bw, 1.0 + bw), "contrast": u(k_contrast, 1.0 - bw, 1.0 + bw)}


@pytest.mark.parametrize("seed", [0, 1])
def test_augment_batch_matches_jax(seed):
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 256, (5, H, W)).astype(np.uint8)
    sizes = np.array([[96, 128], [80, 120], [90, 100], [96, 128], [64, 128]], np.int32)
    key = jax.random.PRNGKey(seed)
    want = ja.augment_batch(key, jnp.asarray(imgs), jnp.asarray(sizes), 15.0, 1 / 1.5, 1.5, 0.1, True)
    draws = _jax_draws(key, 5)
    # thetas/scales come back from JAX: use them as they are
    draws["thetas"], draws["scales"] = np.asarray(want["thetas"]), np.asarray(want["scales"])
    np.testing.assert_allclose(draws["thetas"], _jax_draws(key, 5)["thetas"], atol=1e-7)
    got = ta.augment_batch(torch.from_numpy(imgs), torch.from_numpy(sizes), 15.0, 1 / 1.5, 1.5, 0.1, True,
                           params={k: torch.from_numpy(v.copy()) for k, v in draws.items()})
    assert got["images"].shape == (5, H, W, 1) and got["masks"].dtype == torch.bool
    np.testing.assert_allclose(got["images"].numpy(), np.asarray(want["images"]), atol=1e-4, rtol=0)

    # masks: equal except where a source coordinate is within 1e-4 of an edge
    diff = got["masks"].numpy() != np.asarray(want["masks"])
    if diff.any():
        A, b = ta._inverse_affine(torch.from_numpy(draws["thetas"]), torch.from_numpy(draws["scales"]),
                                  (W / 2.0, H / 2.0))
        yy, xx = np.mgrid[0:H, 0:W].astype(np.float64) + 0.5
        A, b = A.double().numpy(), b.double().numpy()
        for n, y, x in zip(*np.nonzero(diff)):
            sx = A[n, 0, 0] * xx[y, x] + A[n, 0, 1] * yy[y, x] + b[n, 0]
            sy = A[n, 1, 0] * xx[y, x] + A[n, 1, 1] * yy[y, x] + b[n, 1]
            h, w = sizes[n]
            y0, x0 = (H - h) // 2, (W - w) // 2
            edges_y = np.array([y0 + 0.5, y0 + h - 0.5])
            edges_x = np.array([x0 + 0.5, x0 + w - 0.5])
            assert min(np.abs(sy - edges_y).min(), np.abs(sx - edges_x).min()) < 1e-4
    assert diff.mean() < 1e-3


def test_augment_disabled_and_generator_draws():
    rng = np.random.default_rng(3)
    imgs = torch.from_numpy(rng.integers(0, 256, (2, 32, 48)).astype(np.uint8))
    sizes = torch.tensor([[32, 48], [24, 40]], dtype=torch.int32)
    off = ta.augment_batch(imgs, sizes, 15.0, 1 / 1.5, 1.5, 0.1, enabled=False)
    want = ja.augment_batch(jax.random.PRNGKey(0), jnp.asarray(imgs.numpy()), jnp.asarray(sizes.numpy()),
                            15.0, 1 / 1.5, 1.5, 0.1, False)
    np.testing.assert_allclose(off["images"].numpy(), np.asarray(want["images"]), atol=1e-6)
    np.testing.assert_array_equal(off["masks"].numpy(), np.asarray(want["masks"]))
    a = ta.augment_batch(imgs, sizes, 15.0, 1 / 1.5, 1.5, 0.1, generator=torch.Generator().manual_seed(5))
    b = ta.augment_batch(imgs, sizes, 15.0, 1 / 1.5, 1.5, 0.1, generator=torch.Generator().manual_seed(5))
    assert torch.equal(a["images"], b["images"])
    assert float(a["thetas"].abs().max()) <= np.radians(15.0) and float(a["scales"].min()) >= 1 / 1.5


@pytest.mark.parametrize("black_white", [0.1, 0.3])
def test_draw_aug_params_are_the_batch_draws(black_white):
    """augment_batch's own draws are draw_aug_params' on the same stream,
    inside the ranges it is given."""
    rng = np.random.default_rng(6)
    imgs = torch.from_numpy(rng.integers(0, 256, (5, 32, 48)).astype(np.uint8))
    sizes = torch.tensor([[32, 48]] * 5, dtype=torch.int32)
    params = ta.draw_aug_params(torch.Generator().manual_seed(8), 5, 15.0, 1 / 1.5, 1.5, black_white)
    drawn = ta.augment_batch(imgs, sizes, 15.0, 1 / 1.5, 1.5, black_white,
                             generator=torch.Generator().manual_seed(8))
    given = ta.augment_batch(imgs, sizes, 15.0, 1 / 1.5, 1.5, black_white, params=params)
    for k in ("images", "masks", "thetas", "scales"):
        assert torch.equal(drawn[k], given[k]), k
    for k in ("brightness", "contrast"):
        assert float(params[k].min()) >= 1 - black_white and float(params[k].max()) <= 1 + black_white
    assert float(params["thetas"].abs().max()) <= np.radians(15.0)


def test_warp_target_map_exact():
    rng = np.random.default_rng(4)
    tm = rng.normal(size=(6, 12, 16, 3)).astype(np.float32)
    tm[:, ::3, ::5] = 0.0  # "invalid" cells
    thetas = np.asarray(rng.uniform(-0.26, 0.26, 6), np.float32)
    scales = np.asarray(rng.uniform(1 / 1.5, 1.5, 6), np.float32)
    thetas[0], scales[0] = 0.0, 1.0
    want = np.stack([np.asarray(ja.warp_target_map(jnp.asarray(tm[i]), jnp.asarray(thetas[i]),
                                                   jnp.asarray(scales[i]))) for i in range(6)])
    got = ta.warp_target_map(torch.from_numpy(tm), torch.from_numpy(thetas), torch.from_numpy(scales)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[0], tm[0])


@pytest.mark.parametrize("src_hw,content_hw,canvas_hw", [((480, 640), (480, 640), (480, 640)),
                                                          ((240, 320), (360, 480), (368, 480)),
                                                          ((480, 640), (360, 480), (368, 480)),
                                                          ((97, 131), (75, 101), (80, 104))])
def test_depth_to_canvas_matches_pil(src_hw, content_hw, canvas_hw):
    depth = np.random.default_rng(5).uniform(0.5, 4.0, src_hw)
    want = jd.depth_to_canvas(depth, content_hw, canvas_hw)
    got = td.depth_to_canvas(depth, content_hw, canvas_hw)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_depth_files_and_seed_coordinates(tmp_path):
    depth = np.random.default_rng(6).uniform(0.0, 5.0, (48, 64))
    depth[:4] = 0.0
    np.save(tmp_path / "d.npy", depth)
    np.testing.assert_array_equal(td.load_depth_file(tmp_path / "d.npy"), jd.load_depth_file(str(tmp_path / "d.npy")))
    # a 16-bit depth PNG in millimetres reads as metres, as the JAX package reads it through PIL
    mm = np.round(depth * 1000).astype(np.uint16)
    Image.fromarray(mm).save(tmp_path / "d.png")
    got_png = td.load_depth_file(tmp_path / "d.png")
    np.testing.assert_array_equal(got_png, jd.load_depth_file(str(tmp_path / "d.png")))
    np.testing.assert_array_equal(got_png, mm / 1000.0)
    np.testing.assert_array_equal(td.subsample_depth(depth.astype(np.float32)), jd.subsample_depth(depth.astype(np.float32)))
    pose = np.eye(4)
    pose[:3, :3] = np.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    pose[:3, 3] = [0.3, -0.2, 1.5]
    canvas = depth.astype(np.float32)
    np.testing.assert_array_equal(td.seed_scene_coordinates(canvas, 55.0, pose),
                                  jd.seed_scene_coordinates(canvas, 55.0, pose))
