"""The port's visualization (viz/) and PNG helpers against acezero_tpu's.

The renderer, on the CPU, gives the JAX package's frames: bit for bit on
points away from pixel edges and depth ties, and on random clouds at most
MAX_PIXEL_SHARE of the pixels apart (a projection summed in another order
may move a point at a pixel edge by one pixel; measured 0 here). Where
several splats tie for a pixel's depth, the largest splat index writes,
which is XLA's serial scatter on the CPU (the last write wins). The
overlays' rectangles are PIL's pixel for pixel; the text is a bitmap font
of the port's own, held only to stay inside its panel, so frames are
compared with the text drawn by neither package. write_png's files decode
to the same pixels through PIL and read_png; image_size reads PIL's size.
"""

import pickle

import numpy as np
import pytest
import torch
from PIL import Image, ImageDraw
from scipy.spatial.transform import Rotation

from acezero_tpu.viz import ReconstructionVisualizer as JVisualizer
from acezero_tpu.viz import VizConfig as JVizConfig
from acezero_tpu.viz import overlay as jov
from acezero_tpu.viz import renderer as jr
from acezero_tpu_torch.data.images import read_png
from acezero_tpu_torch.io.png import image_size, write_png
from acezero_tpu_torch.viz import ReconstructionVisualizer, VizConfig
from acezero_tpu_torch.viz import font, overlay as tov
from acezero_tpu_torch.viz import renderer as tr

MAX_PIXEL_SHARE = 1e-3
EMPTY = np.zeros((0, 3), np.float32)


@pytest.fixture
def no_text(monkeypatch):
    """Neither package draws text (PIL's ImageDraw.text and the port's _text)."""
    monkeypatch.setattr(ImageDraw.ImageDraw, "text", lambda *a, **k: None)
    monkeypatch.setattr(tov, "_text", lambda *a, **k: None)


def _frames(xyz, rgb, pose, focal, h, w):
    want = jr.composite_frame(xyz, rgb, EMPTY, EMPTY, pose, focal, h, w)
    got = tr.composite_frame(xyz, rgb, EMPTY, EMPTY, pose, focal, h, w, device="cpu")
    assert got.dtype == np.uint8 and got.shape == want.shape == (h, w, 3)
    return got, want


def _view(seed):
    pose = np.eye(4)
    pose[:3, :3] = Rotation.from_rotvec(np.random.default_rng(seed).normal(size=3) * 0.1).as_matrix()
    pose[:3, 3] = [0.1, -0.2, 0.3]
    return pose


# ------------------------------------------------------------- renderer


@pytest.mark.parametrize("h,w", [(64, 64), (120, 160)])
def test_tie_free_points_are_bit_equal(h, w):
    """Points at pixel centres in front of an identity camera, every depth
    distinct: the same image bit for bit, every pixel the nearest splat's."""
    rng = np.random.default_rng(h)
    n = 300
    px = rng.integers(0, w, n) + 0.5
    py = rng.integers(0, h, n) + 0.5
    z = 1.0 + rng.permutation(n) / 64.0  # exact binary fractions, no ties
    focal = 64.0
    xyz = np.stack([(px - w / 2) * z / focal, (py - h / 2) * z / focal, z], -1).astype(np.float32)
    rgb = rng.uniform(size=(n, 3)).astype(np.float32)
    got, want = _frames(xyz, rgb, np.eye(4), focal, h, w)
    assert np.array_equal(got, want)
    assert (got != 255).any(axis=-1).sum() > n  # the splats cover pixels


@pytest.mark.parametrize("h,w", [(64, 64), (120, 160)])
def test_random_clouds_within_pixel_share(h, w):
    rng = np.random.default_rng(w)
    xyz = (rng.normal(size=(20_000, 3)) * [1.5, 1.0, 0.8] + [0, 0, 4.0]).astype(np.float32)
    rgb = rng.uniform(size=(20_000, 3)).astype(np.float32)
    got, want = _frames(xyz, rgb, _view(1), 100.0, h, w)
    assert np.any(got != want, axis=-1).mean() <= MAX_PIXEL_SHARE


@pytest.mark.parametrize("case", ["duplicates", "overlapping_footprints", "within_1e-6", "behind_camera"])
def test_contested_pixels_follow_the_last_write(case):
    """Splats that tie for a pixel's depth: the port's largest-index rule is
    the JAX package's result on the CPU."""
    z = np.float32(2.0)
    if case == "duplicates":  # three points on one spot, one depth, three colours
        xyz = np.array([[0.0, 0.0, z]] * 3, np.float32)
    elif case == "overlapping_footprints":  # 2x2 footprints one pixel apart
        xyz = np.array([[dx * z / 50.0, dy * z / 50.0, z] for dy in (0, 1) for dx in (0, 1, 2)], np.float32)
    elif case == "within_1e-6":  # depths within the relative 1e-6 band, nearest last
        xyz = np.array([[0.0, 0.0, 2.0 + 1e-6], [0.0, 0.0, 2.0], [0.0, 0.0, 2.0 + 5e-7]], np.float32)
    else:  # behind the near plane: never drawn
        xyz = np.array([[0.0, 0.0, 0.04], [0.0, 0.0, -1.0], [0.0, 0.0, 2.0]], np.float32)
    rgb = np.random.default_rng(len(xyz)).uniform(size=(len(xyz), 3)).astype(np.float32)
    got, want = _frames(xyz, rgb, np.eye(4), 50.0, 16, 16)
    assert np.array_equal(got, want)


def test_empty_cloud_and_camera_markers():
    pose = _view(2)
    got = tr.composite_frame(EMPTY, EMPTY, EMPTY, EMPTY, pose, 100.0, 20, 30, device="cpu")
    assert np.array_equal(got, np.full((20, 30, 3), 255, np.uint8))
    poses = np.tile(np.eye(4), (3, 1, 1))
    poses[:, :3, 3] = [[0.0, 0.0, 2.0], [0.3, 0.0, 2.5], [0.0, -0.3, 3.0]]
    colors = np.eye(3)
    cam_j = jr.render_cameras(poses, colors, pose, 100.0, 48, 64)
    cam_t = tr.render_cameras(poses, colors, pose, 100.0, 48, 64)
    assert all(np.array_equal(a, b) for a, b in zip(cam_t, cam_j))
    want = jr.composite_frame(EMPTY, EMPTY, *cam_j, np.eye(4), 100.0, 48, 64)
    got = tr.composite_frame(torch.zeros((0, 3)), torch.zeros((0, 3)), *cam_t, np.eye(4), 100.0, 48, 64)
    assert np.array_equal(got, want) and (got != 255).any()


def test_cuda_asked_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tr.composite_frame(np.ones((1, 3), np.float32), np.ones((1, 3), np.float32), EMPTY, EMPTY, np.eye(4),
                           10.0, 8, 8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ReconstructionVisualizer(VizConfig())


# ------------------------------------------------------------- overlays


@pytest.mark.parametrize("h,w", [(720, 1280), (120, 160), (40, 60)])
def test_overlays_match_pil_without_text(h, w, no_text):
    """Panels and bars at every size (clipped at the small ones), float bar
    ends and histogram heights: PIL's pixels."""
    rng = np.random.default_rng(h)
    img = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
    for title, sub in (("", None), ("", ""), ("Neural Mapping", "iteration1 · step 500")):
        assert np.array_equal(tov.draw_caption(img, title, sub), jov.draw_caption(img, title, sub))
    for frac in (0.0, 0.3333, 0.77777, 1.0, 1.7, -0.2):
        assert np.array_equal(tov.draw_loading_bar(img, frac, "x"), jov.draw_loading_bar(img, frac, "x"))
    for n in (0, 1, 7, 300):
        confs = rng.uniform(0, 5000, n)
        for thr in (500.0, 1234.5):
            assert np.array_equal(tov.draw_conf_histogram(img, confs, thr),
                                  jov.draw_conf_histogram(img, confs, thr))


def test_empty_caption_bit_equal_with_text_on():
    img = np.full((200, 700, 3), 255, np.uint8)
    assert np.array_equal(tov.draw_caption(img, ""), jov.draw_caption(img, ""))
    assert np.array_equal(tov.draw_loading_bar(img, 0.5), jov.draw_loading_bar(img, 0.5))


def test_glyphs_stay_inside_their_panels():
    """The port's text pixels, against its own frame without text, lie in
    the panel each label is drawn in; every character has a glyph."""
    h, w = 720, 1280
    img = np.full((h, w, 3), 255, np.uint8)
    captions = {
        "caption": (lambda im: tov.draw_caption(im, "Reconstruction", "60 cameras, colored by registration round"),
                    (16, 14, 636, 80)),
        "bar": (lambda im: tov.draw_loading_bar(im, 0.4, "training the scene map"), (16, h - 38, w - 16, h - 16)),
        "histogram": (lambda im: tov.draw_conf_histogram(im, np.array([100.0, 900.0]), 500.0),
                      (w - 316, h - 168, w - 16, h - 48)),
    }
    for name, (draw, (x0, y0, x1, y1)) in captions.items():
        with_text = draw(img)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tov, "_text", lambda *a, **k: None)
            without = draw(img)
        ys, xs = np.nonzero(np.any(with_text != without, axis=-1))
        assert len(ys) > 50, name
        assert ys.min() >= y0 and ys.max() <= y1 and xs.min() >= x0 and xs.max() <= x1, name
    printable = "".join(chr(c) for c in range(32, 127)) + "·"
    assert all(ch in font._GLYPHS for ch in printable)
    assert font.text_mask("ab", 2).shape == (2 * font.GLYPH_H, 2 * 2 * font.ADVANCE)


# ----------------------------------------------------------- visualizer


def _poses(n, seed):
    poses = np.tile(np.eye(4), (n, 1, 1))
    for i in range(n):
        poses[i, :3, :3] = Rotation.random(random_state=np.random.RandomState(seed + i)).as_matrix()
        poses[i, :3, 3] = np.random.default_rng(seed + i).normal(size=3)
    return poses


def test_visualizer_sequence_matches_jax(tmp_path, no_text):
    """The same calls on both visualizers: smoothed centre and radius within
    1e-6, every frame within MAX_PIXEL_SHARE (text off), and the budget
    thinning's default_rng(0) choice."""
    size = dict(frame_h=120, frame_w=160, focal=120.0, point_budget=900)
    vt = ReconstructionVisualizer(VizConfig(target_path=tmp_path / "t", **size), device="cpu")
    vj = JVisualizer(JVizConfig(target_path=tmp_path / "j", **size))
    rng = np.random.default_rng(5)
    for step in range(3):
        xyz = (rng.normal(size=(400, 3)) + [0, 0, step]).astype(np.float32)
        rgb = rng.integers(0, 256, (400, 3)).astype(np.uint8)
        for v in (vt, vj):
            v.update_point_cloud(xyz, rgb)
            v.render_mapping_frame(_poses(4, step), caption=f"iteration{step} · step 10", progress=0.25 * step)
            v.render_reloc_frame(_poses(5, step), np.array([100.0, 600.0, 1500.0, 3000.0, 0.0]), caption="q")
            v.record_registration(f"f{step}.png", 600.0, step)
        assert np.array_equal(vt.cloud_xyz, vj.cloud_xyz) and np.array_equal(vt.cloud_rgb, vj.cloud_rgb)
        np.testing.assert_allclose(vt._smoothed_center, vj._smoothed_center, rtol=0, atol=1e-6)
        assert abs(vt._smoothed_radius - vj._smoothed_radius) <= 1e-6
    assert len(vt.cloud_xyz) == 900
    for v in (vt, vj):
        v.render_final_sweep(_poses(5, 9), np.array([1.0, 1.0, 2.0, 3.0, 0.0]), num_frames=4)
    names = sorted(p.name for p in (tmp_path / "t").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "j").iterdir()) and len(names) == 10
    for name in names:
        got, want = read_png(tmp_path / "t" / name), np.asarray(Image.open(tmp_path / "j" / name))
        assert np.any(got != want, axis=-1).mean() <= MAX_PIXEL_SHARE, name
    assert vt.frames_by_kind == {"mapping": 3, "reloc": 3, "sweep": 4}
    assert all(len(v) == 10 for v in vt.frame_seconds.values())


def test_pickles_cross_load_both_ways(tmp_path):
    rng = np.random.default_rng(6)
    vt = ReconstructionVisualizer(VizConfig(target_path=tmp_path / "t", frame_h=24, frame_w=32), device="cpu")
    vj = JVisualizer(JVizConfig(target_path=tmp_path / "j", frame_h=24, frame_w=32))
    for v in (vt, vj):
        v.update_point_cloud(rng.normal(size=(50, 3)).astype(np.float32), np.full((50, 3), 7, np.uint8))
        v.render_mapping_frame(_poses(2, 0))
        v.record_registration("a.png", 900.0, 2)
    vt.save_state(tmp_path / "t.pkl")
    vj.save_state(tmp_path / "j.pkl")
    with open(tmp_path / "t.pkl", "rb") as f:
        state = pickle.load(f)
    assert not any(isinstance(v, torch.Tensor) for v in state.values())
    back_j = JVisualizer(JVizConfig(target_path=tmp_path / "j2"))
    back_j.load_state(tmp_path / "t.pkl")
    back_t = ReconstructionVisualizer(VizConfig(target_path=tmp_path / "t2"), device="cpu")
    back_t.load_state(tmp_path / "j.pkl")
    for a, b in ((back_j, vt), (back_t, vj)):
        assert a.frame_idx == b.frame_idx == 1 and a.registration_history == b.registration_history
        assert np.array_equal(a.cloud_xyz, b.cloud_xyz) and np.array_equal(a.cloud_rgb, b.cloud_rgb)
        assert np.array_equal(a._smoothed_center, b._smoothed_center)
        assert a._smoothed_radius == b._smoothed_radius


def test_device_cloud_refreshed_only_on_change(tmp_path):
    v = ReconstructionVisualizer(VizConfig(target_path=tmp_path, frame_h=16, frame_w=16), device="cpu")
    v.update_point_cloud(np.ones((10, 3), np.float32), np.ones((10, 3), np.uint8))
    v.render_mapping_frame(_poses(1, 0))
    first = v._cloud_on_device
    v.render_mapping_frame(_poses(1, 0))
    assert v._cloud_on_device is first and first[0].shape == (10, 3)
    v.update_point_cloud(np.ones((2, 3), np.float32), np.ones((2, 3), np.uint8))
    assert v._cloud_on_device is None
    v.render_mapping_frame(_poses(1, 0))
    assert v._cloud_on_device[0].shape == (12, 3)
    v.save_state(tmp_path / "s.pkl")
    v.load_state(tmp_path / "s.pkl")
    assert v._cloud_on_device is None


# ------------------------------------------------------------ PNG helpers


@pytest.mark.parametrize("shape", [(1, 1), (17, 23), (17, 23, 3), (90, 120, 3)])
def test_write_png_decodes_identically(shape, tmp_path):
    img = np.random.default_rng(sum(shape)).integers(0, 256, shape).astype(np.uint8)
    write_png(tmp_path / "a.png", img)
    assert np.array_equal(np.asarray(Image.open(tmp_path / "a.png")), img)
    assert np.array_equal(read_png(tmp_path / "a.png"), img)
    with pytest.raises(ValueError):
        write_png(tmp_path / "b.png", img.astype(np.float32))


@pytest.mark.parametrize("mode,size", [("RGB", (45, 31)), ("L", (20, 50)), ("RGBA", (7, 3))])
def test_image_size_png_and_jpeg(mode, size, tmp_path):
    img = Image.fromarray(np.random.default_rng(1).integers(0, 256, (size[1], size[0], len(mode)))
                          .astype(np.uint8).squeeze())
    img.save(tmp_path / "a.png")
    assert image_size(tmp_path / "a.png") == Image.open(tmp_path / "a.png").size == size
    if mode != "RGBA":
        for i, kw in enumerate(({}, {"progressive": True}, {"quality": 40, "exif": b"Exif\x00\x00" + bytes(900)})):
            img.save(tmp_path / f"a{i}.jpg", **kw)
            assert image_size(tmp_path / f"a{i}.jpg") == Image.open(tmp_path / f"a{i}.jpg").size == size
    (tmp_path / "x.bmp").write_bytes(b"BM" + bytes(40))
    with pytest.raises(ValueError, match="neither a PNG nor a JPEG"):
        image_size(tmp_path / "x.bmp")
