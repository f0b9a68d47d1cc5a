"""The port's zlib PNG decoder and canvas path against PIL and acezero_tpu."""

import glob
import zlib
import struct

import numpy as np
import pytest
import torch
from PIL import Image

from acezero_tpu.data import images as jimg
from acezero_tpu.data.augment import normalize_images as j_normalize
from acezero_tpu.data.canvas_geom import content_mask as j_content_mask
from acezero_tpu.data.scene import load_scene as j_load_scene
from acezero_tpu_torch.data import images as timg
from acezero_tpu_torch.data.augment import normalize_images as t_normalize
from acezero_tpu_torch.data.canvas_geom import content_mask as t_content_mask
from acezero_tpu_torch.data.scene import load_scene as t_load_scene

SCENE = "results/heldout/scenes/chesslike_a"
FRAMES = sorted(glob.glob(f"{SCENE}/*.png"))[:3]


def _write_png(path, img, filters):
    """A PNG whose rows use the given filter types (cycled)."""
    h, w = img.shape[:2]
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[1 if img.ndim == 2 else img.shape[2]]
    bpp = 1 if img.ndim == 2 else img.shape[2]
    rows = img.reshape(h, w * bpp).astype(np.int32)
    raw = bytearray()
    prev = np.zeros(w * bpp, np.int32)
    for y in range(h):
        f = filters[y % len(filters)]
        cur = rows[y]
        left = np.concatenate([np.zeros(bpp, np.int32), cur[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        if f == 0:
            pred = np.zeros_like(cur)
        elif f == 1:
            pred = left
        elif f == 2:
            pred = prev
        elif f == 3:
            pred = (left + prev) // 2
        else:
            p = left + prev - upleft
            pa, pb, pc = abs(p - left), abs(p - prev), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
        raw.append(f)
        raw += ((cur - pred) & 255).astype(np.uint8).tobytes()
        prev = cur

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    data = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
    data += chunk(b"IDAT", zlib.compress(bytes(raw))) + chunk(b"IEND", b"")
    path.write_bytes(data)


def test_decoder_matches_pil_on_scene_frames():
    for f in FRAMES:
        got = timg.read_png(f)
        want = np.asarray(Image.open(f))
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
@pytest.mark.parametrize("filters", [(0, 1, 2), (0, 1, 2, 3, 4)])
def test_decoder_matches_pil_synthetic(tmp_path, channels, filters):
    rng = np.random.default_rng(channels)
    shape = (23, 37) if channels == 1 else (23, 37, channels)
    img = rng.integers(0, 256, size=shape, dtype=np.uint8)
    img[5:15, 5:20] = 200  # flat patch: small residuals
    path = tmp_path / "x.png"
    _write_png(path, img, filters)
    np.testing.assert_array_equal(timg.read_png(path), np.asarray(Image.open(path)))
    np.testing.assert_array_equal(timg.read_png(path), img)


def test_decoder_rejects_unsupported(tmp_path):
    # RGB at bit depth 4, which PNG does not allow (palette images now decode:
    # tests/test_torch_jpeg.py)
    Image.fromarray(np.zeros((4, 4, 3), np.uint8)).save(tmp_path / "p.png")
    data = bytearray((tmp_path / "p.png").read_bytes())
    data[24] = 4
    data[29:33] = struct.pack(">I", zlib.crc32(bytes(data[12:29])))
    (tmp_path / "p.png").write_bytes(bytes(data))
    with pytest.raises(ValueError, match="unsupported PNG"):
        timg.read_png(tmp_path / "p.png")
    (tmp_path / "n.png").write_bytes(b"not a png")
    with pytest.raises(ValueError, match="not a PNG"):
        timg.read_png(tmp_path / "n.png")


@pytest.mark.parametrize("short", [480, 120])
def test_canvas_matches_jax(short):
    got = timg.decode_to_canvas(FRAMES, short_size=short, num_workers=2)
    want = jimg.decode_to_canvas(FRAMES, short_size=short, num_workers=2)
    assert got.canvases.shape == want.canvases.shape
    np.testing.assert_array_equal(got.sizes, want.sizes)
    np.testing.assert_array_equal(got.orig_sizes, want.orig_sizes)
    np.testing.assert_array_equal(got.scale_factors, want.scale_factors)
    diff = np.abs(got.canvases.astype(int) - want.canvases.astype(int))
    assert diff.max() == 0


@pytest.mark.parametrize("short", [300, 600])
def test_canvas_rgb_rescale_matches_jax(tmp_path, short):
    """RGB(A) content, a non-integer shrink and an enlargement."""
    rng = np.random.default_rng(7)
    paths = []
    for i, (h, w, c) in enumerate([(96, 128, 3), (120, 90, 4), (80, 80, 3)]):
        img = rng.integers(0, 256, size=(h, w, c), dtype=np.uint8)
        p = tmp_path / f"im{i}.png"
        Image.fromarray(img).save(p)
        paths.append(str(p))
    got = timg.decode_to_canvas(paths, short_size=short // 4, num_workers=2)
    want = jimg.decode_to_canvas(paths, short_size=short // 4, num_workers=2)
    np.testing.assert_array_equal(got.sizes, want.sizes)
    assert np.abs(got.canvases.astype(int) - want.canvases.astype(int)).max() == 0


@pytest.mark.parametrize("focal", [None, 520.0])
def test_load_scene_matches_jax(focal):
    kw = dict(image_short_size=480, use_heuristic_focal_length=focal is None,
              external_focal_length=focal)
    pose_glob = f"{SCENE}/frame_000[0-2]_pose.txt"
    got = t_load_scene(f"{SCENE}/frame_000[0-2].png", pose_files=pose_glob, num_workers=2, **kw)
    want = j_load_scene(f"{SCENE}/frame_000[0-2].png", pose_files=pose_glob, num_workers=2, **kw)
    assert got.rgb_files == want.rgb_files
    np.testing.assert_array_equal(got.images.canvases, want.images.canvases)
    np.testing.assert_array_equal(got.focals_canvas, want.focals_canvas)
    np.testing.assert_array_equal(got.focals_orig, want.focals_orig)
    np.testing.assert_array_equal(got.poses_c2w, want.poses_c2w)
    np.testing.assert_array_equal(got.pose_valid, want.pose_valid)
    assert timg.heuristic_focal_length(480, 640) == jimg.heuristic_focal_length(480, 640)


def test_normalize_and_content_mask(rng):
    u8 = rng.integers(0, 256, size=(3, 24, 40), dtype=np.uint8)
    np.testing.assert_allclose(t_normalize(torch.from_numpy(u8)).numpy(),
                               np.asarray(j_normalize(u8)), atol=1e-6)
    sizes = np.array([[24, 40], [17, 33], [20, 11]], np.int32)
    np.testing.assert_array_equal(t_content_mask(24, 40, torch.from_numpy(sizes)).numpy(),
                                  np.asarray(j_content_mask(24, 40, sizes)))
