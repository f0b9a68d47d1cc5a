"""MPO files (a JPEG frame with more frames after it, as cameras write
stereo pairs) in the port: PIL opens frame 0, and the port's JPEG reader
(io/jpeg.py) gives the same pixels, canvases and depth maps as PIL and the
JAX package do, the later frames ignored."""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from acezero_tpu.data import images as jimg
from acezero_tpu.data.depth import load_depth_file as j_load_depth_file
from acezero_tpu_torch.data import images as timg
from acezero_tpu_torch.data.depth import load_depth_file
from acezero_tpu_torch.io import formats

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))
import make_jpeg2000_fixtures as fx  # noqa: E402


@pytest.fixture(params=["RGB", "L"])
def mpo(request, tmp_path) -> Path:
    """A two-frame MPO of Pillow's save_all: frame 0 and a flipped frame 1."""
    first = fx.image(37, 53, 3, seed=1)
    second = fx.image(37, 53, 3, seed=2)[::-1].copy()
    if request.param == "L":
        first, second = first[..., 0], second[..., 0]
    path = tmp_path / f"pair_{request.param}.mpo"
    Image.fromarray(first).save(path, save_all=True, append_images=[Image.fromarray(second)])
    with Image.open(path) as im:
        assert (im.format, im.n_frames, im.mode) == ("MPO", 2, request.param)
    return path


def test_mpo_reads_as_pils_frame0(mpo):
    with Image.open(mpo) as im:
        want, mode, size = np.asarray(im), im.mode, im.size
        rgb, luma = np.asarray(im.convert("RGB")), np.asarray(im.convert("L"))
    img = timg.read_image(mpo)
    assert (formats.pil_mode(mpo), formats.image_size(mpo), formats.file_kind(mpo)) == (mode, size, "jpeg")
    assert np.array_equal(timg.pil_array(img), want)
    assert np.array_equal(timg.read_rgb(mpo), rgb) and np.array_equal(timg.pil_luma_u8(img), luma)


@pytest.mark.parametrize("short,canvas_hw", [(24, None), (40, None), (40, (32, 40))],
                         ids=["shrunk", "enlarged", "oversize_crop"])
def test_mpo_canvases_match_jax(mpo, short, canvas_hw):
    got = timg.decode_to_canvas([str(mpo)], short_size=short, canvas_hw=canvas_hw, num_workers=1)
    want = jimg.decode_to_canvas([str(mpo)], short_size=short, canvas_hw=canvas_hw, num_workers=1)
    for k in ("canvases", "sizes", "orig_sizes", "scale_factors"):
        assert np.array_equal(getattr(got, k), getattr(want, k)), k


def test_mpo_depth_matches_jax(mpo):
    got, want = load_depth_file(mpo), j_load_depth_file(str(mpo))
    assert got.dtype == want.dtype == np.float64 and got.shape == want.shape and np.array_equal(got, want)
