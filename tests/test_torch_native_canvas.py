"""The port's canvas pass (data/csrc/canvas.cpp through data/native.py)
against the JAX package's (native/canvas.cpp through
acezero_tpu.data.native) and against its plain numpy version
(data/images.py::gray_resize), bit for bit: the sha256 of the canvases
over identity, integer and non-integer shrinks, enlargement, the mixed
cases (one side shrinks, the other grows), 1 x 1 and one-row or
one-column inputs, gray and RGB, and a 4946 x 3286 frame (Mip-NeRF 360's
size) shrunk to a 480 short side, alone and through decode_to_canvas.
The library builds into the port's _build/ and has no fallback: a refused
call or a failed build raises."""

import ast
import hashlib
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from acezero_tpu.data import images as jimg
from acezero_tpu.data.native import get_lib, gray_resize_center_batch
from acezero_tpu_torch.data import images as timg
from acezero_tpu_torch.data import native
from acezero_tpu_torch.ops import build

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402
CASES = {  # name: ((h, w, channels), (out_h, out_w))
    "identity_rgb": ((48, 64, 3), (48, 64)),
    "identity_gray": ((33, 17, 1), (33, 17)),
    "integer_shrink_rgb": ((96, 128, 3), (48, 64)),
    "integer_shrink_gray": ((90, 60, 1), (30, 20)),
    "non_integer_shrink_rgb": ((97, 131, 3), (45, 61)),
    "non_integer_shrink_gray": ((480, 640, 1), (361, 481)),
    "enlarge_rgb": ((30, 40, 3), (61, 83)),
    "enlarge_gray": ((7, 5, 1), (40, 29)),
    "sy_shrinks_sx_grows": ((50, 20, 3), (40, 27)),
    "sx_shrinks_sy_grows": ((20, 50, 1), (27, 40)),
    "one_by_one_rgb": ((1, 1, 3), (1, 1)),
    "one_by_one_enlarged": ((1, 1, 1), (3, 4)),
    "one_row_shrunk": ((1, 9, 3), (1, 4)),
    "one_row_enlarged": ((1, 9, 1), (2, 20)),
    "one_column_shrunk": ((11, 1, 3), (5, 1)),
}
PHOTO_HW = (3286, 4946)


def _image(shape, seed):
    """A ramp with noise, from a seed: (h, w) for one channel."""
    h, w, c = shape
    rng = np.random.default_rng(seed)
    ramp = np.linspace(0, 180, w)[None, :, None] + np.linspace(0, 60, h)[:, None, None]
    img = (ramp + rng.integers(0, 16, (h, w, c))).astype(np.uint8)
    return img[..., 0] if c == 1 else img


def _digest(a):
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def _three_canvases(img, out_hw, canvas_hw):
    """The JAX package's, the port's and the plain version's canvases."""
    jax_side = gray_resize_center_batch([img], np.asarray([out_hw]), canvas_hw)[0]
    port = np.zeros(canvas_hw, np.uint8)
    native.gray_resize_center(img, port, *out_hw)
    plain = np.zeros(canvas_hw, np.uint8)
    y0, x0 = (canvas_hw[0] - out_hw[0]) // 2, (canvas_hw[1] - out_hw[1]) // 2
    plain[y0:y0 + out_hw[0], x0:x0 + out_hw[1]] = timg.gray_resize(img, *out_hw)
    return jax_side, port, plain


def test_the_jax_package_takes_its_native_path():
    assert get_lib() is not None


@pytest.mark.parametrize("name", list(CASES))
def test_canvas_pass_equals_jax_and_plain_bit_for_bit(name):
    shape, out_hw = CASES[name]
    canvas_hw = (-(-out_hw[0] // 8) * 8 + 8, -(-out_hw[1] // 8) * 8 + 8)  # margins on both sides
    jax_side, port, plain = _three_canvases(_image(shape, seed=len(name)), out_hw, canvas_hw)
    assert _digest(port) == _digest(jax_side) == _digest(plain)


def test_photo_size_frame_equals_jax_and_plain_bit_for_bit():
    """A 4946 x 3286 RGB frame shrunk to 480 x 722, where the float64
    resize that this pass replaces differed from the JAX package in a few
    pixels."""
    img = _image((*PHOTO_HW, 3), seed=1)
    out_hw = tuple(int(v) for v in np.round(np.asarray(PHOTO_HW) * np.float32(480 / np.float32(min(PHOTO_HW)))))
    assert out_hw == (480, 722)
    jax_side, port, plain = _three_canvases(img, out_hw, (480, 728))
    assert _digest(port) == _digest(jax_side) == _digest(plain)


def test_photo_size_jpeg_decode_to_canvas_equals_jax(tmp_path):
    Image.fromarray(_image((*PHOTO_HW, 3), seed=2)).save(tmp_path / "photo.jpg", quality=90)
    Image.fromarray(_image((1080, 1920, 3), seed=3)).save(tmp_path / "video.jpg", quality=90)
    paths = sorted(str(p) for p in tmp_path.glob("*.jpg"))
    got = timg.decode_to_canvas(paths, short_size=480, num_workers=2)
    want = jimg.decode_to_canvas(paths, short_size=480, num_workers=2)
    for k in ("canvases", "sizes", "orig_sizes", "scale_factors"):
        assert _digest(getattr(got, k)) == _digest(getattr(want, k)), k


@pytest.mark.parametrize("mode", ["L", "RGB", "RGBA", "LA", "P", "1", "I;16", "CMYK"])
def test_canvas_input_is_what_pil_hands_the_jax_pass(mode, tmp_path):
    """canvas_input of the port's decode is the uint8 L or RGB array that
    the JAX package's _load_raw makes with PIL for the same file."""
    img = Image.fromarray(_image((23, 31, 3), seed=4))
    if mode == "P":
        img = img.quantize(32)
    elif mode == "I;16":
        img = Image.fromarray(np.asarray(img.convert("L")).astype(np.uint16) * 2)  # values on both sides of 255
    else:
        img = img.convert(mode)
    path = tmp_path / ("x.jpg" if mode == "CMYK" else "x.png")
    img.save(path)
    with Image.open(path) as im:  # acezero_tpu/data/images.py::_load_raw
        if im.mode not in ("L", "RGB"):
            im = im.convert("RGB" if im.mode not in ("1", "I", "I;16", "F") else "L")
        want = np.asarray(im)
    got = timg.canvas_input(timg.read_image(path))
    assert got.dtype == np.uint8 and got.shape == want.shape and np.array_equal(got, want)


def test_the_library_builds_into_build_dir_with_the_host_flags():
    target = build.host_target(native.SOURCE)
    assert native.SOURCE == ROOT / "acezero_tpu_torch" / "data" / "csrc" / "canvas.cpp"
    assert target.parent == build.BUILD_DIR and target.name.startswith("canvas-")
    native.gray_resize_center(np.zeros((2, 2), np.uint8), np.zeros((1, 1), np.uint8), 1, 1)
    assert target.exists() and "-ffp-contract=off" in build.HOST_FLAGS


def test_a_refused_call_raises_naming_the_file():
    canvas = np.zeros((8, 8), np.uint8)
    with pytest.raises(ValueError, match="frame_7.png: canvas pass .* failed"):
        native.gray_resize_center(np.zeros((4, 4), np.uint8), canvas, 9, 8, "frame_7.png")
    with pytest.raises(ValueError, match="f.png: the canvas pass takes uint8"):
        native.gray_resize_center(np.zeros((4, 4, 4), np.uint8), canvas, 4, 4, "f.png")
    with pytest.raises(ValueError, match="f.png: the canvas pass takes uint8"):
        native.gray_resize_center(np.zeros((4, 4), np.float32), canvas, 4, 4, "f.png")
    with pytest.raises(ValueError, match="writable C-contiguous"):
        native.gray_resize_center(np.zeros((4, 4), np.uint8), np.zeros((8, 16), np.uint8)[:, ::2], 4, 4)
    assert not canvas.any()


def test_a_failed_build_raises_and_nothing_falls_back(tmp_path, monkeypatch):
    """decode_to_canvas raises the build's error: no numpy or PIL path takes
    over."""
    def broken():
        raise RuntimeError("host build of canvas.cpp failed: c++ exit 1")

    Image.fromarray(_image((40, 60, 3), seed=5)).save(tmp_path / "a.png")
    monkeypatch.setattr(native, "_lib", broken)
    with pytest.raises(RuntimeError, match="host build of canvas.cpp failed"):
        timg.decode_to_canvas([str(tmp_path / "a.png")], short_size=20, num_workers=1)


def test_the_plain_version_is_off_the_run_path():
    """No module of the port calls images.gray_resize: the run path goes
    through the library."""
    callers = []
    for path in sorted((ROOT / "acezero_tpu_torch").rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Call):
                f = node.func
                if (isinstance(f, ast.Name) and f.id == "gray_resize") or (
                        isinstance(f, ast.Attribute) and f.attr == "gray_resize"):
                    callers.append(f"{path.relative_to(ROOT)}:{node.lineno}")
    assert not callers


def test_the_cards_check_of_the_pass_on_photo_frames(tmp_path):
    """chip_smoke.canvas_pass_check, which phase jpeg runs on its photo
    frames, here on smaller JPEGs: the pass equals its plain version, whose
    canvases are decode_to_canvas's."""
    for i in range(3):
        Image.fromarray(_image((301, 457, 3), seed=10 + i)).save(tmp_path / f"p{i}.jpg", quality=95)
    files = sorted(str(p) for p in tmp_path.glob("*.jpg"))
    rec, plain = chip_smoke.canvas_pass_check(np, files, 120)
    assert rec["equal"] and rec["equal_to_plain"] == "3/3" and rec["out_hw"] == [120, 182]
    out = timg.decode_to_canvas(files, short_size=120, num_workers=2)
    assert _digest(out.canvases) == _digest(plain)
