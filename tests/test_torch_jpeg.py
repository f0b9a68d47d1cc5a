"""The port's JPEG codec (io/csrc/jpeg.cpp through io/jpeg.py), its host
build, and the image reads that go through it, against PIL and the JAX
package on the CPU.

- `read_jpeg` equals `np.asarray(Image.open(path))` bit for bit over modes
  L and RGB, subsampling 4:4:4, 4:2:2 and 4:2:0, quality 50-100,
  progressive, optimized Huffman tables and restart markers, at sizes on
  and off the MCU grid;
- and over the files PIL reads but cannot write, made by
  scripts/make_jpeg_fixtures.py's writer: any sampling factors libjpeg
  takes (4:4:0, 4:1:1, chroma above 1 x 1), CMYK and YCCK, arithmetic
  coding (sequential and progressive, DAC conditioning) and lossless
  frames (predictors 1-7, point transforms), with restart markers; where
  PIL refuses a file (12-bit samples, hierarchical frames, a DNL height,
  lossless arithmetic coding, too many blocks in an MCU) the port raises
  a ValueError naming the file;
- unsupported or broken files raise ValueError naming the file;
- `read_rgb`, `pil_luma_u8` and decode_to_canvas give PIL's and the JAX
  package's results on four-component files, and decode_to_canvas with a
  canvas smaller than the content gives the JAX package's crop;
- `write_jpeg` gives PIL's bytes, for gray, RGB and CMYK;
- the Nerfstudio runner's downscale of a source of every mode PIL opens
  (chip_smoke.RUNNER_SOURCES, written by the port and by PIL) gives the
  JAX runner's (PIL's) JPEG bytes and PNG mode and pixels, a palette or
  1-bit source as its RGB or gray pixels; the committed digests
  (tests/data/runner/pil_digests.json, which the card checks) are PIL's;
  Pillow's premultiply round trip over every (value, alpha), its 16-bit
  and nearest-neighbour resizes, and write_png's modes, against PIL;
- decode_to_canvas, read_rgb and the point cloud's frame colours give the
  JAX package's (PIL's) results on JPEG and PNG globs, holding at most
  num_workers decoded images;
- read_png reads palette, 1/2/4-bit gray and Adam7-interlaced PNGs as PIL
  gives them to the JAX package;
- the committed fixtures' digests (tests/data/jpeg/pil_digests.json, which
  the card checks) are PIL's and the JAX package's, and the port decodes to
  them;
- the slice as a whole: the reconstruction CLI's mini loop
  (tests/test_torch_pipeline.py) on a glob of JPEG frames, against the JAX
  pipeline on the same files.
"""

import hashlib
import io
import json
import shutil
import struct
import sys
import threading
import weakref
import zlib
from pathlib import Path

import numpy as np
import pytest
from PIL import Image, ImageFile

from acezero_tpu.data import images as jimg
from acezero_tpu.data.scene import load_scene as j_load_scene
from acezero_tpu.export import point_cloud as jpc
from acezero_tpu_torch.data import images as timg
from acezero_tpu_torch.data.scene import load_scene as t_load_scene
from acezero_tpu_torch.export import point_cloud as tpc
from acezero_tpu_torch.io import formats
from acezero_tpu_torch.io import jpeg as tjpeg
from acezero_tpu_torch.io import png as tpng
from acezero_tpu_torch.ops import build

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))
sys.path.insert(0, str(ROOT / "scripts"))
import chip_smoke  # noqa: E402
import make_jpeg_fixtures as fixtures  # noqa: E402
from synthetic import render_room_scene  # noqa: E402
from test_torch_pipeline import JAX_ONLY, MINI, MINI_FLAGS, MINI_OVERRIDES, N, RATE_BAND  # noqa: E402
from test_torch_trainer import one_torch_thread  # noqa: E402,F401  (autouse: torch on one thread)

MODES = [("L", None), ("RGB", "4:4:4"), ("RGB", "4:2:2"), ("RGB", "4:2:0")]
SIZES = [(1, 1), (7, 9), (17, 33), (37, 53), (480, 640)]
CODINGS = [{"progressive": True}, {"optimize": True}, {"restart_marker_blocks": 3}, {"restart_marker_rows": 1}]
DIGESTS = json.loads((chip_smoke.JPEG_FIXTURES / "pil_digests.json").read_text())


def _image(h, w, mode, seed):
    """A smooth ramp plus noise, from a seed."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w]
    base = np.stack([xx * 255 / max(w - 1, 1), yy * 255 / max(h - 1, 1), (xx + yy) * 127 / max(h + w - 2, 1)], -1)
    img = Image.fromarray(np.clip(base + rng.normal(0, 20, (h, w, 3)), 0, 255).astype(np.uint8))
    return img.convert("L") if mode == "L" else img


def _save(path, h, w, mode, sub, seed, **opts):
    if sub is not None:
        opts["subsampling"] = sub
    _image(h, w, mode, seed).save(path, **opts)
    return path


@pytest.fixture
def big_blocks(monkeypatch):
    """PIL needs a buffer that holds a whole progressive or optimized scan."""
    monkeypatch.setattr(ImageFile, "MAXBLOCK", 1 << 24)


# ------------------------------------------------------------- decoder


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("quality", [50, 75, 95, 100])
@pytest.mark.parametrize("mode,sub", MODES, ids=lambda m: str(m))
def test_decoder_matches_pil(mode, sub, quality, size, tmp_path):
    p = _save(tmp_path / "x.jpg", *size, mode, sub, seed=quality + size[1], quality=quality)
    got, want = tjpeg.read_jpeg(p), np.asarray(Image.open(p))
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert np.array_equal(got, want)


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("coding", CODINGS, ids=lambda c: next(iter(c)))
@pytest.mark.parametrize("mode,sub", MODES, ids=lambda m: str(m))
def test_decoder_matches_pil_coding(mode, sub, coding, size, tmp_path, big_blocks):
    p = _save(tmp_path / "x.jpg", *size, mode, sub, seed=size[0], quality=95, **coding)
    assert np.array_equal(tjpeg.read_jpeg(p), np.asarray(Image.open(p)))


def _patched(src: Path, dst: Path, find: bytes, offset: int, value: int) -> Path:
    data = bytearray(src.read_bytes())
    data[data.index(find) + offset] = value
    dst.write_bytes(bytes(data))
    return dst


@pytest.mark.parametrize("case,match", [
    ("cmyk", None), ("truncated", "truncated"), ("not_an_image", "neither a PNG nor a JPEG"),
    ("arithmetic", None), ("lossless", None), ("12bit", "12-bit"),
    ("sampling", None), ("corrupt", "corrupt JPEG data"),
])
def test_unsupported_or_broken_files_raise(case, match, tmp_path):
    """Broken files and 12-bit samples raise (PIL refuses 12 bits too); CMYK,
    arithmetic coding, lossless frames and luma 1 x 2 sampling, refused once,
    decode to PIL's pixels (match None)."""
    rgb = _save(tmp_path / "rgb.jpg", 37, 53, "RGB", "4:2:0", seed=1, quality=75)
    ycc = fixtures.ycbcr(np.asarray(_image(37, 53, "RGB", 3)))
    if case == "cmyk":
        p = tmp_path / "cmyk.jpg"
        _image(16, 16, "RGB", 2).convert("CMYK").save(p)
    elif case == "truncated":
        p = tmp_path / "cut.jpg"
        p.write_bytes(rgb.read_bytes()[: len(rgb.read_bytes()) // 2])
    elif case == "not_an_image":
        p = tmp_path / "x.jpg"
        p.write_bytes(b"not an image at all")  # (a GIF signature made it a GIF, read since)
    elif case == "arithmetic":
        p = tmp_path / "a.jpg"
        p.write_bytes(fixtures.encode(ycc, sampling=[(2, 2), (1, 1), (1, 1)], coding="arithmetic"))
    elif case == "lossless":
        p = tmp_path / "l.jpg"
        p.write_bytes(fixtures.encode(np.asarray(_image(37, 53, "L", 4)), lossless=1, jfif=False))
    elif case == "12bit":
        p = _patched(rgb, tmp_path / "p.jpg", b"\xff\xc0", 4, 12)
    elif case == "sampling":
        p = tmp_path / "s.jpg"
        p.write_bytes(fixtures.encode(ycc, sampling=[(1, 2), (1, 1), (1, 1)]))  # luma 1x2 (4:4:0)
    else:  # entropy-coded data cut short before the end-of-image marker
        data = rgb.read_bytes()
        p = tmp_path / "c.jpg"
        p.write_bytes(data[: data.index(b"\xff\xda") + 40] + b"\xff\xd9")
    if match is None:
        assert np.array_equal(tjpeg.read_jpeg(p), np.asarray(Image.open(p)))
        return
    if case == "12bit":
        with pytest.raises(OSError):  # UnidentifiedImageError
            Image.open(p)
    with pytest.raises(ValueError, match=match) as exc:
        timg.read_image(p)
    assert str(p) in str(exc.value)


def test_header_gives_the_shape_without_decoding(tmp_path):
    p = _save(tmp_path / "x.jpg", 37, 53, "RGB", "4:2:0", seed=3)
    data = np.fromfile(p, np.uint8)
    assert tjpeg.jpeg_shape(data, p) == (37, 53, 3)
    assert timg.image_size(p) == (53, 37)


# ------------------------------------------------------------- what PIL reads and cannot write

WRITER_SIZES = [(1, 1), (2, 3), (7, 9), (17, 33), (37, 53)]
SAMPLINGS = {  # name: sampling factors libjpeg-turbo upsamples
    "440": [(1, 2), (1, 1), (1, 1)],
    "411": [(4, 1), (1, 1), (1, 1)],
    "chroma2x1_1x2": [(2, 2), (2, 1), (1, 2)],
    "luma_upsampled": [(1, 1), (2, 2), (1, 1)],
    "310": [(3, 1), (1, 1), (1, 1)],
    "420": [(2, 2), (1, 1), (1, 1)],
    "y4x2": [(4, 2), (1, 1), (1, 1)],
    "y1x4_cb1x2": [(1, 4), (1, 2), (1, 1)],
}


def _both(path):
    """PIL's array and the port's, or the exceptions they raise."""
    try:
        want = np.asarray(Image.open(path))
    except OSError as e:  # UnidentifiedImageError is an OSError
        want = e
    try:
        got = tjpeg.read_jpeg(path)
    except ValueError as e:
        got = e
    return want, got


def _assert_pils(path):
    want, got = _both(path)
    assert isinstance(want, np.ndarray), want
    assert isinstance(got, np.ndarray), got
    assert got.dtype == np.uint8 and got.shape == want.shape and np.array_equal(got, want)


def _assert_both_raise(path, match=None):
    want, got = _both(path)
    assert isinstance(want, OSError), f"PIL decodes {path}"
    assert isinstance(got, ValueError) and str(path) in str(got), got
    if match is not None:
        assert match in str(got), got


def _write(tmp_path, name, data):
    p = tmp_path / name
    p.write_bytes(data)
    return p


@pytest.mark.parametrize("coding", ["huffman", "huffman_restart", "scans", "arithmetic", "progressive"])
@pytest.mark.parametrize("sampling", sorted(SAMPLINGS), ids=str)
def test_sampling_factors_match_pil(sampling, coding, tmp_path):
    kw = {"huffman": {}, "huffman_restart": {"restart": 2}, "scans": {"separate_scans": True, "restart": 1},
          "arithmetic": {"coding": "arithmetic", "restart": 3},
          "progressive": {"coding": "arithmetic", "progressive": True}}[coding]
    for i, (h, w) in enumerate(WRITER_SIZES):
        ycc = fixtures.ycbcr(np.asarray(_image(h, w, "RGB", seed=i)))
        _assert_pils(_write(tmp_path, f"s{i}.jpg", fixtures.encode(ycc, sampling=SAMPLINGS[sampling], **kw)))


@pytest.mark.parametrize("sampling,scans,match", [
    ([(3, 1), (2, 1), (1, 1)], False, "sampling factors 3x1,2x1,1x1"),  # not whole ratios
    ([(4, 4), (1, 1), (1, 1)], False, "too large for an interleaved scan"),  # 18 blocks in an MCU
    ([(3, 3), (1, 1), (1, 1)], False, "too large for an interleaved scan"),
], ids=["fractional", "4x4", "3x3"])
def test_sampling_factors_pil_refuses_raise(sampling, scans, match, tmp_path):
    ycc = fixtures.ycbcr(np.asarray(_image(17, 33, "RGB", seed=5)))
    _assert_both_raise(_write(tmp_path, "r.jpg", fixtures.encode(ycc, sampling=sampling, separate_scans=scans)), match)
    # in scans of one component each, 4 x 4 luma is read
    if sampling[0] == (4, 4):
        _assert_pils(_write(tmp_path, "ok.jpg", fixtures.encode(ycc, sampling=sampling, separate_scans=True)))


FOUR = {  # name: (Adobe transform or None, sampling)
    "cmyk": (None, None),
    "cmyk_adobe0": (0, None),
    "ycck_adobe2": (2, [(2, 2), (1, 1), (1, 1), (2, 2)]),
    "ycck_adobe1": (1, [(1, 2), (1, 1), (1, 1), (1, 2)]),  # any transform but 0 is YCCK to libjpeg
}


@pytest.mark.parametrize("coding", ["huffman", "arithmetic", "progressive", "lossless"])
@pytest.mark.parametrize("kind", sorted(FOUR))
def test_four_components_match_pil(kind, coding, tmp_path):
    adobe, sampling = FOUR[kind]
    kw = {"huffman": {"restart": 2}, "arithmetic": {"coding": "arithmetic"},
          "progressive": {"coding": "arithmetic", "progressive": True}, "lossless": {"lossless": 5}}[coding]
    for i, (h, w) in enumerate(WRITER_SIZES):
        rgb = np.asarray(_image(h, w, "RGB", seed=i))
        planes = fixtures.ycck(rgb) if kind.startswith("ycck") else 255 - np.asarray(Image.fromarray(rgb).convert("CMYK"))
        p = _write(tmp_path, f"f{i}.jpg", fixtures.encode(planes, sampling=sampling, jfif=False, adobe=adobe, **kw))
        if coding == "lossless" and kind.startswith("ycck"):
            _assert_both_raise(p, "lossless coding with a colour transform")  # libjpeg-turbo converts no colours there
            continue
        _assert_pils(p)
        im = Image.open(p)
        img = timg.read_image(p)
        assert isinstance(img, timg.CmykImage) and img.mode == im.mode == "CMYK" and timg.pil_uint8(img) is img
        assert np.array_equal(timg.read_rgb(p), np.asarray(im.convert("RGB")))
        assert np.array_equal(timg.pil_luma_u8(img), np.asarray(im.convert("L")))


def test_cmyk_to_rgb_is_pillows_at_every_value():
    c, k = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    px = np.stack([c, (c * 7) % 256, 255 - c, k], -1).astype(np.uint8)
    im = Image.frombytes("CMYK", (256, 256), px.tobytes())
    cmyk = timg.CmykImage(np.asarray(im))
    assert np.array_equal(timg.pil_rgb(cmyk), np.asarray(im.convert("RGB")))
    assert np.array_equal(timg.pil_luma_u8(cmyk), np.asarray(im.convert("L")))


@pytest.mark.parametrize("mode", ["L", "RGB"])
@pytest.mark.parametrize("progressive", [False, True], ids=["sequential", "progressive"])
def test_arithmetic_coding_matches_pil(mode, progressive, tmp_path):
    dacs = [None, {"dc": {0: (2, 5), 1: (0, 0)}, "ac": {0: 2, 1: 40}}, {"dc": {0: (0, 15)}, "ac": {0: 63}}]
    for i, (h, w) in enumerate(WRITER_SIZES):
        img = np.asarray(_image(h, w, mode, seed=i))
        planes = img if mode == "L" else fixtures.ycbcr(img)
        for j, dac in enumerate(dacs):
            data = fixtures.encode(planes, coding="arithmetic", progressive=progressive, dac=dac, restart=j,
                                   quality=(60, 90, 100)[j], sampling=None if mode == "L" else [(2, 2), (1, 1), (1, 1)])
            _assert_pils(_write(tmp_path, f"a{i}_{j}.jpg", data))


@pytest.mark.parametrize("point_transform", [0, 1, 3])
@pytest.mark.parametrize("predictor", range(1, 8))
def test_lossless_matches_pil(predictor, point_transform, tmp_path):
    for i, (h, w) in enumerate(WRITER_SIZES):
        rgb = np.asarray(_image(h, w, "RGB", seed=i))
        gray = np.asarray(_image(h, w, "L", seed=i))
        cases = [
            (gray, {"restart": 2 * w}),
            # no marker: RGB, as libjpeg-turbo takes it; a restart every MCU row
            (rgb, {"restart": -(-w // 2), "sampling": [(2, 2), (1, 1), (1, 2)]}),
            (rgb, {"ids": [82, 71, 66], "separate_scans": True}),
            # one component, two rows an iMCU row, a restart every row: the
            # predictor starts over at iMCU rows, as libjpeg-turbo does it
            (gray, {"sampling": [(1, 2)], "restart": w}),
        ]
        for j, (planes, kw) in enumerate(cases):
            data = fixtures.encode(planes, lossless=predictor, point_transform=point_transform, jfif=False, **kw)
            _assert_pils(_write(tmp_path, f"l{i}_{j}.jpg", data))


def _sof_patched(data: bytes, find: bytes, offset: int, value) -> bytes:
    out = bytearray(data)
    i = data.index(find) + offset
    out[i : i + len(value)] = value
    return bytes(out)


@pytest.mark.parametrize("case,match", [
    ("12bit", None), ("12bit_lossless", None),
    ("sof5", "hierarchical"), ("sof6", "hierarchical"), ("sof7", "hierarchical"),
    ("sof13", "hierarchical"), ("sof14", "hierarchical"), ("sof15", "hierarchical"),
    ("dnl", "DNL"), ("sof11", "lossless arithmetic coding"), ("two_components", "2 components"),
    ("lossless_ycbcr", "lossless coding with a colour transform"), ("lossless_restart", "restart interval"),
])
def test_files_pil_refuses_raise(case, match, tmp_path):
    """Each file PIL refuses (at open, or at load) the port refuses with a
    ValueError naming it: 12-bit samples (PIL's error at open), hierarchical
    frames (SOF5-7, SOF13-15), a height given in a DNL marker, lossless
    arithmetic coding (SOF11, which libjpeg-turbo does not decode), two
    components, a lossless file with a colour transform, a lossless restart
    interval that is not a whole number of rows."""
    ycc = fixtures.ycbcr(np.asarray(_image(17, 33, "RGB", seed=7)))
    gray = np.asarray(_image(17, 33, "L", seed=7))
    seq = fixtures.encode(ycc)  # SOF1
    arith = fixtures.encode(ycc, coding="arithmetic")  # SOF9
    lossless = fixtures.encode(gray, lossless=1, jfif=False)  # SOF3
    data = {
        "12bit": _sof_patched(seq, b"\xff\xc1", 4, b"\x0c"),
        "12bit_lossless": _sof_patched(lossless, b"\xff\xc3", 4, b"\x0c"),
        "sof5": _sof_patched(seq, b"\xff\xc1", 1, b"\xc5"),
        "sof6": _sof_patched(seq, b"\xff\xc1", 1, b"\xc6"),
        "sof7": _sof_patched(lossless, b"\xff\xc3", 1, b"\xc7"),
        "sof13": _sof_patched(arith, b"\xff\xc9", 1, b"\xcd"),
        "sof14": _sof_patched(arith, b"\xff\xc9", 1, b"\xce"),
        "sof15": _sof_patched(arith, b"\xff\xc9", 1, b"\xcf"),
        "sof11": _sof_patched(lossless, b"\xff\xc3", 1, b"\xcb"),
        "two_components": fixtures.encode(ycc[..., :2]),
        "lossless_ycbcr": fixtures.encode(np.asarray(_image(17, 33, "RGB", seed=7)), lossless=1),  # JFIF: YCbCr
        "lossless_restart": fixtures.encode(gray, lossless=1, jfif=False, restart=20),
    }
    if case == "dnl":  # height 0 in the frame header, the lines in a DNL segment after the scan
        d = _sof_patched(seq, b"\xff\xc1", 5, b"\x00\x00")
        data[case] = d[: d.rindex(b"\xff\xd9")] + b"\xff\xdc\x00\x04\x00\x11\xff\xd9"
    p = _write(tmp_path, f"{case}.jpg", data[case])
    _assert_both_raise(p, match or "12-bit")


# ------------------------------------------------------------- encoder


@pytest.mark.parametrize("quality", [75, 90])
@pytest.mark.parametrize("mode,sub", [("RGB", "4:2:0"), ("RGB", "4:4:4"), ("L", None)], ids=str)
def test_encoder_gives_pils_bytes(mode, sub, quality, tmp_path):
    for h, w in [(1, 1), (7, 9), (17, 33), (37, 53), (64, 48)]:
        img = np.asarray(_image(h, w, mode, seed=h * w))
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, format="JPEG", quality=quality, **({} if sub is None else {"subsampling": sub}))
        tjpeg.write_jpeg(tmp_path / "t.jpg", img, quality=quality, subsampling=sub or "4:2:0")
        assert (tmp_path / "t.jpg").read_bytes() == buf.getvalue(), (h, w)


def test_encoder_default_is_pils_plain_save(tmp_path):
    img = np.asarray(_image(37, 53, "RGB", seed=5))
    Image.fromarray(img).save(tmp_path / "pil.jpg")
    tjpeg.write_jpeg(tmp_path / "port.jpg", img)
    assert (tmp_path / "port.jpg").read_bytes() == (tmp_path / "pil.jpg").read_bytes()
    with pytest.raises(ValueError, match="uint8"):
        tjpeg.write_jpeg(tmp_path / "bad.jpg", img.astype(np.float32))
    with pytest.raises(ValueError, match="subsampling"):
        tjpeg.write_jpeg(tmp_path / "bad.jpg", img, subsampling="4:1:1")


# ------------------------------------------------------------- fixtures


@pytest.mark.parametrize("name", sorted(DIGESTS["files"]))
def test_fixture_digests_are_pils_and_the_ports(name):
    path = chip_smoke.JPEG_FIXTURES / name
    want = DIGESTS["files"][name]
    pil = np.asarray(Image.open(path))
    assert list(pil.shape) == want["shape"] and chip_smoke.array_digest(pil) == want["sha256"]
    got = tjpeg.read_jpeg(path)
    assert list(got.shape) == want["shape"] and chip_smoke.array_digest(got) == want["sha256"]


def test_fixtures_are_small_and_cover_the_matrix():
    files = sorted(chip_smoke.JPEG_FIXTURES.glob("*.jpg"))
    assert len(files) <= 22 and sum(f.stat().st_size for f in files) < 100_000
    assert {f.name for f in files} == set(DIGESTS["files"]) == {Path(p).name for p in fixtures.fixture_paths()}
    assert all(max(Image.open(f).size) <= 64 for f in files)
    names = " ".join(f.name for f in files)
    for kind in ("gray", "444", "422", "420", "progressive", "optimize", "restart", "440", "411", "chroma2x1_1x2",
                 "cmyk", "ycck", "arith", "lossless"):
        assert kind in names
    assert set(DIGESTS["rgb"]) == {"cmyk_q90.jpg", "ycck_adobe2.jpg"}


def test_fixture_rgb_digests_are_pils_and_the_ports():
    for name, want in DIGESTS["rgb"].items():
        path = chip_smoke.JPEG_FIXTURES / name
        assert chip_smoke.array_digest(np.asarray(Image.open(path).convert("RGB"))) == want
        assert chip_smoke.array_digest(timg.read_rgb(path)) == want


@pytest.mark.parametrize("entry", DIGESTS["canvas"], ids=lambda e: f"short{e['short_size']}_{e['canvas_hw']}")
def test_fixture_canvas_digests_are_jaxs_and_the_ports(entry):
    """decode_to_canvas over every fixture (all kinds mixed), at the default
    canvas and at one smaller than the content (the crop)."""
    short, hw = entry["short_size"], None if entry["canvas_hw"] is None else tuple(entry["canvas_hw"])
    assert fixtures.jax_canvases(short, hw) == entry["sha256"]
    got = timg.decode_to_canvas(fixtures.fixture_paths(), short_size=short, canvas_hw=hw, num_workers=2)
    assert chip_smoke.canvas_digest(got) == entry["sha256"]


@pytest.mark.parametrize("entry", DIGESTS["roundtrip"], ids=lambda e: f"frame{e['frame']}")
def test_roundtrip_digests(entry, tmp_path):
    img = chip_smoke.jpeg_roundtrip_frame(np, entry["frame"])
    tjpeg.write_jpeg(tmp_path / "r.jpg", img, entry["quality"], entry["subsampling"])
    data = (tmp_path / "r.jpg").read_bytes()
    assert hashlib.sha256(data).hexdigest() == entry["bytes_sha256"]
    pil = np.asarray(Image.open(tmp_path / "r.jpg"))
    assert chip_smoke.array_digest(pil) == entry["sha256"]
    assert chip_smoke.array_digest(tjpeg.read_jpeg(tmp_path / "r.jpg")) == entry["sha256"]


# ------------------------------------------------------------- PNG


def _png(path, samples, depth, ctype, interlace=0, palette=None):
    """A PNG of (h, w, channels) samples at any bit depth, Adam7 or not,
    rows filtered with types 0-4 in turn."""
    h, w, ch = samples.shape
    bits = depth * ch
    bpp = max(1, bits // 8)

    def packed_rows(sub):
        sh, sw = sub.shape[:2]
        if depth == 16:
            b = np.stack([sub >> 8, sub & 255], -1).astype(np.uint8).reshape(sh, sw * ch * 2)
        elif depth == 8:
            b = sub.astype(np.uint8).reshape(sh, sw * ch)
        else:
            per = 8 // depth
            row_bytes = (sw * bits + 7) // 8
            v = np.zeros((sh, row_bytes * per), np.uint8)
            v[:, :sw] = sub[..., 0]
            b = np.zeros((sh, row_bytes), np.uint8)
            for k in range(per):
                b |= (v[:, k::per] << (8 - depth * (k + 1))).astype(np.uint8)
        out = bytearray()
        prev = np.zeros(b.shape[1], np.int32)
        for y in range(sh):
            cur = b[y].astype(np.int32)
            f = y % 5
            left = np.concatenate([np.zeros(bpp, np.int32), cur[:-bpp]])
            ul = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
            p = left + prev - ul
            pa, pb, pc = abs(p - left), abs(p - prev), abs(p - ul)
            pred = [np.zeros_like(cur), left, prev, (left + prev) // 2,
                    np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, ul))][f]
            out.append(f)
            out += ((cur - pred) & 255).astype(np.uint8).tobytes()
            prev = cur
        return bytes(out)

    if interlace:
        raw = b"".join(packed_rows(samples[y0::dy, x0::dx]) for x0, y0, dx, dy in timg._ADAM7
                       if y0 < h and x0 < w)
    else:
        raw = packed_rows(samples)

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    data = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, interlace))
    if palette is not None:
        data += chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    data += chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b"")
    Path(path).write_bytes(data)
    return path


PNG_CASES = [  # (colour type, bit depth, interlace)
    (3, 1, 0), (3, 2, 0), (3, 4, 0), (3, 8, 0), (0, 1, 0), (0, 2, 0), (0, 4, 0),
    (0, 8, 1), (2, 8, 1), (6, 16, 1), (3, 4, 1), (0, 2, 1), (4, 8, 1),
]


def _png_case(tmp_path, ctype, depth, interlace, h=13, w=11, seed=0):
    rng = np.random.default_rng(seed + 10 * ctype + depth)
    ch = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    top = (1 << depth) - 1
    samples = rng.integers(0, top + 1, (h, w, ch)).astype(np.uint16 if depth == 16 else np.uint8)
    palette = rng.integers(0, 256, (min(256, top + 1) - 1, 3)) if ctype == 3 else None  # one entry short
    return _png(tmp_path / f"c{ctype}d{depth}i{interlace}_{seed}.png", samples, depth, ctype, interlace, palette)


@pytest.mark.parametrize("ctype,depth,interlace", PNG_CASES, ids=lambda v: str(v))
def test_png_reads_as_pil_gives_it_to_the_jax_package(ctype, depth, interlace, tmp_path):
    p = _png_case(tmp_path, ctype, depth, interlace)
    im = Image.open(p)
    got = timg.pil_uint8(timg.read_png(p))  # 16-bit samples as PIL makes them 8-bit
    if ctype == 3:
        want = np.asarray(im.convert("RGB"))  # the JAX package's _load_raw converts mode P
    elif ctype == 0 and depth < 8:
        want = np.asarray(im.convert("L"))
    else:
        want = np.asarray(im)
    assert got.shape == want.shape and np.array_equal(got, want)
    assert np.array_equal(timg.read_rgb(p), np.asarray(im.convert("RGB")))


def test_png_canvases_match_jax(tmp_path):
    paths = [str(_png_case(tmp_path, *case, h=24, w=32, seed=i)) for i, case in enumerate(PNG_CASES)]
    got = timg.decode_to_canvas(paths, short_size=24, num_workers=3)
    want = jimg.decode_to_canvas(paths, short_size=24, num_workers=3)
    for k in ("canvases", "sizes", "orig_sizes", "scale_factors"):
        assert np.array_equal(getattr(got, k), getattr(want, k)), k


# ------------------------------------------------------------- the glob


def _mixed_glob(tmp_path, short):
    """JPEGs of every mode and coding above and PNGs, short side `short`."""
    paths = []
    for i, ((mode, sub), extra) in enumerate([(m, c) for m in MODES for c in [{}] + CODINGS]):
        h, w = (short, short + 7 * i) if i % 2 else (short + 5 * i, short)
        paths.append(_save(tmp_path / f"f{i:02d}.jpg", h, w, mode, sub, seed=i, quality=80, **extra))
    for i, mode in enumerate(("RGB", "L", "RGBA")):
        img = _image(short, short + 3 * i, "RGB", seed=50 + i).convert(mode)
        img.save(tmp_path / f"p{i}.png")
        paths.append(tmp_path / f"p{i}.png")
    return sorted(str(p) for p in paths)


@pytest.mark.parametrize("short,resized", [(40, False), (24, True)])
def test_canvas_matches_jax_on_a_mixed_glob(short, resized, tmp_path, big_blocks):
    paths = _mixed_glob(tmp_path, 40)
    got = timg.decode_to_canvas(paths, short_size=short, num_workers=4)
    want = jimg.decode_to_canvas(paths, short_size=short, num_workers=4)
    for k in ("sizes", "orig_sizes", "scale_factors"):
        assert np.array_equal(getattr(got, k), getattr(want, k)), k
    assert got.canvases.shape == want.canvases.shape
    diff = np.abs(got.canvases.astype(int) - want.canvases.astype(int))
    # resized or not, the canvas pass gives the JAX package's bits
    assert diff.max() == 0


def test_read_rgb_matches_pils_convert(tmp_path):
    for i, (mode, sub) in enumerate(MODES):
        p = _save(tmp_path / f"r{i}.jpg", 37, 53, mode, sub, seed=i, quality=85)
        assert np.array_equal(timg.read_rgb(p), np.asarray(Image.open(p).convert("RGB")))


def _four_component_glob(tmp_path, short):
    """CMYK and YCCK files of every coding, and gray and RGB ones, short side
    `short`."""
    paths = []
    for i, ((kind, coding), (h, w)) in enumerate(zip(
            [(k, c) for k in sorted(FOUR) for c in ("huffman", "arithmetic", "progressive")],
            [(short, short + 5 * j) if j % 2 else (short + 4 * j, short) for j in range(12)])):
        adobe, sampling = FOUR[kind]
        rgb = np.asarray(_image(h, w, "RGB", seed=60 + i))
        planes = fixtures.ycck(rgb) if kind.startswith("ycck") else 255 - np.asarray(Image.fromarray(rgb).convert("CMYK"))
        kw = {"arithmetic": {"coding": "arithmetic"}, "progressive": {"coding": "arithmetic", "progressive": True}}
        paths.append(_write(tmp_path, f"k{i:02d}.jpg", fixtures.encode(planes, sampling=sampling, jfif=False, adobe=adobe,
                                                                        **kw.get(coding, {}))))
    paths.append(_save(tmp_path / "g.jpg", short, short + 9, "L", None, seed=70, quality=85))
    paths.append(_save(tmp_path / "c.jpg", short + 11, short, "RGB", "4:2:0", seed=71, quality=85))
    _image(short, short + 2, "RGB", seed=72).convert("CMYK").save(tmp_path / "pil_cmyk.jpg")
    paths.append(tmp_path / "pil_cmyk.jpg")
    return sorted(str(p) for p in paths)


@pytest.mark.parametrize("short,resized", [(40, False), (24, True)])
def test_four_component_canvases_match_jax(short, resized, tmp_path):
    paths = _four_component_glob(tmp_path, 40)
    got = timg.decode_to_canvas(paths, short_size=short, num_workers=3)
    want = jimg.decode_to_canvas(paths, short_size=short, num_workers=3)
    for k in ("sizes", "orig_sizes", "scale_factors"):
        assert np.array_equal(getattr(got, k), getattr(want, k)), k
    assert got.canvases.shape == want.canvases.shape
    diff = np.abs(got.canvases.astype(int) - want.canvases.astype(int))
    assert diff.max() == 0  # as test_canvas_matches_jax_on_a_mixed_glob
    for p in paths:
        assert np.array_equal(timg.read_rgb(p), np.asarray(Image.open(p).convert("RGB"))), p


def _oversize_glob(tmp_path):
    """PNGs of every mode the JAX package's PIL path converts (RGB, L, RGBA,
    LA, P, 16-bit gray and RGB) and JPEGs of every kind, sizes whose resized
    extents round differently in float32 and float64 among them."""
    paths = []
    sizes = [(37, 53), (53, 37), (45, 45), (29, 61), (61, 31), (40, 71), (33, 33)]
    for i, (mode, (h, w)) in enumerate(zip(("RGB", "L", "RGBA", "LA", "P"), sizes)):
        im = _image(h, w, "RGB", seed=80 + i)
        im = im.quantize(64) if mode == "P" else im.convert(mode)
        im.save(tmp_path / f"p{i}.png")
        paths.append(tmp_path / f"p{i}.png")
    rng = np.random.default_rng(0)
    _png(tmp_path / "g16.png", rng.integers(0, 400, (41, 57, 1)).astype(np.uint16), 16, 0)
    _png(tmp_path / "c16.png", rng.integers(0, 65536, (39, 44, 3)).astype(np.uint16), 16, 2)
    paths += [tmp_path / "g16.png", tmp_path / "c16.png"]
    for i, (h, w) in enumerate(sizes):
        rgb = np.asarray(_image(h, w, "RGB", seed=90 + i))
        data = [fixtures.encode(fixtures.ycbcr(rgb), sampling=[(1, 2), (1, 1), (1, 1)]),
                fixtures.encode(fixtures.ycck(rgb), jfif=False, adobe=2, coding="arithmetic"),
                fixtures.encode(255 - np.asarray(Image.fromarray(rgb).convert("CMYK")), jfif=False),
                fixtures.encode(rgb[..., 1], lossless=3, jfif=False),
                fixtures.encode(fixtures.ycbcr(rgb), coding="arithmetic", progressive=True)][i % 5]
        paths.append(_write(tmp_path, f"j{i}.jpg", data))
        paths.append(_save(tmp_path / f"q{i}.jpg", h, w, "RGB", "4:2:0", seed=95 + i, quality=80))
    return sorted(str(p) for p in paths)


@pytest.mark.parametrize("short,canvas_hw", [(48, (64, 64)), (37, (40, 40)), (33, (32, 40)), (48, (24, 24))],
                         ids=["one_too_wide", "some", "every", "every_both_sides"])
def test_oversize_canvas_crop_matches_jax(short, canvas_hw, tmp_path):
    """An explicit canvas smaller than one resized image, then than every
    one: the whole glob takes the JAX package's PIL path (luma, a BILINEAR
    resize to float64-rounded sizes, a centre crop that rewrites `sizes`)."""
    paths = _oversize_glob(tmp_path)
    got = timg.decode_to_canvas(paths, short_size=short, canvas_hw=canvas_hw, num_workers=3)
    want = jimg.decode_to_canvas(paths, short_size=short, canvas_hw=canvas_hw, num_workers=3)
    for k in ("canvases", "sizes", "orig_sizes", "scale_factors"):
        assert getattr(got, k).dtype == getattr(want, k).dtype, k
        assert np.array_equal(getattr(got, k), getattr(want, k)), k
    assert (got.sizes <= np.asarray(canvas_hw)).all() and got.canvases.shape[1:] == canvas_hw


def test_oversize_sizes_round_in_float64(tmp_path):
    """The PIL path's sizes are Python's round of the float64 product, as
    the JAX package's: a 6 x 27 image at short side 7 is 31.5000...04 wide,
    32 pixels, where the float32 product of the default path rounds to 31."""
    paths = []
    for i, (h, w) in enumerate([(6, 27), (51, 6), (41, 205), (3, 5)]):
        _image(h, w, "RGB", seed=i).save(tmp_path / f"r{i}.png")
        paths.append(str(tmp_path / f"r{i}.png"))
    assert round(27 * (7 / 6)) == 32 and int(np.round(np.float32(27) * (np.float32(7) / np.float32(6)))) == 31
    for short in (7, 5, 41):
        want = jimg.decode_to_canvas(paths, short_size=short, canvas_hw=(8, 16), num_workers=2)
        got = timg.decode_to_canvas(paths, short_size=short, canvas_hw=(8, 16), num_workers=2)
        for k in ("canvases", "sizes", "orig_sizes", "scale_factors"):
            assert np.array_equal(getattr(got, k), getattr(want, k)), (short, k)


# ------------------------------------------------------------- the runner's downscale

RUNNER_NAMES = list(chip_smoke.RUNNER_SOURCES)
PIL_OPENS = {"RGB;16": "RGB", "RGBA;16": "RGBA", "LA;16": "RGBA"}  # the mode PIL opens 16-bit colour in


def _pil_runner_sources(out):
    """The runner sources, written by PIL (16-bit colour, which PIL cannot
    write, by _png with every row filter; the GIFs as RUNNER_FIXTURES has
    them)."""
    out.mkdir()
    paths = []
    for name, (kind, _) in chip_smoke.RUNNER_SOURCES.items():
        px = chip_smoke.runner_source(np, name)
        if name.endswith(".gif"):
            shutil.copyfile(chip_smoke.RUNNER_FIXTURES / name, out / name)
        elif kind.endswith(";16") and kind != "I;16":
            _png(out / name, px, 16, {"RGB;16": 2, "LA;16": 4, "RGBA;16": 6}[kind])
        elif kind == "P":
            img = Image.fromarray(px, "P")
            img.putpalette([c for rgb in chip_smoke.RUNNER_PALETTE for c in rgb])
            img.save(out / name)
        else:
            Image.fromarray(px, kind if kind in ("LA", "RGBA", "CMYK") else None).save(out / name)
        paths.append(str(out / name))
    return paths


@pytest.fixture(scope="module")
def runner_outputs(tmp_path_factory):
    """Both runners' downscale of the runner sources, as the port writes
    them and as PIL writes them: {writer: {"j"|"t": {name: frame}}}."""
    from acezero_tpu.export import nerfstudio_runner as jrunner
    from acezero_tpu_torch.export import nerfstudio_runner as trunner

    root = tmp_path_factory.mktemp("runner")
    sources = {"port": chip_smoke.write_runner_sources(np, root / "port_sources"),
               "pil": _pil_runner_sources(root / "pil_sources")}
    return {writer: {name: chip_smoke.runner_downscale(mod, paths, root / f"{writer}_{name}")
                     for name, mod in (("j", jrunner), ("t", trunner))}
            for writer, paths in sources.items()}


@pytest.mark.parametrize("writer", ["port", "pil"])
@pytest.mark.parametrize("name", RUNNER_NAMES)
def test_runner_downscales_every_mode_as_pil(name, writer, runner_outputs):
    """The port's runner against the JAX runner's PIL `resize(BILINEAR)` and
    `save` of the same source: the same frame entry, JPEG bytes equal, PNG
    mode, pixels (a palette output's indices, a 1-bit one's bits) and RGB
    pixels equal under PIL."""
    ft, fj = runner_outputs[writer]["t"][name], runner_outputs[writer]["j"][name]
    assert {k: v for k, v in ft.items() if k != "file_path"} == {k: v for k, v in fj.items() if k != "file_path"}
    got, want = Path(ft["file_path"]), Path(fj["file_path"])
    assert got.name == want.name == name and got.parent.name == "images_downscaled"
    assert max(ft["w"], ft["h"]) == 640
    if name.endswith(".jpg"):
        assert got.read_bytes() == want.read_bytes()
        return
    with Image.open(got) as g, Image.open(want) as w:
        kind = chip_smoke.RUNNER_SOURCES[name][0]
        if name.endswith(".gif"):  # PIL's GIF save of L keeps L only for a palette of the grey ramp
            assert g.getpalette() == w.getpalette() and g.info.get("transparency") == w.info.get("transparency")
        else:
            assert w.mode == PIL_OPENS.get(kind, kind)  # PIL keeps the mode it opened the source in
        assert g.mode == w.mode
        assert np.array_equal(np.asarray(g), np.asarray(w))
        assert np.array_equal(np.asarray(g.convert("RGB")), np.asarray(w.convert("RGB")))


def test_runner_digests_are_pils_and_the_ports(tmp_path):
    """tests/data/runner/pil_digests.json, which the card checks, holds the
    JAX runner's (PIL's) results on the sources the port writes, and the
    committed P and 1 fixtures are runner_source's pixels."""
    import make_runner_fixtures

    committed = json.loads((chip_smoke.RUNNER_FIXTURES / "pil_digests.json").read_text())
    assert make_runner_fixtures.digests(tmp_path) == committed
    assert sorted(committed) == sorted(RUNNER_NAMES)
    for name in ("palette.png", "bilevel.png"):
        with Image.open(chip_smoke.RUNNER_FIXTURES / name) as img:
            assert img.mode == chip_smoke.RUNNER_SOURCES[name][0]
            assert np.array_equal(np.asarray(img), chip_smoke.runner_source(np, name))
        assert (chip_smoke.RUNNER_FIXTURES / name).stat().st_size < 1000
    # the card's check, here: the port's downscale equals every digest
    from acezero_tpu_torch.export import nerfstudio_runner as trunner

    kinds = chip_smoke.runner_kinds_check(np, trunner, tmp_path / "card_check")
    assert sorted(kinds) == sorted(RUNNER_NAMES) and all(c["equal_to_pil"] for c in kinds.values()), kinds


@pytest.mark.parametrize("mode", ["RGBA", "LA", "I;16", "P"])
def test_runner_raises_where_pil_cannot_save_a_jpeg(mode, tmp_path):
    """A PNG source named .jpg, in a mode JPEG cannot hold: both runners
    raise OSError when they save it."""
    from acezero_tpu.export import nerfstudio_runner as jrunner
    from acezero_tpu_torch.export import nerfstudio_runner as trunner

    img = _image(30, 700, "RGB", seed=3)
    img = img.quantize(16) if mode == "P" else img.convert("I;16" if mode == "I;16" else mode)
    with open(tmp_path / "x.jpg", "wb") as f:
        img.save(f, format="PNG")
    for name, mod in (("j", jrunner), ("t", trunner)):
        frame = {"file_path": str(tmp_path / "x.jpg"), "fl_x": 1.0, "fl_y": 1.0, "cx": 1.0, "cy": 1.0, "w": 700, "h": 30}
        (tmp_path / f"{name}.json").write_text(json.dumps({"frames": [frame], "train_filenames": [], "test_filenames": []}))
        (tmp_path / name).mkdir()
        with pytest.raises(OSError, match=f"cannot write mode {mode} as JPEG"):
            mod._downscale_images(tmp_path / f"{name}.json", tmp_path / name)


@pytest.mark.parametrize("mode", ["RGBA", "LA"])
def test_premultiply_round_trip_matches_pil_for_every_value_and_alpha(mode):
    """pil_premultiply and pil_unpremultiply against PIL's conversions to
    and from RGBa and La, over all 65,536 (value, alpha) pairs."""
    v, a = (c.astype(np.uint8) for c in np.meshgrid(np.arange(256), np.arange(256), indexing="ij"))
    img = np.stack([v, 255 - v, v // 3, a] if mode == "RGBA" else [v, a], -1)
    premultiplied = mode[:-1] + "a"
    assert np.array_equal(timg.pil_premultiply(img), np.asarray(Image.fromarray(img, mode).convert(premultiplied)))
    back = np.asarray(Image.frombytes(premultiplied, (256, 256), img.tobytes()).convert(mode))
    assert np.array_equal(timg.pil_unpremultiply(img), back)


@pytest.mark.parametrize("hw,out_hw", [((37, 53), (20, 30)), ((100, 333), (17, 61)), ((64, 64), (64, 63)),
                                       ((1000, 997), (333, 301)), ((9, 1), (4, 1))])
def test_pil_resizes_of_other_modes_match_pil(hw, out_hw):
    """pil_resize_bilinear of 16-bit gray (I;16, every byte clipped as
    Pillow stores it) and pil_resize_nearest (modes P and 1) against PIL."""
    rng = np.random.default_rng(sum(hw))
    (h, w), (oh, ow) = hw, out_hw
    g16 = rng.integers(0, 65536, (h, w)).astype(np.uint16)
    g16[0] = 65535
    want = np.asarray(Image.fromarray(g16).resize((ow, oh), Image.BILINEAR))
    got = timg.pil_resize_bilinear(g16, oh, ow)
    assert got.dtype == np.uint16 and np.array_equal(got, want)
    pal = Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).quantize(32)
    want = np.asarray(pal.resize((ow, oh), Image.BILINEAR).convert("RGB"))
    assert np.array_equal(timg.pil_resize_nearest(np.asarray(pal.convert("RGB")), oh, ow), want)
    bits = Image.fromarray(rng.integers(0, 2, (h, w)).astype(bool))
    want = np.asarray(bits.resize((ow, oh), Image.BILINEAR).convert("L"))
    assert np.array_equal(timg.pil_resize_nearest(np.asarray(bits.convert("L")), oh, ow), want)


@pytest.mark.parametrize("hw", [(1, 1), (7, 9), (20, 30), (64, 80), (201, 301)])
@pytest.mark.parametrize("quality", [50, 75, 95])
def test_write_jpeg_of_cmyk_gives_pils_bytes(hw, quality, tmp_path):
    """An (h, w, 4) image through write_jpeg: PIL's save of mode CMYK, byte
    for byte, and read_jpeg gives PIL's decode of it."""
    rng = np.random.default_rng(hw[0] * quality)
    px = rng.integers(0, 256, (*hw, 4), dtype=np.uint8)
    px[: hw[0] // 2] = np.asarray(_image(hw[0], hw[1], "RGB", seed=quality).convert("CMYK"))[: hw[0] // 2]
    Image.fromarray(px, "CMYK").save(tmp_path / "pil.jpg", quality=quality)
    tjpeg.write_jpeg(tmp_path / "port.jpg", px, quality)
    assert (tmp_path / "port.jpg").read_bytes() == (tmp_path / "pil.jpg").read_bytes()
    assert np.array_equal(tjpeg.read_jpeg(tmp_path / "port.jpg"), np.asarray(Image.open(tmp_path / "pil.jpg")))


@pytest.mark.parametrize("dtype,channels", [(np.uint8, 1), (np.uint8, 2), (np.uint8, 3), (np.uint8, 4),
                                            (np.uint16, 1), (np.uint16, 2), (np.uint16, 3), (np.uint16, 4)])
def test_write_png_opens_in_pils_mode_with_its_pixels(dtype, channels, tmp_path):
    """write_png's 8- and 16-bit gray, gray+alpha, RGB and RGBA: PIL opens
    each as it opens PIL's own save (or the file of the 16-bit samples),
    with its pixels, and pil_mode names that mode."""
    rng = np.random.default_rng(channels)
    px = rng.integers(0, np.iinfo(dtype).max + 1, (13, 17, channels)).astype(dtype)
    px = px[..., 0] if channels == 1 else px
    tpng.write_png(tmp_path / "port.png", px)
    if dtype == np.uint8 or channels == 1:
        Image.fromarray(px, {2: "LA", 4: "RGBA"}.get(channels)).save(tmp_path / "ref.png")
    else:
        _png(tmp_path / "ref.png", px, 16, {2: 4, 3: 2, 4: 6}[channels])
    with Image.open(tmp_path / "port.png") as got, Image.open(tmp_path / "ref.png") as want:
        assert got.mode == want.mode == formats.pil_mode(tmp_path / "port.png")
        assert np.array_equal(np.asarray(got), np.asarray(want))
    assert np.array_equal(timg.read_png(tmp_path / "port.png"), px)


@pytest.mark.parametrize("ctype,depth,interlace", PNG_CASES, ids=lambda v: str(v))
def test_pil_mode_is_the_mode_pil_opens_a_png_in(ctype, depth, interlace, tmp_path):
    p = _png_case(tmp_path, ctype, depth, interlace)
    with Image.open(p) as img:
        assert formats.pil_mode(p) == img.mode


def test_frame_colors_match_jax_on_jpeg_frames(tmp_path):
    for i, (mode, sub) in enumerate(MODES):
        _save(tmp_path / f"c{i}.jpg", 60, 84, mode, sub, seed=i, quality=85)
    kw = dict(image_short_size=48, external_focal_length=100.0, num_workers=2)
    jscene = j_load_scene(str(tmp_path / "c*.jpg"), **kw)
    tscene = t_load_scene(str(tmp_path / "c*.jpg"), **kw)
    hs, ws = tscene.canvas_hw[0] // 8, tscene.canvas_hw[1] // 8
    for idx in range(len(MODES)):
        got = tpc._frame_colors(tscene, idx, hs, ws)
        want = jpc._frame_colors(jscene, idx, hs, ws)
        assert np.array_equal(got, want), idx
        assert not np.array_equal(got[:, 0], got[:, 2]) or MODES[idx][0] == "L"  # colours, not the gray canvas


def test_decode_holds_at_most_num_workers_images(tmp_path, monkeypatch):
    paths = [str(_save(tmp_path / f"m{i:02d}.jpg", 64, 80, "RGB", "4:2:0", seed=i)) for i in range(12)]
    real = timg.read_image
    lock = threading.Lock()
    live = {"now": 0, "peak": 0, "calls": 0}

    def freed():
        with lock:
            live["now"] -= 1

    def counted(path):
        arr = real(path)
        with lock:
            live["now"] += 1
            live["calls"] += 1
            live["peak"] = max(live["peak"], live["now"])
        weakref.finalize(arr, freed)
        return arr

    monkeypatch.setattr(timg, "read_image", counted)
    out = timg.decode_to_canvas(paths, short_size=32, num_workers=3)
    assert live["calls"] == 12 and 1 <= live["peak"] <= 3 and live["now"] == 0
    monkeypatch.setattr(timg, "read_image", real)
    assert np.array_equal(out.canvases, timg.decode_to_canvas(paths, short_size=32, num_workers=1).canvases)


def test_png_canvases_equal_the_decode_all_first_path(tmp_path):
    """The restructured decode_to_canvas gives the bits of the path it
    replaced (every PNG decoded first, then each resized and placed), on
    the scene's frames and on RGB(A) PNGs that shrink and enlarge."""
    paths = sorted(str(p) for p in (ROOT / "results/heldout/scenes/chesslike_a").glob("frame_000[0-2].png"))
    for i, (h, w, c) in enumerate([(96, 128, 3), (120, 90, 4), (80, 80, 3)]):
        Image.fromarray(np.asarray(_image(h, w, "RGB", seed=i).convert("RGBA"))[..., :c]).save(tmp_path / f"q{i}.png")
        paths.append(str(tmp_path / f"q{i}.png"))
    for short in (480, 90):
        raws = [timg.read_png(p) for p in paths]
        orig = np.array([r.shape[:2] for r in raws], np.int32)
        scales = short / orig.min(axis=1).astype(np.float32)
        sizes = np.round(orig * scales[:, None]).astype(np.int32)
        hc, wc = (-(-int(v) // 8) * 8 for v in sizes.max(axis=0))
        want = np.zeros((len(paths), hc, wc), np.uint8)
        for i, (r, (h, w)) in enumerate(zip(raws, sizes)):
            want[i, (hc - h) // 2: (hc - h) // 2 + h, (wc - w) // 2: (wc - w) // 2 + w] = timg.gray_resize(r, h, w)
        got = timg.decode_to_canvas(paths, short_size=short, num_workers=3)
        assert np.array_equal(got.canvases, want) and np.array_equal(got.sizes, sizes)
        assert np.array_equal(got.orig_sizes, orig) and np.array_equal(got.scale_factors, scales)


# ------------------------------------------------------------- host build


def test_host_build_is_keyed_by_source_and_flags(tmp_path, monkeypatch):
    src = tmp_path / "jpeg.cpp"
    src.write_bytes(tjpeg.SOURCE.read_bytes())
    assert build.host_target(src) == build.host_target(tjpeg.SOURCE)
    assert build.host_target(src).parent == build.BUILD_DIR and build.host_target(src).name.startswith("jpeg-")
    src.write_text(src.read_text() + "\n// edit\n")
    assert build.host_target(src) != build.host_target(tjpeg.SOURCE)
    monkeypatch.setattr(build, "HOST_FLAGS", build.HOST_FLAGS + ("-g",))
    assert build.host_target(tjpeg.SOURCE) != build.host_target(src)
    assert not any(f in build.HOST_FLAGS for f in ("-ffast-math", "-march=native"))
    assert "-ffp-contract=off" in build.HOST_FLAGS  # no fused multiply-add in the canvas pass on any host


def test_host_build_raises_without_a_compiler_or_on_an_error(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    bad = tmp_path / "bad.cpp"
    bad.write_text("int main( {\n")
    with pytest.raises(RuntimeError, match="host build of bad.cpp failed"):
        build.build_host(bad)
    assert not list((tmp_path / "_build").glob("*.tmp"))
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="c\\+\\+ not found"):
        build.build_host(tjpeg.SOURCE)


# ------------------------------------------------------------- the slice


@pytest.fixture(scope="module")
def jpeg_scene(tmp_path_factory):
    """The mini loop's room scene as tinted 4:2:0 JPEGs at quality 90."""
    out = tmp_path_factory.mktemp("jpeg_scene")
    data = render_room_scene(N, h=96, w=128)
    for i in range(N):
        Image.fromarray(chip_smoke.tinted(np, data["images_u8"][i])).save(out / f"frame_{i:03d}.jpg", quality=90)
        np.save(out / f"frame_{i:03d}_depth.npy", data["depth"][i])
        np.savetxt(out / f"frame_{i:03d}_pose.txt", data["poses_c2w"][i])
    return out, data["focal"]


def test_mini_loop_on_jpeg_frames_matches_jax(jpeg_scene, tmp_path):
    """The reconstruction CLI on a JPEG glob: the scene loads to the JAX
    package's canvases, and both packages' loops register within the mini
    loop's band, with the same frames in poses_final.txt."""
    from acezero_tpu.reconstruct import AceZeroConfig as JConfig
    from acezero_tpu.reconstruct import AceZeroPipeline as JPipeline
    from acezero_tpu_torch.cli import ace_zero_cli

    path, focal = jpeg_scene
    files = sorted(str(p) for p in path.glob("*.jpg"))
    t_scene = t_load_scene(str(path / "*.jpg"), external_focal_length=float(focal), num_workers=2)
    j_scene = j_load_scene(str(path / "*.jpg"), external_focal_length=float(focal), num_workers=2)
    assert t_scene.rgb_files == files and np.array_equal(t_scene.images.canvases, j_scene.images.canvases)
    argv = [str(path / "*.jpg"), str(tmp_path / "t"), "--depth_files", str(path / "*_depth.npy"),
            "--use_external_focal_length", str(focal), *MINI_FLAGS, "--device", "cpu"]
    res_t = ace_zero_cli.main(argv, **MINI_OVERRIDES, decode_cache_dir=None)
    res_j = JPipeline(JConfig(rgb_files=str(path / "*.jpg"), results_folder=tmp_path / "j",
                              depth_files=str(path / "*_depth.npy"), use_external_focal_length=float(focal),
                              **MINI, **JAX_ONLY, base_seed=2089)).run()
    for res in (res_t, res_j):
        assert all(RATE_BAND[0] <= r <= RATE_BAND[1] for r in res["rate_history"]), res["rate_history"]
    lines_t = (tmp_path / "t" / "poses_final.txt").read_text().splitlines()
    lines_j = (tmp_path / "j" / "poses_final.txt").read_text().splitlines()
    assert sorted(ln.split()[0] for ln in lines_t) == sorted(ln.split()[0] for ln in lines_j) == files
