"""TIFF, BMP and Netpbm/PFM files in the port (io/tiff.py, io/bmp.py,
io/pnm.py, io/csrc/tiff.cpp) against PIL, which opens them for the JAX
package, and against the JAX package itself:

- every fixture of tests/data/formats (scripts/make_format_fixtures.py)
  decodes to PIL's array, dtype and mode, live and as recorded in
  pil_digests.json (which the card checks), with PIL's size and mode from
  the header alone, and PIL's `convert("RGB")` and `convert("L")`;
- decode_to_canvas gives the JAX package's canvases bit for bit, on the
  native path and on the PIL path (a canvas smaller than the content);
- load_depth_file gives the JAX package's depth maps;
- the Nerfstudio runner's downscale of each reads back in PIL as PIL's own
  resize and save does;
- the writers' files read back in PIL (BMP and PNM byte for byte);
- a matrix of TIFF layouts written here (byte orders, compressions,
  predictors, strips, tiles, planes) decodes as PIL decodes it;
- every kind PIL refuses, and every kind the port queues, raises
  ValueError naming the file;
- the slice: the reconstruction CLI on TIFF frames with TIFF depth gives
  the poses of its run on PNG copies, and the train CLI the same map from
  PNG, TIFF and PGM depth.
"""

from __future__ import annotations

import io
import json
import struct
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from acezero_tpu.data import images as jimg
from acezero_tpu.data.depth import load_depth_file as j_load_depth_file
from acezero_tpu_torch.cli import ace_zero_cli, train_ace_cli
from acezero_tpu_torch.data import images as timg
from acezero_tpu_torch.data.depth import load_depth_file
from acezero_tpu_torch.export import nerfstudio_runner as runner
from acezero_tpu_torch.io import bmp as tbmp
from acezero_tpu_torch.io import formats
from acezero_tpu_torch.io import pnm as tpnm
from acezero_tpu_torch.io import tiff as ttiff
from acezero_tpu_torch.io.png import write_png
from acezero_tpu_torch.models import torch_io as tio

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))
sys.path.insert(0, str(Path(__file__).resolve().parent))
import chip_smoke  # noqa: E402
import make_format_fixtures as fx  # noqa: E402
from synthetic import render_room_scene  # noqa: E402
from test_torch_pipeline import MINI_FLAGS, MINI_OVERRIDES, N  # noqa: E402
from test_torch_trainer import one_torch_thread  # noqa: E402,F401  (autouse: torch on one thread)

FIXTURES = sorted(fx.FIXTURES)
DIGESTS = json.loads((fx.OUT / "pil_digests.json").read_text())
SCENE = ROOT / "results" / "heldout" / "scenes" / "chesslike_a"


def _pil(path):
    """(np.asarray, mode, size, convert("RGB"), convert("L")) of PIL's image."""
    with Image.open(path) as im:
        return np.asarray(im), im.mode, im.size, np.asarray(im.convert("RGB")), np.asarray(im.convert("L"))


def _assert_decodes_as_pil(path):
    want, mode, size, rgb, luma = _pil(path)
    img = timg.read_image(path)
    got = timg.pil_array(img)
    assert (formats.pil_mode(path), formats.image_size(path)) == (mode, size)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want, equal_nan=want.dtype.kind == "f")
    assert np.array_equal(timg.read_rgb(path), rgb)
    assert np.array_equal(timg.pil_luma_u8(img), luma)


# ------------------------------------------------------------- the fixtures


@pytest.mark.parametrize("name", FIXTURES)
def test_fixture_decodes_as_pil(name):
    _assert_decodes_as_pil(fx.OUT / name)


@pytest.mark.parametrize("name", FIXTURES)
def test_fixture_digests_are_pils(name):
    """pil_digests.json holds PIL's decode of each fixture as it is (the
    card checks the port against it), and the port's decode gives it."""
    path = fx.OUT / name
    want = DIGESTS["files"][name]
    arr, mode, _, rgb, _ = _pil(path)
    assert want == {"mode": mode, "shape": list(arr.shape), "dtype": arr.dtype.str,
                    "sha256": chip_smoke.array_digest(arr), "rgb_sha256": chip_smoke.array_digest(rgb)}
    assert chip_smoke.array_digest(timg.pil_array(timg.read_image(path))) == want["sha256"]
    assert (fx.OUT / name).read_bytes() == fx.FIXTURES[name]()  # the script writes these bytes


def test_fixtures_stay_small_and_cover_every_kind():
    files = list(fx.OUT.iterdir())
    assert sum(p.stat().st_size for p in files) < 300_000
    assert sorted(DIGESTS["files"]) == FIXTURES and set(fx.DEPTH) <= set(FIXTURES)
    modes = {d["mode"] for d in DIGESTS["files"].values()}
    assert modes == {"1", "L", "P", "LA", "RGB", "RGBA", "I;16", "I;16B", "I", "F", "CMYK"}
    kinds = {formats.file_kind(fx.OUT / n) for n in FIXTURES}
    assert kinds == {"tiff", "bmp", "pnm"}


@pytest.mark.parametrize("short_size,canvas_hw", fx.CANVAS_CHECKS)
def test_canvases_of_every_fixture_match_jax(short_size, canvas_hw):
    """decode_to_canvas over every fixture in one glob: the JAX package's
    canvases, sizes and scales (native path at the default canvas, PIL path
    at the small one), and the recorded digest."""
    paths = fx.fixture_paths()
    got = timg.decode_to_canvas(paths, short_size=short_size, canvas_hw=canvas_hw, num_workers=4)
    want = jimg.decode_to_canvas(paths, short_size=short_size, canvas_hw=canvas_hw, num_workers=2)
    diff = np.abs(got.canvases.astype(np.int16) - want.canvases.astype(np.int16))
    assert diff.max() == 0
    assert np.array_equal(got.sizes, want.sizes) and np.array_equal(got.orig_sizes, want.orig_sizes)
    assert np.array_equal(got.scale_factors, want.scale_factors)
    entry = [c for c in DIGESTS["canvas"] if c["short_size"] == short_size][0]
    assert chip_smoke.canvas_digest(got) == entry["sha256"]


@pytest.mark.parametrize("name", FIXTURES)
def test_canvas_input_is_load_raws(name):
    """Each fixture alone at a short side of 64 (enlarged: the bilinear
    branch of the pass) equals the JAX package's canvas."""
    path = [str(fx.OUT / name)]
    got = timg.decode_to_canvas(path, short_size=64, num_workers=1).canvases
    want = jimg.decode_to_canvas(path, short_size=64, num_workers=1).canvases
    assert np.abs(got.astype(np.int16) - want.astype(np.int16)).max() == 0


@pytest.mark.parametrize("name", FIXTURES)
def test_load_depth_file_matches_jax(name):
    """Any image as a depth file: its values over 1,000, float images too."""
    got, want = load_depth_file(fx.OUT / name), j_load_depth_file(str(fx.OUT / name))
    assert got.dtype == want.dtype == np.float64 and np.array_equal(got, want)
    if name in fx.DEPTH:
        assert chip_smoke.array_digest(got) == DIGESTS["depth"][name]


@pytest.mark.parametrize("name", FIXTURES)
def test_runner_downscale_reads_back_as_pils(name, tmp_path):
    """The runner's downscale written under the source's name: PIL reads it
    back to the mode and pixels of PIL's own resize and save (a mode-P
    image to the same colours). A JPEG-compressed TIFF is the recorded
    difference: PIL compresses the downscale again, the port writes it
    uncompressed, so its read-back is PIL's resize itself."""
    src = fx.OUT / name
    with Image.open(src) as im:
        size = (max(1, im.width * 2 // 3), max(1, im.height * 3 // 5))
        resized = im.resize(size, Image.BILINEAR)
        try:
            resized.save(tmp_path / f"pil_{name}")
        except OSError:  # a mode the format cannot hold (P or CMYK as PPM): the port's save raises too
            with pytest.raises(OSError, match=f"cannot write mode {resized.mode}"):
                runner._save(tmp_path / f"port_{name}", *runner._resized(src, *size))
            return
        jpeg_tiff = im.info.get("compression") == "jpeg"
        resized_arr = np.asarray(resized)
    with Image.open(tmp_path / f"pil_{name}") as back:
        want, want_mode = np.asarray(back), back.mode
        want_rgb = np.asarray(back.convert("RGB"))
    dst = tmp_path / f"port_{name}"
    runner._save(dst, *runner._resized(src, *size))
    with Image.open(dst) as back:
        got, got_mode = np.asarray(back), back.mode
        got_rgb = np.asarray(back.convert("RGB"))
    assert got_mode == want_mode and got.shape == want.shape
    if jpeg_tiff:
        assert np.array_equal(got, resized_arr) and not np.array_equal(got, want)
    else:
        assert np.array_equal(got, want, equal_nan=True) and np.array_equal(got_rgb, want_rgb)
    if name.endswith((".bmp", ".pbm", ".pgm", ".ppm", ".pfm")):
        assert dst.read_bytes() == (tmp_path / f"pil_{name}").read_bytes()


@pytest.mark.parametrize("kind", ["P256", "P16", "P2", "P_trns", "1"])
def test_palette_and_bilevel_png_as_pil(kind, tmp_path):
    """Palette PNGs (8-, 4- and 1-bit indices, with tRNS) and 1-bit PNGs
    decode to PIL's indices and bools, so their depth maps, canvases and
    the runner's downscale are PIL's too."""
    rng = np.random.default_rng(len(kind))
    rgb = rng.integers(0, 256, (29, 37, 3), np.uint8)
    im = Image.fromarray(rgb)
    if kind == "1":
        im = im.convert("1")
    else:
        im = im.quantize(int(kind[1:]) if kind[1:].isdigit() else 64)
        if kind == "P_trns":
            im.info["transparency"] = 3
    src = tmp_path / f"{kind}.png"
    im.save(src)
    _assert_decodes_as_pil(src)
    got, want = load_depth_file(src), j_load_depth_file(str(src))
    assert got.dtype == want.dtype == np.float64 and np.array_equal(got, want)
    path = [str(src)]
    for short_size, canvas_hw in ((64, None), (24, (16, 24))):
        a = timg.decode_to_canvas(path, short_size=short_size, canvas_hw=canvas_hw, num_workers=1).canvases
        b = jimg.decode_to_canvas(path, short_size=short_size, canvas_hw=canvas_hw, num_workers=1).canvases
        assert np.abs(a.astype(np.int16) - b.astype(np.int16)).max() == 0
    with Image.open(src) as im:
        im.resize((25, 17), Image.BILINEAR).save(tmp_path / "pil.png")
    runner._save(tmp_path / "port.png", *runner._resized(src, 25, 17))
    with Image.open(tmp_path / "pil.png") as w, Image.open(tmp_path / "port.png") as g:
        assert g.mode == w.mode == ("1" if kind == "1" else "P")
        assert np.array_equal(np.asarray(g), np.asarray(w))
        assert np.array_equal(np.asarray(g.convert("RGB")), np.asarray(w.convert("RGB")))


# ------------------------------------------------------------- conversions


def test_gray_numeric_modes_convert_as_pil(tmp_path):
    """F truncates to L (2.25 -> 2, 3.98 -> 3) and clips; I, I;16 and I;16B
    clip at 0 and 255, in convert("L") and convert("RGB") and on the
    canvas."""
    f = np.array([[2.25, 3.98, -1.5, 300.0, 254.99, 0.5]], np.float32)
    i = np.array([[-5, 3, 254, 256, 70000, 128]], np.int32)
    u = np.array([[3, 255, 4000, 0, 65535, 256]], np.uint16)
    paths = {"f.tif": (f, "F"), "i.tif": (i, "I"), "u.tif": (u, "I;16"), "ub.tif": (u, "I;16B"),
             "f.pfm": (f, "F"), "i.pgm": (i, "I")}
    for name, (arr, mode) in paths.items():
        writer = ttiff.write_tiff if name.endswith(".tif") else tpnm.write_pnm
        writer(tmp_path / name, np.repeat(arr, 3, axis=0), mode)
        _assert_decodes_as_pil(tmp_path / name)
    assert timg.pil_luma_u8(timg.read_image(tmp_path / "f.tif"))[0].tolist() == [2, 3, 0, 255, 254, 0]
    got = timg.decode_to_canvas([str(tmp_path / n) for n in paths], short_size=24, num_workers=2)
    want = jimg.decode_to_canvas([str(tmp_path / n) for n in paths], short_size=24, num_workers=2)
    assert np.array_equal(got.canvases, want.canvases)


@pytest.mark.parametrize("mode,dtype", [("I", np.int32), ("F", np.float32), ("I;16", np.uint16)])
def test_wide_gray_resize_is_pils(mode, dtype):
    """Pillow's 32-bit (double sums, I rounded half away from zero) and
    16-bit resamples, shrinking and enlarging."""
    rng = np.random.default_rng(5)
    lo, hi = (-70000, 70000) if mode == "I" else (0, 65535)
    img = rng.uniform(lo, hi, (23, 41)).astype(dtype)
    for size in ((17, 29), (40, 63), (23, 9)):
        want = np.asarray(Image.fromarray(img).resize(size[::-1], Image.BILINEAR))
        assert np.array_equal(timg.pil_resize_bilinear(img, *size), want)


# ------------------------------------------------------------- the writers


@pytest.mark.parametrize("fmt,mode", [(f, m) for f, modes in (
    ("tif", ("1", "L", "LA", "P", "I;16", "I;16B", "I", "F", "RGB", "RGBA", "CMYK")),
    ("bmp", ("1", "L", "P", "RGB", "RGBA")),
    ("ppm", ("1", "L", "I", "RGB", "RGBA", "F"))) for m in modes])
def test_writers_read_back_in_pil(fmt, mode, tmp_path):
    """write_tiff, write_bmp and write_pnm: PIL reads the image back (BMP
    RGBA as RGB, PNM RGBA as RGB, as PIL's own files); BMP and PNM are PIL's
    bytes."""
    rng = np.random.default_rng(len(mode) * 7 + len(fmt))
    shape = (13, 19)
    arr = {"1": rng.random(shape) > 0.5, "L": rng.integers(0, 256, shape, np.uint8),
           "P": rng.integers(0, 16, shape, np.uint8), "I;16": rng.integers(0, 65536, shape, np.uint16),
           "I;16B": rng.integers(0, 65536, shape, np.uint16), "I": rng.integers(-99999, 99999, shape, np.int32),
           "F": rng.normal(0, 100, shape).astype(np.float32)}.get(mode)
    if arr is None:
        arr = rng.integers(0, 256, (*shape, {"LA": 2, "RGB": 3, "RGBA": 4, "CMYK": 4}[mode]), np.uint8)
    palette = rng.integers(0, 256, (16, 3), np.uint8) if mode == "P" else None
    path = tmp_path / f"x.{fmt}"
    if fmt == "tif":
        ttiff.write_tiff(path, arr, mode, palette)
    elif fmt == "bmp":
        tbmp.write_bmp(path, arr, mode, palette)
    else:
        tpnm.write_pnm(path, arr, mode)
    if mode in ("P", "CMYK"):
        pil = Image.frombytes(mode, shape[::-1], arr.tobytes())
    else:
        pil = Image.fromarray(arr.astype(">u2") if mode == "I;16B" else arr)
    if mode == "P":
        pil.putpalette(palette.reshape(-1).tolist())
    buf = io.BytesIO()
    pil.save(buf, format={"tif": "TIFF", "bmp": "BMP", "ppm": "PPM"}[fmt])
    want = Image.open(buf)
    with Image.open(path) as got:
        assert got.mode == want.mode
        assert np.array_equal(np.asarray(got), np.asarray(want))
        if mode == "P":
            assert np.array_equal(np.asarray(got.convert("RGB")), np.asarray(want.convert("RGB")))
    if fmt != "tif":
        assert path.read_bytes() == buf.getvalue()
    _assert_decodes_as_pil(path)


# ------------------------------------------------------------- more TIFF layouts

_RNG = np.random.default_rng(11)
_SAMPLES = {
    "gray8": (_RNG.integers(0, 256, (35, 41), np.uint8), dict(bits=(8,), photometric=1)),
    "rgb8": (_RNG.integers(0, 256, (35, 41, 3), np.uint8), dict(bits=(8,) * 3, photometric=2)),
    "rgba8": (_RNG.integers(0, 256, (35, 41, 4), np.uint8), dict(bits=(8,) * 4, photometric=2, extra=(2,))),
    "gray16": (_RNG.integers(0, 65536, (35, 41), np.uint16), dict(bits=(16,), photometric=1)),
    "rgb16": (_RNG.integers(0, 65536, (35, 41, 3), np.uint16), dict(bits=(16,) * 3, photometric=2)),
    "float32": (_RNG.normal(0, 300, (35, 41)).astype(np.float32), dict(bits=(32,), photometric=1,
                                                                       sample_format=(3,))),
    "int32": (_RNG.integers(-2**31, 2**31 - 1, (35, 41), dtype=np.int64).astype(np.int32),
              dict(bits=(32,), photometric=1, sample_format=(2,))),
    "palette4": (_RNG.integers(0, 16, (35, 41), np.uint8), dict(bits=(4,), photometric=3,
                                                                colormap=fx.COLORMAP16)),
    "bilevel": (_RNG.integers(0, 2, (35, 41), np.uint8), dict(bits=(1,), photometric=0)),
}
_LAYOUTS = {"strips": dict(rows_per_strip=6), "tiles": dict(tile=(16, 32)), "planar": dict(planar=2, rows_per_strip=9)}


_CASES = [(k, c, lay) for k in sorted(_SAMPLES) for c in (1, 5, 8, 32773) for lay in sorted(_LAYOUTS)
          if lay != "planar" or _SAMPLES[k][0].ndim == 3]  # planar configuration 2 needs two samples or more


@pytest.mark.parametrize("kind,compression,layout", _CASES)
def test_tiff_layouts_decode_as_pil(kind, compression, layout, tmp_path):
    """Each kind in strips, tiles and planes, under each compression, in
    both byte orders (predictor 2, or 3 for floats, with LZW and Deflate
    where the samples are whole bytes). The port refuses what PIL misreads:
    big-endian compressed F and I (byte-swapped), and uncompressed planes of
    16-bit samples (read as 8-bit planes)."""
    arr, opts = _SAMPLES[kind]
    opts = dict(opts, **_LAYOUTS[layout], compression=compression)
    for big in (False, True):
        pred = 3 if kind == "float32" else 2
        predictor = pred if compression in (5, 8) and opts["bits"][0] >= 8 else 1
        path = tmp_path / f"{kind}_{int(big)}.tif"
        path.write_bytes(fx.tiff_bytes(arr, big=big, predictor=predictor, **opts))
        if big and compression != 1 and kind in ("float32", "int32"):
            with pytest.raises(ValueError, match="byte-swaps"):
                timg.read_image(path)
        elif layout == "planar" and compression == 1 and opts["bits"][0] != 8:
            with pytest.raises(ValueError, match="uncompressed planar .* is not read yet"):
                timg.read_image(path)
        else:
            _assert_decodes_as_pil(path)


def test_lzw_beyond_the_table_and_packbits_runs(tmp_path):
    """Strips long enough for LZW to fill its table and clear it (PIL's
    libtiff writer and the fixture writer), and PackBits runs of every
    length."""
    rng = np.random.default_rng(3)
    noisy = rng.integers(0, 256, (96, 200, 3), np.uint8)
    noisy[::7] = 17  # long runs too
    (tmp_path / "pil.tif").write_bytes(fx.pil_tiff(noisy, compression="tiff_lzw"))
    (tmp_path / "np.tif").write_bytes(fx.tiff_bytes(noisy, bits=(8,) * 3, photometric=2, compression=5))
    runs = np.repeat(np.arange(300) % 256, np.arange(300) % 130 + 1)[: 96 * 200].astype(np.uint8)
    runs = np.resize(runs, (96, 200))
    (tmp_path / "pb.tif").write_bytes(fx.tiff_bytes(runs, bits=(8,), photometric=1, compression=32773))
    for name in ("pil.tif", "np.tif", "pb.tif"):
        _assert_decodes_as_pil(tmp_path / name)


@pytest.mark.parametrize("orientation", range(1, 9))
def test_orientation_is_pils_exif_transpose(orientation, tmp_path):
    arr = np.random.default_rng(orientation).integers(0, 256, (7, 12, 3), np.uint8)
    path = tmp_path / "o.tif"
    path.write_bytes(fx.tiff_bytes(arr, bits=(8,) * 3, photometric=2, orientation=orientation))
    _assert_decodes_as_pil(path)


def _rle_bitmap(rle: bytes, w: int, h: int, bits: int, colors: int) -> bytes:
    """A BMP of `rle` (compression RLE8 for 8 bits, RLE4 for 4) under a
    palette of `colors` entries."""
    pal = b"".join(bytes([i * 40 % 256, i * 90 % 256, 255 - i * 15, 0]) for i in range(colors))
    info = struct.pack("<IiiHHIIiiII", 40, w, h, 1, bits, 1 if bits == 8 else 2, len(rle), 0, 0, colors, 0)
    offset = 14 + len(info) + len(pal)
    return b"BM" + struct.pack("<IHHI", offset + len(rle), 0, 0, offset) + info + pal + rle


# RLE streams with Pillow's quirks: (width, height, bits, stream)
RLE_CASES = {
    "rle8_runs_clipped_at_the_row": (5, 2, 8, b"\x07\x01\x00\x00\x03\x02\x02\x03\x00\x00\x00\x01"),
    "rle8_absolute_odd_padded": (6, 2, 8, b"\x00\x03\x04\x05\x06\x00\x03\x01\x00\x00\x06\x02\x00\x00"),
    "rle8_absolute_spills_into_the_next_row": (4, 2, 8, b"\x00\x06\x01\x02\x03\x04\x05\x06\x02\x07\x00\x00"),
    "rle8_end_of_line_pads": (6, 3, 8, b"\x02\x01\x00\x00\x01\x02\x00\x00\x06\x03\x00\x01"),
    "rle4_encoded_nibbles": (7, 2, 4, b"\x07\x12\x00\x00\x05\x34\x02\x56\x00\x00\x00\x01"),
    "rle4_absolute_odd_reads_count_halved": (6, 2, 4, b"\x00\x05\x12\x34\x00\x00\x01\x07\x00\x00\x06\x0f\x00\x01"),
    "rle8_short": (4, 3, 8, b"\x04\x01\x00\x00\x00\x01"),
}


@pytest.mark.parametrize("case", sorted(RLE_CASES))
def test_bmp_rle_quirks_as_pil(case, tmp_path):
    """Pillow's RLE decoder step for step: runs clipped to the row only in
    encoded mode, absolute runs word-aligned in the file and free to spill
    into the next row, RLE4 absolute runs of count // 2 bytes, an end of
    line padding the row with index 0, and data that ends early refused."""
    w, h, bits, rle = RLE_CASES[case]
    path = tmp_path / f"{case}.bmp"
    path.write_bytes(_rle_bitmap(rle, w, h, bits, 16))
    try:
        with Image.open(path) as im:
            im.load()
    except ValueError:
        with pytest.raises(ValueError, match="truncated"):
            timg.read_image(path)
        return
    _assert_decodes_as_pil(path)


PNM_CASES = {
    "comments_everywhere.pgm": b"P5 # a\n# b\n3# c\n 2 # d\n255\n" + bytes(range(6)),
    "maxval1.pgm": b"P5\n3 2\n1\n" + bytes([0, 1, 1, 0, 1, 0]),
    "maxval300_clipped.pgm": b"P5\n2 2\n300\n" + struct.pack(">4H", 0, 150, 300, 65535),
    "plain_rgb_maxval7.ppm": b"P3\n2 1\n7\n0 3 7\n+5 1 2\n",
    "plain_16bit_gray.pgm": b"P2 2 2 65535 0 1 65535 40000",
    "plain_bits_without_spaces.pbm": b"P1\n# x\n4 2\n0110\n10 01",
    "binary_rgb16.ppm": b"P6\n2 1\n65535\n" + struct.pack(">6H", 0, 65535, 32768, 1, 257, 60000),
    "pfm_be_negative_rows.pfm": b"Pf\n2 2\n3.5\n" + struct.pack(">4f", -1.5, 2.0, 1e30, 0.25),
}


@pytest.mark.parametrize("name", sorted(PNM_CASES))
def test_pnm_headers_and_maxvals_as_pil(name, tmp_path):
    path = tmp_path / name
    path.write_bytes(PNM_CASES[name])
    _assert_decodes_as_pil(path)


def _ifd_edit(data: bytes, tag: int, typ: int | None = None, count: int | None = None, value: bytes | None = None,
              n: int | None = None) -> bytes:
    """A little-endian TIFF with one entry of its first IFD changed (its
    type, count or value bytes), or the IFD's entry count set to `n`."""
    out = bytearray(data)
    (ifd,) = struct.unpack("<I", data[4:8])
    if n is not None:
        out[ifd: ifd + 2] = struct.pack("<H", n)
        return bytes(out)
    for k in range(struct.unpack("<H", data[ifd: ifd + 2])[0]):
        at = ifd + 2 + 12 * k
        if struct.unpack("<H", data[at: at + 2])[0] == tag:
            if typ is not None:
                out[at + 2: at + 4] = struct.pack("<H", typ)
            if count is not None:
                out[at + 4: at + 8] = struct.pack("<I", count)
            if value is not None:
                out[at + 8: at + 12] = value
            return bytes(out)
    raise KeyError(tag)


def _ifd_cases() -> dict:
    gray = np.random.default_rng(4).integers(0, 256, (9, 12), np.uint8)
    flt = np.random.default_rng(5).normal(0, 50, (9, 12)).astype(np.float32)
    raw_f = fx.tiff_bytes(flt, bits=(32,), photometric=1, sample_format=(3,))
    lzw = fx.tiff_bytes(gray, bits=(8,), photometric=1, compression=5)
    raw = fx.tiff_bytes(gray, bits=(8,), photometric=1)
    return {
        # the planar field's data past the file's end: Pillow stops reading the
        # IFD there, so SampleFormat (after it) is lost and F opens as I
        "field_past_the_end_ends_the_ifd": _ifd_edit(raw_f, 284, count=10 ** 6),
        "width_as_ascii": _ifd_edit(raw, 256, typ=2),
        "width_of_no_values": _ifd_edit(raw, 256, count=0),
        "rows_per_strip_0": _ifd_edit(raw, 278, value=struct.pack("<I", 0)),
        "unknown_field_type": _ifd_edit(raw, 262, typ=99),
        "uncompressed_ifd_count_past_the_end": _ifd_edit(raw, 0, n=900),
        "compressed_ifd_count_past_the_end": _ifd_edit(lzw, 0, n=900),
        "compressed_ifd_of_5000_entries": _ifd_edit(lzw, 0, n=5000),
    }


@pytest.mark.parametrize("case", sorted(_ifd_cases()))
def test_ifd_edge_cases_as_pil(case, tmp_path):
    """Pillow's reading of the IFD, field by field: a field cut short by the
    file's end ends the IFD, a field of an unknown type or of no values is
    skipped, a width that is not a number refuses the file; libtiff, which
    decodes compressed files for PIL, refuses an IFD it cannot read whole."""
    path = tmp_path / f"{case}.tif"
    path.write_bytes(_ifd_cases()[case])
    try:
        with Image.open(path) as im:
            im.load()
    except Exception:
        with pytest.raises(ValueError) as exc:
            timg.read_image(path)
        assert str(path) in str(exc.value)
        return
    _assert_decodes_as_pil(path)


# ------------------------------------------------------------- refusals


def _patched_tag(data: bytes, tag: int, value: int) -> bytes:
    """A little-endian TIFF with one SHORT or LONG field of its first IFD
    replaced."""
    (ifd,) = struct.unpack("<I", data[4:8])
    (n,) = struct.unpack("<H", data[ifd: ifd + 2])
    for k in range(n):
        at = ifd + 2 + 12 * k
        t, typ = struct.unpack("<HH", data[at: at + 4])
        if t == tag:
            packed = struct.pack("<H", value).ljust(4, b"\x00") if typ == 3 else struct.pack("<I", value)
            return data[: at + 8] + packed + data[at + 12:]
    raise KeyError(tag)


def _queued_files(tmp_path) -> dict:
    """Files PIL opens that the port does not read yet: name -> path."""
    rgb = np.random.default_rng(1).integers(0, 256, (9, 12, 3), np.uint8)
    gray = rgb[..., 0]
    out = {}

    def put(name, data):
        out[name] = tmp_path / name
        out[name].write_bytes(data)

    buf = io.BytesIO()
    Image.fromarray(gray > 128).save(buf, format="TIFF", compression="group4")
    put("ccitt_g4.tif", buf.getvalue())
    put("old_jpeg.tif", _patched_tag(fx.pil_tiff(rgb, compression="jpeg"), 259, 6))
    put("ycbcr_raw.tif", fx.tiff_bytes(rgb, bits=(8,) * 3, photometric=6))
    put("lab.tif", fx.pil_tiff(rgb, "LAB"))
    buf = io.BytesIO()
    pa = Image.fromarray(gray).convert("P").convert("PA")
    pa.save(buf, format="TIFF")
    put("pa.tif", buf.getvalue())
    put("gray12.tif", _patched_tag(fx.tiff_bytes(gray.astype(np.uint16), bits=(16,), photometric=1), 258, 12))
    put("float_mm_deflate.tif", fx.tiff_bytes(gray.astype(np.float32), bits=(32,), photometric=1, big=True,
                                              sample_format=(3,), compression=8))
    buf = io.BytesIO()
    Image.fromarray(rgb).save(buf, format="TIFF", big_tiff=True)
    put("bigtiff.tif", buf.getvalue())
    put("rgba16_assoc.tif", fx.tiff_bytes(np.concatenate([rgb, rgb[..., :1]], -1).astype(np.uint16) * 257,
                                          bits=(16,) * 4, photometric=2, extra=(1,)))
    # an RLE8 bitmap of 4 x 2 with a delta escape, which Pillow reads the wrong bytes for
    rle = b"\x04\x01\x00\x00" + b"\x00\x02\x01\x00" + b"\x03\x02\x00\x00\x00\x01"
    info = struct.pack("<IiiHHIIiiII", 40, 4, 2, 1, 8, 1, len(rle), 0, 0, 3, 0)
    pal = bytes([0, 0, 0, 0, 255, 0, 0, 0, 0, 255, 0, 0])
    put("rle_delta.bmp", b"BM" + struct.pack("<IHHI", 66 + len(rle), 0, 0, 66) + info + pal + rle)
    put("gray4_palette.bmp", fx.bmp_bytes(gray // 16, bits=4, palette=[(i, i, i) for i in range(16)]))
    put("pillow_only.ppm", b"PyP\n2 2\n255\n" + bytes(4))
    for fmt in ("GIF", "WEBP"):
        buf = io.BytesIO()
        Image.fromarray(rgb).save(buf, format=fmt)
        put(f"frame.{fmt.lower()}", buf.getvalue())
    for suffix in ("jp2", "j2k"):
        buf = io.BytesIO()
        Image.fromarray(rgb).save(buf, format="JPEG2000", no_jp2=suffix == "j2k")
        put(f"frame.{suffix}", buf.getvalue())
    for fmt in ("QOI", "TGA", "SGI", "PCX"):
        buf = io.BytesIO()
        Image.fromarray(rgb).save(buf, format=fmt)
        put(f"frame.{fmt.lower()}", buf.getvalue())
    buf = io.BytesIO()
    Image.fromarray(np.tile(rgb, (2, 2, 1))[:16, :16]).save(buf, format="ICO", sizes=[(16, 16)])
    put("frame.ico", buf.getvalue())
    # a Sun raster of the frame (PIL writes none): 24-bit BGR rows padded to 16 bits
    rows = np.pad(rgb[..., ::-1].reshape(9, 36), ((0, 0), (0, 0)))
    put("frame.ras", struct.pack(">8I", 0x59A66A95, 12, 9, 24, rows.size, 1, 0, 0) + rows.tobytes())
    # a cursor (PIL writes none): one entry whose image is a 24-bit BMP
    # bitmap of twice the height (the image, then its AND mask)
    dib = struct.pack("<IiiHHIIiiII", 40, 12, 18, 1, 24, 0, 0, 0, 0, 0, 0)
    dib += rgb[::-1, :, ::-1].tobytes() + bytes(9 * 4)
    put("frame.cur", b"\x00\x00\x02\x00\x01\x00" + struct.pack("<BBBBHHII", 12, 9, 0, 0, 1, 1, len(dib), 22) + dib)
    return out


QUEUED = ("ccitt_g4.tif", "old_jpeg.tif", "ycbcr_raw.tif", "lab.tif", "pa.tif", "gray12.tif", "float_mm_deflate.tif",
          "bigtiff.tif", "rgba16_assoc.tif", "rle_delta.bmp", "gray4_palette.bmp", "pillow_only.ppm", "frame.gif",
          "frame.jp2", "frame.j2k", "frame.qoi", "frame.tga", "frame.sgi", "frame.pcx", "frame.ras", "frame.ico",
          "frame.cur")
# queued once, read since: a GIF frame (tests/test_torch_gif.py holds every
# kind), an RLE delta escape, a 4-bit gray palette, Pillow's own PyP, a
# JPEG 2000 frame in JP2 boxes and as a bare codestream
# (tests/test_torch_jpeg2000.py holds every kind), QOI, TGA, SGI, PCX and
# Sun raster frames (tests/test_torch_raster.py holds every kind)
READ_SINCE = ("rle_delta.bmp", "gray4_palette.bmp", "pillow_only.ppm", "frame.gif", "frame.jp2", "frame.j2k",
              "frame.qoi", "frame.tga", "frame.sgi", "frame.pcx", "frame.ras")


@pytest.mark.parametrize("name", QUEUED)
def test_queued_kinds_raise_naming_the_file(name, tmp_path):
    """PIL opens these; the port raises ValueError naming the file and the
    kind (ROADMAP.md queues each), or, for the kinds it reads since
    (READ_SINCE), gives PIL's pixels, mode and size."""
    path = _queued_files(tmp_path)[name]
    Image.open(path).close()  # PIL identifies it
    if name in READ_SINCE:
        _assert_decodes_as_pil(path)
        return
    with pytest.raises(ValueError, match="not read yet") as exc:
        timg.read_image(path)
    assert str(path) in str(exc.value)
    with pytest.raises(ValueError, match="not read yet"):
        formats.pil_mode(path)
    with Image.open(path) as im:
        kind = im.format
    if kind in ("ICO", "CUR"):  # their signatures also begin a TGA header: never read as one
        assert f"{kind}, not read yet" in str(exc.value) and formats.file_kind(path) is None


def test_webp_frame_decodes_as_pil(tmp_path):
    """A WebP was queued; the port now reads it (tests/test_torch_webp.py
    holds every kind): PIL's pixels, mode and size."""
    path = _queued_files(tmp_path)["frame.webp"]
    with Image.open(path) as im:
        want, mode, size = np.asarray(im), im.mode, im.size
    assert (formats.pil_mode(path), formats.image_size(path)) == (mode, size)
    assert np.array_equal(timg.read_image(path), want)


def _refused_files(tmp_path) -> dict:
    rgb = np.random.default_rng(2).integers(0, 256, (9, 12, 3), np.uint8)
    raw = fx.pil_tiff(rgb)
    bmp = fx._pil_save(rgb, "BMP")
    files = {
        "colour.pfm": b"PF\n2 2\n-1.0\n" + bytes(48),
        "maxval0.pgm": b"P5\n2 2\n0\n" + bytes(4),
        "too_large.pgm": b"P2\n2 1\n10\n3 11\n",
        "bad_token.pbm": b"P1\n2 1\n0 2\n",
        "truncated.ppm": b"P6\n4 4\n255\n" + bytes(10),
        "truncated.tif": raw[: len(raw) - 40],
        "two_samples.tif": fx.tiff_bytes(rgb[..., :2], bits=(8, 8), photometric=2),
        "no_size.tif": raw[:8] + b"\x00\x00" + raw[10:],  # an IFD of no entries
        "header0.bmp": b"BM" + bytes(40),
        "bits7.bmp": bmp[:28] + struct.pack("<H", 7) + bmp[30:],
        "truncated.bmp": bmp[: len(bmp) - 50],
        "bitfields.bmp": fx.bmp_bytes(rgb[..., ::-1], bits=24, compression=3, masks=(0xFF, 0xFF00, 0xFF0000)),
        "not_an_image.gif": b"GIF89a" + bytes(30),
        "bomb.pgm": b"P5\n20000 20000\n255\n" + bytes(10),  # PIL's decompression-bomb limit
        "bomb.tif": _patched_tag(_patched_tag(raw, 256, 20000), 257, 20000),
        "bomb.bmp": bmp[:18] + struct.pack("<ii", 20000, 20000) + bmp[26:],
    }
    out = {}
    for name, data in files.items():
        out[name] = tmp_path / name
        out[name].write_bytes(data)
    return out


@pytest.mark.parametrize("name", ["colour.pfm", "maxval0.pgm", "too_large.pgm", "bad_token.pbm", "truncated.ppm",
                                  "truncated.tif", "two_samples.tif", "no_size.tif", "header0.bmp", "bits7.bmp",
                                  "truncated.bmp", "bitfields.bmp", "not_an_image.gif", "bomb.pgm", "bomb.tif",
                                  "bomb.bmp"])
def test_files_pil_refuses_raise(name, tmp_path):
    path = _refused_files(tmp_path)[name]
    with pytest.raises(Exception):
        with Image.open(path) as im:
            im.load()
    with pytest.raises(ValueError) as exc:
        timg.read_image(path)
    assert str(path) in str(exc.value)


# ------------------------------------------------------------- the slice


def test_train_cli_takes_png_tiff_and_pgm_depth(tmp_path):
    """The train CLI with --depth_files of 16-bit PNGs, TIFFs (II and MM)
    and PGMs of the same millimetres: the same map bits."""
    frames = sorted(SCENE.glob("frame_000[0-1].png"))
    for f in frames:
        mm = np.clip(np.round(np.load(str(f)[:-4] + "_depth.npy") * 1000), 0, 65535).astype(np.uint16)
        write_png(tmp_path / f"{f.stem}_depth.png", mm)
        ttiff.write_tiff(tmp_path / f"{f.stem}_depth.tif", mm, "I;16B" if f.stem.endswith("1") else "I;16")
        tpnm.write_pnm(tmp_path / f"{f.stem}_depth.pgm", mm, "I;16")
    heads = []
    for ext in ("png", "tif", "pgm"):
        out = tmp_path / f"map_{ext}.pt"
        result = train_ace_cli.main([
            f"{SCENE}/frame_000[0-1].png", str(out), "--pose_files", f"{SCENE}/frame_000[0-1]_pose.txt",
            "--depth_files", str(tmp_path / f"*_depth.{ext}"), "--use_external_focal_length", "520",
            "--encoder_path", str(ROOT / "weights" / "tpu_encoder_v6.pt"), "--image_resolution", "64",
            "--samples_per_image", "32", "--batch_size", "64", "--iterations", "6", "--num_head_blocks", "0",
            "--device", "cpu"])
        assert result["iterations"] == 6
        heads.append(tio.load_state_dict(out))
    assert all(h.keys() == heads[0].keys() and all(torch.equal(h[k], heads[0][k]) for k in h) for h in heads)


@pytest.fixture(scope="module")
def scene_pair(tmp_path_factory):
    """The mini loop's room scene twice: PNG frames with 16-bit PNG depth,
    and TIFF frames (chip_smoke.FORMAT_TIFF_KINDS in turn) with 16-bit TIFF
    depth (II and MM in turn), the same pixels and millimetres."""
    png, tif = tmp_path_factory.mktemp("png"), tmp_path_factory.mktemp("tif")
    data = render_room_scene(N, h=96, w=128)
    for i in range(N):
        img = data["images_u8"][i]
        mm = np.clip(np.round(data["depth"][i] * 1000), 0, 65535).astype(np.uint16)
        write_png(png / f"frame_{i:03d}.png", img)
        write_png(png / f"frame_{i:03d}_depth.png", mm)
        chip_smoke.write_format_frame(np, tif / f"frame_{i:03d}.tif", img,
                                      chip_smoke.FORMAT_TIFF_KINDS[i % len(chip_smoke.FORMAT_TIFF_KINDS)])
        ttiff.write_tiff(tif / f"frame_{i:03d}_depth.tif", mm, "I;16B" if i % 2 else "I;16")
    return png, tif, data["focal"]


def test_mini_reconstruction_on_tiff_gives_the_png_poses(scene_pair, tmp_path):
    """The reconstruction CLI on TIFF frames with TIFF depth (the mini loop,
    one round): the poses file of its run on the PNG copies, line for line
    (the names aside)."""
    png, tif, focal = scene_pair
    lines = {}
    for name, d, ext in (("png", png, "png"), ("tif", tif, "tif")):
        argv = [str(d / f"frame_???.{ext}"), str(tmp_path / name), "--depth_files", str(d / f"*_depth.{ext}"),
                "--use_external_focal_length", str(focal), *MINI_FLAGS, "--iterations_max", "1", "--device", "cpu"]
        ace_zero_cli.main(argv, **MINI_OVERRIDES, decode_cache_dir=None)
        lines[name] = [ln.split() for ln in (tmp_path / name / "poses_final.txt").read_text().splitlines()]
    assert len(lines["tif"]) == N
    assert [Path(ln[0]).stem for ln in lines["tif"]] == [Path(ln[0]).stem for ln in lines["png"]]
    assert [ln[1:] for ln in lines["tif"]] == [ln[1:] for ln in lines["png"]]
