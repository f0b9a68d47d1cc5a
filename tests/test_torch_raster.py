"""TGA, SGI, PCX, DCX, Sun raster and QOI files in the port (io/tga.py,
io/sgi.py, io/pcx.py, io/dcx.py, io/sun.py, io/qoi.py, io/csrc/raster.cpp)
against PIL, which opens them for the JAX package, and against the JAX
package:

- every fixture of tests/data/raster (scripts/make_raster_fixtures.py)
  decodes to PIL's pixels, mode and size exactly, with PIL's size and mode
  from the headers alone (those PIL opens and cannot load too), PIL's
  palette, `convert("RGB")` and `convert("L")`, live and as recorded in
  pil_digests.json (which the card checks); where PIL's open or load
  raises, the port raises ValueError naming the file;
- decode_to_canvas over the fixtures, and over a glob of each kind, gives
  the JAX package's canvases bit for bit; load_depth_file gives the JAX
  package's depth maps, a 16-bit SGI's as its high byte over 1,000;
- the Nerfstudio runner's downscale of each kind and mode is PIL's resize,
  and its TGA, SGI, PCX and QOI saves are PIL's bytes (a TGA source's
  run-length coding, row order and ID section kept); `.ras` and `.dcx`
  destinations raise OSError; write_tga, write_sgi, write_pcx and
  write_qoi give PIL's bytes;
- identification in Pillow's order: TGA only where no plugin before it
  takes the file, a PCX header Pillow gives up on read as TGA, the formats
  Pillow tries first and the port does not read refused by name;
- the faults a differential sweep of corrupt files found each have a case,
  and seeded corruptions decode as PIL or raise where PIL raises;
- the slice: the register CLI on TGA, SGI and PCX copies of the chesslike
  frames gives the poses of PNG copies of the same pixels.
"""

from __future__ import annotations

import io
import json
import shutil
import struct
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from acezero_tpu.data import images as jimg
from acezero_tpu.data.depth import load_depth_file as j_load_depth_file
from acezero_tpu_torch.cli import register_cli as tcli
from acezero_tpu_torch.data import images as timg
from acezero_tpu_torch.data.depth import load_depth_file
from acezero_tpu_torch.data.scene import load_scene as t_load_scene
from acezero_tpu_torch.export import nerfstudio_runner as runner
from acezero_tpu_torch.io import dcx, formats, pcx, qoi, sgi, sun, tga
from acezero_tpu_torch.io.png import write_png

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402
import make_raster_fixtures as fx  # noqa: E402

FIXTURES = sorted(fx.FIXTURES)
DIGESTS = json.loads((fx.OUT / "pil_digests.json").read_text())
DECODED = [n for n in FIXTURES if not DIGESTS["files"][n].get("raises")]
KINDS = {"TGA": "tga", "SGI": "sgi", "PCX": "pcx", "DCX": "dcx", "SUN": "sun", "QOI": "qoi"}
READERS = {"tga": tga.read_tga, "sgi": sgi.read_sgi, "pcx": pcx.read_pcx, "dcx": dcx.read_dcx, "sun": sun.read_sun,
           "qoi": qoi.read_qoi}
SCENE = ROOT / "results" / "heldout" / "scenes" / "chesslike_a"


def _pil(path):
    """PIL's image of a file: (array, mode, size, palette digest,
    convert("RGB"), convert("L"), format), or None where its open or load
    raises."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        try:
            with Image.open(path) as im:
                arr = np.asarray(im)
                return (arr, im.mode, im.size, fx.palette_digest(im.getpalette()), np.asarray(im.convert("RGB")),
                        np.asarray(im.convert("L")), im.format)
        except Exception:
            return None


def _pil_opens(path):
    """(mode, size) of PIL's open, or None where it raises."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        try:
            with Image.open(path) as im:
                return im.mode, im.size
        except Exception:
            return None


def _assert_as_pil(path) -> str:
    """The port gives PIL's image of `path`, or raises ValueError naming it
    where PIL raises (its header too where PIL's open raises)."""
    want = _pil(path)
    if want is None:
        with pytest.raises(ValueError) as exc:
            timg.read_image(path)
        assert str(path) in str(exc.value)
        opened = _pil_opens(path)
        if opened is None:
            with pytest.raises(ValueError):
                formats.header(path)
        else:
            assert (formats.pil_mode(path), formats.image_size(path)) == opened
        return "raise"
    arr, mode, size, palette, rgb, luma, fmt = want
    assert formats.file_kind(path) == KINDS[fmt]
    r = READERS[KINDS[fmt]](path)
    assert (r.mode, r.pixels.shape[1::-1], r.pixels.dtype) == (mode, size, arr.dtype)
    assert np.array_equal(r.pixels, arr) and fx.palette_digest(r.palette) == palette
    assert (formats.pil_mode(path), formats.image_size(path)) == (mode, size)
    img = timg.read_image(path)
    assert np.array_equal(timg.pil_array(img), arr)
    assert np.array_equal(timg.read_rgb(path), rgb) and np.array_equal(timg.pil_luma_u8(img), luma)
    return "decode"


# ------------------------------------------------------------- the fixtures


@pytest.mark.parametrize("name", FIXTURES)
def test_fixture_decodes_as_pil(name):
    outcome = _assert_as_pil(fx.OUT / name)
    assert outcome == ("raise" if DIGESTS["files"][name].get("raises") else "decode")


@pytest.mark.parametrize("name", FIXTURES)
def test_fixture_digests_are_pils(name):
    """pil_digests.json holds PIL's decode of each fixture (the card checks
    the port against it), the port's decode gives it, and the script
    writes these bytes."""
    path = fx.OUT / name
    want = DIGESTS["files"][name]
    assert want == fx.digest(path)
    assert path.read_bytes() == fx.FIXTURES[name]()
    assert (formats.pil_mode(path), list(formats.image_size(path))) == (want["mode"], want["size"])
    if not want.get("raises"):
        img = timg.read_image(path)
        arr = timg.pil_array(img)
        assert chip_smoke.array_digest(arr) == want["sha256"] and list(arr.shape) == want["shape"]
        assert chip_smoke.array_digest(timg.read_rgb(path)) == want["rgb_sha256"]
        assert fx.palette_digest(getattr(img, "palette", None)) == want["palette"]


def test_fixtures_stay_small_and_cover_every_kind():
    files = list(fx.OUT.iterdir())
    assert sum(p.stat().st_size for p in files) < 1_000_000
    assert sorted(DIGESTS["files"]) == FIXTURES and set(fx.DEPTH) <= set(DECODED)
    got = [DIGESTS["files"][n] for n in FIXTURES]
    assert all(d["size"][0] <= 64 and d["size"][1] <= 48 for d in got)
    assert {d["format"] for d in got} == set(KINDS)
    modes = {(d["format"], d["mode"]) for d in got if not d.get("raises")}
    assert modes >= {("TGA", m) for m in ("1", "L", "LA", "P", "RGB", "RGBA")}
    assert modes >= {("SGI", m) for m in ("L", "RGB", "RGBA")} | {("QOI", "RGB"), ("QOI", "RGBA")}
    assert modes >= {("PCX", m) for m in ("1", "L", "P", "RGB")} | {("SUN", m) for m in ("1", "L", "P", "RGB")}
    raising = {n for n in FIXTURES if DIGESTS["files"][n].get("raises")}
    assert "tga_cannot_load_gray32.tga" in raising and len(raising) == 7
    assert DIGESTS["files"]["pcx_falls_through_to_tga.pcx"]["format"] == "TGA"


@pytest.mark.parametrize("short_size,canvas_hw", fx.CANVAS_CHECKS)
def test_canvases_of_every_fixture_match_jax(short_size, canvas_hw):
    """decode_to_canvas over every fixture PIL decodes, in one glob: the
    JAX package's canvases, sizes and scales, and the digest the card
    checks."""
    paths = [str(fx.OUT / n) for n in DECODED]
    got = timg.decode_to_canvas(paths, short_size=short_size, canvas_hw=canvas_hw, num_workers=4)
    want = jimg.decode_to_canvas(paths, short_size=short_size, canvas_hw=canvas_hw, num_workers=2)
    assert np.array_equal(got.canvases, want.canvases)
    for k in ("sizes", "orig_sizes", "scale_factors"):
        assert np.array_equal(getattr(got, k), getattr(want, k)), k
    entry = [c for c in DIGESTS["canvas"] if c["short_size"] == short_size][0]
    assert chip_smoke.canvas_digest(got) == entry["sha256"]


@pytest.mark.parametrize("fmt", sorted(KINDS))
@pytest.mark.parametrize("short,canvas_hw", [(20, None), (40, None), (16, (12, 16))],
                         ids=["shrunk", "enlarged", "oversize_crop"])
def test_glob_of_each_kind_matches_jax(fmt, short, canvas_hw):
    paths = [str(fx.OUT / n) for n in DECODED if DIGESTS["files"][n]["format"] == fmt]
    got = timg.decode_to_canvas(paths, short_size=short, canvas_hw=canvas_hw, num_workers=3)
    want = jimg.decode_to_canvas(paths, short_size=short, canvas_hw=canvas_hw, num_workers=2)
    for k in ("sizes", "orig_sizes", "scale_factors"):
        assert np.array_equal(getattr(got, k), getattr(want, k)), k
    assert got.canvases.shape == want.canvases.shape and np.array_equal(got.canvases, want.canvases)


@pytest.mark.parametrize("name", DECODED)
def test_load_depth_file_matches_jax(name):
    """A depth file of each kind: np.asarray(Image.open(p)) / 1000, as the
    JAX package reads it; the recorded digests for the card."""
    got, want = load_depth_file(fx.OUT / name), j_load_depth_file(str(fx.OUT / name))
    assert got.dtype == want.dtype == np.float64 and got.shape == want.shape and np.array_equal(got, want)
    if name in fx.DEPTH:
        assert chip_smoke.array_digest(got) == DIGESTS["depth"][name]


def test_sgi16_depth_reaches_both_packages_as_its_high_byte(tmp_path):
    """A 16-bit SGI depth map in millimetres opens in PIL as 8-bit L, its
    samples' high bytes: both packages read it as that byte over 1,000 (a
    reference behaviour the port keeps)."""
    mm = fx.depth_mm(9, 14, 5)
    (tmp_path / "d.sgi").write_bytes(fx.sgi_raw_bytes(mm, 2))
    (tmp_path / "r.sgi").write_bytes(fx.sgi_rle_bytes(mm, 2, 6))
    for p in (tmp_path / "d.sgi", tmp_path / "r.sgi"):
        got = load_depth_file(p)
        assert np.array_equal(got, j_load_depth_file(str(p)))
        assert np.array_equal(got, (mm >> 8).astype(np.float64) / 1000.0)


# ------------------------------------------------------------- the runner and the writers


def _runner_sources() -> list[str]:
    return [n for n in FIXTURES if DIGESTS["files"][n]["format"] in ("TGA", "SGI", "PCX", "QOI", "SUN", "DCX")
            and not DIGESTS["files"][n].get("raises")]


@pytest.mark.parametrize("name", _runner_sources())
def test_runner_downscale_is_pils_resize_and_save(name, tmp_path):
    """The runner's downscale of a source of each kind and mode equals PIL's
    BILINEAR resize; saved under the source's name it gives PIL's bytes
    (TGA, SGI, PCX, QOI), or raises where PIL's save or resize does (Sun
    raster and DCX: no writer; a colour map under L or LA: no resize)."""
    src = fx.OUT / name
    (tmp_path / "pil").mkdir()
    (tmp_path / "port").mkdir()
    with Image.open(src) as im:
        size = (max(1, im.width * 2 // 3), max(1, im.height * 3 // 5))
        try:
            small = im.resize(size, Image.BILINEAR)
        except ValueError:
            with pytest.raises(ValueError, match="wrong mode"):
                runner._resized(src, *size)
            return
        want = np.asarray(small)
    got, mode, palette, transparency = runner._resized(src, *size)
    assert mode == small.mode and np.array_equal(got, want)
    info = tga.tga_header(src).info if formats.file_kind(src) == "tga" else None
    if src.suffix in (".ras", ".dcx"):
        with pytest.raises((KeyError, OSError)):
            small.save(tmp_path / "pil" / src.name)
        with pytest.raises(OSError):
            runner._save(tmp_path / "port" / src.name, got, mode, palette, transparency, info)
        return
    small.save(tmp_path / "pil" / src.name)
    runner._save(tmp_path / "port" / src.name, got, mode, palette, transparency, info)
    assert (tmp_path / "port" / src.name).read_bytes() == (tmp_path / "pil" / src.name).read_bytes()


def test_runner_downscale_images_keeps_a_tga_sources_info(tmp_path):
    """_downscale_images over a transforms.json of a top-down run-length
    TGA with an ID section wider than 640 pixels: PIL's bytes."""
    rgb = fx.photo(20, 700, 3)
    src = tmp_path / "wide.tga"
    Image.fromarray(rgb).save(src, rle=True, orientation=1, id_section=b"kept")
    frames = [{"file_path": str(src), "fl_x": 500.0, "fl_y": 500.0, "cx": 350.0, "cy": 10.0, "w": 700, "h": 20}]
    transforms = tmp_path / "transforms.json"
    transforms.write_text(json.dumps({"frames": frames, "train_filenames": [str(src)], "test_filenames": []}))
    runner._downscale_images(transforms, tmp_path)
    out = Path(json.loads(transforms.read_text())["frames"][0]["file_path"])
    with Image.open(src) as im:
        im.resize((640, 18), Image.BILINEAR).save(tmp_path / "pil.tga")
    assert out.read_bytes() == (tmp_path / "pil.tga").read_bytes()
    assert out.read_bytes()[2] == 10 and out.read_bytes()[17] & 0x20


def _writer_image(mode: str, h: int, w: int, seed: int):
    rng = np.random.default_rng(seed)
    img = (rng.integers(0, 4, (h, w, 4)) * 70).astype(np.uint8)
    img[:, : w // 3] = 9
    if mode == "P":
        pal = rng.integers(0, 256, (int(rng.integers(1, 257)), 3)).astype(np.uint8)
        idx = rng.integers(0, len(pal), (h, w)).astype(np.uint8)
        pil = Image.frombytes("P", (w, h), idx.tobytes())
        pil.putpalette(pal.tobytes())
        return idx, pal, pil
    arr = {"1": img[..., 0] > 100, "L": img[..., 0], "LA": img[..., :2], "RGB": img[..., :3], "RGBA": img}[mode]
    return arr, None, Image.fromarray(arr) if mode in ("1", "L") else Image.fromarray(arr, mode)


WRITER_SHAPES = [(1, 1), (3, 129), (7, 130), (24, 300)]


@pytest.mark.parametrize("shape", WRITER_SHAPES, ids=[f"{h}x{w}" for h, w in WRITER_SHAPES])
@pytest.mark.parametrize("orientation", [1, -1])
@pytest.mark.parametrize("rle", [False, True], ids=["raw", "rle"])
@pytest.mark.parametrize("mode", ["1", "L", "LA", "P", "RGB", "RGBA"])
def test_write_tga_is_pils_bytes(mode, rle, orientation, shape, tmp_path):
    img, pal, pil = _writer_image(mode, *shape, seed=sum(shape) + len(mode))
    if rle and mode == "1":
        with pytest.raises(OSError):
            tga.write_tga(tmp_path / "port.tga", img, mode, pal, "tga_rle", orientation)
        return
    pil.save(tmp_path / "pil.tga", rle=rle, orientation=orientation, id_section=b"id" * shape[0])
    tga.write_tga(tmp_path / "port.tga", img, mode, pal, "tga_rle" if rle else None, orientation, b"id" * shape[0])
    assert (tmp_path / "port.tga").read_bytes() == (tmp_path / "pil.tga").read_bytes()


@pytest.mark.parametrize("shape", WRITER_SHAPES, ids=[f"{h}x{w}" for h, w in WRITER_SHAPES])
@pytest.mark.parametrize("mode", ["1", "L", "P", "RGB"])
def test_write_pcx_is_pils_bytes(mode, shape, tmp_path):
    img, pal, pil = _writer_image(mode, *shape, seed=sum(shape) * 3 + len(mode))
    pil.save(tmp_path / "pil.pcx")
    pcx.write_pcx(tmp_path / "port.pcx", img, mode, pal)
    assert (tmp_path / "port.pcx").read_bytes() == (tmp_path / "pil.pcx").read_bytes()


@pytest.mark.parametrize("shape", WRITER_SHAPES, ids=[f"{h}x{w}" for h, w in WRITER_SHAPES])
@pytest.mark.parametrize("mode", ["L", "RGB", "RGBA"])
def test_write_sgi_is_pils_bytes(mode, shape, tmp_path):
    img, _, pil = _writer_image(mode, *shape, seed=sum(shape) * 5 + len(mode))
    for d in ("pil", "port"):
        (tmp_path / d).mkdir()
    name = "a rather long frame name that PIL cuts at seventy-nine bytes, as the header holds no more.rgb"
    pil.save(tmp_path / "pil" / name)
    sgi.write_sgi(tmp_path / "port" / name, img, mode)
    assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "pil" / name).read_bytes()


@pytest.mark.parametrize("shape", WRITER_SHAPES + [(100, 90)], ids=[f"{h}x{w}" for h, w in WRITER_SHAPES + [(100, 90)]])
@pytest.mark.parametrize("mode", ["RGB", "RGBA"])
def test_write_qoi_is_pils_bytes(mode, shape, tmp_path):
    img, _, pil = _writer_image(mode, *shape, seed=sum(shape) * 7 + len(mode))
    if shape == (100, 90):  # every op: runs past 62, diffs, lumas, the index
        img = np.concatenate([fx.photo(100, 90, 9), fx.alpha(100, 90)[..., None]], -1)[..., : len(mode)]
        img[:10] = 40
        pil = Image.fromarray(np.ascontiguousarray(img))
    pil.save(tmp_path / "pil.qoi")
    qoi.write_qoi(tmp_path / "port.qoi", img, mode)
    assert (tmp_path / "port.qoi").read_bytes() == (tmp_path / "pil.qoi").read_bytes()


@pytest.mark.parametrize("suffix,mode,error", [(".tga", "CMYK", OSError), (".sgi", "P", ValueError),
                                               (".pcx", "LA", ValueError), (".qoi", "L", ValueError),
                                               (".ras", "L", OSError), (".dcx", "L", OSError)])
def test_writers_refuse_what_pil_refuses(suffix, mode, error, tmp_path):
    img = np.zeros((4, 5, 4) if mode == "CMYK" else (4, 5, 2) if mode == "LA" else (4, 5), np.uint8)
    with pytest.raises(error):
        runner._save(tmp_path / f"x{suffix}", img, mode)


# ------------------------------------------------------------- identification


def _tga_head(**kw) -> bytes:
    return fx.tga_bytes(4, 3, bytes(12), imagetype=3, depth=8, **kw)


def test_a_file_only_pils_tga_plugin_opens_is_read_as_tga(tmp_path):
    """A PCX header Pillow gives up on (version 0, no pixels in its window)
    reads as the TGA it also is, in PIL and in the port."""
    path = fx.OUT / "pcx_falls_through_to_tga.pcx"
    assert formats.file_kind(path) == "tga" and _assert_as_pil(path) == "decode"
    (tmp_path / "short.pcx").write_bytes(path.read_bytes()[:60])  # a PCX header cut short: a truncated TGA
    assert formats.file_kind(tmp_path / "short.pcx") == "tga" and _assert_as_pil(tmp_path / "short.pcx") == "raise"
    assert formats.pil_mode(tmp_path / "short.pcx") == "L"


@pytest.mark.parametrize("case", ["mpeg", "fli", "iptc", "im", "pcd", "ico", "cur"])
def test_headers_pil_tries_first_are_never_read_as_tga(case, tmp_path):
    """Headers that pass TGA's checks but that a plugin Pillow tries before
    TGA takes (or may take): the port refuses them by that format's name."""
    body = bytes(12)
    heads = {
        "mpeg": b"\x00\x00\x01\xb3\x01\x01\x01" + bytes(5) + struct.pack("<HH", 4, 3) + bytes([8, 0]),
        "fli": bytes([0, 0, 3, 0]) + struct.pack("<HHHHHH", 0xAF11, 1, 1, 1, 4, 3) + bytes([8, 0]) + bytes(110),
        "iptc": bytes([0x1C, 1, 3]) + struct.pack("<HHB", 0, 1, 24) + bytes(4) + struct.pack("<HH", 4, 3)
        + bytes([8, 0]) + bytes(28) + bytes(3),
        "im": bytes([ord("A"), 0, 3]) + bytes(9) + struct.pack("<HH", 4, 3) + bytes([8, 0]) + b"bc: d\n" + bytes(59),
        "pcd": _tga_head().ljust(2048, b"\0") + b"PCD_" + bytes(8),
        "ico": bytes([0, 0, 1, 0, 1, 0]) + bytes(6) + struct.pack("<HH", 4, 3) + bytes([8, 0]),
        "cur": bytes([0, 0, 2, 0, 1, 0]) + bytes(6) + struct.pack("<HH", 4, 3) + bytes([8, 0]),
    }
    data = heads[case] + body if case != "pcd" else heads[case]
    assert tga.is_tga(data[:18])
    path = tmp_path / f"x.{case}"
    path.write_bytes(data)
    assert formats.file_kind(path) is None
    with pytest.raises(ValueError, match="not read yet") as exc:
        timg.read_image(path)
    assert str(path) in str(exc.value) and {"ico": "ICO", "cur": "CUR"}.get(case, case.upper()) in str(exc.value)


def test_tga_without_other_signatures_is_read(tmp_path):
    path = tmp_path / "plain.tga"
    path.write_bytes(_tga_head(id_section=b"x"))
    assert formats.file_kind(path) == "tga" and _assert_as_pil(path) == "decode"


# ------------------------------------------------------------- sweep faults and corruption


# faults a differential sweep found, each a fixture and its edits (offset,
# value): headers that GBR's and MPEG's signature tests accept but whose
# `_open` gives up on, so that PIL reads them as TGA (the port refused
# them by those formats' names)
SWEEP_FAULTS = [
    ("pil_1_raw_bottom.tga", [(7, 1)]),
    ("pil_rgb_rle_top.tga", [(0, 2), (7, 2)]),
    ("pil_l_raw_top.tga", [(0, 0), (1, 0), (2, 1), (3, 0xB3)]),
]


@pytest.mark.parametrize("name,edits", SWEEP_FAULTS, ids=[f"{n}@{e[-1][0]}" for n, e in SWEEP_FAULTS])
def test_sweep_faults_decode_as_pil(name, edits, tmp_path):
    data = bytearray((fx.OUT / name).read_bytes())
    for at, value in edits:
        data[at] = value
    (tmp_path / name).write_bytes(bytes(data))
    assert _assert_as_pil(tmp_path / name) in ("decode", "raise")
    want = _pil(tmp_path / name)
    assert want is None or formats.file_kind(tmp_path / name) == "tga"


def test_a_tga_that_starts_as_a_cursor_is_refused_by_name(tmp_path):
    """A true-colour TGA without an ID section starts with CUR's signature;
    where its colour-map fields make a cursor directory of entries, PIL's
    CUR plugin may take it, and the port refuses it as CUR (PIL, whose
    plugin gives up on this one, reads a TGA: a recorded difference)."""
    data = bytearray((fx.OUT / "pil_rgb_raw_bottom.tga").read_bytes())
    data[4] = 1
    (tmp_path / "x.tga").write_bytes(bytes(data))
    assert _pil(tmp_path / "x.tga")[6] == "TGA"
    with pytest.raises(ValueError, match="CUR, not read yet"):
        timg.read_image(tmp_path / "x.tga")


def _corrupt(rng, data: bytes) -> bytes:
    b = bytearray(data)
    kind = rng.integers(0, 4)
    if kind == 0:
        return bytes(b[: rng.integers(0, len(b))])
    for _ in range(rng.integers(1, 4)):
        at = rng.integers(0, min(len(b), 40)) if kind == 1 else rng.integers(0, len(b))
        b[at] = rng.integers(0, 256) if kind != 3 else b[at] ^ (1 << rng.integers(0, 8))
    return bytes(b)


SWEEP_CHUNKS = 6


@pytest.mark.parametrize("chunk", range(SWEEP_CHUNKS))
def test_corrupt_files_decode_as_pil_or_raise(chunk, tmp_path):
    """Seeded truncations, header bytes and byte flips of the fixtures: the
    port raises ValueError naming the file wherever PIL's open or load
    raises, and where PIL decodes it gives PIL's pixels or raises
    ValueError naming the file."""
    rng = np.random.default_rng(2300 + chunk)
    for i in range(80):
        name = FIXTURES[rng.integers(0, len(FIXTURES))]
        path = tmp_path / f"{i}_{name}"
        path.write_bytes(_corrupt(rng, (fx.OUT / name).read_bytes()))
        want = _pil(path)
        try:
            img = timg.read_image(path)
        except ValueError as e:
            assert str(path) in str(e)
            continue
        assert want is not None, f"{path}: PIL raises, the port decodes"
        assert np.array_equal(timg.pil_array(img), want[0]) and formats.pil_mode(path) == want[1], path


# ------------------------------------------------------------- the slice


def test_register_cli_on_raster_frames_gives_the_png_poses(tmp_path):
    """The register CLI (the slice's entry point) on 4 chesslike_a frames as
    run-length and raw TGA, SGI and PCX files of their gray pixels
    (the port's writers): the scene loads to the canvases of PNG copies,
    and the poses equal the PNG glob's."""
    frames = sorted(SCENE.glob("frame_00[0-3]0.png"))
    for sub in ("png", "raster"):
        (tmp_path / sub).mkdir()
    for i, f in enumerate(frames):
        img = timg.read_png(f)
        write_png(tmp_path / "png" / f.name, img)
        dst = tmp_path / "raster" / f.stem
        [lambda: tga.write_tga(dst.with_suffix(".tga"), img, "L", compression="tga_rle"),
         lambda: tga.write_tga(dst.with_suffix(".tga"), img, "L"),
         lambda: sgi.write_sgi(dst.with_suffix(".sgi"), img, "L"),
         lambda: pcx.write_pcx(dst.with_suffix(".pcx"), img, "L")][i % 4]()
    kw = dict(image_short_size=120, external_focal_length=520.0, num_workers=2)
    t_png = t_load_scene(str(tmp_path / "png" / "*.png"), **kw)
    t_raster = t_load_scene(str(tmp_path / "raster" / "frame_*"), **kw)
    assert np.array_equal(t_raster.images.canvases, t_png.images.canvases)
    poses = {}
    for sub, pattern in (("png", "*.png"), ("raster", "frame_*")):
        net = tmp_path / f"head_{sub}.pt"
        shutil.copy(ROOT / "results" / "heldout" / "sweep_a_warmstart" / "iteration2.pt", net)
        argv = [str(tmp_path / sub / pattern), str(net), "--encoder_path", str(ROOT / "weights" / "tpu_encoder_v6.pt"),
                "--use_external_focal_length", "520", "--image_resolution", "120", "--session", sub,
                "--num_data_workers", "2", "--device", "cpu"]
        assert tcli.main(argv) == 0
        poses[sub] = [ln.split()[1:] for ln in (tmp_path / f"poses_{sub}.txt").read_text().splitlines()]
    assert len(poses["raster"]) == 4 and poses["raster"] == poses["png"]


def test_pil_saves_of_raster_kinds_read_back(tmp_path):
    """PIL's own saves of each kind it writes, read back by the port."""
    rgb = fx.photo(11, 13, 4)
    for suffix, img in ((".tga", Image.fromarray(rgb)), (".sgi", Image.fromarray(rgb)),
                        (".pcx", Image.fromarray(rgb).quantize(9)), (".qoi", Image.fromarray(rgb))):
        buf = io.BytesIO()
        img.save(buf, format={".tga": "TGA", ".sgi": "SGI", ".pcx": "PCX", ".qoi": "QOI"}[suffix])
        (tmp_path / f"x{suffix}").write_bytes(buf.getvalue())
        assert _assert_as_pil(tmp_path / f"x{suffix}") == "decode"
