"""JPEG 2000 files in the port (io/jpeg2000.py, io/csrc/jpeg2000.cpp)
against PIL, which opens them for the JAX package through openjpeg, and
against the JAX package:

- every fixture of tests/data/jpeg2000 (scripts/make_jpeg2000_fixtures.py),
  reversible and irreversible alike, decodes to PIL's pixels, mode and
  size exactly, with PIL's size and mode from the headers alone, PIL's
  palette, `convert("RGB")` and `convert("L")`, live and as recorded in
  pil_digests.json (which the card checks); where PIL's open or load
  raises, the port raises ValueError naming the file; the photo-size file
  too;
- decode_to_canvas over the fixtures and over a mixed JPEG 2000 + PNG +
  JPEG glob gives the JAX package's canvases bit for bit, on the canvas
  pass and on the oversize crop; load_depth_file gives the JAX package's
  depth maps (I;16 millimetres and 8-bit ones);
- the Nerfstudio runner's downscale of each JPEG 2000 mode is PIL's resize
  and reads back as PIL's save does (P and PA raise as PIL's save does);
  write_jpeg2000 reads back in PIL as PIL's read-back of its own save, for
  `.jp2` and `.j2k` names and every mode PIL saves;
- the codestream features Pillow's encoder cannot write raise ValueError
  naming the file and the feature; the faults a differential sweep of
  corrupt files found each have a case;
- the slice: the register CLI on JPEG 2000 copies of the chesslike frames
  gives the poses of PNG copies of the same pixels.
"""

from __future__ import annotations

import json
import shutil
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from acezero_tpu.data import images as jimg
from acezero_tpu.data.depth import load_depth_file as j_load_depth_file
from acezero_tpu.data.scene import load_scene as j_load_scene
from acezero_tpu_torch.cli import register_cli as tcli
from acezero_tpu_torch.data import images as timg
from acezero_tpu_torch.data.depth import load_depth_file
from acezero_tpu_torch.data.scene import load_scene as t_load_scene
from acezero_tpu_torch.export import nerfstudio_runner as runner
from acezero_tpu_torch.io import formats
from acezero_tpu_torch.io import jpeg2000 as tj
from acezero_tpu_torch.io.jpeg import write_jpeg
from acezero_tpu_torch.io.png import write_png

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402
import make_jpeg2000_fixtures as fx  # noqa: E402

FIXTURES = sorted(fx.FIXTURES)
DIGESTS = json.loads((fx.OUT / "pil_digests.json").read_text())
DECODED = [n for n in FIXTURES if not DIGESTS["files"][n].get("raises")]
SCENE = ROOT / "results" / "heldout" / "scenes" / "chesslike_a"


def _pil(path):
    """PIL's image of a file: (array, mode, size, palette digest,
    convert("RGB"), convert("L")), or None where its open or load raises."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        try:
            with Image.open(path) as im:
                arr = np.asarray(im)
                return (arr, im.mode, im.size, fx.palette_digest(im.getpalette()), np.asarray(im.convert("RGB")),
                        np.asarray(im.convert("L")))
        except Exception:
            return None


def _assert_as_pil(path) -> str:
    """The port gives PIL's image of `path`, or raises ValueError naming it
    where PIL raises (the header too where PIL's open raises)."""
    want = _pil(path)
    if want is None:
        with pytest.raises(ValueError, match="JPEG 2000") as exc:
            timg.read_image(path)
        assert str(path) in str(exc.value)
        try:
            Image.open(path).close()
        except Exception:
            with pytest.raises(ValueError):
                formats.header(path)
        return "raise"
    arr, mode, size, palette, rgb, luma = want
    r = tj.read_jpeg2000(path)
    assert (r.mode, r.pixels.shape[1::-1]) == (mode, size) and r.pixels.dtype == arr.dtype
    assert np.array_equal(r.pixels, arr)
    assert tj.jpeg2000_header(path) == (*size, mode)
    assert (formats.pil_mode(path), formats.image_size(path), formats.file_kind(path)) == (mode, size, "jpeg2000")
    img = timg.read_image(path)
    assert np.array_equal(timg.pil_array(img), arr)
    if mode in ("P", "PA"):
        assert fx.palette_digest(img.palette) == palette
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
    if not want.get("raises"):
        img = timg.read_image(path)
        assert chip_smoke.array_digest(timg.pil_array(img)) == want["sha256"]
        assert chip_smoke.array_digest(timg.read_rgb(path)) == want["rgb_sha256"]


def test_photo_decodes_as_pil():
    """The committed photo-size file (irreversible, one quality layer) that
    the card times: PIL's pixels, and its recorded digest."""
    assert fx.PHOTO.stat().st_size <= fx.PHOTO_MAX_BYTES
    want = DIGESTS["photo"]
    with Image.open(fx.PHOTO) as im:
        assert (im.mode, list(im.size)) == (want["mode"], want["size"]) == ("RGB", list(chip_smoke.JPEG_PHOTO_HW[::-1]))
        arr = np.asarray(im)
    r = tj.read_jpeg2000(fx.PHOTO)
    assert r.mode == "RGB" and np.array_equal(r.pixels, arr)
    assert chip_smoke.array_digest(r.pixels) == want["sha256"]


def test_fixtures_stay_small_and_cover_every_kind():
    files = [p for p in fx.OUT.iterdir() if p != fx.PHOTO]
    assert sum(p.stat().st_size for p in files) < 650_000
    assert sorted(DIGESTS["files"]) == FIXTURES and set(fx.DEPTH) <= set(DECODED)
    got = {n: DIGESTS["files"][n] for n in DECODED}
    # at most 64 x 48 pixels, but the 7-resolution file (six levels need 64 on each side)
    assert all(d["size"][0] * d["size"][1] <= 64 * 48 for n, d in got.items() if n != "res7_97.jp2")
    assert {d["mode"] for d in got.values()} == {"L", "I;16", "LA", "RGB", "RGBA", "CMYK", "P", "PA"}
    heads = {n: (fx.OUT / n).read_bytes()[:12] for n in FIXTURES}
    assert {tj.is_jpeg2000(h) for h in heads.values()} == {True}
    assert {h.startswith(tj.CODESTREAM_SIGNATURE) for n, h in heads.items() if n in got} == {True, False}
    raises = sorted(n for n in FIXTURES if DIGESTS["files"][n].get("raises"))
    assert raises == ["cmyk_colr_3_components.jp2", "eycc_colr.jp2", "ihdr_larger.jp2", "ihdr_smaller.jp2",
                      "palette_16bit_columns.jp2", "palette_gray_colr.jp2", "precincts_16x16_res6.jp2"]


@pytest.mark.parametrize("short_size,canvas_hw", fx.CANVAS_CHECKS)
def test_canvases_of_every_fixture_match_jax(short_size, canvas_hw):
    """decode_to_canvas over every fixture PIL decodes, in one glob: the
    JAX package's canvases, sizes and scales (the canvas pass at the
    default canvas, the oversize crop at the small one), and the digest the
    card checks."""
    paths = [str(fx.OUT / n) for n in DECODED]
    got = timg.decode_to_canvas(paths, short_size=short_size, canvas_hw=canvas_hw, num_workers=4)
    want = jimg.decode_to_canvas(paths, short_size=short_size, canvas_hw=canvas_hw, num_workers=2)
    assert np.array_equal(got.canvases, want.canvases)
    for k in ("sizes", "orig_sizes", "scale_factors"):
        assert np.array_equal(getattr(got, k), getattr(want, k)), k
    entry = [c for c in DIGESTS["canvas"] if c["short_size"] == short_size][0]
    assert chip_smoke.canvas_digest(got) == entry["sha256"]


def _mixed_glob(tmp_path) -> list[str]:
    """JPEG 2000 (lossless and lossy, JP2 and bare, gray, RGBA, 16-bit),
    PNG and JPEG frames of a few sizes."""
    paths = []
    for i, (h, w) in enumerate([(40, 52), (45, 61), (36, 40), (52, 40)]):
        rgb = fx.image(h, w, 3, 70 + i)
        write_png(tmp_path / f"a{i}.png", rgb)
        write_jpeg(tmp_path / f"b{i}.jpg", rgb)
        Image.fromarray(rgb).save(tmp_path / f"c{i}.jp2", irreversible=bool(i % 2))
        Image.fromarray(rgb[..., 1]).save(tmp_path / f"d{i}.j2k")
        Image.fromarray(np.concatenate([rgb, rgb[..., :1]], -1)).save(tmp_path / f"e{i}.jpx", irreversible=True,
                                                                     quality_layers=[20])
        paths += [tmp_path / f"{k}{i}.{s}" for k, s in zip("abcde", ("png", "jpg", "jp2", "j2k", "jpx"))]
    paths += [fx.OUT / "pil_i16_53.jp2", fx.OUT / "palette_alpha.jp2", fx.OUT / "pil_cmyk_97.jp2"]
    return sorted(str(p) for p in paths)


@pytest.mark.parametrize("short,canvas_hw", [(40, None), (24, None), (40, (32, 40))],
                         ids=["shrunk", "enlarged", "oversize_crop"])
def test_mixed_glob_canvases_match_jax(short, canvas_hw, tmp_path):
    paths = _mixed_glob(tmp_path)
    got = timg.decode_to_canvas(paths, short_size=short, canvas_hw=canvas_hw, num_workers=3)
    want = jimg.decode_to_canvas(paths, short_size=short, canvas_hw=canvas_hw, num_workers=3)
    for k in ("sizes", "orig_sizes", "scale_factors"):
        assert np.array_equal(getattr(got, k), getattr(want, k)), k
    assert got.canvases.shape == want.canvases.shape and np.array_equal(got.canvases, want.canvases)


@pytest.mark.parametrize("name", DECODED)
def test_load_depth_file_matches_jax(name):
    """A JPEG 2000 as a depth file: np.asarray(Image.open(p)) / 1000, as the
    JAX package reads it (an I;16 map in millimetres, an 8-bit one, a
    palette's indices)."""
    got, want = load_depth_file(fx.OUT / name), j_load_depth_file(str(fx.OUT / name))
    assert got.dtype == want.dtype == np.float64 and got.shape == want.shape and np.array_equal(got, want)
    if name in fx.DEPTH:
        assert chip_smoke.array_digest(got) == DIGESTS["depth"][name]


# ------------------------------------------------------------- the runner and the writer


def _read_back(path):
    with Image.open(path) as im:
        return im.mode, np.asarray(im)


RUNNER_MODES = ("L", "LA", "RGB", "RGBA", "CMYK", "I;16", "P", "PA")


def _runner_source(mode: str, tmp_path, suffix: str) -> Path:
    """A JPEG 2000 file of `mode`, 700 x 37 (wider than the runner's 640)."""
    src = tmp_path / f"src{suffix}"
    if mode in ("P", "PA"):
        base = fx.OUT / ("palette_rgb.jp2" if mode == "P" else "palette_alpha.jp2")
        cs = fx.codestream_of(fx.pil_image("L" if mode == "P" else "LA", 37, 700, seed=5))
        head = fx.ihdr(37, 700, 1 if mode == "P" else 2, 7) + fx.colr(16)
        pal = tj.read_jpeg2000(base).palette
        src.write_bytes(fx.jp2(cs, head + fx.pclr(pal) + fx.cmap(3, direct=int(mode == "PA"))))
    else:
        fx.pil_image(mode, 37, 700, seed=6).save(src, irreversible=mode == "RGB")
    return src


@pytest.mark.parametrize("suffix", [".jp2", ".j2k", ".jpx"])
@pytest.mark.parametrize("mode", RUNNER_MODES)
def test_runner_downscale_is_pils_resize_and_reads_back_as_pils_save(mode, suffix, tmp_path):
    """The runner's downscale of a JPEG 2000 source is PIL's BILINEAR resize
    of its mode (nearest for P), and its save reads back in PIL as PIL's
    own save does (a bare codestream for .j2k, JP2 boxes otherwise); PIL
    cannot save P and PA as JPEG 2000, and the runner raises OSError as it
    does."""
    src = _runner_source(mode, tmp_path, suffix)
    size = (640, 34)
    with Image.open(src) as im:
        mode = im.mode  # a CMYK codestream without its boxes opens as RGBA
        resized = im.resize(size, Image.BILINEAR)
    got, got_mode, _, _ = runner._resized(src, *size)
    assert got_mode == mode and np.array_equal(got, np.asarray(resized))
    if mode in ("P", "PA"):
        with pytest.raises(OSError):
            resized.save(tmp_path / f"pil{suffix}")
        with pytest.raises(OSError, match="cannot write mode"):
            runner._save(tmp_path / f"port{suffix}", got, got_mode)
        return
    resized.save(tmp_path / f"pil{suffix}")
    runner._save(tmp_path / f"port{suffix}", got, got_mode)
    pil, port = _read_back(tmp_path / f"pil{suffix}"), _read_back(tmp_path / f"port{suffix}")
    assert pil[0] == port[0] and np.array_equal(pil[1], port[1])
    assert (tmp_path / f"port{suffix}").read_bytes().startswith(
        tj.CODESTREAM_SIGNATURE if suffix == ".j2k" else tj.JP2_SIGNATURE)


@pytest.mark.parametrize("suffix", [".jp2", ".j2k"])
@pytest.mark.parametrize("shape", [(1, 1), (1, 9), (9, 1), (2, 3), (48, 64), (65, 130), (131, 67), (300, 257)])
@pytest.mark.parametrize("mode", tj.SAVE_MODES)
def test_write_jpeg2000_reads_back_as_pils_save(mode, shape, suffix, tmp_path):
    """write_jpeg2000 (lossless 5/3, one tile, one layer): PIL reads it back
    as its read-back of its own save of the same pixels (a CMYK
    codestream without its boxes reads back as RGBA in both), and so does
    the port."""
    nc = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4, "CMYK": 4, "I;16": 1}[mode]
    img = fx.image(*shape, nc, seed=sum(shape), bits=16 if mode == "I;16" else 8)
    img[0, 0] = 0  # the extremes of the range
    img[-1, -1] = 65535 if mode == "I;16" else 255
    Image.frombytes(mode, shape[::-1], img.tobytes()).save(tmp_path / f"pil{suffix}")
    tj.write_jpeg2000(tmp_path / f"port{suffix}", img, mode)
    pil, port = _read_back(tmp_path / f"pil{suffix}"), _read_back(tmp_path / f"port{suffix}")
    assert pil[0] == port[0] and np.array_equal(pil[1], port[1]) and np.array_equal(port[1], img)
    r = tj.read_jpeg2000(tmp_path / f"port{suffix}")
    assert r.mode == pil[0] and np.array_equal(r.pixels, img)


def test_write_jpeg2000_refuses_the_modes_pil_does_not_save_and_other_samples(tmp_path):
    for mode, img in (("P", np.zeros((4, 4), np.uint8)), ("1", np.zeros((4, 4), bool)),
                      ("F", np.zeros((4, 4), np.float32))):
        with pytest.raises(OSError, match=f"cannot write mode {mode}"):
            tj.write_jpeg2000(tmp_path / "x.jp2", img, mode)
    for mode, img in (("L", np.zeros((4, 4), np.uint16)), ("I;16", np.zeros((4, 4), np.uint8)),
                      ("RGB", np.zeros((4, 4, 4), np.uint8)), ("LA", np.zeros((4, 4), np.uint8))):
        with pytest.raises(ValueError, match=f"a mode-{mode} image takes"):
            tj.write_jpeg2000(tmp_path / "x.jp2", img, mode)


def test_runner_saves_i16b_as_i16(tmp_path):
    """PIL saves an I;16B image's values as I;16 JPEG 2000; so does the
    runner."""
    img = fx.image(20, 30, 1, seed=3, bits=16)
    runner._save(tmp_path / "x.jpf", img, "I;16B")
    assert _read_back(tmp_path / "x.jpf")[0] == "I;16" and np.array_equal(_read_back(tmp_path / "x.jpf")[1], img)


# ------------------------------------------------------------- refusals


def _edited(name: str, edit) -> bytes:
    """A fixture's codestream with `edit` applied to its Codestream."""
    c = fx.Codestream((fx.OUT / name).read_bytes())
    edit(c)
    return c.bytes()


def _cod_byte(at: int, value: int):
    def edit(c):
        cod = bytearray(c.segment(0xFF52))
        cod[at] = value
        c.replace(0xFF52, bytes(cod))
    return edit


def _qcd_derived(c):
    qcd = c.segment(0xFF5C)
    c.replace(0xFF5C, bytes([(qcd[0] & 0xE0) | 1]) + qcd[1:3])


def _siz_subsampled(c):
    siz = bytearray(c.segment(0xFF51))
    siz[37 + 3] = 2  # component 1's XRsiz
    c.replace(0xFF51, bytes(siz))


def _rsiz(bit: int):
    def edit(c):
        siz = bytearray(c.segment(0xFF51))
        siz[0] |= bit >> 8
        c.replace(0xFF51, bytes(siz))
    return edit


REFUSED = {
    "codeblock_style_bypass": (_cod_byte(8, 0x01), "code-block style other than 0"),
    "codeblock_style_reset": (_cod_byte(8, 0x02), "code-block style other than 0"),
    "codeblock_style_termall": (_cod_byte(8, 0x04), "code-block style other than 0"),
    "codeblock_style_causal": (_cod_byte(8, 0x08), "code-block style other than 0"),
    "codeblock_style_pterm": (_cod_byte(8, 0x10), "code-block style other than 0"),
    "codeblock_style_segsym": (_cod_byte(8, 0x20), "code-block style other than 0"),
    "sop_markers": (_cod_byte(0, 0x02), "SOP or EPH"),
    "eph_markers": (_cod_byte(0, 0x04), "SOP or EPH"),
    "rgn": (lambda c: c.insert(0xFF5E, bytes([0, 0, 3]), after=0xFF5C), "RGN"),
    "poc": (lambda c: c.insert(0xFF5F, bytes([0, 0, 0, 1, 6, 3, 0]), after=0xFF5C), "POC"),
    "ppm": (lambda c: c.insert(0xFF60, bytes([0, 0, 0, 0, 1, 0]), after=0xFF5C), "PPM"),
    "ppt": (lambda c: c.parts[0]["segs"].insert(0, (0xFF61, bytes([0, 0]))), "PPT"),
    "rgn_in_a_tile": (lambda c: c.parts[0]["segs"].insert(0, (0xFF5E, bytes([0, 0, 3]))), "RGN"),
    "scalar_derived_quantisation": (_qcd_derived, "scalar derived quantisation"),
    "subsampled_component": (_siz_subsampled, "sub-sampled component"),
    "part2_codestream": (_rsiz(0x8000), "part-2 codestream"),
    "htj2k_codestream": (_rsiz(0x4000), "HTJ2K codestream"),
    "cap_marker": (lambda c: c.insert(0xFF50, bytes([0, 0x02, 0, 0, 0, 0]), after=0xFF51), "CAP marker"),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_refused_features_raise_naming_the_file(case, tmp_path):
    """The codestream features Pillow's encoder cannot write raise
    ValueError naming the file and the feature, in a bare codestream and
    in a JP2 file."""
    edit, feature = REFUSED[case]
    cs = _edited("pil_rgb_53.j2k", edit)
    for path, data in ((tmp_path / f"{case}.j2k", cs),
                       (tmp_path / f"{case}.jp2", fx.jp2(cs, fx.ihdr(48, 64, 3, 7) + fx.colr(16)))):
        path.write_bytes(data)
        with pytest.raises(ValueError, match="not read yet") as exc:
            timg.read_image(path)
        assert str(path) in str(exc.value) and feature in str(exc.value)


def test_files_of_other_kinds_keep_their_messages(tmp_path):
    (tmp_path / "x.bin").write_bytes(b"\x00\x01\x02" * 10)
    with pytest.raises(ValueError, match="neither a PNG nor .* GIF or JPEG 2000 file") as exc:
        timg.read_image(tmp_path / "x.bin")
    assert str(tmp_path / "x.bin") in str(exc.value)


# ------------------------------------------------------------- corrupt files

# Files of a differential sweep (9,280 truncated and byte-flipped fixtures)
# whose pixels once differed from PIL's by 1 or 2 levels: a corrupt pass
# count made the port decode one bit-plane past openjpeg's last (which is 1
# in openjpeg's numbering, where the sample keeps a bit below each plane).
# Only the 9/7 path showed it. (fixture, [(offset, new byte)])
SWEEP_FAULTS = [
    ("coc_qcc.j2k", [(109, 68)]),
    ("codeblock_4x4_97.jp2", [(1144, 0), (3846, 6), (6049, 64)]),
    ("mct_97.jp2", [(431, 196)]),
    ("mct_97_rgba.j2k", [(79, 90)]),
    ("pil_i16_97.jp2", [(238, 39)]),
    ("pil_la_97.jp2", [(194, 71)]),
    ("prog_rlcp_layers3_97.j2k", [(86, 44)]),
    ("prog_rpcl_layers3_97.j2k", [(100, 55)]),
    ("res5_97.jp2", [(572, 208)]),
    ("res7_97.jp2", [(171, 46)]),
    ("signed_rgb_97.jp2", [(175, 47)]),
]


@pytest.mark.parametrize("name,edits", SWEEP_FAULTS, ids=[f"{n}@{e[0][0]}" for n, e in SWEEP_FAULTS])
def test_sweep_faults_decode_as_pil(name, edits, tmp_path):
    data = bytearray((fx.OUT / name).read_bytes())
    for at, value in edits:
        data[at] = value
    (tmp_path / name).write_bytes(bytes(data))
    assert _assert_as_pil(tmp_path / name) == "decode"


def _corrupt(rng, data: bytes) -> bytes:
    b = bytearray(data)
    kind = rng.integers(0, 4)
    if kind == 0:
        return bytes(b[: rng.integers(0, len(b))])
    for _ in range(rng.integers(1, 4)):
        at = rng.integers(0, min(len(b), 240)) if kind == 1 else rng.integers(0, len(b))
        b[at] = rng.integers(0, 256) if kind != 3 else b[at] ^ (1 << rng.integers(0, 8))
    return bytes(b)


SWEEP_CHUNKS = 4


@pytest.mark.parametrize("chunk", range(SWEEP_CHUNKS))
def test_corrupt_files_decode_as_pil_or_raise(chunk, tmp_path):
    """Seeded truncations, header bytes and byte flips of the fixtures: the
    port raises ValueError naming the file wherever PIL's open or load
    raises, and where PIL decodes it gives PIL's pixels or raises
    ValueError naming the file (where openjpeg reads on past a fault)."""
    rng = np.random.default_rng(1000 + chunk)
    names = [n for n in DECODED if n != "res7_97.jp2"]
    for i in range(60):
        name = names[rng.integers(0, len(names))]
        path = tmp_path / f"{i}_{name}"
        path.write_bytes(_corrupt(rng, (fx.OUT / name).read_bytes()))
        want = _pil(path)
        try:
            got = tj.read_jpeg2000(path)
        except ValueError as e:
            assert str(path) in str(e)
            continue
        assert want is not None, f"{path}: PIL raises, the port decodes"
        assert got.mode == want[1] and np.array_equal(got.pixels, want[0]), path


# ------------------------------------------------------------- the slice


def test_register_cli_on_jpeg2000_frames_gives_the_png_poses(tmp_path):
    """The register CLI (the slice's entry point) on 4 chesslike_a frames as
    lossless JPEG 2000 (write_jpeg2000: JP2 and bare codestreams) of their
    gray pixels: the scene loads to the canvases of PNG copies in both
    packages, and the poses equal the PNG glob's."""
    frames = sorted(SCENE.glob("frame_00[0-3]0.png"))
    for sub in ("png", "jp2"):
        (tmp_path / sub).mkdir()
    for i, f in enumerate(frames):
        img = timg.read_png(f)
        write_png(tmp_path / "png" / f.name, img)
        tj.write_jpeg2000(tmp_path / "jp2" / f"{f.stem}.{('jp2', 'j2k')[i % 2]}", img, "L")
    kw = dict(image_short_size=120, external_focal_length=520.0, num_workers=2)
    t_png, t_j2k = t_load_scene(str(tmp_path / "png" / "*.png"), **kw), t_load_scene(str(tmp_path / "jp2" / "frame_*"), **kw)
    j_j2k = j_load_scene(str(tmp_path / "jp2" / "frame_*"), **kw)
    assert np.array_equal(t_j2k.images.canvases, t_png.images.canvases)
    assert np.array_equal(t_j2k.images.canvases, j_j2k.images.canvases)
    poses = {}
    for sub, pattern in (("png", "*.png"), ("jp2", "frame_*")):
        net = tmp_path / f"head_{sub}.pt"
        shutil.copy(ROOT / "results" / "heldout" / "sweep_a_warmstart" / "iteration2.pt", net)
        argv = [str(tmp_path / sub / pattern), str(net), "--encoder_path", str(ROOT / "weights" / "tpu_encoder_v6.pt"),
                "--use_external_focal_length", "520", "--image_resolution", "120", "--session", sub,
                "--num_data_workers", "2", "--device", "cpu"]
        assert tcli.main(argv) == 0
        poses[sub] = [ln.split()[1:] for ln in (tmp_path / f"poses_{sub}.txt").read_text().splitlines()]
    assert len(poses["jp2"]) == 4 and poses["jp2"] == poses["png"]
