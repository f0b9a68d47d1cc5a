"""WebP files in the port (io/webp.py, io/csrc/webp.cpp) against PIL's
libwebp, which opens them for the JAX package, and against the JAX package:

- every fixture of tests/data/webp (scripts/make_webp_fixtures.py) decodes
  to PIL's array and mode, with PIL's size and mode from the header alone,
  PIL's `convert("RGB")` and `convert("L")`, live and as recorded in
  pil_digests.json (which the card checks); the script writes the same
  bytes, and the fixtures cover every kind the port decodes;
- decode_to_canvas over a mixed glob of PNG, lossy and lossless RGBA WebP
  gives the JAX package's canvases bit for bit, on the canvas pass and on
  the oversize crop; load_depth_file gives the JAX package's depth maps;
- the Nerfstudio runner's downscale of an RGB or an RGBA WebP reads back in
  the source's mode as PIL's resize exactly (the port writes it lossless,
  PIL's save lossy: the recorded difference);
- the port's VP8L encoder round-trips, and PIL reads its files to the same
  pixels and mode;
- a seeded sweep of truncated and byte-flipped fixtures: ValueError naming
  the file where PIL's open or load raises, PIL's pixels where it decodes;
- the slice: the register CLI on lossless WebP copies of the chesslike
  frames gives the poses of the PNG frames.
"""

from __future__ import annotations

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
from acezero_tpu.data.scene import load_scene as j_load_scene
from acezero_tpu_torch.cli import register_cli as tcli
from acezero_tpu_torch.data import images as timg
from acezero_tpu_torch.data.depth import load_depth_file
from acezero_tpu_torch.data.scene import load_scene as t_load_scene
from acezero_tpu_torch.export import nerfstudio_runner as runner
from acezero_tpu_torch.io import formats
from acezero_tpu_torch.io import webp as twebp
from acezero_tpu_torch.io.png import write_png

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402
import make_webp_fixtures as fx  # noqa: E402

FIXTURES = sorted(fx.FIXTURES)
DIGESTS = json.loads((fx.OUT / "pil_digests.json").read_text())
SMALL = [n for n in FIXTURES if n != fx.PHOTO]
SCENE = ROOT / "results" / "heldout" / "scenes" / "chesslike_a"


def _pil(path):
    """(np.asarray, mode, size, convert("RGB"), convert("L")) of PIL's image."""
    with Image.open(path) as im:
        return np.asarray(im), im.mode, im.size, np.asarray(im.convert("RGB")), np.asarray(im.convert("L"))


# ------------------------------------------------------------- the fixtures


@pytest.mark.parametrize("name", FIXTURES)
def test_fixture_decodes_as_pil(name):
    path = fx.OUT / name
    want, mode, size, rgb, luma = _pil(path)
    img = timg.read_image(path)
    assert (formats.file_kind(path), formats.pil_mode(path), formats.image_size(path)) == ("webp", mode, size)
    assert img.dtype == want.dtype == np.uint8 and img.shape == want.shape
    assert np.array_equal(img, want)
    assert np.array_equal(timg.read_rgb(path), rgb)
    assert np.array_equal(timg.pil_luma_u8(img), luma)


@pytest.mark.parametrize("name", FIXTURES)
def test_fixture_digests_are_pils(name):
    """pil_digests.json holds PIL's decode of each fixture as it is (the
    card checks the port against it), and the script writes these bytes."""
    path = fx.OUT / name
    want = DIGESTS["files"][name]
    assert want == fx.digest(path)
    assert chip_smoke.array_digest(twebp.read_webp(path).pixels) == want["sha256"]
    assert path.read_bytes() == fx.FIXTURES[name]()


def _chunks(data: bytes) -> list[bytes]:
    """Every chunk tag of a file, ANMF payloads' chunks included."""
    tags, pos, ends = [], 12, [len(data)]
    while pos + 8 <= ends[-1] or len(ends) > 1:
        if pos + 8 > ends[-1]:
            pos = ends.pop()
            continue
        tag, size = data[pos: pos + 4], struct.unpack_from("<I", data, pos + 4)[0]
        tags.append(tag)
        if tag == b"ANMF":
            ends.append(pos + 8 + size + (size & 1))
            pos += 24
            continue
        pos += 8 + size + (size & 1)
    return tags


def test_fixtures_stay_small_and_cover_every_kind():
    files = list(fx.OUT.iterdir())
    assert sum(p.stat().st_size for p in files) < 1 << 20
    assert (fx.OUT / fx.PHOTO).stat().st_size <= 300_000
    assert sorted(DIGESTS["files"]) == FIXTURES
    assert {d["mode"] for d in DIGESTS["files"].values()} == {"RGB", "RGBA"}
    tags = {name: _chunks((fx.OUT / name).read_bytes()) for name in FIXTURES}
    assert set().union(*tags.values()) >= {b"VP8 ", b"VP8L", b"VP8X", b"ALPH", b"ANIM", b"ANMF", b"ICCP", b"EXIF",
                                           b"XMP "}
    alph = set()  # (compression, filter, pre-processing) of each ALPH chunk
    for name in FIXTURES:
        data = (fx.OUT / name).read_bytes()
        at = data.find(b"ALPH")
        if at >= 0:
            alph.add((data[at + 8] & 3, (data[at + 8] >> 2) & 3, (data[at + 8] >> 4) & 3))
    assert {a[0] for a in alph} == {0, 1} and {f for m, f, _ in alph if m == 0} == {0, 1, 2, 3}
    assert {a[2] for a in alph} == {0, 1}
    for name, want in fx.HEADERS.items():
        got = fx.vp8_header((fx.OUT / name).read_bytes())
        assert {k: got[k] for k in want} == want, name
    with Image.open(fx.OUT / "anim_two_frames.webp") as anim:
        assert anim.n_frames == 2


# ------------------------------------------------------------- against the JAX package


def _mixed_glob(tmp_path) -> list[str]:
    """PNG, lossy WebP (RGB, RGBA) and lossless WebP (RGB, RGBA) frames of
    a few sizes."""
    paths = []
    for i, (h, w) in enumerate([(40, 52), (45, 61), (36, 40), (52, 40)]):
        rgb = fx.photo(h, w, 70 + i)
        rgba = np.concatenate([rgb, fx.alpha_plane(h, w, 70 + i)[..., None]], -1)
        write_png(tmp_path / f"a{i}.png", rgb)
        (tmp_path / f"b{i}.webp").write_bytes(fx.pil_webp(rgb if i % 2 else rgba, quality=60 + 10 * i))
        (tmp_path / f"c{i}.webp").write_bytes(fx.pil_webp(rgba if i % 2 else rgb, lossless=True))
        paths += [tmp_path / f"a{i}.png", tmp_path / f"b{i}.webp", tmp_path / f"c{i}.webp"]
    return sorted(str(p) for p in paths)


@pytest.mark.parametrize("short,canvas_hw", [(40, None), (24, None), (40, (32, 40))],
                         ids=["shrunk", "enlarged_none", "oversize_crop"])
def test_mixed_glob_canvases_match_jax(short, canvas_hw, tmp_path):
    paths = _mixed_glob(tmp_path)
    got = timg.decode_to_canvas(paths, short_size=short, canvas_hw=canvas_hw, num_workers=3)
    want = jimg.decode_to_canvas(paths, short_size=short, canvas_hw=canvas_hw, num_workers=3)
    for k in ("sizes", "orig_sizes", "scale_factors"):
        assert np.array_equal(getattr(got, k), getattr(want, k)), k
    diff = np.abs(got.canvases.astype(np.int16) - want.canvases.astype(np.int16))
    assert got.canvases.shape == want.canvases.shape and diff.max() == 0


@pytest.mark.parametrize("name", FIXTURES)
def test_load_depth_file_matches_jax(name):
    """A WebP as a depth file: its (h, w, 3) or (h, w, 4) array over 1,000,
    as the JAX package's np.asarray(Image.open(p)) / 1000 gives it."""
    got, want = load_depth_file(fx.OUT / name), j_load_depth_file(str(fx.OUT / name))
    assert got.dtype == want.dtype == np.float64 and got.shape == want.shape and np.array_equal(got, want)


# ------------------------------------------------------------- the runner and the encoder


@pytest.mark.parametrize("name", ["lossy_q80.webp", "lossy_rgba_aq100.webp", "lossless_rgb.webp",
                                  "lossless_rgba.webp", "anim_offset_first_frame.webp", "lossy_17x33.webp"])
def test_runner_downscale_reads_back_as_pils_resize(name, tmp_path):
    """The runner's downscale of a WebP source is a lossless WebP that PIL
    reads back in the source's mode as PIL's resize. The recorded
    difference: PIL's own save is lossy VP8, so its read-back of a lossy
    save is not its resize."""
    src = fx.OUT / name
    with Image.open(src) as im:
        size = (max(1, im.width * 2 // 3), max(1, im.height * 3 // 5))
        resized = im.resize(size, Image.BILINEAR)
        want, want_mode = np.asarray(resized), resized.mode
        resized.save(tmp_path / f"pil_{name}")
    dst = tmp_path / name
    runner._save(dst, *runner._resized(src, *size))
    assert formats.file_kind(dst) == "webp" and dst.read_bytes()[12:16] == b"VP8L"
    with Image.open(dst) as back:
        assert back.mode == want_mode and np.array_equal(np.asarray(back), want)
    with Image.open(tmp_path / f"pil_{name}") as pil_back:
        assert pil_back.mode == want_mode
        assert not np.array_equal(np.asarray(pil_back), want)  # PIL's save loses what VP8 loses


def test_runner_refuses_modes_webp_cannot_hold(tmp_path):
    with pytest.raises(OSError, match="cannot write mode L as WebP"):
        runner._save(tmp_path / "x.webp", np.zeros((4, 4), np.uint8), "L")


@pytest.mark.parametrize("shape", [(1, 1, 3), (1, 1, 4), (5, 300, 3), (33, 17, 4), (64, 48, 3), (2, 2, 4)])
@pytest.mark.parametrize("content", ["noise", "flat", "two_colours"])
def test_encoder_round_trips_and_pil_reads_it(shape, content, tmp_path):
    rng = np.random.default_rng(sum(shape))
    if content == "noise":
        img = rng.integers(0, 256, shape, dtype=np.uint8)
    elif content == "flat":
        img = np.full(shape, 77, np.uint8)
    else:
        img = np.where(rng.integers(0, 2, shape[:2] + (1,)) > 0, 200, 13).astype(np.uint8).repeat(shape[2], -1)
    path = tmp_path / "e.webp"
    twebp.write_webp(path, img)
    r = twebp.read_webp(path)
    assert r.mode == ("RGBA" if shape[2] == 4 else "RGB") and np.array_equal(r.pixels, img)
    with Image.open(path) as im:
        assert im.mode == r.mode and np.array_equal(np.asarray(im), img)


def test_encoder_refuses_what_vp8l_cannot_hold():
    with pytest.raises(ValueError, match="cannot write"):
        twebp.encode_webp(np.zeros((4, 4), np.uint8))
    with pytest.raises(ValueError, match="cannot write"):
        twebp.encode_webp(np.zeros((1, 16385, 3), np.uint8))


# ------------------------------------------------------------- corrupt files


def _corrupt(rng, data: bytes) -> bytes:
    data = bytearray(data)
    kind = int(rng.integers(3))
    if kind == 0:
        return bytes(data[: int(rng.integers(0, len(data)))])
    for at in rng.integers(0, len(data), int(rng.integers(1, 4))):
        data[at] = data[at] ^ (1 << int(rng.integers(8))) if kind == 1 else int(rng.integers(256))
    return bytes(data)


SWEEP_CHUNKS, SWEEP_CASES = 6, 50


@pytest.mark.parametrize("chunk", range(SWEEP_CHUNKS))
def test_corrupt_files_raise_where_pil_raises(chunk, tmp_path):
    """Truncations and byte flips of the fixtures, SWEEP_CASES a chunk
    from a seeded generator: where PIL's open raises, the header raises;
    where its open or load raises, read_image raises ValueError naming
    the file; elsewhere the port gives PIL's pixels and mode."""
    rng = np.random.default_rng(1000 + chunk)
    outcomes = {"raise": 0, "decode": 0}
    for k in range(SWEEP_CASES):
        name = SMALL[int(rng.integers(len(SMALL)))]
        path = tmp_path / f"case{k}.webp"
        path.write_bytes(_corrupt(rng, (fx.OUT / name).read_bytes()))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            try:
                im = Image.open(path)
            except Exception:
                opened, want = False, None
            else:
                opened = True
                try:
                    want, mode = np.asarray(im), im.mode
                except Exception:
                    want = None
                im.close()
        if opened:
            got_mode = formats.pil_mode(path)
            assert want is None or got_mode == mode
        else:
            with pytest.raises(ValueError, match=str(path)):
                formats.pil_mode(path)
        if want is None:
            with pytest.raises(ValueError, match=str(path)):
                timg.read_image(path)
            outcomes["raise"] += 1
        else:
            got = twebp.read_webp(path)
            assert got.mode == mode and np.array_equal(got.pixels, want), (name, k)
            outcomes["decode"] += 1
    assert min(outcomes.values()) > 0, outcomes


def _partition_starts(data: bytes) -> list[int]:
    """File offsets of each VP8 stream's first and second partitions."""
    out, pos = [], 12
    while pos + 8 <= len(data):
        tag, size = data[pos: pos + 4], struct.unpack_from("<I", data, pos + 4)[0]
        if tag == b"ANMF":
            pos += 24
            continue
        if tag == b"VP8 ":
            q = pos + 8
            first = (data[q] | (data[q + 1] << 8) | (data[q + 2] << 16)) >> 5
            out += [q + 10, q + 10 + first]
        pos += 8 + size + (size & 1)
    return out


@pytest.mark.parametrize("chunk", range(2))
def test_corrupt_partition_starts_decode_as_pil(chunk, tmp_path):
    """Bytes set at the start of a VP8 partition (0xFF among them), which
    leave the boolean decoder in states no encoder makes: libwebp decodes
    most such files, and the port gives the same pixels, since it keeps
    libwebp's 56-bit window and its sign trick."""
    rng = np.random.default_rng(2000 + chunk)
    lossy = [n for n in SMALL if _partition_starts((fx.OUT / n).read_bytes())]
    decoded = 0
    for k in range(SWEEP_CASES):
        name = lossy[int(rng.integers(len(lossy)))]
        data = bytearray((fx.OUT / name).read_bytes())
        starts = _partition_starts(bytes(data))
        at = min(len(data) - 1, starts[int(rng.integers(len(starts)))] + int(rng.integers(0, 12)))
        data[at] = int(rng.choice([255, 254, 0, int(rng.integers(256))]))
        path = tmp_path / f"case{k}.webp"
        path.write_bytes(bytes(data))
        try:
            with Image.open(path) as im:
                want, mode = np.asarray(im), im.mode
        except OSError:
            with pytest.raises(ValueError, match=str(path)):
                twebp.read_webp(path)
            continue
        got = twebp.read_webp(path)
        assert got.mode == mode and np.array_equal(got.pixels, want), (name, at, data[at])
        decoded += 1
    assert decoded > SWEEP_CASES // 2


# bytes whose change once set the port apart from PIL: coefficients past 16
# bits, which libwebp's SSE2 inverse DCT wraps; a token partition starting
# with 0xFF, where libwebp's 64-bit window decides the bits
REGRESSIONS = {"sse2_idct_overflow": ("lossy_from_p.webp", {36: 162, 242: 190, 343: 130}),
               "token_partition_ff": ("anim_two_frames.webp", {146: 255})}


@pytest.mark.parametrize("case", sorted(REGRESSIONS))
def test_corrupt_streams_that_once_differed(case, tmp_path):
    name, edits = REGRESSIONS[case]
    data = bytearray((fx.OUT / name).read_bytes())
    for at, value in edits.items():
        data[at] = value
    path = tmp_path / f"{case}.webp"
    path.write_bytes(bytes(data))
    want, mode, *_ = _pil(path)
    got = twebp.read_webp(path)
    assert got.mode == mode and np.array_equal(got.pixels, want)


def test_still_image_with_an_unflagged_alpha_chunk_is_rgba_and_opaque(tmp_path):
    """VP8X without the alpha flag drops its ALPH chunk from the frame, but
    WebPGetFeatures still sees it: PIL's RGBA of opaque pixels."""
    data = (fx.OUT / "alph_raw_filter1.webp").read_bytes()
    at = data.find(b"VP8X") + 8
    path = tmp_path / "unflagged.webp"
    path.write_bytes(data[:at] + bytes([data[at] & ~0x10]) + data[at + 1:])
    want, mode, *_ = _pil(path)
    got = twebp.read_webp(path)
    assert mode == got.mode == "RGBA" and (want[..., 3] == 255).all() and np.array_equal(got.pixels, want)


def test_other_riff_files_are_refused(tmp_path):
    path = tmp_path / "x.webp"
    path.write_bytes(b"RIFF" + struct.pack("<I", 20) + b"WEBPALPH" + bytes(16))
    with pytest.raises(ValueError, match="neither a PNG"):
        timg.read_image(path)


# ------------------------------------------------------------- the slice


def test_register_cli_on_lossless_webp_frames_gives_the_png_poses(tmp_path):
    """The register CLI (the slice's entry point) on 4 chesslike_a frames
    as lossless WebP that the port's encoder writes (the gray frames as
    RGB): the scene loads to the canvases of PNG copies of the same RGB
    pixels in both packages, and the poses equal the PNG glob's. (At a
    120-pixel side an RGB copy of a gray frame is not the gray frame's
    canvas, in either package: the pass's float32 luma of (v, v, v) is not
    always v before it is averaged; chip_smoke.py's phase formats, at the
    frames' own 480 side, compares with the gray PNGs.)"""
    frames = sorted(SCENE.glob("frame_00[0-3]0.png"))
    for sub in ("png", "webp"):
        (tmp_path / sub).mkdir()
    for f in frames:
        img = timg.read_png(f)
        rgb = np.repeat(img[..., None], 3, -1) if img.ndim == 2 else img
        write_png(tmp_path / "png" / f.name, rgb)
        twebp.write_webp(tmp_path / "webp" / f"{f.stem}.webp", rgb)
    kw = dict(image_short_size=120, external_focal_length=520.0, num_workers=2)
    t_png, t_webp = t_load_scene(str(tmp_path / "png" / "*.png"), **kw), t_load_scene(str(tmp_path / "webp" / "*.webp"), **kw)
    j_webp = j_load_scene(str(tmp_path / "webp" / "*.webp"), **kw)
    assert np.array_equal(t_webp.images.canvases, t_png.images.canvases)
    assert np.array_equal(t_webp.images.canvases, j_webp.images.canvases)
    poses = {}
    for sub in ("png", "webp"):
        net = tmp_path / f"head_{sub}.pt"
        shutil.copy(ROOT / "results" / "heldout" / "sweep_a_warmstart" / "iteration2.pt", net)
        argv = [str(tmp_path / sub / f"*.{sub}"), str(net), "--encoder_path", str(ROOT / "weights" / "tpu_encoder_v6.pt"),
                "--use_external_focal_length", "520", "--image_resolution", "120", "--session", sub,
                "--num_data_workers", "2", "--device", "cpu"]
        assert tcli.main(argv) == 0
        poses[sub] = [ln.split()[1:] for ln in (tmp_path / f"poses_{sub}.txt").read_text().splitlines()]
    assert len(poses["webp"]) == 4 and poses["webp"] == poses["png"]
