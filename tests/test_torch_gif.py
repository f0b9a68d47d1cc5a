"""GIF files in the port (io/gif.py, io/csrc/gif.cpp) against PIL, which
opens them for the JAX package, and against the JAX package:

- every fixture of tests/data/gif (scripts/make_gif_fixtures.py) decodes to
  PIL's frame 0: its indices, mode, size, palette and transparency index,
  with PIL's size and mode from the container alone, PIL's
  `convert("RGB")` and `convert("L")`, live and as recorded in
  pil_digests.json (which the card checks); where PIL's open or load
  raises, the port raises ValueError naming the file;
- decode_to_canvas over the fixtures and over a mixed GIF + PNG + JPEG glob
  gives the JAX package's canvases bit for bit, on the canvas pass and on
  the oversize crop; load_depth_file gives the JAX package's depth maps;
- the Nerfstudio runner's GIF downscale, and write_gif of P and L images,
  read back in PIL as PIL's read-back of its own save (mode, indices,
  palette, transparency);
- seeded sweeps of corrupted fixtures and of synthetic LZW streams (code
  sizes 0-13, odd extents, extension quirks): ValueError naming the file
  where PIL's open or load raises, PIL's pixels where it decodes;
- the slice: the register CLI on GIF copies of the chesslike frames gives
  the poses of PNG copies of the same pixels.
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
from acezero_tpu_torch.io import gif as tgif
from acezero_tpu_torch.io.jpeg import write_jpeg
from acezero_tpu_torch.io.png import write_png

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402
import make_gif_fixtures as fx  # noqa: E402

FIXTURES = sorted(fx.FIXTURES)
DIGESTS = json.loads((fx.OUT / "pil_digests.json").read_text())
DECODED = [n for n in FIXTURES if not DIGESTS["files"][n].get("raises")]
SCENE = ROOT / "results" / "heldout" / "scenes" / "chesslike_a"


def _pil(path):
    """PIL's frame 0 of a file: (array, mode, size, palette digest,
    transparency, convert("RGB"), convert("L")), or None where its open or
    load raises."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        try:
            with Image.open(path) as im:
                arr = np.asarray(im)
                return (arr, im.mode, im.size, fx.palette_digest(im.getpalette()), im.info.get("transparency"),
                        np.asarray(im.convert("RGB")), np.asarray(im.convert("L")))
        except Exception:
            return None


def _assert_as_pil(path):
    """The port gives PIL's frame 0 of `path`, or raises ValueError naming
    it where PIL raises (the header where PIL's open raises)."""
    want = _pil(path)
    if want is None:
        with pytest.raises(ValueError, match="GIF|PIL") as exc:
            timg.read_image(path)
        assert str(path) in str(exc.value)
        try:
            Image.open(path).close()
        except Exception:
            with pytest.raises(ValueError):
                formats.header(path)
        return "raise"
    arr, mode, size, palette, transparency, rgb, luma = want
    r = tgif.read_gif(path)
    assert (r.mode, r.pixels.shape[::-1]) == (mode, size) and r.pixels.dtype == arr.dtype == np.uint8
    assert np.array_equal(r.pixels, arr)
    assert fx.palette_digest(r.palette) == palette and r.transparency == transparency
    assert tgif.gif_header(path) == (*size, mode, transparency)
    assert (formats.pil_mode(path), formats.image_size(path), formats.file_kind(path)) == (mode, size, "gif")
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
    if not want.get("raises"):
        r = tgif.read_gif(path)
        assert chip_smoke.array_digest(r.pixels) == want["sha256"] and fx.palette_digest(r.palette) == want["palette"]
        assert chip_smoke.array_digest(timg.read_rgb(path)) == want["rgb_sha256"]


def test_fixtures_stay_small_and_cover_every_kind():
    files = list(fx.OUT.iterdir())
    assert sum(p.stat().st_size for p in files) < 150_000
    assert sorted(DIGESTS["files"]) == FIXTURES and set(fx.DEPTH) <= set(DECODED)
    got = [DIGESTS["files"][n] for n in DECODED]
    assert {d["mode"] for d in got} == {"P", "L"}
    assert any(d["mode"] == "L" and d["palette"] for d in got)  # a global palette under a local grey ramp
    assert {d["transparency"] is not None for d in got} == {True, False}
    assert [n for n in FIXTURES if DIGESTS["files"][n].get("raises")] == ["early_end_code.gif"]
    heads = {n: (fx.OUT / n).read_bytes() for n in FIXTURES}
    assert {h[:6] for h in heads.values()} == {b"GIF87a", b"GIF89a"}
    frames = {n: tgif._open(h, n) for n, h in heads.items()}
    assert {f.bits for f in frames.values()} >= set(range(2, 9))
    assert {f.interlace for f in frames.values()} == {True, False}
    assert any(f.extent[:2] != (0, 0) for f in frames.values())
    sizes = {n: tuple(DIGESTS["files"][n]["size"]) for n in DECODED}
    assert any(sizes[n] != (frames[n].extent[2], frames[n].extent[3]) for n in DECODED)
    with Image.open(fx.OUT / "pil_animation.gif") as anim:
        assert anim.n_frames == 3


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
    """GIF (P, L, transparency, a global palette under a grey ramp), PNG and
    JPEG frames of a few sizes."""
    paths = []
    for i, (h, w) in enumerate([(40, 52), (45, 61), (36, 40), (52, 40)]):
        rgb = fx.photo(h, w, 70 + i)
        write_png(tmp_path / f"a{i}.png", rgb)
        write_jpeg(tmp_path / f"b{i}.jpg", rgb)
        im = Image.fromarray(rgb).quantize(16 << i)
        if i % 2:
            im.info["transparency"] = 3
        im.save(tmp_path / f"c{i}.gif")
        Image.fromarray(rgb[..., 1]).save(tmp_path / f"d{i}.gif")
        paths += [tmp_path / f"a{i}.png", tmp_path / f"b{i}.jpg", tmp_path / f"c{i}.gif", tmp_path / f"d{i}.gif"]
    paths.append(fx.OUT / "grey_ramp_local_over_global.gif")
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
    """A GIF as a depth file: its indices (or grey levels) over 1,000, as
    the JAX package's np.asarray(Image.open(p)) / 1000 gives them."""
    got, want = load_depth_file(fx.OUT / name), j_load_depth_file(str(fx.OUT / name))
    assert got.dtype == want.dtype == np.float64 and got.shape == want.shape and np.array_equal(got, want)
    if name in fx.DEPTH:
        assert chip_smoke.array_digest(got) == DIGESTS["depth"][name]


# ------------------------------------------------------------- the runner and the writer


def _read_back(path):
    with Image.open(path) as im:
        return im.mode, np.asarray(im), im.getpalette(), im.info.get("transparency")


def _assert_same_read_back(got, want):
    assert got[0] == want[0] and got[1].shape == want[1].shape and np.array_equal(got[1], want[1])
    assert got[2] == want[2] and got[3] == want[3]


def _large_p(tmp_path) -> Path:
    """A P GIF of 512 x 520 pixels (at PIL's 512 x 512 bound, whose palette
    PIL's save does not optimize) with holes in its indices and a
    transparency index."""
    im = Image.fromarray(fx.photo(520, 512, 90)).quantize(64)
    idx = np.asarray(im) * 2
    out = Image.frombytes("P", (512, 520), idx.astype(np.uint8).tobytes())
    out.putpalette(fx.palette(256, 91).reshape(-1).tolist())
    out.info["transparency"] = 6
    out.save(tmp_path / "large_p.gif")
    return tmp_path / "large_p.gif"


RUNNER_CASES = ["pil_p2.gif", "pil_p16.gif", "pil_p256.gif", "pil_p_transparency.gif", "pil_l.gif", "pil_l_ramp.gif",
                "pil_l_transparency.gif", "offset_frame_transparency.gif", "indices_past_the_palette.gif",
                "grey_ramp_transparency.gif", "animation_local_palettes.gif", "large_p.gif"]


@pytest.mark.parametrize("name", RUNNER_CASES)
def test_runner_downscale_reads_back_as_pils(name, tmp_path):
    """The runner's downscale of a GIF source, written as a GIF, reads back
    in PIL as PIL's own resize and save does: the same mode, indices,
    palette and transparency index."""
    src = _large_p(tmp_path) if name == "large_p.gif" else fx.OUT / name
    with Image.open(src) as im:
        size = (max(1, im.width * 2 // 3), max(1, im.height * 3 // 5))
        im.resize(size, Image.BILINEAR).save(tmp_path / "pil.gif")
    runner._save(tmp_path / "port.gif", *runner._resized(src, *size))
    _assert_same_read_back(_read_back(tmp_path / "port.gif"), _read_back(tmp_path / "pil.gif"))


def test_runner_raises_where_pils_resize_does(tmp_path):
    """A GIF of mode L with the global palette kept under a local grey ramp:
    PIL's BILINEAR resize raises ValueError, and so does the runner."""
    src = fx.OUT / "grey_ramp_local_over_global.gif"
    with Image.open(src) as im, pytest.raises(ValueError, match="wrong mode"):
        im.resize((5, 4), Image.BILINEAR)
    with pytest.raises(ValueError, match="wrong mode"):
        runner._resized(src, 5, 4)


@pytest.mark.parametrize("suffix", [".dat", ".psd", ".ico", ".dib", ""])
def test_runner_refuses_suffixes_it_has_no_writer_for(suffix, tmp_path):
    """A suffix the port does not write raises OSError rather than getting
    PNG bytes under its name; .png and .apng stay PNG."""
    img = np.zeros((4, 5), np.uint8)
    with pytest.raises(OSError, match="writes no image format"):
        runner._save(tmp_path / f"x{suffix}", img, "L")
    for ok in (".png", ".apng"):
        runner._save(tmp_path / f"x{ok}", img, "L")
        with Image.open(tmp_path / f"x{ok}") as im:
            assert im.format == "PNG" and np.array_equal(np.asarray(im), img)


def _writer_case(kind: str):
    """(indices or grey levels, mode, palette, transparency) of a writer
    case."""
    rng = np.random.default_rng(len(kind) * 31 + sum(map(ord, kind)))
    h, w = (9, 11) if "small" in kind else (40, 57)
    if kind.startswith("L"):
        levels = {"L_few": [0, 1, 2, 3], "L_ramp8": list(range(8)), "L_two": [0, 255]}.get(kind.split("_small")[0])
        img = (rng.choice(levels, (h, w)) if levels else rng.integers(0, 256, (h, w))).astype(np.uint8)
        t = int(img[1, 2]) if "trns" in kind else (300 % 256 if "gone" in kind else None)
        if "gone" in kind:
            img[img == t] = (t + 1) % 256
        return img, "L", None, t
    n = {"P2": 2, "P3": 3, "P16": 16, "P200": 200, "P256": 256}[kind.split("_")[0]]
    pal = rng.integers(0, 256, (n, 3)).astype(np.uint8)
    used = rng.permutation(n)[: max(1, n // 3)] if "holes" in kind else np.arange(max(1, n // 3))
    if "full" in kind:
        used = np.arange(n)
    img = rng.choice(used, (h, w)).astype(np.uint8)
    if "past" in kind:
        img[0, :3] = n + 5
    t = int(img[2, 3]) if "trns" in kind else (int(np.setdiff1d(np.arange(n), used)[0]) if "gone" in kind else None)
    return img, "P", pal, t


WRITER_CASES = ["L", "L_small", "L_few", "L_ramp8", "L_two", "L_trns", "L_gone", "P2", "P3", "P16", "P16_holes",
                "P16_full", "P16_small", "P200", "P200_holes_trns", "P256_full", "P256_holes", "P16_holes_gone",
                "P16_trns", "P16_past", "P3_full_small"]


@pytest.mark.parametrize("kind", WRITER_CASES)
def test_write_gif_reads_back_as_pils_save(kind, tmp_path):
    """write_gif of a P or L image with `info["transparency"]`: PIL reads it
    back as it reads back its own save of the same image (the palette
    optimized or not, the transparency index remapped or dropped)."""
    img, mode, pal, t = _writer_case(kind)
    pil = Image.frombytes(mode, img.shape[::-1], img.tobytes())
    if pal is not None:
        pil.putpalette(pal.reshape(-1).tolist())
    if t is not None:
        pil.info["transparency"] = t
    pil.save(tmp_path / "pil.gif")
    tgif.write_gif(tmp_path / "port.gif", img, mode, pal, t)
    want = _read_back(tmp_path / "pil.gif")
    _assert_same_read_back(_read_back(tmp_path / "port.gif"), want)
    r = tgif.read_gif(tmp_path / "port.gif")
    assert r.mode == want[0] and np.array_equal(r.pixels, want[1]) and r.transparency == want[3]


def test_write_gif_refuses_other_modes(tmp_path):
    with pytest.raises(OSError, match="cannot write mode RGB as GIF"):
        tgif.write_gif(tmp_path / "x.gif", np.zeros((4, 4, 3), np.uint8), "RGB")


@pytest.mark.parametrize("shape", [(1, 1), (7, 300), (15, 16), (16, 16), (300, 7), (97, 131), (480, 640)])
def test_encoder_round_trips(shape, tmp_path):
    """encode_gif (LZW at minimum code size 8, a clear when the table is
    full; interlaced when both sides are 16 or more): the port and PIL read
    the indices back."""
    rng = np.random.default_rng(sum(shape))
    idx = rng.integers(0, 256, shape).astype(np.uint8)
    idx[: shape[0] // 2] //= 64  # runs and noise
    pal = rng.integers(0, 256, (256, 3)).astype(np.uint8)
    (tmp_path / "e.gif").write_bytes(tgif.encode_gif(idx, pal))
    r = tgif.read_gif(tmp_path / "e.gif")
    assert r.mode == "P" and np.array_equal(r.pixels, idx) and np.array_equal(r.palette, pal)
    with Image.open(tmp_path / "e.gif") as im:
        assert im.mode == "P" and np.array_equal(np.asarray(im), idx)
        assert im.info.get("transparency") is None


# ------------------------------------------------------------- refusals and corrupt files


def _refused() -> dict:
    idx = fx.indices(9, 12, 16, 80)
    pal = fx.palette(16, 81)
    good = fx.gif_bytes(12, 9, [fx.image_block(idx, bits=4)], palette=pal)
    codes = fx.lzw_codes(idx.reshape(-1), 4)
    return {
        "header_cut_short": good[:11],
        "trailer_only": good[:13 + 48] + b";",
        "no_image_block": fx.gif_bytes(12, 9, [fx.comment(b"nothing")], palette=pal),
        "descriptor_cut_short": good[: 13 + 48 + 5],
        "palette_cut_short_in_an_entry": fx.gif_bytes(12, 9, [], palette=fx.GREY[:16])[: 13 + 7],
        "data_cut_short": good[:-8],
        "code_size_13": fx.gif_bytes(12, 9, [fx.image_block(idx, bits=4)], palette=pal).replace(
            b"," + struct.pack("<HHHHB", 0, 0, 12, 9, 0) + b"\x04", b"," + struct.pack("<HHHHB", 0, 0, 12, 9, 0) + b"\x0d"),
        "code_past_the_table": fx.gif_bytes(12, 9, [fx.image_block(idx, bits=4, codes=codes[:5] + [30] + codes[5:])],
                                            palette=pal),
        "first_code_not_a_literal": fx.gif_bytes(12, 9, [fx.image_block(idx, bits=4, codes=[16, 20] + codes[1:])],
                                                 palette=pal),
        "early_end_code": (fx.OUT / "early_end_code.gif").read_bytes(),
        "zero_size": fx.gif_bytes(0, 0, [fx.image_block(idx[:0, :0], bits=4, codes=[16, 17])], palette=pal),
        "bomb": fx.gif_bytes(20000, 20000, [fx.image_block(idx, bits=4)], palette=pal),
        "frame_makes_a_bomb": fx.gif_bytes(12, 9, [fx.image_block(idx, bits=4, x=19990, y=19990)], palette=pal),
        "graphic_control_cut_short": fx.gif_bytes(12, 9, [b"!\xf9\x02\x01\x00\x00", fx.image_block(idx, bits=4)],
                                                  palette=pal),
    }


@pytest.mark.parametrize("case", sorted(_refused()))
def test_files_pil_refuses_raise(case, tmp_path):
    """Each file PIL's open or load refuses: the port raises ValueError
    naming the file (the header where PIL's open raises)."""
    path = tmp_path / f"{case}.gif"
    path.write_bytes(_refused()[case])
    assert _pil(path) is None
    assert _assert_as_pil(path) == "raise"


def _corrupt(rng, data: bytes) -> bytes:
    data = bytearray(data)
    kind = int(rng.integers(4))
    if kind == 0:
        return bytes(data[: int(rng.integers(0, len(data)))])
    if kind == 3:  # the header, the palettes and the descriptor
        data[int(rng.integers(0, min(len(data), 48)))] = int(rng.integers(256))
        return bytes(data)
    for at in rng.integers(0, len(data), int(rng.integers(1, 4))):
        data[at] = data[at] ^ (1 << int(rng.integers(8))) if kind == 1 else int(rng.integers(256))
    return bytes(data)


SWEEP_CHUNKS, SWEEP_CASES = 6, 60
SMALL = [n for n in FIXTURES if (fx.OUT / n).stat().st_size < 5000]


@pytest.mark.parametrize("chunk", range(SWEEP_CHUNKS))
def test_corrupt_files_decode_as_pil(chunk, tmp_path):
    """Truncations and byte flips of the fixtures, SWEEP_CASES a chunk from
    a seeded generator: the port raises where PIL raises and gives PIL's
    frame 0 elsewhere."""
    rng = np.random.default_rng(3000 + chunk)
    outcomes = {"raise": 0, "decode": 0}
    for k in range(SWEEP_CASES):
        path = tmp_path / f"case{k}.gif"
        path.write_bytes(_corrupt(rng, (fx.OUT / SMALL[int(rng.integers(len(SMALL)))]).read_bytes()))
        outcomes[_assert_as_pil(path)] += 1
    assert min(outcomes.values()) > 0, outcomes


def _synthetic(rng) -> bytes:
    """A GIF of a random screen, frame extent, code size (0-13), code stream
    (random bytes, or LZW codes of random indices, some of them changed),
    sub-block lengths and extension blocks (Pillow's quirks among them)."""
    w, h = int(rng.integers(0, 12)), int(rng.integers(0, 10))
    sw, sh = int(rng.integers(0, 14)), int(rng.integers(0, 12))
    x, y = (int(rng.integers(0, 4)), int(rng.integers(0, 4))) if rng.random() < 0.5 else (0, 0)
    bits = int(rng.choice([0, 1, 2, 3, 4, 8, 11, 12, 13])) if rng.random() < 0.5 else int(rng.integers(2, 9))
    code_bits = max(bits, 1) if bits <= 12 else 8
    if rng.random() < 0.4:
        data = rng.integers(0, 256, int(rng.integers(0, 60))).astype(np.uint8).tobytes()
    else:
        idx = rng.integers(0, 1 << min(code_bits, 8), max(max(w * h, 1) + int(rng.integers(-3, 4)), 0))
        codes = fx.lzw_codes(idx, code_bits, clear_when_full=bool(rng.random() < 0.5),
                             clear_every=int(rng.integers(0, 6)))
        if rng.random() < 0.3 and len(codes) > 2:
            codes[int(rng.integers(1, len(codes)))] = int(rng.integers(0, 1 << min(code_bits + 1, 12)))
        data = fx.pack_codes(codes, code_bits)
    sizes = tuple(int(v) for v in rng.integers(1, 256, 3)) if rng.random() < 0.3 else (255,)
    flags = 64 if rng.random() < 0.4 else 0
    table = b""
    if rng.random() < 0.3:
        size, table = fx.colour_table(fx.palette(8, 2) if rng.random() < 0.5 else fx.GREY[: 2 << int(rng.integers(0, 8))])
        flags |= 128 | size
    block = b"," + struct.pack("<HHHHB", x, y, w, h, flags) + table + bytes([bits]) + fx.sub_blocks(data, sizes)
    if rng.random() < 0.2:
        block = block[: int(rng.integers(0, len(block)))]
    exts = []
    for _ in range(int(rng.integers(0, 4))):
        exts.append([b"!\xf9\x00", b"!\xff\x0bNETSCAPE2.0\x00", fx.comment(b"c" * int(rng.integers(0, 20))),
                     fx.plain_text(b"x"), bytes([int(rng.integers(0, 256))]),
                     b"!\xf9" + bytes([int(rng.integers(0, 6))]) + rng.integers(0, 256, 5).astype(np.uint8).tobytes(),
                     fx.netscape(int(rng.integers(0, 5))), fx.gce(transparency=int(rng.integers(0, 8))),
                     fx.gce()][int(rng.integers(9))])
    r = rng.random()
    pal = fx.palette(4, 1) if r < 0.5 else (fx.GREY[: 2 << int(rng.integers(0, 8))] if r < 0.7 else None)
    tail = b";" if rng.random() < 0.7 else rng.integers(0, 256, int(rng.integers(0, 8))).astype(np.uint8).tobytes()
    return fx.gif_bytes(sw, sh, exts + [block], palette=pal, trailer=False) + tail


@pytest.mark.parametrize("chunk", range(SWEEP_CHUNKS))
def test_synthetic_streams_decode_as_pil(chunk, tmp_path):
    rng = np.random.default_rng(4000 + chunk)
    outcomes = {"raise": 0, "decode": 0}
    for k in range(SWEEP_CASES):
        path = tmp_path / f"case{k}.gif"
        path.write_bytes(_synthetic(rng))
        outcomes[_assert_as_pil(path)] += 1
    assert min(outcomes.values()) > 0, outcomes


@pytest.mark.parametrize("cut", [5000, 30000, 100000])
def test_an_end_code_before_the_frame_is_full(cut, tmp_path):
    """An end code stops Pillow's decoder; ImageFile.load then reads the
    file's next 65,536 bytes and the decoder goes on after the end code, so
    a file larger than that decodes when the end code falls in its first
    block, and is truncated (or broken) otherwise: the port reads it the
    same way."""
    rng = np.random.default_rng(cut)
    h, w = 300, 400
    codes = fx.lzw_codes(rng.integers(0, 256, h * w), 8)
    block = b"," + struct.pack("<HHHHB", 0, 0, w, h, 0) + b"\x08" + fx.sub_blocks(
        fx.pack_codes(codes[:cut] + [257] + codes[cut:], 8))
    path = tmp_path / "end.gif"
    path.write_bytes(fx.gif_bytes(w, h, [block], palette=fx.palette(256, 1)))
    assert _assert_as_pil(path) == ("decode" if cut == 30000 else "raise")


# quirks of Pillow's container that a sweep once found or that the fixtures
# hold: the later graphic control extension without the transparency flag
# keeps the earlier index; a NETSCAPE extension whose loop sub-block is the
# terminator reads the next bytes as sub-blocks; stray bytes between blocks
_IDX = fx.indices(9, 12, 16, 82)
QUIRKS = {
    "second_gce_without_the_flag": [fx.gce(transparency=5), fx.gce(), fx.image_block(_IDX, bits=4)],
    "netscape_without_its_sub_block": [b"!\xff\x0bNETSCAPE2.0\x00", b"\x02ab\x00", fx.image_block(_IDX, bits=4)],
    "stray_bytes_between_blocks": [b"\x00\x07", fx.comment(b"x"), b"\xff", fx.image_block(_IDX, bits=4)],
}


@pytest.mark.parametrize("case", sorted(QUIRKS))
def test_container_quirks_as_pil(case, tmp_path):
    path = tmp_path / f"{case}.gif"
    path.write_bytes(fx.gif_bytes(12, 9, QUIRKS[case], palette=fx.palette(16, 83)))
    assert _assert_as_pil(path) == "decode"


def test_a_palette_under_a_grey_ramp_converts_as_pil():
    """Mode L with the global palette kept: convert("RGB") through the
    palette, convert("L") the grey levels, and the JAX package's oversize
    path takes NEAREST (its convert("L") copies the image as mode P)."""
    path = fx.OUT / "grey_ramp_local_over_global.gif"
    img = timg.read_image(path)
    assert isinstance(img, timg.ModeImage) and img.mode == "L" and img.palette is not None
    assert not np.array_equal(timg.read_rgb(path), np.repeat(img.pixels[..., None], 3, -1))
    got = timg.decode_to_canvas([str(path)], short_size=12, canvas_hw=(8, 8), num_workers=1)
    want = jimg.decode_to_canvas([str(path)], short_size=12, canvas_hw=(8, 8), num_workers=1)
    assert np.array_equal(got.canvases, want.canvases) and np.array_equal(got.sizes, want.sizes)


# ------------------------------------------------------------- the slice


def test_register_cli_on_gif_frames_gives_the_png_poses(tmp_path):
    """The register CLI (the slice's entry point) on 4 chesslike_a frames as
    interlaced P GIFs with a permuted grey palette (write_gif): the scene
    loads to the canvases of PNG copies of the same RGB pixels in both
    packages, and the poses equal the PNG glob's. (At the 120-pixel side an
    RGB copy of a gray frame is not the gray frame's canvas; chip_smoke.py's
    phase formats compares with the gray PNGs at the frames' own size.)"""
    frames = sorted(SCENE.glob("frame_00[0-3]0.png"))
    perm = np.random.default_rng(7).permutation(256).astype(np.uint8)
    palette = np.repeat(np.argsort(perm).astype(np.uint8)[:, None], 3, axis=1)  # entry perm[g] is grey g
    for sub in ("png", "gif"):
        (tmp_path / sub).mkdir()
    for f in frames:
        img = timg.read_png(f)
        write_png(tmp_path / "png" / f.name, np.repeat(img[..., None], 3, -1))
        tgif.write_gif(tmp_path / "gif" / f"{f.stem}.gif", perm[img], "P", palette)
        assert tgif.gif_header(tmp_path / "gif" / f"{f.stem}.gif")[2] == "P"
    kw = dict(image_short_size=120, external_focal_length=520.0, num_workers=2)
    t_png, t_gif = t_load_scene(str(tmp_path / "png" / "*.png"), **kw), t_load_scene(str(tmp_path / "gif" / "*.gif"), **kw)
    j_gif = j_load_scene(str(tmp_path / "gif" / "*.gif"), **kw)
    assert np.array_equal(t_gif.images.canvases, t_png.images.canvases)
    assert np.array_equal(t_gif.images.canvases, j_gif.images.canvases)
    poses = {}
    for sub in ("png", "gif"):
        net = tmp_path / f"head_{sub}.pt"
        shutil.copy(ROOT / "results" / "heldout" / "sweep_a_warmstart" / "iteration2.pt", net)
        argv = [str(tmp_path / sub / f"*.{sub}"), str(net), "--encoder_path", str(ROOT / "weights" / "tpu_encoder_v6.pt"),
                "--use_external_focal_length", "520", "--image_resolution", "120", "--session", sub,
                "--num_data_workers", "2", "--device", "cpu"]
        assert tcli.main(argv) == 0
        poses[sub] = [ln.split()[1:] for ln in (tmp_path / f"poses_{sub}.txt").read_text().splitlines()]
    assert len(poses["gif"]) == 4 and poses["gif"] == poses["png"]
