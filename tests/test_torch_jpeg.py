"""The port's JPEG codec (io/csrc/jpeg.cpp through io/jpeg.py), its host
build, and the image reads that go through it, against PIL and the JAX
package on the CPU.

- `read_jpeg` equals `np.asarray(Image.open(path))` bit for bit over modes
  L and RGB, subsampling 4:4:4, 4:2:2 and 4:2:0, quality 50-100,
  progressive, optimized Huffman tables and restart markers, at sizes on
  and off the MCU grid;
- unsupported or broken files raise ValueError naming the file;
- `write_jpeg` gives PIL's bytes;
- decode_to_canvas, read_rgb and the point cloud's frame colours give the
  JAX package's (PIL's) results on JPEG and PNG globs, holding at most
  num_workers decoded images;
- read_png reads palette, 1/2/4-bit gray and Adam7-interlaced PNGs as PIL
  gives them to the JAX package;
- the committed fixtures' digests (tests/data/jpeg/pil_digests.json, which
  the card checks) are PIL's, and the port decodes to them;
- the slice as a whole: the reconstruction CLI's mini loop
  (tests/test_torch_pipeline.py) on a glob of JPEG frames, against the JAX
  pipeline on the same files.
"""

import hashlib
import io
import json
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
from acezero_tpu_torch.io import jpeg as tjpeg
from acezero_tpu_torch.ops import build

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))
import chip_smoke  # noqa: E402
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
    ("cmyk", "4 components"), ("truncated", "truncated"), ("not_an_image", "neither a PNG nor a JPEG"),
    ("arithmetic", "arithmetic coding"), ("lossless", "lossless"), ("12bit", "12-bit"),
    ("sampling", "sampling factors"), ("corrupt", "corrupt JPEG data"),
])
def test_unsupported_or_broken_files_raise(case, match, tmp_path):
    rgb = _save(tmp_path / "rgb.jpg", 37, 53, "RGB", "4:2:0", seed=1, quality=75)
    if case == "cmyk":
        p = tmp_path / "cmyk.jpg"
        _image(16, 16, "RGB", 2).convert("CMYK").save(p)
    elif case == "truncated":
        p = tmp_path / "cut.jpg"
        p.write_bytes(rgb.read_bytes()[: len(rgb.read_bytes()) // 2])
    elif case == "not_an_image":
        p = tmp_path / "x.jpg"
        p.write_bytes(b"GIF89a not an image at all")
    elif case == "arithmetic":
        p = _patched(rgb, tmp_path / "a.jpg", b"\xff\xc0", 1, 0xC9)
    elif case == "lossless":
        p = _patched(rgb, tmp_path / "l.jpg", b"\xff\xc0", 1, 0xC3)
    elif case == "12bit":
        p = _patched(rgb, tmp_path / "p.jpg", b"\xff\xc0", 4, 12)
    elif case == "sampling":
        p = _patched(rgb, tmp_path / "s.jpg", b"\xff\xc0", 11, 0x12)  # luma 1x2 (4:4:0)
    else:  # entropy-coded data cut short before the end-of-image marker
        data = rgb.read_bytes()
        p = tmp_path / "c.jpg"
        p.write_bytes(data[: data.index(b"\xff\xda") + 40] + b"\xff\xd9")
    with pytest.raises(ValueError, match=match) as exc:
        timg.read_image(p)
    assert str(p) in str(exc.value)


def test_header_gives_the_shape_without_decoding(tmp_path):
    p = _save(tmp_path / "x.jpg", 37, 53, "RGB", "4:2:0", seed=3)
    data = np.fromfile(p, np.uint8)
    assert tjpeg.jpeg_shape(data, p) == (37, 53, 3)
    assert timg.image_size(p) == (53, 37)


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
    assert len(files) <= 12 and sum(f.stat().st_size for f in files) < 100_000
    assert {f.name for f in files} == set(DIGESTS["files"])
    assert all(max(Image.open(f).size) <= 64 for f in files)
    names = " ".join(f.name for f in files)
    for kind in ("gray", "444", "422", "420", "progressive", "optimize", "restart"):
        assert kind in names


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
    # unresized, the decode and the luma are bit-equal; a shrink rounds the
    # area average as tests/test_torch_images.py's PNG canvases do (float64
    # sums here, float32 in native/canvas.cpp)
    assert diff.max() == 0 if not resized else diff.max() <= 1


def test_read_rgb_matches_pils_convert(tmp_path):
    for i, (mode, sub) in enumerate(MODES):
        p = _save(tmp_path / f"r{i}.jpg", 37, 53, mode, sub, seed=i, quality=85)
        assert np.array_equal(timg.read_rgb(p), np.asarray(Image.open(p).convert("RGB")))


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
