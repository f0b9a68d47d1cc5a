"""The port's learned seed depth and image conversions against acezero_tpu's
and PIL's.

Tolerances: the depth head and the encoder are bf16 convolutions with the
JAX package's rounding points, summed in another order by the CPU's
convolutions than by XLA's, so single bf16 roundings flip; the head's four
convolutions carry a flip to the log-depth, itself a bf16 output (one unit
in the last place is 2^-9 to 2^-7 here). On these inputs the largest
|log d_port - log d_jax| is 0.018 and the median one unit, 2^-9
(measured); the tests allow DLOG_TOL = 0.03 at most and 2^-8 at the median.
A pad of 0 after normalising (instead of -1.6) is off by far more. The
image conversions (PIL's convert("L") and
convert("RGB"), 16-bit PNG decoding, millimetre depth PNGs) are exact.
"""

import struct
import zlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import acezero_tpu.data.depth as jd
from acezero_tpu.models import depthnet as jdn
from acezero_tpu.models import torch_io as jio
from acezero_tpu.models.encoder import encoder_apply as j_encoder_apply
import acezero_tpu_torch.reconstruct.pipeline as tpipe
from acezero_tpu_torch.data import depth as td
from acezero_tpu_torch.data import images as ti
from acezero_tpu_torch.models import depthnet as tdn
from acezero_tpu_torch.models import torch_io as tio
from acezero_tpu_torch.models.encoder import encoder_apply as t_encoder_apply
from acezero_tpu_torch.reconstruct import AceZeroConfig, AceZeroPipeline

ROOT = Path(__file__).resolve().parents[1]
ENCODER = ROOT / "weights" / "tpu_encoder_v6.pt"
HEAD_V4 = ROOT / "weights" / "tpu_depth_v4.pt"
DLOG_TOL = 0.03


def _png(path, w, h, ctype, depth, rows, filters):
    """A PNG written by hand: `rows` (h, w * bytes per pixel) uint8 raw
    scanlines, each filtered with its own filter type (0-4)."""
    bpp = {0: 1, 2: 3, 4: 2, 6: 4}[ctype] * depth // 8
    out, prev = [], np.zeros(rows.shape[1], np.int32)
    for row, ft in zip(rows.astype(np.int32), filters):
        left = np.concatenate([np.zeros(bpp, np.int32), row[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        if ft == 0:
            f = row
        elif ft == 1:
            f = row - left
        elif ft == 2:
            f = row - prev
        elif ft == 3:
            f = row - (left + prev) // 2
        else:
            p = left + prev - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - upleft)
            f = row - np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
        out.append(bytes([ft]) + (f & 255).astype(np.uint8).tobytes())
        prev = row

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF)

    Path(path).write_bytes(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, 0))
                           + chunk(b"IDAT", zlib.compress(b"".join(out))) + chunk(b"IEND", b""))


def _row_filters(path) -> set:
    data = Path(path).read_bytes()
    pos, idat, header = 8, [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos: pos + 4])
        kind, body = data[pos + 4: pos + 8], data[pos + 8: pos + 8 + n]
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        pos += 12 + n
    w, h, depth, ctype = header[:4]
    stride = w * {0: 1, 2: 3, 4: 2, 6: 4}[ctype] * depth // 8 + 1
    raw = zlib.decompress(b"".join(idat))
    return {raw[y * stride] for y in range(h)}


# ----------------------------------------------------------- depth head


def _depth_params_np(rng, cin1):
    layers = [("d_conv1", 3, 3, cin1, 256), ("d_conv2", 3, 3, 256, 128), ("d_conv3", 1, 1, 128, 64),
              ("d_conv4", 1, 1, 64, 1)]
    params = {}
    for name, kh, kw, cin, cout in layers:
        bound = 1.0 / np.sqrt(cin * kh * kw)
        params[name] = {"w": rng.uniform(-bound, bound, (kh, kw, cin, cout)).astype(np.float32),
                        "b": rng.uniform(-bound, bound, cout).astype(np.float32)}
    params["d_conv4"]["b"] += 0.5  # a log-depth offset, so the exp is not near 1 everywhere
    return params


@pytest.mark.parametrize("variant", ["global_context", "plain"])
def test_depth_head_matches_jax(variant):
    """Encoder and depth head at full channel widths (512 features; d_conv1
    1024 -> 256 with the image-mean feature, or 512 -> 256 without) on one
    48 x 64 image, the JAX weights carried over by params_from_jax."""
    rng = np.random.default_rng(21)
    enc_np = jio.load_encoder(ENCODER)
    head_np = _depth_params_np(rng, 1024 if variant == "global_context" else 512)
    x = ((rng.uniform(0, 1, (1, 48, 64, 1)) - 0.4) / 0.25).astype(np.float32)
    want = np.asarray(jdn.depth_head_apply(jax.tree.map(jnp.asarray, head_np),
                                           j_encoder_apply(jax.tree.map(jnp.asarray, enc_np), jnp.asarray(x))))
    enc_t, _, head_t = tio.params_from_jax(enc_np, None, depth_np=head_np)
    got = tdn.depth_head_apply(head_t, t_encoder_apply(enc_t, torch.from_numpy(x))).numpy()
    assert got.shape == want.shape == (1, 6, 8) and got.dtype == np.float32
    dlog = np.abs(np.log(got) - np.log(want))
    assert dlog.max() <= DLOG_TOL and np.median(dlog) <= 2**-8, (dlog.max(), np.median(dlog))


def test_depth_head_init_shapes_and_losses_match_jax():
    """init_depth_head_params' shapes (width_mult 2 doubles the hidden
    widths) and both losses against the JAX package on the same inputs
    (float32, within 1e-5 relative)."""
    p = tdn.init_depth_head_params(torch.Generator().manual_seed(0), width_mult=2)
    pj = jdn.init_depth_head_params(jax.random.PRNGKey(0), width_mult=2)
    for name in ("d_conv1", "d_conv2", "d_conv3", "d_conv4"):
        assert tuple(p[name]["w"].shape) == tuple(np.asarray(pj[name]["w"]).transpose(3, 2, 0, 1).shape)
    rng = np.random.default_rng(3)
    pred, gt = rng.uniform(0.2, 5, (2, 6, 8)).astype(np.float32), rng.uniform(0.2, 5, (2, 6, 8)).astype(np.float32)
    valid = rng.uniform(size=(2, 6, 8)) > 0.3
    for tf, jf in ((tdn.silog_loss, jdn.silog_loss), (tdn.gradient_matching_loss, jdn.gradient_matching_loss)):
        got = float(tf(torch.from_numpy(pred), torch.from_numpy(gt), torch.from_numpy(valid)))
        want = float(jf(jnp.asarray(pred), jnp.asarray(gt), jnp.asarray(valid)))
        assert got == pytest.approx(want, rel=1e-5)


def test_load_depth_head_reads_the_shipped_v4():
    params = tio.load_depth_head(HEAD_V4)
    assert tuple(params["d_conv1"]["w"].shape) == (256, 1024, 3, 3)  # the global-context variant
    assert tuple(params["d_conv4"]["w"].shape) == (1, 64, 1, 1)
    with pytest.raises(ValueError, match="not a depth head"):
        tio.load_depth_head(ENCODER)


def test_learned_estimator_matches_jax(tmp_path):
    """The v4 head on the v6 encoder through each package's estimator, on an
    RGB PNG of 45 x 61 pixels: the zero pad to 48 x 64 is normalised after
    the pad (-1.6), and the stride-8 depth repeats to the image's size."""
    rng = np.random.default_rng(22)
    yy, xx = np.mgrid[:45, :61]
    rgb = np.stack([(xx * 4) % 256, (yy * 5) % 256, (xx + yy) % 256], -1).astype(np.int64)
    rgb = np.clip(rgb + rng.integers(-20, 20, rgb.shape), 0, 255).astype(np.uint8)
    Image.fromarray(rgb).save(tmp_path / "f.png")
    img = np.asarray(Image.open(tmp_path / "f.png").convert("RGB"))
    assert np.array_equal(ti.read_rgb(tmp_path / "f.png"), img)
    want = jd.learned_depth_estimator(HEAD_V4, encoder_path=ENCODER)(img)
    got = td.learned_depth_estimator(HEAD_V4, encoder_path=ENCODER, device="cpu")(img)
    assert got.shape == want.shape == (45, 61) and got.dtype == want.dtype == np.float64
    dlog = np.abs(np.log(got) - np.log(want))
    assert dlog.max() <= DLOG_TOL and np.median(dlog) <= 2**-8, (dlog.max(), np.median(dlog))
    # the estimator takes the caller's encoder params and runs on their device
    enc = tio.load_encoder(ENCODER)
    again = td.learned_depth_estimator(HEAD_V4, encoder_params=enc)(img)
    assert np.array_equal(again, got)
    with pytest.raises(ValueError, match="encoder"):
        td.learned_depth_estimator(HEAD_V4)


def test_zoe_estimator_raises_without_a_download():
    with pytest.raises(RuntimeError, match="ZoeDepth is unavailable in this environment"):
        td.zoe_depth_estimator()


# ----------------------------------------------------- PIL conversions


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA", "I;16", "RGB16", "LA16", "RGBA16"])
def test_convert_l_and_rgb_match_pil(mode, tmp_path):
    """read_rgb and pil_luma_u8 against PIL's convert("RGB") and convert("L")
    of every PNG colour type at 8 bits and 16 bits, on random pixels: exact."""
    rng = np.random.default_rng(23)
    h, w = 19, 27
    path = tmp_path / "img.png"
    if mode in ("RGB16", "LA16", "RGBA16"):
        ctype = {"RGB16": 2, "LA16": 4, "RGBA16": 6}[mode]
        ch = {2: 3, 4: 2, 6: 4}[ctype]
        samples = rng.integers(0, 65536, (h, w, ch)).astype(">u2")
        _png(path, w, h, ctype, 16, samples.view(np.uint8).reshape(h, -1), rng.integers(0, 5, h))
    else:
        shape = {"L": (h, w), "LA": (h, w, 2), "RGB": (h, w, 3), "RGBA": (h, w, 4), "I;16": (h, w)}[mode]
        arr = rng.integers(0, 65536 if mode == "I;16" else 256, shape)
        arr = arr.astype(np.uint16 if mode == "I;16" else np.uint8)
        (Image.fromarray(arr, mode="LA") if mode == "LA" else Image.fromarray(arr)).save(path)
    with Image.open(path) as im:
        want_rgb = np.asarray(im.convert("RGB"))
        want_l = np.asarray(im.convert("L"))
    got_rgb = ti.read_rgb(path)
    assert got_rgb.dtype == np.uint8 and np.array_equal(got_rgb, want_rgb)
    assert np.array_equal(ti.pil_luma_u8(ti.read_png(path)), want_l)
    assert np.array_equal(ti.pil_luma_u8(got_rgb), np.asarray(Image.fromarray(want_rgb).convert("L")))


def test_pillow_luma_on_every_rgb_level():
    """Pillow's integer luma against PIL over all 256 x 256 (R, G) pairs at
    16 blue levels."""
    rg = np.stack(np.meshgrid(np.arange(256), np.arange(256), indexing="ij"), -1)
    for b in range(0, 256, 17):
        rgb = np.concatenate([rg, np.full(rg.shape[:2] + (1,), b)], -1).astype(np.uint8)
        assert np.array_equal(ti.pil_luma_u8(rgb), np.asarray(Image.fromarray(rgb).convert("L")))


# ------------------------------------------------------- 16-bit PNGs


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4])
def test_16bit_gray_png_with_each_row_filter(ftype, tmp_path):
    """A 16-bit gray PNG whose every row uses one filter type (bytes per
    pixel 2, big-endian samples) reads back exactly, and as PIL reads it."""
    rng = np.random.default_rng(24 + ftype)
    depth = rng.integers(0, 65536, (13, 17)).astype(">u2")
    _png(tmp_path / "d.png", 17, 13, 0, 16, depth.view(np.uint8).reshape(13, -1), [ftype] * 13)
    got = ti.read_png(tmp_path / "d.png")
    assert got.dtype == np.uint16 and np.array_equal(got, depth.astype(np.uint16))
    assert np.array_equal(got, np.asarray(Image.open(tmp_path / "d.png")))


def test_16bit_gray_pngs_written_by_pil(tmp_path):
    """Depth-like 16-bit gray images (smooth ramps, steps, a wave, noise)
    written by PIL's adaptive filtering read back exactly; together they use
    every row filter (PIL tries Average only with optimize=True)."""
    rng = np.random.default_rng(25)
    yy, xx = np.mgrid[:64, :80]
    images = [(xx * 700 + yy * 300), (yy // 8) * 5000 + (xx // 10) * 900, rng.integers(0, 65536, (64, 80)),
              1500 + 40 * xx + rng.integers(0, 3, (64, 80)), np.where(xx > yy, 60000, 300) + (xx * yy) % 17,
              30000 + 20000 * np.sin(xx / 7.0) * np.cos(yy / 9.0)]
    filters = set()
    for i, img in enumerate(images):
        arr = np.asarray(img, np.uint16)
        Image.fromarray(arr).save(tmp_path / f"d{i}.png", optimize=True)
        assert np.array_equal(ti.read_png(tmp_path / f"d{i}.png"), arr)
        filters |= _row_filters(tmp_path / f"d{i}.png")
    assert filters == {0, 1, 2, 3, 4}


def test_mm_depth_png_matches_jax(tmp_path):
    depth_mm = np.random.default_rng(26).integers(0, 8000, (30, 40)).astype(np.uint16)
    Image.fromarray(depth_mm).save(tmp_path / "d.png")
    got = td.load_depth_file(tmp_path / "d.png")
    assert got.dtype == np.float64 and np.array_equal(got, jd.load_depth_file(str(tmp_path / "d.png")))


# ------------------------------------------------- the pipeline's choice


def test_candidate_choice_and_encoder_pairing(tmp_path, monkeypatch):
    """Without depth files or an estimator the pipeline seeds from
    cfg.depth_network, else the first of v4, v3, v1 in weights/ (as the JAX
    package), built on the pipeline's own encoder params; with depth files or
    a plugged estimator it builds none."""
    scene = ROOT / "results" / "heldout" / "scenes" / "chesslike_a"
    made = []

    def fake(head_path, encoder_params=None, **kw):
        made.append((Path(head_path).name, encoder_params))
        return lambda rgb: np.ones(rgb.shape[:2])

    monkeypatch.setattr(tpipe, "learned_depth_estimator", fake)
    enc = {"conv1": {"w": torch.zeros(1)}}
    kw = dict(rgb_files=str(scene / "frame_000[0-1].png"), use_external_focal_length=520.0, image_resolution=64,
              decode_cache_dir=None)
    pipe = AceZeroPipeline(AceZeroConfig(results_folder=tmp_path / "a", **kw), device="cpu", encoder_params=enc)
    assert made == [("tpu_depth_v4.pt", enc)] and pipe.depth_estimator is not None
    AceZeroPipeline(AceZeroConfig(results_folder=tmp_path / "b", depth_network=ROOT / "weights" / "tpu_depth_v1.pt",
                                  **kw), device="cpu", encoder_params=enc)
    assert made[-1] == ("tpu_depth_v1.pt", enc)
    weights = tmp_path / "w"
    weights.mkdir()
    (weights / "tpu_depth_v3.pt").touch()
    (weights / "tpu_depth_v1.pt").touch()
    monkeypatch.setattr(tpipe, "WEIGHTS", weights)
    AceZeroPipeline(AceZeroConfig(results_folder=tmp_path / "c", **kw), device="cpu", encoder_params=enc)
    assert made[-1][0] == "tpu_depth_v3.pt"
    n = len(made)
    AceZeroPipeline(AceZeroConfig(results_folder=tmp_path / "d", depth_files=str(scene / "frame_000[0-1]_depth.npy"),
                                  **kw), device="cpu", encoder_params=enc)
    own = AceZeroPipeline(AceZeroConfig(results_folder=tmp_path / "e", **kw), device="cpu", encoder_params=enc,
                          depth_estimator=lambda rgb: np.full(rgb.shape[:2], 2.0))
    assert len(made) == n
    canvas = own._seed_depth_canvas(1)
    assert canvas.shape == own.scene.canvas_hw and set(np.unique(canvas)) <= {0.0, 2.0}
    # the JAX package makes the same default choice: its v4 head
    assert tpipe.SHIPPED_DEPTH_HEADS[0] == "tpu_depth_v4.pt"
