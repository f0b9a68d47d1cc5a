#!/usr/bin/env python3
"""Write the WebP fixtures that hold the port's decoder (io/webp.py,
io/csrc/webp.cpp) to PIL's where there is no PIL (the card's machine):
small files under tests/data/webp/, and tests/data/webp/pil_digests.json
with, for each, PIL's size, mode, and the shape and sha256 of
`np.asarray(Image.open(path))` (chip_smoke.array_digest).

    python3 scripts/make_webp_fixtures.py

Pillow's `save` makes the lossy (VP8), lossless (VP8L), alpha (VP8X + ALPH
+ VP8), metadata (ICCP, EXIF, XMP) and two-frame files at the options
Pillow takes (quality, method, alpha_quality, lossless, exact). The rest
are built here around the bitstreams Pillow writes:

- ALPH chunks with raw compression under each filter (none, horizontal,
  vertical, gradient), filtered by `filter_alpha` in numpy;
- an animation whose first ANMF frame is smaller than the canvas and
  offset (`anim_bytes`);
- VP8 frames with a header Pillow's encoder never writes: the simple loop
  filter, filter level 0, sharpness, mode and reference filter deltas, no
  segmentation. `rewrite_vp8` decodes the first partition with a boolean
  decoder (header, probability updates, every macroblock's modes) and
  encodes the same decisions again with a boolean encoder, the header
  fields changed; the token partitions are kept. It reads the VP8
  probability tables from io/csrc/webp.cpp: a wrong table would only make
  another stream, which PIL still decodes for the digest;
- VP8 frames of 2, 4 and 8 token partitions, which need the tokens
  re-split, and lossless files of the methods Pillow's save does not reach
  (meta prefix codes, the colour cache, the predictor modes Pillow's
  files leave out): `libwebp_encode` calls the encoder of the libwebp that Pillow
  ships (WebPEncode with its `partitions` option, which it keeps only at
  methods 0-2) through ctypes.

tests/test_torch_webp.py checks the digests against PIL on every run and
that this script writes the same bytes; chip_smoke.py's phase formats
checks the port against the digests on the card.
"""

from __future__ import annotations

import ctypes
import glob
import io
import json
import re
import struct
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

OUT = chip_smoke.WEBP_FIXTURES
PHOTO = chip_smoke.WEBP_PHOTO  # the lossy photo chip_smoke.py times read_webp on
CPP = ROOT / "acezero_tpu_torch" / "io" / "csrc" / "webp.cpp"


def photo(h: int, w: int, seed: int, noise: float = 10.0) -> np.ndarray:
    """(h, w, 3) uint8 with smooth colour waves, edges and noise."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.stack([128 + 100 * np.sin(x / 9.0 + seed) * np.cos(y / 13.0),
                    128 + 90 * np.cos((x + 2 * y) / 17.0),
                    128 + 80 * np.sin(y / 7.0 - x / 23.0)], -1)
    img[(x // 24 + y // 24) % 2 == 0] *= 0.6  # a checker of hard edges
    img += rng.normal(0, noise, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def alpha_plane(h: int, w: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    a = 255 - np.hypot(x - w / 2, y - h / 2) * 400 / max(h, w)
    a += rng.normal(0, 6, a.shape)
    return np.clip(a, 0, 255).astype(np.uint8)


def pil_webp(img: np.ndarray, mode: str | None = None, **opts) -> bytes:
    from PIL import Image

    im = Image.fromarray(img) if mode is None else Image.fromarray(img).convert(mode)
    buf = io.BytesIO()
    im.save(buf, format="WEBP", **opts)
    return buf.getvalue()


# ---------------------------------------------------------------- container


def chunk(tag: bytes, payload: bytes) -> bytes:
    return tag + struct.pack("<I", len(payload)) + payload + b"\x00" * (len(payload) & 1)


def riff(*chunks: bytes) -> bytes:
    body = b"WEBP" + b"".join(chunks)
    return b"RIFF" + struct.pack("<I", len(body)) + body


def vp8x(flags: int, w: int, h: int) -> bytes:
    return chunk(b"VP8X", struct.pack("<I", flags) + (w - 1).to_bytes(3, "little") + (h - 1).to_bytes(3, "little"))


def chunks_of(data: bytes) -> list[tuple[bytes, bytes]]:
    """The (tag, payload) chunks of a RIFF WEBP file."""
    out, pos = [], 12
    while pos + 8 <= len(data):
        tag, size = data[pos: pos + 4], struct.unpack_from("<I", data, pos + 4)[0]
        out.append((tag, data[pos + 8: pos + 8 + size]))
        pos += 8 + size + (size & 1)
    return out


def image_chunk(data: bytes) -> tuple[bytes, bytes]:
    return next((t, p) for t, p in chunks_of(data) if t in (b"VP8 ", b"VP8L"))


def filter_alpha(a: np.ndarray, method: int) -> np.ndarray:
    """The deltas an ALPH filter (0 none, 1 horizontal, 2 vertical, 3
    gradient) makes of an alpha plane: what libwebp's unfilters undo."""
    a = a.astype(np.int32)
    h, w = a.shape
    pred = np.zeros_like(a)
    if method:
        pred[0, 1:] = a[0, :-1]  # the first row: the left sample (0 for the first)
        pred[1:, 0] = a[:-1, 0]  # the first column: the sample above
        if method == 1:
            pred[1:, 1:] = a[1:, :-1]
        elif method == 2:
            pred[1:, 1:] = a[:-1, 1:]
        else:
            pred[1:, 1:] = np.clip(a[1:, :-1] + a[:-1, 1:] - a[:-1, :-1], 0, 255)
    return ((a - pred) % 256).astype(np.uint8)


def alph_raw(img: np.ndarray, alpha: np.ndarray, method: int) -> bytes:
    """VP8X + ALPH (raw, `method` filter) + Pillow's VP8 stream of `img`."""
    h, w = alpha.shape
    vp8 = image_chunk(pil_webp(img, quality=70))[1]
    alph = bytes([method << 2]) + filter_alpha(alpha, method).tobytes()
    return riff(vp8x(0x10, w, h), chunk(b"ALPH", alph), chunk(b"VP8 ", vp8))


def anim_bytes(canvas: tuple[int, int], frames: list[tuple[int, int, bytes]], alpha: bool) -> bytes:
    """An animation: VP8X, ANIM, then one ANMF per (x, y, single-image
    file) whose chunks (ALPH and VP8, or VP8L) it carries."""
    w, h = canvas
    anmf = []
    for x, y, data in frames:
        parts = [(t, p) for t, p in chunks_of(data) if t in (b"ALPH", b"VP8 ", b"VP8L")]
        fw, fh = _image_size(data)
        head = ((x // 2).to_bytes(3, "little") + (y // 2).to_bytes(3, "little") + (fw - 1).to_bytes(3, "little")
                + (fh - 1).to_bytes(3, "little") + (100).to_bytes(3, "little") + b"\x00")
        anmf.append(chunk(b"ANMF", head + b"".join(chunk(t, p) for t, p in parts)))
    return riff(vp8x(0x02 | (0x10 if alpha else 0), w, h), chunk(b"ANIM", struct.pack("<IH", 0, 0)), *anmf)


def _image_size(data: bytes) -> tuple[int, int]:
    tag, p = image_chunk(data)
    if tag == b"VP8L":
        v = int.from_bytes(p[1:5], "little")
        return (v & 0x3FFF) + 1, ((v >> 14) & 0x3FFF) + 1
    return struct.unpack_from("<H", p, 6)[0] & 0x3FFF, struct.unpack_from("<H", p, 8)[0] & 0x3FFF


# ---------------------------------------------------------------- VP8 first-partition rewriter


def _cpp_table(name: str) -> list[int]:
    body = re.search(name + r"\[[^\]]*\] = \{([^}]*)\}", CPP.read_text()).group(1)
    return [int(v) for v in body.replace("\n", " ").split(",") if v.strip()]


class BoolDecoder:
    """RFC 6386's boolean decoder, recording every (probability, bit)."""

    def __init__(self, data: bytes):
        self.data, self.pos = data, 2
        self.value = (data[0] << 8) | data[1]
        self.range, self.bit_count = 255, 0
        self.events: list[tuple[int, int]] = []

    def get(self, prob: int) -> int:
        split = 1 + (((self.range - 1) * prob) >> 8)
        big = split << 8
        if self.value >= big:
            self.range -= split
            self.value -= big
            bit = 1
        else:
            self.range = split
            bit = 0
        while self.range < 128:
            self.value <<= 1
            self.range <<= 1
            self.bit_count += 1
            if self.bit_count == 8:
                self.bit_count = 0
                self.value |= self.data[self.pos] if self.pos < len(self.data) else 0
                self.pos += 1
        self.events.append((prob, bit))
        return bit

    def literal(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.get(128)
        return v

    def signed(self, n: int) -> int:
        v = self.literal(n)
        return -v if self.get(128) else v


class BoolEncoder:
    """RFC 6386's boolean encoder."""

    def __init__(self):
        self.out = bytearray()
        self.range, self.bottom, self.bit_count = 255, 0, 24

    def _carry(self):
        i = len(self.out) - 1
        while self.out[i] == 255:
            self.out[i] = 0
            i -= 1
        self.out[i] += 1

    def put(self, prob: int, bit: int) -> None:
        split = 1 + (((self.range - 1) * prob) >> 8)
        if bit:
            self.bottom += split
            self.range -= split
        else:
            self.range = split
        while self.range < 128:
            self.range <<= 1
            if self.bottom & (1 << 31):
                self._carry()
            self.bottom = (self.bottom << 1) & 0xFFFFFFFF
            self.bit_count -= 1
            if not self.bit_count:
                self.out.append((self.bottom >> 24) & 0xFF)
                self.bottom &= (1 << 24) - 1
                self.bit_count = 8

    def literal(self, v: int, n: int) -> None:
        for b in range(n - 1, -1, -1):
            self.put(128, (v >> b) & 1)

    def flush(self) -> bytes:
        c, v = self.bit_count, self.bottom
        if v & (1 << (32 - c)):
            self._carry()
        v = (v << (c & 7)) & 0xFFFFFFFF
        for _ in range(c >> 3):
            v = (v << 8) & 0xFFFFFFFF
        for _ in range(4):
            self.out.append((v >> 24) & 0xFF)
            v = (v << 8) & 0xFFFFFFFF
        return bytes(self.out)


_YMODES4 = (-0, 1, -1, 2, -2, 3, 4, 6, -3, 5, -4, -5, -6, 7, -7, 8, -8, -9)  # libwebp's tree and mode order


def parse_first_partition(part: bytes, mb_w: int, mb_h: int) -> tuple[BoolDecoder, dict]:
    """Decode a key frame's first partition; return the decoder (its
    events) and the event indices where the segment header, the filter
    header and the rest begin."""
    update_probs, bmode_probs = _cpp_table("kCoeffsUpdateProba"), _cpp_table("kBModesProba")
    d = BoolDecoder(part)
    d.get(128), d.get(128)  # colour space, clamping
    marks = {"segment": len(d.events)}
    update_map = 0
    if d.get(128):
        update_map = d.get(128)
        if d.get(128):
            d.get(128)
            for _ in range(4):
                if d.get(128):
                    d.signed(7)
            for _ in range(4):
                if d.get(128):
                    d.signed(6)
        seg_probs = [d.literal(8) if d.get(128) else 255 for _ in range(3)] if update_map else []
    marks["filter"] = len(d.events)
    d.get(128), d.literal(6), d.literal(3)
    marks["lf_delta"] = len(d.events)
    if d.get(128) and d.get(128):
        for _ in range(8):
            if d.get(128):
                d.signed(6)
    marks["partitions"] = len(d.events)
    d.literal(2)
    d.literal(7)
    for _ in range(5):
        if d.get(128):
            d.signed(4)
    d.get(128)
    for p in update_probs:
        if d.get(p):
            d.literal(8)
    skip_p = d.literal(8) if d.get(128) else None
    marks["modes"] = len(d.events)
    intra_t = [0] * (4 * mb_w)
    mb_segments = []
    for _ in range(mb_h):
        intra_l = [0] * 4
        for mb_x in range(mb_w):
            if update_map:
                mb_segments.append(len(d.events))
                (d.get(seg_probs[1]) if not d.get(seg_probs[0]) else d.get(seg_probs[2]))
            if skip_p is not None:
                d.get(skip_p)
            if d.get(145):  # 16x16
                ymode = (1 if d.get(128) else 3) if d.get(156) else (2 if d.get(163) else 0)
                intra_t[4 * mb_x: 4 * mb_x + 4] = [ymode] * 4
                intra_l = [ymode] * 4
            else:
                for y in range(4):
                    ymode = intra_l[y]
                    for x in range(4):
                        prob = bmode_probs[(intra_t[4 * mb_x + x] * 10 + ymode) * 9:][:9]
                        i = _YMODES4[d.get(prob[0])]
                        while i > 0:
                            i = _YMODES4[2 * i + d.get(prob[i])]
                        ymode = -i
                        intra_t[4 * mb_x + x] = ymode
                    intra_l[y] = ymode
            if d.get(142) and d.get(114):
                d.get(183)
    marks["segment_ids"] = mb_segments
    marks["end"] = len(d.events)
    return d, marks


def rewrite_vp8(data: bytes, *, simple: int | None = None, level: int | None = None, sharpness: int | None = None,
                ref_deltas=None, mode_deltas=None, drop_segments: bool = False) -> bytes:
    """A single-image lossy file with its VP8 frame header changed (module
    note); the token partitions are kept as they are."""
    vp8 = image_chunk(data)[1]
    first_len = (vp8[0] | (vp8[1] << 8) | (vp8[2] << 16)) >> 5
    w, h = struct.unpack_from("<H", vp8, 6)[0] & 0x3FFF, struct.unpack_from("<H", vp8, 8)[0] & 0x3FFF
    part0, rest = vp8[10: 10 + first_len], vp8[10 + first_len:]
    d, m = parse_first_partition(part0, (w + 15) >> 4, (h + 15) >> 4)
    ev = d.events
    e = BoolEncoder()

    def put_events(lo, hi, skip=()):
        for i in range(lo, hi):
            if i not in skip:
                e.put(*ev[i])

    put_events(0, m["segment"])
    if drop_segments:
        e.put(128, 0)
    else:
        put_events(m["segment"], m["filter"])
    old_simple = ev[m["filter"]][1]
    old_level = int("".join(str(b) for _, b in ev[m["filter"] + 1: m["filter"] + 7]), 2)
    old_sharp = int("".join(str(b) for _, b in ev[m["filter"] + 7: m["filter"] + 10]), 2)
    e.put(128, old_simple if simple is None else simple)
    e.literal(old_level if level is None else level, 6)
    e.literal(old_sharp if sharpness is None else sharpness, 3)
    if ref_deltas is None and mode_deltas is None:
        put_events(m["lf_delta"], m["partitions"])
    else:
        e.put(128, 1)
        e.put(128, 1)
        for v in list(ref_deltas) + list(mode_deltas):
            e.put(128, 1)
            e.literal(abs(v), 6)
            e.put(128, int(v < 0))
    skip = set()
    if drop_segments:  # the per-macroblock segment ids go with the map
        for i in m["segment_ids"]:
            skip.update((i, i + 1))
    put_events(m["partitions"], m["end"], skip)
    new0 = e.flush()
    tag = ((len(new0) << 5) | (vp8[0] & 0x1F)).to_bytes(3, "little")
    frame = tag + vp8[3:10] + new0 + rest
    return riff(chunk(b"VP8 ", frame))


# ---------------------------------------------------------------- libwebp's own encoder


def libwebp_encode(img: np.ndarray, **opts) -> bytes:
    """WebPEncode of Pillow's libwebp, with WebPConfig fields `opts` (by
    name, for the options Pillow's save does not pass)."""
    import PIL

    libs = Path(PIL.__file__).resolve().parent.parent / "pillow.libs"
    for dep in sorted(glob.glob(str(libs / "libsharpyuv-*.so*"))):
        ctypes.CDLL(dep, mode=ctypes.RTLD_GLOBAL)
    lib = ctypes.CDLL(sorted(glob.glob(str(libs / "libwebp-*.so*")))[0])
    fields = ["lossless", "quality", "method", "image_hint", "target_size", "target_PSNR", "segments",
              "sns_strength", "filter_strength", "filter_sharpness", "filter_type", "autofilter",
              "alpha_compression", "alpha_filtering", "alpha_quality", "pass", "show_compressed", "preprocessing",
              "partitions"]
    abi = 0x0210
    cfg = (ctypes.c_int32 * 64)()
    if not lib.WebPConfigInitInternal(cfg, 0, ctypes.c_float(75.0), abi):
        raise RuntimeError("WebPConfigInit failed")
    for k, v in opts.items():
        i = fields.index(k)
        if k in ("quality", "target_PSNR"):
            ctypes.cast(ctypes.byref(cfg, 4 * i), ctypes.POINTER(ctypes.c_float))[0] = float(v)
        else:
            cfg[i] = int(v)
    if not lib.WebPValidateConfig(cfg):
        raise ValueError(f"libwebp refuses {opts}")

    class MemoryWriter(ctypes.Structure):
        _fields_ = [("mem", ctypes.c_void_p), ("size", ctypes.c_size_t), ("max_size", ctypes.c_size_t),
                    ("pad", ctypes.c_uint32)]

    pic = (ctypes.c_uint8 * 512)()  # WebPPicture: width at byte 8, height 12, writer 96, custom_ptr 104
    if not lib.WebPPictureInitInternal(pic, abi):
        raise RuntimeError("WebPPictureInit failed")
    h, w, c = img.shape
    ints = ctypes.cast(pic, ctypes.POINTER(ctypes.c_int32))
    ints[2], ints[3] = w, h
    img = np.ascontiguousarray(img)
    imp = lib.WebPPictureImportRGBA if c == 4 else lib.WebPPictureImportRGB
    if not imp(pic, img.ctypes.data_as(ctypes.c_void_p), w * c):
        raise RuntimeError("WebPPictureImport failed")
    wr = MemoryWriter()
    lib.WebPMemoryWriterInit(ctypes.byref(wr))
    ptrs = ctypes.cast(pic, ctypes.POINTER(ctypes.c_void_p))
    ptrs[12] = ctypes.cast(lib.WebPMemoryWrite, ctypes.c_void_p).value
    ptrs[13] = ctypes.addressof(wr)
    ok = lib.WebPEncode(cfg, pic)
    lib.WebPPictureFree(pic)
    out = ctypes.string_at(wr.mem, wr.size)
    lib.WebPMemoryWriterClear(ctypes.byref(wr))
    if not ok:
        raise RuntimeError("WebPEncode failed")
    return out


def vp8_header(data: bytes) -> dict:
    """The frame-header fields of a lossy file's VP8 stream that the
    fixtures vary (the check that each fixture has what its name says)."""
    vp8 = image_chunk(data)[1]
    first_len = (vp8[0] | (vp8[1] << 8) | (vp8[2] << 16)) >> 5
    w, h = struct.unpack_from("<H", vp8, 6)[0] & 0x3FFF, struct.unpack_from("<H", vp8, 8)[0] & 0x3FFF
    d, m = parse_first_partition(vp8[10: 10 + first_len], (w + 15) >> 4, (h + 15) >> 4)
    bits = [b for _, b in d.events]
    f = m["filter"]
    return {"segments": bits[m["segment"]], "simple": bits[f], "level": int("".join(map(str, bits[f + 1: f + 7])), 2),
            "sharpness": int("".join(map(str, bits[f + 7: f + 10])), 2), "lf_delta": bits[m["lf_delta"]],
            "partitions": 1 << int("".join(map(str, bits[m["partitions"]: m["partitions"] + 2])), 2)}


# ---------------------------------------------------------------- the fixtures


def _rgba(h, w, seed):
    return np.concatenate([photo(h, w, seed), alpha_plane(h, w, seed)[..., None]], -1)


def _transparent(h, w, seed):
    """RGBA whose outer half is fully transparent over coloured noise, which
    `exact` keeps."""
    img = _rgba(h, w, seed)
    img[..., 3] = np.where(img[..., 3] < 128, 0, img[..., 3])
    return img


def _mixed(n, seed):
    """Quadrants of noise, a photo, posterised and green-free content: the
    lossless encoder then picks several prefix-code groups (a meta image)
    and most predictor modes."""
    rng = np.random.default_rng(seed)
    a = photo(n, n, seed, noise=3)
    a[: n // 2, : n // 2] = rng.integers(0, 256, (n // 2, n // 2, 3))
    a[n // 2:, : n // 2] = (a[n // 2:, : n // 2] // 64) * 64
    a[: n // 2, n // 2:, 1] = 0
    return a


def _few_colours(h, w, n, seed, channels=3):
    rng = np.random.default_rng(seed)
    pal = rng.integers(0, 256, (n, channels), dtype=np.uint8)
    y, x = np.mgrid[0:h, 0:w]
    return pal[((x // 3 + y // 5 + rng.integers(0, 2, (h, w))) % n)]


def _two_frames():
    from PIL import Image

    frames = [Image.fromarray(photo(36, 44, s)) for s in (50, 51)]
    buf = io.BytesIO()
    frames[0].save(buf, format="WEBP", save_all=True, append_images=frames[1:], duration=100, quality=75)
    return buf.getvalue()


def _meta():
    from PIL import Image

    exif = Image.Exif()
    exif[0x0112] = 6  # an orientation, which PIL does not apply
    exif[0x010F] = "acezero"
    return pil_webp(photo(40, 56, 60), icc_profile=b"\x00" * 128 + b"acsp" + bytes(124), exif=exif.tobytes(),
                    xmp=b"<x:xmpmeta xmlns:x='adobe:ns:meta/'></x:xmpmeta>")


FIXTURES = {
    "lossy_q1.webp": lambda: pil_webp(photo(48, 64, 1), quality=1),
    "lossy_q50.webp": lambda: pil_webp(photo(48, 64, 2), quality=50),
    "lossy_q80.webp": lambda: pil_webp(photo(48, 64, 3)),
    "lossy_q100.webp": lambda: pil_webp(photo(48, 64, 4), quality=100),
    "lossy_m0.webp": lambda: pil_webp(photo(40, 48, 5), method=0),
    "lossy_m6.webp": lambda: pil_webp(photo(40, 48, 6), method=6),
    "lossy_1x1.webp": lambda: pil_webp(photo(1, 1, 7)),
    "lossy_17x33.webp": lambda: pil_webp(photo(33, 17, 8)),
    "lossy_61x45.webp": lambda: pil_webp(photo(45, 61, 9), quality=90),
    "lossy_from_l.webp": lambda: pil_webp(photo(30, 40, 10)[..., 0]),
    "lossy_from_p.webp": lambda: pil_webp(photo(30, 40, 11), mode="P"),
    "lossy_rgba_aq100.webp": lambda: pil_webp(_rgba(37, 51, 12), alpha_quality=100),
    "lossy_rgba_aq50.webp": lambda: pil_webp(_rgba(37, 51, 13), alpha_quality=50),
    **{f"alph_raw_filter{m}.webp": (lambda m=m: alph_raw(photo(27, 35, 14 + m), alpha_plane(27, 35, 14 + m), m))
       for m in range(4)},
    "lossless_rgb.webp": lambda: pil_webp(photo(40, 52, 20), lossless=True),
    "lossless_rgba.webp": lambda: pil_webp(_rgba(40, 52, 21), lossless=True),
    "lossless_16_colours.webp": lambda: pil_webp(_few_colours(35, 45, 16, 22), lossless=True),
    "lossless_4_colours.webp": lambda: pil_webp(_few_colours(29, 47, 4, 23), lossless=True),
    "lossless_2_colours_rgba.webp": lambda: pil_webp(_few_colours(23, 53, 2, 24, 4), lossless=True),
    "lossless_exact.webp": lambda: pil_webp(_transparent(30, 38, 25), lossless=True, exact=True),
    # libwebp's lossless encoder at methods Pillow does not reach: meta
    # prefix codes, the colour cache, subtract green, cross-colour, and
    # predictor modes 0-5 and 7-13 (mode 6 is in lossless_rgba.webp)
    "lossless_meta_m6.webp": lambda: libwebp_encode(_mixed(96, 3), lossless=1, method=6, quality=100),
    "lossless_meta_cache_m4.webp": lambda: libwebp_encode(_mixed(64, 3), lossless=1, method=4, quality=100),
    "vp8x_iccp_exif_xmp.webp": _meta,
    "anim_two_frames.webp": _two_frames,
    "anim_offset_first_frame.webp": lambda: anim_bytes(
        (48, 40), [(6, 4, pil_webp(_rgba(21, 30, 30), quality=80)), (0, 0, pil_webp(photo(40, 48, 31), lossless=True))],
        alpha=True),
    "vp8_simple_filter.webp": lambda: rewrite_vp8(pil_webp(photo(48, 64, 40), quality=60), simple=1),
    "vp8_filter_level0.webp": lambda: rewrite_vp8(pil_webp(photo(48, 64, 41), quality=60), level=0),
    "vp8_sharpness5.webp": lambda: rewrite_vp8(pil_webp(photo(48, 64, 42), quality=60), sharpness=5, level=40),
    "vp8_lf_deltas.webp": lambda: rewrite_vp8(pil_webp(photo(48, 64, 43), quality=60), ref_deltas=(9, -3, 2, 1),
                                              mode_deltas=(-12, 4, 0, 7)),
    "vp8_no_segments.webp": lambda: rewrite_vp8(pil_webp(photo(48, 64, 44), quality=60), drop_segments=True),
    **{f"vp8_partitions{1 << p}.webp": (lambda p=p: libwebp_encode(photo(80, 72, 45 + p), quality=70, method=2, partitions=p))
       for p in (1, 2, 3)},
    PHOTO: lambda: pil_webp(photo(768, 1024, 99, noise=5.0), quality=80),
}
# what each rewritten or re-encoded file's VP8 header must show
HEADERS = {
    "vp8_simple_filter.webp": {"simple": 1}, "vp8_filter_level0.webp": {"level": 0},
    "vp8_sharpness5.webp": {"sharpness": 5, "level": 40}, "vp8_lf_deltas.webp": {"lf_delta": 1},
    "vp8_no_segments.webp": {"segments": 0}, "lossy_q80.webp": {"segments": 1, "simple": 0, "lf_delta": 0},
    "vp8_partitions2.webp": {"partitions": 2}, "vp8_partitions4.webp": {"partitions": 4},
    "vp8_partitions8.webp": {"partitions": 8},
}


def digest(path) -> dict:
    from PIL import Image

    with Image.open(path) as im:
        arr = np.asarray(im)
        return {"size": list(im.size), "mode": im.mode, "shape": list(arr.shape),
                "sha256": chip_smoke.array_digest(arr)}


def main() -> None:
    OUT.mkdir(parents=True, exist_ok=True)
    for name, make in FIXTURES.items():
        data = make()
        (OUT / name).write_bytes(data)
        for k, v in HEADERS.get(name, {}).items():
            got = vp8_header(data)[k]
            if got != v:
                raise SystemExit(f"{name}: {k} is {got}, not {v}")
    digests = {"files": {name: digest(OUT / name) for name in sorted(FIXTURES)}}
    (OUT / "pil_digests.json").write_text(json.dumps(digests, indent=1, sort_keys=True) + "\n")
    total = sum(p.stat().st_size for p in OUT.iterdir())
    print(f"{len(FIXTURES)} fixtures, {total} bytes in {OUT}")


if __name__ == "__main__":
    main()
