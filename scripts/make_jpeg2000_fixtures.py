#!/usr/bin/env python3
"""Write the JPEG 2000 fixtures that hold the port's reader
(io/jpeg2000.py, io/csrc/jpeg2000.cpp) to PIL's where there is no PIL (the
card's machine): small files under tests/data/jpeg2000/, and
tests/data/jpeg2000/pil_digests.json with

- "files": for each fixture, what PIL makes of it: its mode, size, the
  shape, dtype and sha256 of `np.asarray(Image.open(path))`, the palette
  (`getpalette()` as chip_smoke.palette_digest gives it) and the sha256 of
  its `convert("RGB")`; or `"raises": true` where PIL's open or load raises;
- "canvas": for each of CANVAS_CHECKS, the digest (chip_smoke.canvas_digest)
  of the JAX package's decode_to_canvas over every fixture PIL decodes;
- "depth": for each of DEPTH, the sha256 of the JAX package's
  `load_depth_file` (float64).

    JAX_PLATFORMS=cpu python3 scripts/make_jpeg2000_fixtures.py

Pillow's save writes most of them (`_pil_kinds`): every mode it saves,
reversible and irreversible, 1-7 resolutions, code-blocks of 4 x 4, 16 x 64
and 64 x 64, precincts, tiles with tile and image offsets, three quality
layers, the five progressions, the component transform on and off, signed
samples, PLT and COM markers, a bare codestream. The rest are Pillow's
codestreams edited (`Codestream`, `jp2`): other precisions in SIZ, JP2
boxes that Pillow does not write (sYCC and unknown colour spaces, an ICC
profile, palettes of RGB and RGBA colours with and without alpha, an
`ihdr` larger than the codestream, XL and open-ended boxes, boxes around
the header), TLM, PLM and CRG markers, tile-parts split and interleaved,
an open-ended last tile-part, coding and quantisation parameters in COC,
QCC and tile-part headers that override the main header's. The photo-size
file PHOTO (chip_smoke.JPEG_PHOTO_HW, irreversible, one quality layer
chosen to fit 1.5 MB) is timed on the card.

tests/test_torch_jpeg2000.py checks the digests against PIL and the JAX
package on every run, so the file cannot go stale; chip_smoke.py's phase
formats checks the port against them on the card.
"""

from __future__ import annotations

import io
import json
import struct
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

OUT = chip_smoke.JPEG2000_FIXTURES
PHOTO = chip_smoke.JPEG2000_PHOTO
PHOTO_MAX_BYTES = 1_500_000

# ---------------------------------------------------------------- images


def image(h: int, w: int, channels: int, seed: int, bits: int = 8) -> np.ndarray:
    """A smooth pattern with noise, (h, w) or (h, w, c), uint8 or uint16."""
    rng = np.random.default_rng(seed)
    hi = (1 << bits) - 1
    yy, xx = np.mgrid[:h, :w].astype(np.float64)
    chans = [(np.sin(xx / 5.0 + k) * 0.25 + np.cos(yy / 7.0 - k) * 0.2 + 0.5) * hi
             + rng.normal(0, hi * 0.015, (h, w)) for k in range(channels)]
    out = np.clip(np.stack(chans, -1), 0, hi).astype(np.uint16 if bits > 8 else np.uint8)
    return out[..., 0] if channels == 1 else out


def pil_image(mode: str, h: int = 48, w: int = 64, seed: int = 0):
    from PIL import Image

    nc = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4, "CMYK": 4, "YCbCr": 3, "I;16": 1}[mode]
    a = image(h, w, nc, seed, 16 if mode == "I;16" else 8)
    return Image.frombytes(mode, (w, h), a.tobytes())


def pil_save(img, **opts) -> bytes:
    buf = io.BytesIO()
    img.save(buf, format="JPEG2000", **opts)
    return buf.getvalue()


def codestream_of(img, **opts) -> bytes:
    return pil_save(img, no_jp2=True, **opts)


# ---------------------------------------------------------------- editing


def box(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", 8 + len(body)) + kind + body


def ihdr(h: int, w: int, nc: int, bpc: int) -> bytes:
    return box(b"ihdr", struct.pack(">IIHBBBB", h, w, nc, bpc, 7, 0, 0))


def colr(enumcs: int) -> bytes:
    return box(b"colr", struct.pack(">BBBI", 1, 0, 0, enumcs))


def pclr(colours: np.ndarray, depth: int = 7) -> bytes:
    """A palette box of n colours of c columns, 8-bit entries."""
    n, c = colours.shape
    return box(b"pclr", struct.pack(">HB", n, c) + bytes([depth] * c) + colours.astype(np.uint8).tobytes())


def cmap(columns: int, direct: int = 0) -> bytes:
    """Component 0 through the palette's columns, then `direct` components
    mapped as they are."""
    body = b"".join(struct.pack(">HBB", 0, 1, i) for i in range(columns))
    body += b"".join(struct.pack(">HBB", 1 + i, 0, 0) for i in range(direct))
    return box(b"cmap", body)


def jp2(codestream: bytes, header: bytes, before: bytes = b"", after: bytes = b"", brand: bytes = b"jp2 ",
        jp2c: bytes | None = None) -> bytes:
    """A JP2 file: signature, file type, `before`, the header box of
    `header`'s boxes, the codestream box (or `jp2c` whole), `after`."""
    ftyp = box(b"ftyp", brand + b"\0\0\0\0" + b"jp2 ")
    return (b"\x00\x00\x00\x0cjP  \x0d\x0a\x87\x0a" + ftyp + before + box(b"jp2h", header)
            + (box(b"jp2c", codestream) if jp2c is None else jp2c) + after)


class Codestream:
    """A codestream cut into its main header's marker segments and its
    tile-parts (the SOT fields, the header's segments, the data)."""

    def __init__(self, data: bytes):
        assert data[:2] == b"\xff\x4f"
        pos = 2
        self.main: list[tuple[int, bytes]] = []
        while True:
            m = struct.unpack_from(">H", data, pos)[0]
            if m == 0xFF90:
                break
            n = struct.unpack_from(">H", data, pos + 2)[0]
            self.main.append((m, data[pos + 4: pos + 2 + n]))
            pos += 2 + n
        self.parts: list[dict] = []
        while struct.unpack_from(">H", data, pos)[0] == 0xFF90:
            isot, psot, tpsot, tnsot = struct.unpack_from(">HIBB", data, pos + 4)
            end = pos + psot
            p = pos + 12
            segs = []
            while struct.unpack_from(">H", data, p)[0] != 0xFF93:
                m, n = struct.unpack_from(">HH", data, p)
                segs.append((m, data[p + 4: p + 2 + n]))
                p += 2 + n
            self.parts.append({"tile": isot, "tp": tpsot, "tn": tnsot, "segs": segs, "data": data[p + 2: end]})
            pos = end
        assert data[pos:] == b"\xff\xd9", data[pos:]

    def segment(self, marker: int) -> bytes:
        return next(b for m, b in self.main if m == marker)

    def replace(self, marker: int, body: bytes) -> None:
        self.main = [(m, body if m == marker else b) for m, b in self.main]

    def insert(self, marker: int, body: bytes, after: int = 0xFF51) -> None:
        i = next(i for i, (m, _) in enumerate(self.main) if m == after)
        self.main.insert(i + 1, (marker, body))

    def bytes(self, open_last: bool = False) -> bytes:
        out = bytearray(b"\xff\x4f")
        for m, b in self.main:
            out += struct.pack(">HH", m, len(b) + 2) + b
        for i, t in enumerate(self.parts):
            head = b"".join(struct.pack(">HH", m, len(b) + 2) + b for m, b in t["segs"])
            psot = 0 if open_last and i == len(self.parts) - 1 else 12 + len(head) + 2 + len(t["data"])
            out += struct.pack(">HHHIBB", 0xFF90, 10, t["tile"], psot, t["tp"], t["tn"]) + head + b"\xff\x93"
            out += t["data"]
        return bytes(out + b"\xff\xd9")


def siz_precision(cs: bytes, bits: int, signed: bool = False) -> bytes:
    """The codestream with every component's SIZ precision set to `bits`."""
    c = Codestream(cs)
    siz = bytearray(c.segment(0xFF51))
    for k in range(struct.unpack_from(">H", siz, 34)[0]):
        siz[36 + 3 * k] = (bits - 1) | (0x80 if signed else 0)
    c.replace(0xFF51, bytes(siz))
    return c.bytes()


def plt_lengths(segs) -> list[int]:
    """The packet lengths of a tile-part's PLT segments."""
    out, v = [], 0
    for m, b in segs:
        if m != 0xFF58:
            continue
        for byte in b[1:]:
            v = (v << 7) | (byte & 0x7F)
            if not byte & 0x80:
                out.append(v)
                v = 0
    return out


def split_tile_parts(cs: bytes, interleave: bool) -> bytes:
    """Each tile's one tile-part (written with PLT) cut in two at a packet
    boundary: TNsot 2; with `interleave` every tile's first part before any
    second part."""
    c = Codestream(cs)
    firsts, seconds = [], []
    for t in c.parts:
        lengths = plt_lengths(t["segs"])
        cut = sum(lengths[: len(lengths) // 2])
        firsts.append({"tile": t["tile"], "tp": 0, "tn": 2, "segs": [], "data": t["data"][:cut]})
        seconds.append({"tile": t["tile"], "tp": 1, "tn": 2, "segs": [], "data": t["data"][cut:]})
    c.parts = firsts + seconds if interleave else [p for pair in zip(firsts, seconds) for p in pair]
    return c.bytes()


def with_tlm(cs: bytes) -> bytes:
    """A TLM marker segment (8-bit tile indices, 32-bit lengths) listing
    every tile-part."""
    c = Codestream(cs)
    body = bytes([0, 0x50])
    for t in c.parts:
        head = sum(4 + len(b) for _, b in t["segs"])
        body += struct.pack(">BI", t["tile"], 12 + head + 2 + len(t["data"]))
    c.insert(0xFF55, body, after=0xFF5C)
    return c.bytes()


def with_plm_crg(cs: bytes) -> bytes:
    c = Codestream(cs)
    nc = struct.unpack_from(">H", c.segment(0xFF51), 34)[0]
    c.insert(0xFF63, b"".join(struct.pack(">HH", 0, 0) for _ in range(nc)), after=0xFF5C)
    c.insert(0xFF57, bytes([0, 3, 5, 7, 9]), after=0xFF5C)
    return c.bytes()


def tile_headers_override(cs: bytes) -> bytes:
    """The main COD with another code-block size and the main QCD with other
    step sizes; each tile's first tile-part header carries the true ones."""
    c = Codestream(cs)
    cod, qcd = c.segment(0xFF52), c.segment(0xFF5C)
    for t in c.parts:
        t["segs"] = [(0xFF52, cod), (0xFF5C, qcd)] + t["segs"]
    bad_cod = bytearray(cod)
    bad_cod[6], bad_cod[7] = 2, 2
    c.replace(0xFF52, bytes(bad_cod))
    c.replace(0xFF5C, bytes([qcd[0]]) + bytes(len(qcd) - 1))
    return c.bytes()


def coc_qcc_override(cs: bytes) -> bytes:
    """The main COD and QCD spoiled, every component's true parameters in a
    COC and a QCC."""
    c = Codestream(cs)
    cod, qcd = c.segment(0xFF52), c.segment(0xFF5C)
    nc = struct.unpack_from(">H", c.segment(0xFF51), 34)[0]
    bad_cod = bytearray(cod)
    bad_cod[6], bad_cod[7] = 2, 2
    c.replace(0xFF52, bytes(bad_cod))
    c.replace(0xFF5C, bytes([qcd[0]]) + bytes(len(qcd) - 1))
    for k in reversed(range(nc)):
        c.insert(0xFF5D, bytes([k]) + qcd, after=0xFF5C)
        c.insert(0xFF53, bytes([k, cod[0] & 1]) + cod[5:], after=0xFF5C)
    return c.bytes()


# ---------------------------------------------------------------- the fixtures


def _pil_kinds() -> dict:
    kinds = {}
    for mode in ("L", "LA", "RGB", "RGBA", "CMYK", "I;16", "YCbCr"):
        name = mode.replace(";", "").lower()
        for irr in (False, True):
            tag = "97" if irr else "53"
            kinds[f"pil_{name}_{tag}.jp2"] = (lambda m=mode, i=irr: pil_save(pil_image(m, seed=1), irreversible=i))
        kinds[f"pil_{name}_53.j2k"] = (lambda m=mode: codestream_of(pil_image(m, seed=2)))
    rgb = pil_image("RGB", seed=3)
    for r in range(1, 7):
        kinds[f"res{r}_53.jp2"] = (lambda r=r: pil_save(rgb, num_resolutions=r))
        kinds[f"res{r}_97.jp2"] = (lambda r=r: pil_save(rgb, num_resolutions=r, irreversible=True))
    kinds["res7_97.jp2"] = lambda: pil_save(pil_image("L", 64, 64, seed=4), num_resolutions=7, irreversible=True)
    for cb in ((4, 4), (16, 64), (64, 64)):
        kinds[f"codeblock_{cb[0]}x{cb[1]}.jp2"] = (lambda cb=cb: pil_save(rgb, codeblock_size=cb))
        kinds[f"codeblock_{cb[0]}x{cb[1]}_97.jp2"] = (lambda cb=cb: pil_save(rgb, codeblock_size=cb,
                                                                             irreversible=True))
    for prog in ("LRCP", "RLCP", "RPCL", "PCRL", "CPRL"):
        kinds[f"prog_{prog.lower()}_layers3.jp2"] = (lambda p=prog: pil_save(
            rgb, progression=p, quality_layers=[30, 10, 1], precinct_size=(32, 32)))
        kinds[f"prog_{prog.lower()}_layers3_97.j2k"] = (lambda p=prog: codestream_of(
            rgb, progression=p, quality_layers=[40, 20, 8], irreversible=True, precinct_size=(32, 64)))
    kinds["precincts_16x16_res4.jp2"] = lambda: pil_save(rgb, precinct_size=(16, 16), num_resolutions=4)
    # openjpeg halves the precincts at each lower resolution down to 1 x 1,
    # which its decoder refuses: PIL cannot read this file of its own
    kinds["precincts_16x16_res6.jp2"] = lambda: pil_save(rgb, precinct_size=(16, 16))
    kinds["tiles_offsets.jp2"] = lambda: pil_save(rgb, tile_size=(20, 13), tile_offset=(3, 5), offset=(7, 9))
    kinds["tiles_offsets_97.j2k"] = lambda: codestream_of(rgb, tile_size=(32, 24), tile_offset=(1, 1), offset=(5, 2),
                                                          irreversible=True, num_resolutions=3)
    kinds["tiles_16x16_l.jp2"] = lambda: pil_save(pil_image("L", seed=5), tile_size=(16, 16))
    kinds["layers3_53.jp2"] = lambda: pil_save(rgb, quality_layers=[40, 20, 1])
    kinds["layers3_97_db.jp2"] = lambda: pil_save(rgb, quality_layers=[30, 40, 50], quality_mode="dB",
                                                  irreversible=True)
    kinds["mct_53.jp2"] = lambda: pil_save(rgb, mct=1)
    kinds["mct_97.jp2"] = lambda: pil_save(rgb, mct=1, irreversible=True)
    kinds["mct_97_rgba.j2k"] = lambda: codestream_of(pil_image("RGBA", seed=6), mct=1, irreversible=True)
    kinds["signed_l.jp2"] = lambda: pil_save(pil_image("L", seed=7), signed=True)
    kinds["signed_rgb_97.jp2"] = lambda: pil_save(rgb, signed=True, irreversible=True)
    kinds["signed_i16.j2k"] = lambda: codestream_of(pil_image("I;16", seed=8), signed=True)
    kinds["plt.jp2"] = lambda: pil_save(rgb, plt=True)
    kinds["comment.j2k"] = lambda: codestream_of(rgb, comment="written by scripts/make_jpeg2000_fixtures.py")
    kinds["no_jp2_option.jp2"] = lambda: pil_save(rgb, no_jp2=True)
    for h, w in ((1, 1), (1, 13), (13, 1), (3, 2), (17, 33)):
        kinds[f"size_{h}x{w}.jp2"] = (lambda h=h, w=w: pil_save(pil_image("RGB", h, w, seed=9), num_resolutions=1))
        kinds[f"size_{h}x{w}_97.j2k"] = (lambda h=h, w=w: codestream_of(
            pil_image("RGB", h, w, seed=10), irreversible=True, num_resolutions=2 if min(h, w) > 1 else 1))
    return kinds


def _edited_kinds() -> dict:
    gray = codestream_of(pil_image("L", seed=11))
    gray97 = codestream_of(pil_image("L", seed=12), irreversible=True)
    rgb = codestream_of(pil_image("RGB", seed=13))
    la = codestream_of(pil_image("LA", seed=14))
    tiled = codestream_of(pil_image("RGB", seed=15), tile_size=(24, 16), plt=True)
    tiled97 = codestream_of(pil_image("RGB", seed=16), tile_size=(24, 20), irreversible=True, num_resolutions=3)
    pal = np.random.default_rng(17).integers(0, 256, (256, 3)).astype(np.uint8)
    pal_rgba = np.concatenate([pal, np.random.default_rng(18).integers(0, 256, (256, 1)).astype(np.uint8)], 1)
    dup = pal.copy()
    dup[100:] = dup[:156]  # repeated colours: ImagePalette.getcolor keeps the first of each
    kinds = {}
    for bits in (1, 4, 9, 12):
        kinds[f"precision_{bits}.j2k"] = (lambda b=bits: siz_precision(gray, b))
        kinds[f"precision_{bits}.jp2"] = (lambda b=bits: jp2(siz_precision(gray, b), ihdr(48, 64, 1, b - 1) + colr(17)))
    kinds["precision_10_97.jp2"] = lambda: jp2(siz_precision(gray97, 10), ihdr(48, 64, 1, 9) + colr(17))
    kinds["precision_9_signed.j2k"] = lambda: siz_precision(gray, 9, signed=True)
    kinds["precision_16_as_l.jp2"] = lambda: jp2(siz_precision(gray, 16), ihdr(48, 64, 1, 7) + colr(17))
    kinds["palette_rgb.jp2"] = lambda: jp2(gray, ihdr(48, 64, 1, 7) + colr(16) + pclr(pal) + cmap(3))
    kinds["palette_rgba.jp2"] = lambda: jp2(gray, ihdr(48, 64, 1, 7) + colr(16) + pclr(pal_rgba) + cmap(4))
    kinds["palette_repeated_colours.jp2"] = lambda: jp2(gray, ihdr(48, 64, 1, 7) + colr(16) + pclr(dup) + cmap(3))
    kinds["palette_alpha.jp2"] = lambda: jp2(la, ihdr(48, 64, 2, 7) + colr(16) + pclr(pal) + cmap(3, direct=1))
    kinds["palette_16bit_columns.jp2"] = lambda: jp2(gray, ihdr(48, 64, 1, 7) + colr(16) + box(
        b"pclr", struct.pack(">HB", 4, 3) + bytes([15] * 3) + bytes(24)) + cmap(3))
    kinds["palette_gray_colr.jp2"] = lambda: jp2(gray, ihdr(48, 64, 1, 7) + colr(17) + pclr(pal) + cmap(3))
    kinds["sycc_colr.jp2"] = lambda: jp2(rgb, ihdr(48, 64, 3, 7) + colr(18))
    kinds["cmyk_colr_4_components.jp2"] = lambda: jp2(codestream_of(pil_image("RGBA", seed=19)),
                                                      ihdr(48, 64, 4, 7) + colr(12))
    kinds["unknown_colr.jp2"] = lambda: jp2(rgb, ihdr(48, 64, 3, 7) + colr(20))
    kinds["eycc_colr.jp2"] = lambda: jp2(rgb, ihdr(48, 64, 3, 7) + colr(24))
    kinds["cmyk_colr_3_components.jp2"] = lambda: jp2(rgb, ihdr(48, 64, 3, 7) + colr(12))
    kinds["gray_colr_1_component_rgba.jp2"] = lambda: jp2(gray, ihdr(48, 64, 4, 7) + colr(17))
    kinds["icc_colr.jp2"] = lambda: jp2(rgb, ihdr(48, 64, 3, 7) + box(b"colr", bytes([2, 0, 0]) + bytes(64)))
    kinds["no_colr.jp2"] = lambda: jp2(rgb, ihdr(48, 64, 3, 7))
    kinds["two_colr_boxes.jp2"] = lambda: jp2(rgb, ihdr(48, 64, 3, 7) + colr(16) + colr(17))
    kinds["ihdr_larger.jp2"] = lambda: jp2(rgb, ihdr(53, 70, 3, 7) + colr(16))
    kinds["ihdr_smaller.jp2"] = lambda: jp2(rgb, ihdr(40, 64, 3, 7) + colr(16))
    kinds["ihdr_three_components_gray.jp2"] = lambda: jp2(gray, ihdr(48, 64, 3, 7) + colr(17))
    kinds["res_box.jp2"] = lambda: jp2(rgb, ihdr(48, 64, 3, 7) + colr(16) + box(
        b"res ", box(b"resc", struct.pack(">HHHHBB", 72, 1, 72, 1, 0, 0))))
    kinds["boxes_around.jp2"] = lambda: jp2(rgb, ihdr(48, 64, 3, 7) + colr(16), before=box(b"xml ", b"<a/>"),
                                            after=box(b"uuid", bytes(20)), brand=b"jpx ")
    kinds["jp2c_xl_box.jp2"] = lambda: jp2(rgb, ihdr(48, 64, 3, 7) + colr(16), jp2c=struct.pack(
        ">I4sQ", 1, b"jp2c", 16 + len(rgb)) + rgb)
    kinds["jp2c_open_ended.jp2"] = lambda: jp2(rgb, ihdr(48, 64, 3, 7) + colr(16), jp2c=struct.pack(
        ">I4s", 0, b"jp2c") + rgb)
    kinds["tlm.j2k"] = lambda: with_tlm(tiled)
    kinds["plm_crg.j2k"] = lambda: with_plm_crg(rgb)
    kinds["tile_parts_split.j2k"] = lambda: split_tile_parts(tiled, interleave=False)
    kinds["tile_parts_interleaved.j2k"] = lambda: split_tile_parts(tiled, interleave=True)
    kinds["last_tile_part_open.j2k"] = lambda: Codestream(tiled97).bytes(open_last=True)
    kinds["tile_header_cod_qcd.j2k"] = lambda: tile_headers_override(tiled97)
    kinds["coc_qcc.j2k"] = lambda: coc_qcc_override(tiled97)
    return kinds


def _fixtures() -> dict:
    return {**_pil_kinds(), **_edited_kinds()}


FIXTURES = _fixtures()
# the fixtures the depth check reads (I;16 millimetres, 8-bit, a palette's indices)
DEPTH = ("pil_i16_53.jp2", "pil_i16_53.j2k", "pil_l_53.jp2", "pil_l_97.jp2", "precision_12.j2k",
         "palette_rgb.jp2")
# decode_to_canvas over every fixture PIL decodes: (short side, explicit canvas or None)
CANVAS_CHECKS = ((40, None), (24, (16, 24)))


def photo_bytes() -> bytes:
    """The photo-size file: the first chesslike frame enlarged to
    JPEG_PHOTO_HW and tinted (as phase formats makes its photo frames),
    saved by PIL irreversibly at the fewest bytes a layer of rate 40, 60,
    ... fits under PHOTO_MAX_BYTES."""
    from PIL import Image

    from acezero_tpu_torch.data.images import pil_resize_bilinear, read_png

    frame = sorted((chip_smoke.SCENE).glob(chip_smoke.FRAMES))[0]
    big = chip_smoke.tinted(np, pil_resize_bilinear(read_png(frame), *chip_smoke.JPEG_PHOTO_HW))
    for rate in (40, 60, 80, 120, 160):
        data = pil_save(Image.fromarray(big), irreversible=True, quality_layers=[rate])
        if len(data) <= PHOTO_MAX_BYTES:
            return data
    raise RuntimeError("no rate fits the photo under PHOTO_MAX_BYTES")


def palette_digest(palette) -> list | None:
    return chip_smoke.palette_digest(np, palette)


def digest(path: Path) -> dict:
    """What PIL makes of a file (module note)."""
    from PIL import Image

    try:
        with Image.open(path) as im:
            arr = np.asarray(im)
            return {"mode": im.mode, "size": list(im.size), "shape": list(arr.shape), "dtype": arr.dtype.str,
                    "sha256": chip_smoke.array_digest(arr), "palette": palette_digest(im.getpalette()),
                    "rgb_sha256": chip_smoke.array_digest(np.asarray(im.convert("RGB")))}
    except Exception:
        return {"raises": True}


def jax_canvas(paths: list[str], short_size: int, canvas_hw) -> str:
    from acezero_tpu.data import images as jimg

    return chip_smoke.canvas_digest(jimg.decode_to_canvas(paths, short_size=short_size, canvas_hw=canvas_hw,
                                                          num_workers=2))


def digests() -> dict:
    from acezero_tpu.data.depth import load_depth_file

    files = {name: digest(OUT / name) for name in sorted(FIXTURES)}
    paths = [str(OUT / n) for n in sorted(FIXTURES) if not files[n].get("raises")]
    canvas = [{"short_size": s, "canvas_hw": None if c is None else list(c), "sha256": jax_canvas(paths, s, c)}
              for s, c in CANVAS_CHECKS]
    depth = {name: chip_smoke.array_digest(load_depth_file(str(OUT / name))) for name in DEPTH}
    return {"files": files, "canvas": canvas, "depth": depth, "photo": digest(PHOTO)}


def main() -> None:
    OUT.mkdir(parents=True, exist_ok=True)
    for name, make in FIXTURES.items():
        (OUT / name).write_bytes(make())
    if "--keep_photo" not in sys.argv or not PHOTO.exists():
        PHOTO.write_bytes(photo_bytes())
    (OUT / "pil_digests.json").write_text(json.dumps(digests(), indent=1) + "\n")
    total = sum(p.stat().st_size for p in OUT.iterdir() if p != PHOTO)
    print(f"wrote {len(FIXTURES)} fixtures ({total} bytes), {PHOTO.name} ({PHOTO.stat().st_size} bytes) "
          f"and pil_digests.json to {OUT}")


if __name__ == "__main__":
    main()
