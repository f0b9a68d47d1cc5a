#!/usr/bin/env python3
"""Write the JPEG fixtures that hold the port's codec to PIL's bits where
there is no PIL (the card's machine): small JPEGs under tests/data/jpeg/,
one for each kind of file the decoder reads, and
tests/data/jpeg/pil_digests.json with

- "files": for each fixture, the shape and the sha256 of PIL's decoded
  array (`np.asarray(Image.open(path))`);
- "rgb": for each four-component fixture, the sha256 of PIL's
  `convert("RGB")`;
- "canvas": for each of CANVAS_CHECKS, the digest (chip_smoke.canvas_digest)
  of the JAX package's decode_to_canvas over every fixture;
- "roundtrip": for each of chip_smoke.JPEG_ROUNDTRIP's frames
  (chip_smoke.jpeg_roundtrip_frame), the sha256 of the bytes PIL writes at
  that quality and subsampling and of PIL's decode of them.

    python3 scripts/make_jpeg_fixtures.py

PIL writes the baseline, progressive and CMYK fixtures. It cannot write
the other kinds (luma 1 x 2 or 4 x 1, chroma above 1 x 1, YCCK, arithmetic
coding, lossless frames), so `encode` below writes them: a small numpy
writer whose files PIL decodes; their bytes are nobody's in particular. The
tests import it to make more such files.

tests/test_torch_jpeg.py checks the digests against PIL and the JAX package
on every run, so the file cannot go stale; chip_smoke.py's phase jpeg
checks the port against them on the card.
"""

from __future__ import annotations

import hashlib
import io
import json
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
from PIL import Image

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

OUT = chip_smoke.JPEG_FIXTURES
# name: (height, width, PIL mode, save options)
FIXTURES = {
    "gray_q75.jpg": (48, 64, "L", {"quality": 75}),
    "gray_progressive.jpg": (37, 53, "L", {"quality": 90, "progressive": True}),
    "rgb444_q95.jpg": (48, 64, "RGB", {"quality": 95, "subsampling": "4:4:4"}),
    "rgb422_q50.jpg": (37, 53, "RGB", {"quality": 50, "subsampling": "4:2:2"}),
    "rgb420_q75.jpg": (37, 53, "RGB", {"quality": 75, "subsampling": "4:2:0"}),
    "rgb420_q100.jpg": (48, 64, "RGB", {"quality": 100, "subsampling": "4:2:0"}),
    "rgb420_progressive.jpg": (37, 53, "RGB", {"quality": 90, "progressive": True}),
    "rgb444_progressive.jpg": (48, 64, "RGB", {"quality": 75, "subsampling": "4:4:4", "progressive": True}),
    "rgb420_optimize.jpg": (48, 64, "RGB", {"quality": 90, "optimize": True}),
    "rgb420_restart_blocks3.jpg": (37, 53, "RGB", {"quality": 75, "restart_marker_blocks": 3}),
    "rgb444_restart_rows1.jpg": (17, 33, "RGB", {"quality": 95, "subsampling": "4:4:4", "restart_marker_rows": 1}),
    "rgb420_7x9.jpg": (7, 9, "RGB", {"quality": 75}),
    "cmyk_q90.jpg": (37, 53, "CMYK", {"quality": 90}),
}


# ---------------------------------------------------------------- the writer

# ITU T.81 Table D.2: (Qe, Next_Index_LPS, Next_Index_MPS, Switch_MPS); entry
# 113 is the fixed bin of the sign and DC-refinement decisions
ARITAB = (
    (0x5A1D, 1, 1, 1), (0x2586, 14, 2, 0), (0x1114, 16, 3, 0), (0x080B, 18, 4, 0), (0x03D8, 20, 5, 0),
    (0x01DA, 23, 6, 0), (0x00E5, 25, 7, 0), (0x006F, 28, 8, 0), (0x0036, 30, 9, 0), (0x001A, 33, 10, 0),
    (0x000D, 35, 11, 0), (0x0006, 9, 12, 0), (0x0003, 10, 13, 0), (0x0001, 12, 13, 0), (0x5A7F, 15, 15, 1),
    (0x3F25, 36, 16, 0), (0x2CF2, 38, 17, 0), (0x207C, 39, 18, 0), (0x17B9, 40, 19, 0), (0x1182, 42, 20, 0),
    (0x0CEF, 43, 21, 0), (0x09A1, 45, 22, 0), (0x072F, 46, 23, 0), (0x055C, 48, 24, 0), (0x0406, 49, 25, 0),
    (0x0303, 51, 26, 0), (0x0240, 52, 27, 0), (0x01B1, 54, 28, 0), (0x0144, 56, 29, 0), (0x00F5, 57, 30, 0),
    (0x00B7, 59, 31, 0), (0x008A, 60, 32, 0), (0x0068, 62, 33, 0), (0x004E, 63, 34, 0), (0x003B, 32, 35, 0),
    (0x002C, 33, 9, 0), (0x5AE1, 37, 37, 1), (0x484C, 64, 38, 0), (0x3A0D, 65, 39, 0), (0x2EF1, 67, 40, 0),
    (0x261F, 68, 41, 0), (0x1F33, 69, 42, 0), (0x19A8, 70, 43, 0), (0x1518, 72, 44, 0), (0x1177, 73, 45, 0),
    (0x0E74, 74, 46, 0), (0x0BFB, 75, 47, 0), (0x09F8, 77, 48, 0), (0x0861, 78, 49, 0), (0x0706, 79, 50, 0),
    (0x05CD, 48, 51, 0), (0x04DE, 50, 52, 0), (0x040F, 50, 53, 0), (0x0363, 51, 54, 0), (0x02D4, 52, 55, 0),
    (0x025C, 53, 56, 0), (0x01F8, 54, 57, 0), (0x01A4, 55, 58, 0), (0x0160, 56, 59, 0), (0x0125, 57, 60, 0),
    (0x00F6, 58, 61, 0), (0x00CB, 59, 62, 0), (0x00AB, 61, 63, 0), (0x008F, 61, 32, 0), (0x5B12, 65, 65, 1),
    (0x4D04, 80, 66, 0), (0x412C, 81, 67, 0), (0x37D8, 82, 68, 0), (0x2FE8, 83, 69, 0), (0x293C, 84, 70, 0),
    (0x2379, 86, 71, 0), (0x1EDF, 87, 72, 0), (0x1AA9, 87, 73, 0), (0x174E, 72, 74, 0), (0x1424, 72, 75, 0),
    (0x119C, 74, 76, 0), (0x0F6B, 74, 77, 0), (0x0D51, 75, 78, 0), (0x0BB6, 77, 79, 0), (0x0A40, 77, 48, 0),
    (0x5832, 80, 81, 1), (0x4D1C, 88, 82, 0), (0x438E, 89, 83, 0), (0x3BDD, 90, 84, 0), (0x34EE, 91, 85, 0),
    (0x2EAE, 92, 86, 0), (0x299A, 93, 87, 0), (0x2516, 86, 71, 0), (0x5570, 88, 89, 1), (0x4CA9, 95, 90, 0),
    (0x44D9, 96, 91, 0), (0x3E22, 97, 92, 0), (0x3824, 99, 93, 0), (0x32B4, 99, 94, 0), (0x2E17, 93, 86, 0),
    (0x56A8, 95, 96, 1), (0x4F46, 101, 97, 0), (0x47E5, 102, 98, 0), (0x41CF, 103, 99, 0), (0x3C3D, 104, 100, 0),
    (0x375E, 99, 93, 0), (0x5231, 105, 102, 0), (0x4C0F, 106, 103, 0), (0x4639, 107, 104, 0), (0x415E, 103, 99, 0),
    (0x5627, 105, 106, 1), (0x50E7, 108, 107, 0), (0x4B85, 109, 103, 0), (0x5597, 110, 109, 0), (0x504F, 111, 107, 0),
    (0x5A10, 110, 111, 1), (0x5522, 112, 109, 0), (0x59EB, 112, 111, 1), (0x5A1D, 113, 113, 0),
)

ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14,
    21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60,
    61, 54, 47, 55, 62, 63])
LUMA_Q = np.array([16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55, 14, 13, 16, 24, 40, 57, 69, 56,
                   14, 17, 22, 29, 51, 87, 80, 62, 18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
                   49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
# every AC symbol: EOB, ZRL and run/size with sizes 1-10
AC_SYMBOLS = sorted([0x00, 0xF0] + [(r << 4) | s for r in range(16) for s in range(1, 11)])
AC_RANK = {s: i for i, s in enumerate(AC_SYMBOLS)}
# arithmetic-coding progression: (Ss, Se, Ah, Al) of each scan; DC scans
# hold every component, AC scans one
PROGRESSION = ((0, 0, 0, 1), (1, 5, 0, 2), (6, 63, 0, 2), (1, 63, 2, 1), (0, 0, 1, 0), (1, 63, 1, 0))


def _dct_matrix():
    u = np.arange(8)[:, None]
    x = np.arange(8)[None, :]
    m = np.cos((2 * x + 1) * u * np.pi / 16) * np.sqrt(2 / 8)
    m[0] /= np.sqrt(2)
    return m


_DCT = _dct_matrix()


def _nbits(v: int) -> int:
    return int(v).bit_length()


class _Bits:
    """Huffman-coded bits, 0xFF stuffed with 0x00, the last byte padded with ones."""

    def __init__(self, out: bytearray):
        self.out, self.acc, self.n = out, 0, 0

    def put(self, code: int, size: int) -> None:
        self.acc = (self.acc << size) | (code & ((1 << size) - 1))
        self.n += size
        while self.n >= 8:
            b = (self.acc >> (self.n - 8)) & 0xFF
            self.out.append(b)
            if b == 0xFF:
                self.out.append(0)
            self.n -= 8
        self.acc &= (1 << self.n) - 1

    def flush(self) -> None:
        if self.n:
            self.put(0x7F, 8 - self.n)


class _Arith:
    """jcarith.c's QM encoder (ITU T.81 Annex D) into `out`."""

    def __init__(self, out: bytearray):
        self.out = out
        self.c, self.a, self.sc, self.zc, self.ct, self.buffer = 0, 0x10000, 0, 0, 11, -1

    def _emit_zeros(self):
        while self.zc:
            self.out.append(0)
            self.zc -= 1

    def _emit_byte(self, b):
        self.out.append(b)
        if b == 0xFF:
            self.out.append(0)

    def _emit_stacked(self):
        if self.buffer == 0:
            self.zc += 1
        elif self.buffer >= 0:
            self._emit_zeros()
            self.out.append(self.buffer)
        if self.sc:
            self._emit_zeros()
            self.out += b"\xff\x00" * self.sc
            self.sc = 0

    def _carry(self):
        if self.buffer >= 0:
            self._emit_zeros()
            self._emit_byte(self.buffer + 1)
        self.zc += self.sc
        self.sc = 0

    def encode(self, st: list, i: int, val: int) -> None:
        sv = st[i]
        qe, nl, nm, sw = ARITAB[sv & 0x7F]
        nl |= sw << 7
        self.a -= qe
        if val != (sv >> 7):
            if self.a >= qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) ^ nl
        else:
            if self.a >= 0x8000:
                return
            if self.a < qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) ^ nm
        while True:
            self.a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                temp = self.c >> 19
                if temp > 0xFF:
                    self._carry()
                    self.buffer = temp & 0xFF
                elif temp == 0xFF:
                    self.sc += 1
                else:
                    self._emit_stacked()
                    self.buffer = temp & 0xFF
                self.c &= 0x7FFFF
                self.ct += 8
            if self.a >= 0x8000:
                break

    def finish(self) -> None:
        temp = (self.a - 1 + self.c) & 0xFFFF0000
        self.c = temp + 0x8000 if temp < self.c else temp
        self.c <<= self.ct
        if self.c & 0xF8000000:
            self._carry()
        else:
            self._emit_stacked()
        if self.c & 0x7FFF800:
            self._emit_zeros()
            self._emit_byte((self.c >> 19) & 0xFF)
            if self.c & 0x7F800:
                self._emit_byte((self.c >> 11) & 0xFF)


def _seg(marker: int, body: bytes) -> bytes:
    return bytes([0xFF, marker]) + (len(body) + 2).to_bytes(2, "big") + body


def _component_samples(plane: np.ndarray, h: int, v: int, hmax: int, vmax: int):
    """(ch, cw) samples of a component at factors h x v: a box average over
    whole cells where the ratio is integral, the nearest sample otherwise."""
    height, width = plane.shape
    ch, cw = -(-height * v // vmax), -(-width * h // hmax)
    if hmax % h or vmax % v:
        ys = np.minimum(np.arange(ch) * vmax // v, height - 1)
        xs = np.minimum(np.arange(cw) * hmax // h, width - 1)
        return plane[ys][:, xs].astype(np.int64)
    fy, fx = vmax // v, hmax // h
    ys = np.minimum(np.arange(ch * fy), height - 1)
    xs = np.minimum(np.arange(cw * fx), width - 1)
    cells = plane[ys][:, xs].astype(np.float64).reshape(ch, fy, cw, fx)
    return np.rint(cells.mean(axis=(1, 3))).astype(np.int64)


def _predict(x: np.ndarray, first_rows, predictor: int, pt: int) -> np.ndarray:
    """Lossless differences (ITU T.81 H.1.2.1) of the point-transformed
    samples `x`, (diff & 0xFFFF) as a signed value; each row in `first_rows`
    starts over (the first row of a scan or a restart interval)."""
    ch, cw = x.shape
    pred = np.zeros_like(x)
    for y in range(ch):
        ra = np.concatenate([[0], x[y, :-1]])
        if y in first_rows:
            pred[y] = ra
            pred[y, 0] = 1 << (8 - pt - 1)
            continue
        rb = x[y - 1]
        rc = np.concatenate([[0], x[y - 1, :-1]])
        pred[y] = {1: ra, 2: rb, 3: rc, 4: ra + rb - rc, 5: ra + ((rb - rc) >> 1), 6: rb + ((ra - rc) >> 1),
                   7: (ra + rb) >> 1}[predictor]
        pred[y, 0] = rb[0]
    d = (x - pred) & 0xFFFF
    return np.where(d >= 0x8000, d - 0x10000, d)


def encode(planes: np.ndarray, *, sampling=None, coding: str = "huffman", progressive: bool = False,
           lossless: int | None = None, point_transform: int = 0, restart: int = 0, quality: int = 75,
           jfif: bool = True, adobe: int | None = None, ids=None, separate_scans: bool = False,
           dac: dict | None = None) -> bytes:
    """JPEG bytes of (h, w) or (h, w, n) uint8 samples, already in the file's
    colour space.

    sampling: (h, v) of each component, 1 x 1 each by default; coding
    "huffman" or "arithmetic"; progressive: the PROGRESSION scans
    (arithmetic coding); lossless: a predictor 1-7 (SOF3, Huffman coding
    only) with `point_transform`; restart: MCUs per restart
    interval (lossless: whole MCU rows); jfif / adobe: an APP0 JFIF marker,
    an APP14 Adobe marker with that transform; ids: the component ids, 1..n
    by default; separate_scans: one scan per component; dac: the DAC
    segment, {"dc": {table: (L, U)}, "ac": {table: K}}.
    """
    planes = np.asarray(planes)
    if planes.ndim == 2:
        planes = planes[..., None]
    height, width, nc = planes.shape
    sampling = [tuple(s) for s in (sampling or [(1, 1)] * nc)]
    ids = list(ids or range(1, nc + 1))
    arith = coding == "arithmetic"
    if lossless is not None and arith:
        raise ValueError("lossless frames are written with Huffman coding only")
    hmax = max(h for h, _ in sampling)
    vmax = max(v for _, v in sampling)
    unit = 1 if lossless is not None else 8
    mcux, mcuy = -(-width // (hmax * unit)), -(-height // (vmax * unit))
    q = np.ones(64, np.int64)
    if lossless is None:
        scale = 5000 // quality if quality < 50 else 200 - 2 * quality
        q = np.clip((LUMA_Q * scale + 50) // 100, 1, 255)
    comps = []
    for i, (h, v) in enumerate(sampling):
        c = SimpleNamespace()
        c.index, c.id, c.h, c.v = i, ids[i], h, v
        c.tbl = 0 if i == 0 else 1
        s = _component_samples(planes[..., i], h, v, hmax, vmax)
        c.ch, c.cw = s.shape
        c.uh, c.uw = -(-c.ch // unit), -(-c.cw // unit)  # the component's own units
        if nc == 1:
            c.h = c.v = 1  # a single component is one unit per MCU
            gh, gw = c.uh, c.uw
        else:
            gh, gw = mcuy * v, mcux * h  # the MCU grid's units
        full = s[np.minimum(np.arange(gh * unit), c.ch - 1)][:, np.minimum(np.arange(gw * unit), c.cw - 1)]
        if lossless is None:
            blocks = (full.astype(np.float64) - 128).reshape(gh, 8, gw, 8).transpose(0, 2, 1, 3)
            coef = np.einsum("ux,abxy,vy->abuv", _DCT, blocks, _DCT) / q.reshape(8, 8)
            c.units = np.clip(np.rint(coef), -1023, 1023).astype(np.int64).reshape(gh, gw, 64)
        else:
            c.samples = full >> point_transform
        comps.append(c)

    out = bytearray(b"\xff\xd8")
    if jfif:
        out += _seg(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    if adobe is not None:
        out += _seg(0xEE, b"Adobe" + (100).to_bytes(2, "big") + bytes(4) + bytes([adobe]))
    if lossless is None:
        for t in range(min(nc, 2)):
            out += _seg(0xDB, bytes([t]) + bytes(int(v) for v in q[ZIGZAG]))
    if lossless is not None:
        sof = 0xC3
    elif arith:
        sof = 0xCA if progressive else 0xC9
    else:
        sof = 0xC1
    body = bytes([8]) + height.to_bytes(2, "big") + width.to_bytes(2, "big") + bytes([nc])
    for c, (h, v) in zip(comps, sampling):
        body += bytes([c.id, (h << 4) | v, c.tbl if lossless is None else 0])
    out += _seg(sof, body)
    if arith:
        if dac:
            d = b"".join(bytes([t, (u << 4) | lo]) for t, (lo, u) in dac.get("dc", {}).items())
            d += b"".join(bytes([16 + t, k]) for t, k in dac.get("ac", {}).items())
            out += _seg(0xCC, d)
    else:
        dc_syms = list(range(17 if lossless is not None else 12))
        tables = [(0x00, 4 if lossless is None else 5, dc_syms)] + ([(0x10, 8, AC_SYMBOLS)] if lossless is None else [])
        for cls_id, length, syms in tables:
            counts = [0] * 16
            counts[length - 1] = len(syms)
            out += _seg(0xC4, bytes([cls_id]) + bytes(counts) + bytes(syms))
    if restart:
        out += _seg(0xDD, restart.to_bytes(2, "big"))

    if progressive:
        scans = []
        for ss, se, ah, al in PROGRESSION:
            scans += [(comps if ss == 0 else [c], ss, se, ah, al) for c in (comps[:1] if ss == 0 else comps)]
    elif lossless is not None:
        groups = [[c] for c in comps] if separate_scans else [comps]
        scans = [(g, lossless, 0, 0, point_transform) for g in groups]
    else:
        groups = [[c] for c in comps] if separate_scans else [comps]
        scans = [(g, 0, 63, 0, 0) for g in groups]
    for group, ss, se, ah, al in scans:
        body = bytes([len(group)])
        for c in group:
            body += bytes([c.id, (c.tbl << 4) | c.tbl if arith else 0])
        out += _seg(0xDA, body + bytes([ss, se, (ah << 4) | al]))
        _Scan(out, group, ss, se, ah, al, arith, lossless, restart, (mcux, mcuy), dac or {}).run()
    out += b"\xff\xd9"
    return bytes(out)


class _Scan:
    """The entropy-coded segment of one scan."""

    def __init__(self, out, group, ss, se, ah, al, arith, lossless, restart, mcu_grid, dac):
        self.out, self.group, self.ss, self.se, self.ah, self.al = out, group, ss, se, ah, al
        self.arith, self.lossless, self.restart, self.dac = arith, lossless, restart, dac
        if len(group) > 1:
            self.mcux, self.mcuy = mcu_grid
        else:
            self.mcux, self.mcuy = group[0].uw, group[0].uh

    def units(self, mx, my):
        if len(self.group) == 1:
            return [(self.group[0], my, mx)]
        return [(c, my * c.v + by, mx * c.h + bx) for c in self.group for by in range(c.v) for bx in range(c.h)]

    def reset(self):
        self.last_dc = {c.index: 0 for c in self.group}
        self.dc_ctx = {c.index: 0 for c in self.group}
        if self.arith:
            self.enc = _Arith(self.out)
            self.dc_stats = {c.tbl: [0] * 64 for c in self.group}
            self.ac_stats = {c.tbl: [0] * 256 for c in self.group}
            self.fixed = [113]
        else:
            self.bits = _Bits(self.out)

    def finish(self):
        if self.arith:
            self.enc.finish()
        else:
            self.bits.flush()

    def run(self):
        if self.lossless is not None:
            self.diffs = self.lossless_diffs()
        self.reset()
        n, rst = 0, 0
        for my in range(self.mcuy):
            for mx in range(self.mcux):
                if self.restart and n and n % self.restart == 0:
                    self.finish()
                    self.out += bytes([0xFF, 0xD0 + rst])
                    rst = (rst + 1) & 7
                    self.reset()
                for c, uy, ux in self.units(mx, my):
                    self.unit(c, uy, ux)
                n += 1
        self.finish()

    def lossless_diffs(self):
        rows_per_interval = self.restart // self.mcux if self.restart else 0
        diffs = {}
        for c in self.group:
            v = c.v if len(self.group) > 1 else 1
            firsts = {m * v for m in range(self.mcuy) if m == 0 or (rows_per_interval and m % rows_per_interval == 0)}
            d = np.zeros_like(c.samples)
            d[: c.ch, : c.cw] = _predict(c.samples[: c.ch, : c.cw], firsts, self.lossless, self.al)
            diffs[c.index] = d
        return diffs

    # ---- one unit: a block's coefficients or a lossless sample's difference

    def unit(self, c, uy, ux):
        if self.lossless is not None:
            self.huff_value(int(self.diffs[c.index][uy, ux]))
            return
        blk = c.units[uy, ux]
        if self.arith:
            if self.ss == 0:
                if self.ah == 0:
                    self.arith_dc(c, int(blk[0]) >> self.al)
                else:
                    self.enc.encode(self.fixed, 0, (int(blk[0]) >> self.al) & 1)
            if self.se > 0:
                if self.ah == 0:
                    self.arith_ac(c, blk)
                else:
                    self.arith_ac_refine(c, blk)
            return
        diff = int(blk[0]) - self.last_dc[c.index]
        self.last_dc[c.index] = int(blk[0])
        self.huff_value(diff)
        run = 0
        for k in range(1, 64):
            val = int(blk[ZIGZAG[k]])
            if val == 0:
                run += 1
                continue
            while run > 15:
                self.huff_sym_ac(0xF0)
                run -= 16
            self.huff_ac(run, val)
            run = 0
        if run:
            self.huff_sym_ac(0x00)

    # flat Huffman tables: DC symbol s is the code s of 4 bits (5 for
    # lossless), an AC symbol the code of its rank in AC_SYMBOLS, 8 bits
    def huff_sym_ac(self, sym):
        self.bits.put(AC_RANK[sym], 8)

    def huff_value(self, diff):
        size = _nbits(abs(diff))
        self.bits.put(size, 5 if self.lossless is not None else 4)
        if size and size < 16:
            self.bits.put(diff - 1 if diff < 0 else diff, size)

    def huff_ac(self, run, val):
        size = _nbits(abs(val))
        self.huff_sym_ac((run << 4) | size)
        self.bits.put(val - 1 if val < 0 else val, size)

    # ---- arithmetic coding (jcarith.c)

    def _magnitude(self, stats, st, v, k_high):
        """Figures F.8 and F.9 from bin `st`: the category, then the bits of v - 1."""
        enc = self.enc
        m = 0
        v -= 1
        if v:
            enc.encode(stats, st, 1)
            m = 1
            v2 = v
            if k_high is None:  # DC
                st = 20
                v2 >>= 1
                while v2:
                    enc.encode(stats, st, 1)
                    m <<= 1
                    st += 1
                    v2 >>= 1
            else:
                v2 >>= 1
                if v2:
                    enc.encode(stats, st, 1)
                    m <<= 1
                    st = k_high
                    v2 >>= 1
                    while v2:
                        enc.encode(stats, st, 1)
                        m <<= 1
                        st += 1
                        v2 >>= 1
        enc.encode(stats, st, 0)
        return st, m, v

    def arith_dc(self, c, value):
        enc, stats, ci = self.enc, self.dc_stats[c.tbl], c.index
        v = value - self.last_dc[ci]
        st = self.dc_ctx[ci]
        if v == 0:
            enc.encode(stats, st, 0)
            self.dc_ctx[ci] = 0
            return
        self.last_dc[ci] = value
        enc.encode(stats, st, 1)
        if v > 0:
            enc.encode(stats, st + 1, 0)
            st += 2
            self.dc_ctx[ci] = 4
        else:
            v = -v
            enc.encode(stats, st + 1, 1)
            st += 3
            self.dc_ctx[ci] = 8
        st, m, v = self._magnitude(stats, st, v, None)
        lo, hi = self.dac.get("dc", {}).get(c.tbl, (0, 1))
        if m < (1 << lo) >> 1:
            self.dc_ctx[ci] = 0
        elif m > (1 << hi) >> 1:
            self.dc_ctx[ci] += 8
        st += 14
        m >>= 1
        while m:
            enc.encode(stats, st, 1 if m & v else 0)
            m >>= 1

    def arith_ac(self, c, blk):
        enc, stats, al = self.enc, self.ac_stats[c.tbl], self.al
        kk = self.dac.get("ac", {}).get(c.tbl, 5)

        def shifted(k):
            val = int(blk[ZIGZAG[k]])
            return (val >> al) if val >= 0 else -((-val) >> al)

        start = max(self.ss, 1)
        ke = self.se
        while ke >= start and shifted(ke) == 0:
            ke -= 1
        k = start
        while k <= ke:
            st = 3 * (k - 1)
            enc.encode(stats, st, 0)
            while shifted(k) == 0:
                enc.encode(stats, st + 1, 0)
                st += 3
                k += 1
            v = shifted(k)
            enc.encode(stats, st + 1, 1)
            enc.encode(self.fixed, 0, 1 if v < 0 else 0)
            st += 2
            st, m, a = self._magnitude(stats, st, abs(v), 189 if k <= kk else 217)
            st += 14
            m >>= 1
            while m:
                enc.encode(stats, st, 1 if m & a else 0)
                m >>= 1
            k += 1
        if k <= self.se:
            enc.encode(stats, 3 * (k - 1), 1)

    def arith_ac_refine(self, c, blk):
        enc, stats, al, ah = self.enc, self.ac_stats[c.tbl], self.al, self.ah

        def mag(k, shift):
            return abs(int(blk[ZIGZAG[k]])) >> shift

        ke = self.se
        while ke > 0 and mag(ke, al) == 0:
            ke -= 1
        kex = ke
        while kex > 0 and mag(kex, ah) == 0:
            kex -= 1
        k = self.ss
        while k <= ke:
            st = 3 * (k - 1)
            if k > kex:
                enc.encode(stats, st, 0)
            while True:
                v = mag(k, al)
                if v:
                    if v >> 1:
                        enc.encode(stats, st + 2, v & 1)
                    else:
                        enc.encode(stats, st + 1, 1)
                        enc.encode(self.fixed, 0, 1 if blk[ZIGZAG[k]] < 0 else 0)
                    break
                enc.encode(stats, st + 1, 0)
                st += 3
                k += 1
            k += 1
        if k <= self.se:
            enc.encode(stats, 3 * (k - 1), 1)


def fixture_image(h: int, w: int, mode: str, seed: int) -> Image.Image:
    """A smooth ramp plus noise, from a seed."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w]
    base = np.stack([xx * 255 / max(w - 1, 1), yy * 255 / max(h - 1, 1), (xx + yy) * 127 / max(h + w - 2, 1)], -1)
    img = Image.fromarray(np.clip(base + rng.normal(0, 20, (h, w, 3)), 0, 255).astype(np.uint8))
    return img if mode == "RGB" else img.convert(mode)


def ycbcr(rgb: np.ndarray) -> np.ndarray:
    """JFIF's YCbCr of an RGB image, rounded: the samples of a colour JPEG."""
    r, g, b = (rgb[..., i].astype(np.float64) for i in range(3))
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = -0.168736 * r - 0.331264 * g + 0.5 * b + 128
    cr = 0.5 * r - 0.418688 * g - 0.081312 * b + 128
    return np.clip(np.rint(np.stack([y, cb, cr], -1)), 0, 255).astype(np.uint8)


def ycck(rgb: np.ndarray) -> np.ndarray:
    """YCCK samples that PIL opens as the ink of `rgb` (K the common part of
    C, M and Y): YCbCr of C, M and Y, and 255 - K, since PIL takes four
    components in Adobe's inverted convention."""
    ink = 255 - rgb.astype(np.int16)
    k = ink.min(axis=-1, keepdims=True)
    return np.concatenate([ycbcr((ink - k).astype(np.uint8)), (255 - k).astype(np.uint8)], -1)


def _rgb(h: int, w: int, seed: int) -> np.ndarray:
    return np.asarray(fixture_image(h, w, "RGB", seed))


# name: the file's bytes, from the writer above
WRITTEN = {
    "rgb440_q90.jpg": lambda: encode(ycbcr(_rgb(37, 53, 20)), sampling=[(1, 2), (1, 1), (1, 1)], quality=90),
    "rgb411_restart2.jpg": lambda: encode(ycbcr(_rgb(37, 53, 21)), sampling=[(4, 1), (1, 1), (1, 1)], quality=85,
                                          restart=2),
    "rgb_chroma2x1_1x2_scans.jpg": lambda: encode(ycbcr(_rgb(37, 53, 22)), sampling=[(2, 2), (2, 1), (1, 2)],
                                                  quality=80, separate_scans=True, restart=5),
    "ycck_adobe2.jpg": lambda: encode(ycck(_rgb(37, 53, 23)), sampling=[(2, 2), (1, 1), (1, 1), (2, 2)],
                                      quality=90, jfif=False, adobe=2),
    "arith_seq420_dac.jpg": lambda: encode(ycbcr(_rgb(37, 53, 24)), sampling=[(2, 2), (1, 1), (1, 1)],
                                           coding="arithmetic", restart=3, dac={"dc": {0: (1, 4)}, "ac": {0: 12}}),
    "arith_progressive422.jpg": lambda: encode(ycbcr(_rgb(37, 53, 25)), sampling=[(2, 1), (1, 1), (1, 1)],
                                               coding="arithmetic", progressive=True, restart=4),
    "arith_gray_7x9.jpg": lambda: encode(np.asarray(fixture_image(7, 9, "L", 26)), coding="arithmetic"),
    "lossless_gray_p4_restart.jpg": lambda: encode(np.asarray(fixture_image(37, 53, "L", 27)), lossless=4,
                                                   jfif=False, restart=53 * 4),
    "lossless_rgb_p7_pt1.jpg": lambda: encode(_rgb(17, 33, 28), lossless=7, point_transform=1, jfif=False),
}
# decode_to_canvas over every fixture: (short side, explicit canvas or None)
CANVAS_CHECKS = ((48, None), (40, (32, 40)))


def pil_jpeg_bytes(img: np.ndarray, quality: int, subsampling: str) -> bytes:
    """PIL's file for `img`, as Image.fromarray(img).save(path, ...) writes
    it (a gray image takes no subsampling option, as a plain save)."""
    buf = io.BytesIO()
    kw = {} if img.ndim == 2 else {"subsampling": subsampling}
    Image.fromarray(img).save(buf, format="JPEG", quality=quality, **kw)
    return buf.getvalue()


def fixture_paths() -> list[str]:
    return sorted(str(OUT / name) for name in (*FIXTURES, *WRITTEN))


def jax_canvases(short_size: int, canvas_hw) -> str:
    """chip_smoke.canvas_digest of the JAX package's decode_to_canvas over
    every fixture."""
    from acezero_tpu.data import images as jimg

    return chip_smoke.canvas_digest(jimg.decode_to_canvas(fixture_paths(), short_size=short_size,
                                                          canvas_hw=canvas_hw, num_workers=2))


def digests() -> dict:
    files, rgb = {}, {}
    for path in fixture_paths():
        name = Path(path).name
        with Image.open(path) as im:
            arr = np.asarray(im)
            if im.mode == "CMYK":
                rgb[name] = chip_smoke.array_digest(np.asarray(im.convert("RGB")))
        files[name] = {"shape": list(arr.shape), "sha256": chip_smoke.array_digest(arr)}
    canvas = [{"short_size": s, "canvas_hw": None if c is None else list(c), "sha256": jax_canvases(s, c)}
              for s, c in CANVAS_CHECKS]
    roundtrip = []
    for i, (quality, subsampling) in enumerate(chip_smoke.JPEG_ROUNDTRIP):
        img = chip_smoke.jpeg_roundtrip_frame(np, i)
        data = pil_jpeg_bytes(img, quality, subsampling)
        arr = np.asarray(Image.open(io.BytesIO(data)))
        roundtrip.append({"frame": i, "quality": quality, "subsampling": subsampling, "shape": list(arr.shape),
                          "bytes_sha256": hashlib.sha256(data).hexdigest(),
                          "sha256": chip_smoke.array_digest(arr)})
    return {"files": files, "rgb": rgb, "canvas": canvas, "roundtrip": roundtrip}


def main() -> None:
    OUT.mkdir(parents=True, exist_ok=True)
    for i, (name, (h, w, mode, opts)) in enumerate(FIXTURES.items()):
        fixture_image(h, w, mode, seed=i).save(OUT / name, **opts)
    for name, make in WRITTEN.items():
        (OUT / name).write_bytes(make())
    (OUT / "pil_digests.json").write_text(json.dumps(digests(), indent=1) + "\n")
    total = sum(p.stat().st_size for p in OUT.iterdir())
    print(f"wrote {len(FIXTURES) + len(WRITTEN)} fixtures and pil_digests.json to {OUT} ({total} bytes)")


if __name__ == "__main__":
    main()
