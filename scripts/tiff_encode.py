"""TIFF writers in numpy alone, for the kinds Pillow's save does not write:
LZW as libtiff encodes it, PackBits, Deflate, the horizontal (2) and
floating-point (3) predictors, tiles, planar configuration 2, big-endian
files, bit depths below 8 and fill order 2.

scripts/make_format_fixtures.py writes tests/data/formats with them, and
chip_smoke.py's phase formats writes its frames with them, so this module
imports only the standard library and numpy.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def lzw_encode(data: bytes) -> bytes:
    """TIFF LZW as libtiff's encoder writes it: 9- to 12-bit codes, most
    significant bit first, a clear code first and when the table reaches
    4094 entries; the width grows once the next free code passes the
    largest the width holds (the decoder's early change)."""
    out, acc, nbits = bytearray(), 0, 0
    width = 9

    def put(code):
        nonlocal acc, nbits
        acc = (acc << width) | code
        nbits += width
        while nbits >= 8:
            out.append((acc >> (nbits - 8)) & 255)
            nbits -= 8

    table = {}  # (prefix code << 8 | byte) -> code
    nxt = 258
    put(256)
    w = -1
    for b in data:
        if w < 0:
            w = b
            continue
        code = table.get(w << 8 | b)
        if code is not None:
            w = code
            continue
        put(w)
        table[w << 8 | b] = nxt
        nxt += 1
        if nxt == 4094:
            put(256)
            table = {}
            nxt, width = 258, 9
        elif nxt > (1 << width) - 1:
            width += 1
        w = b
    if w >= 0:
        put(w)
        nxt += 1
        if nxt > (1 << width) - 1 and width < 12:
            width += 1
    put(257)
    if nbits:
        out.append((acc << (8 - nbits)) & 255)
    return bytes(out)


def packbits_encode(data: bytes) -> bytes:
    """PackBits with both runs (3 or more equal bytes) and literals."""
    out, i, n = bytearray(), 0, len(data)
    while i < n:
        j = i
        while j < n and j - i < 128 and data[j] == data[i]:
            j += 1
        if j - i >= 3:
            out += bytes([(257 - (j - i)) & 255, data[i]])
            i = j
            continue
        j = i
        while j < n and j - i < 128 and not (j + 2 < n and data[j] == data[j + 1] == data[j + 2]):
            j += 1
        out += bytes([j - i - 1]) + data[i:j]
        i = j
    return bytes(out)


def _predict(rows: np.ndarray, spp: int, bps: int, predictor: int, big: bool) -> np.ndarray:
    """Apply the TIFF predictor to (rows, samples) values of a chunk: the
    encoded bytes, (rows, row bytes)."""
    e = ">" if big else "<"
    if predictor == 2:
        dt = np.dtype(f"{e}u{bps // 8}") if bps > 8 else np.dtype(np.uint8)
        v = rows.astype(dt.newbyteorder("=")).reshape(rows.shape[0], -1, spp)
        d = v.copy()
        d[:, 1:] = v[:, 1:] - v[:, :-1]
        return d.reshape(rows.shape[0], -1).astype(dt).view(np.uint8).reshape(rows.shape[0], -1)
    # floating point: each row's values as bytes, most significant first, in planes, then differenced
    nb = bps // 8
    be = rows.astype(np.dtype(f">f{nb}")).view(np.uint8).reshape(rows.shape[0], -1, nb)
    planes = be.transpose(0, 2, 1).reshape(rows.shape[0], -1)
    d = planes.copy()
    d[:, spp:] = planes[:, spp:] - planes[:, :-spp]
    return d


def tiff_bytes(samples: np.ndarray, *, bits, photometric: int, big: bool = False, sample_format=None,
               extra=None, planar: int = 1, compression: int = 1, predictor: int = 1, rows_per_strip=None,
               tile=None, fillorder: int = 1, colormap=None, orientation=None, extra_tags=()) -> bytes:
    """A TIFF of `samples` ((h, w, spp) values; for fewer than 8 bits a
    sample, (h, w) values packed into bytes), one IFD written before the
    data. `bits` a tuple a sample; `tile` (width, length) or strips of
    `rows_per_strip` rows."""
    e = ">" if big else "<"
    samples = np.asarray(samples)
    if samples.ndim == 2:
        samples = samples[..., None]
    h, w, spp = samples.shape
    bps = bits[0]
    if bps < 8:
        per = 8 // bps

        def pack(v):  # (rows, cols) -> packed rows
            cols = -(-v.shape[1] // per) * per
            padded = np.zeros((v.shape[0], cols), np.uint8)
            padded[:, : v.shape[1]] = v
            shifts = (8 - bps * (1 + np.arange(per))).astype(np.uint8)
            return (padded.reshape(v.shape[0], -1, per) << shifts).sum(-1).astype(np.uint8)
    planes = [samples[..., k: k + 1] for k in range(spp)] if planar == 2 else [samples]
    cw, ch = tile if tile else (w, rows_per_strip or h)
    chunks = []
    for plane in planes:
        for y0 in range(0, h, ch):
            for x0 in range(0, w, cw):
                part = plane[y0: y0 + ch, x0: x0 + cw]
                if tile:  # tiles are whole, padded with zeros
                    full = np.zeros((ch, cw, plane.shape[2]), plane.dtype)
                    full[: part.shape[0], : part.shape[1]] = part
                    part = full
                rows = part.reshape(part.shape[0], -1)
                if bps < 8:
                    raw = pack(rows)
                elif predictor > 1:
                    raw = _predict(rows, plane.shape[2], bps, predictor, big)
                elif bps > 8:
                    dt = np.dtype(f"{e}{samples.dtype.kind}{bps // 8}")
                    raw = rows.astype(dt).view(np.uint8).reshape(rows.shape[0], -1)
                else:
                    raw = rows.astype(np.uint8)
                data = raw.tobytes()
                if compression == 5:
                    data = lzw_encode(data)
                elif compression in (8, 32946):
                    data = zlib.compress(data, 6)
                elif compression == 32773:
                    data = packbits_encode(data)
                if fillorder == 2:
                    data = bytes(int(f"{b:08b}"[::-1], 2) for b in data)
                chunks.append(data)
    tags = [(256, 4, [w]), (257, 4, [h]), (258, 3, list(bits)), (259, 3, [compression]), (262, 3, [photometric]),
            (277, 3, [spp]), (284, 3, [planar])]
    if tile:
        tags += [(322, 3, [cw]), (323, 3, [ch]), (324, 4, None), (325, 4, [len(c) for c in chunks])]
    else:
        tags += [(273, 4, None), (278, 4, [ch]), (279, 4, [len(c) for c in chunks])]
    if predictor > 1:
        tags.append((317, 3, [predictor]))
    if fillorder != 1:
        tags.append((266, 3, [fillorder]))
    if sample_format is not None:
        tags.append((339, 3, list(sample_format)))
    if extra is not None:
        tags.append((338, 3, list(extra)))
    if colormap is not None:
        tags.append((320, 3, list(colormap)))
    if orientation is not None:
        tags.append((274, 3, [orientation]))
    tags += list(extra_tags)
    tags.sort(key=lambda t: t[0])
    codes = {3: "H", 4: "I", 7: "B"}
    n = len(tags)
    blob_at = 8 + 2 + 12 * n + 4
    blobs = bytearray()
    offsets_pos = None
    entries = bytearray(struct.pack(e + "H", n))
    for tag, typ, vals in tags:
        if vals is None:  # the chunk offsets, filled in below
            vals = [0] * len(chunks)
        packed = bytes(vals) if typ == 7 else struct.pack(e + codes[typ] * len(vals), *vals)
        if len(packed) <= 4:
            entries += struct.pack(e + "HHI", tag, typ, len(vals)) + packed.ljust(4, b"\x00")
            if tag in (273, 324):
                offsets_pos = ("inline", len(entries) - 4)
        else:
            if tag in (273, 324):
                offsets_pos = ("blob", len(blobs))
            entries += struct.pack(e + "HHII", tag, typ, len(vals), blob_at + len(blobs))
            blobs += packed + b"\x00" * (len(packed) % 2)
    data_at = blob_at + len(blobs)
    offs, pos = [], data_at
    for c in chunks:
        offs.append(pos)
        pos += len(c) + len(c) % 2
    packed = struct.pack(e + "I" * len(offs), *offs)
    if offsets_pos[0] == "inline":
        entries[offsets_pos[1]: offsets_pos[1] + 4] = packed.ljust(4, b"\x00")
    else:
        blobs[offsets_pos[1]: offsets_pos[1] + len(packed)] = packed
    head = (b"MM\x00\x2a" if big else b"II\x2a\x00") + struct.pack(e + "I", 8)
    body = b"".join(c + b"\x00" * (len(c) % 2) for c in chunks)
    return head + bytes(entries) + struct.pack(e + "I", 0) + bytes(blobs) + body
