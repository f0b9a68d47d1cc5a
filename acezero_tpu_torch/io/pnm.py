"""Netpbm (PBM, PGM, PPM) and PFM files without an image library, read
as Pillow's PpmImagePlugin reads them and written as its `save` writes
them.

`read_pnm(path)` gives a `Raster` (io/formats.py): PIL's mode and the
pixels of `np.asarray(Image.open(path))`:
  - P1 and P4: mode 1 (a 1 is black, False);
  - P2 and P5: mode L up to maxval 255, mode I (int32) above it;
  - P3 and P6: mode RGB, at any maxval;
  - Pf: mode F (float32), rows bottom-up, little-endian when the scale is
    negative, big-endian otherwise. PIL does not open colour PFM (PF);
  - Pillow's own binary kinds: P0CMYK and PyCMYK mode CMYK, PyRGBA mode
    RGBA, PyP mode P with an empty palette (so its colours are black).
A maxval other than 255 (and, in P5, 65535) scales each value to 255, or
to 65535 for mode I, with Python's round (half to even), as Pillow's
decoders do; the binary decoder clips values above maxval, the plain one
refuses them. The plain formats' tokens and comments are parsed as
Pillow's PpmPlainDecoder parses them. What PIL refuses raises ValueError
naming the file.

`write_pnm(path, img, mode)` writes PIL's bytes: mode 1 as P4, L as P5
(maxval 255), I and I;16 as P5 (maxval 65535, I clipped to 0-65535), RGB
and RGBA as P6 (alpha dropped), F as Pf (scale -1.0, little-endian,
bottom-up).
"""

from __future__ import annotations

import math
import re
from pathlib import Path

import numpy as np

from acezero_tpu_torch.io.formats import Raster, check_size

MODES = {b"P1": "1", b"P2": "L", b"P3": "RGB", b"P4": "1", b"P5": "L", b"P6": "RGB", b"Pf": "F",
         b"P0CMYK": "CMYK", b"PyP": "P", b"PyRGBA": "RGBA", b"PyCMYK": "CMYK"}
BANDS = {"RGB": 3, "RGBA": 4, "CMYK": 4}  # samples a pixel; 1 for the other modes
_WHITESPACE = b" \t\n\x0b\x0c\r"
_COMMENT = re.compile(rb"#[^\r\n]*[\r\n]?")


def is_pnm(head: bytes) -> bool:
    return len(head) >= 2 and head[:1] == b"P" and head[1:2] in b"0123456fy"


def _header(data: bytes, path) -> tuple[str, str, int, int, float | int, int]:
    """(magic, mode, width, height, maxval or PFM scale, where the pixels
    start), read token by token as PpmImageFile._open reads them."""
    pos = 0
    magic = b""
    while pos < len(data) and len(magic) < 6:
        c = data[pos: pos + 1]
        pos += 1
        if c in _WHITESPACE:
            break
        magic += c
    if magic not in MODES:
        raise ValueError(f"{path}: PIL does not open this Netpbm file (magic {magic!r})")

    def token():
        nonlocal pos
        tok = b""
        while len(tok) <= 10:
            c = data[pos: pos + 1]
            pos += 1
            if not c:
                break
            if c in _WHITESPACE:
                if not tok:
                    continue
                break
            if c == b"#":
                while data[pos: pos + 1] not in (b"\r", b"\n", b""):
                    pos += 1
                pos += 1
                continue
            tok += c
        if not tok or len(tok) > 10:
            raise ValueError(f"{path}: PIL does not open this Netpbm file (bad header token {tok!r})")
        return tok

    mode = MODES[magic]
    try:
        width, height = int(token()), int(token())
        if mode == "1":
            maxval = 1
        elif mode == "F":
            maxval = float(token())  # the scale
            if maxval == 0.0 or not math.isfinite(maxval):
                raise ValueError("scale must be finite and non-zero")
        else:
            maxval = int(token())
    except ValueError as exc:
        raise ValueError(f"{path}: PIL does not open this Netpbm file ({exc})") from None
    check_size(width, height, path)
    if mode in ("1", "F"):
        return magic.decode(), mode, width, height, maxval, pos
    if not 0 < maxval < 65536:
        raise ValueError(f"{path}: PIL does not open a Netpbm maxval of {maxval}")
    if maxval > 255 and mode == "L":
        mode = "I"
    return magic.decode(), mode, width, height, maxval, pos


def pnm_header(path) -> tuple[int, int, str]:
    """(width, height, mode) as PIL opens the Netpbm or PFM file."""
    with open(path, "rb") as f:
        head = f.read(1 << 16)  # the header, comments and all
    _, mode, w, h, _, _ = _header(head, path)
    return w, h, mode


def _scale(vals: np.ndarray, maxval: int, out_max: int) -> np.ndarray:
    return np.round(vals.astype(np.float64) / maxval * out_max)


def read_pnm(path) -> Raster:
    """Decode a Netpbm or PFM file as PIL opens it (module note)."""
    data = Path(path).read_bytes()
    magic, mode, w, h, maxval, pos = _header(data, path)
    bands = BANDS.get(mode, 1)
    n = w * h * bands
    body = data[pos:]
    if magic == "P1":
        tokens = b"".join(_COMMENT.sub(b"", body).split())
        bad = set(tokens[:n]) - {48, 49}
        if bad:
            raise ValueError(f"{path}: PIL does not open this PBM (token {bytes([min(bad)])!r})")
        if len(tokens) < n:
            raise ValueError(f"{path}: truncated PBM ({len(tokens)} of {n} pixels)")
        return Raster(np.frombuffer(tokens[:n], np.uint8).reshape(h, w) == 48, mode)
    if magic in ("P2", "P3"):
        tokens = _COMMENT.sub(b"", body).split()[:n]
        if any(len(t) > 10 for t in tokens):
            raise ValueError(f"{path}: PIL does not open this Netpbm file (a token longer than 10)")
        try:
            vals = np.array([int(t) for t in tokens], np.int64)
        except ValueError as exc:
            raise ValueError(f"{path}: PIL does not open this Netpbm file ({exc})") from None
        if len(vals) < n:
            raise ValueError(f"{path}: truncated Netpbm file ({len(vals)} of {n} values)")
        if (vals < 0).any() or (vals > maxval).any():
            raise ValueError(f"{path}: PIL does not open this Netpbm file (a value outside 0-{maxval})")
        out = _scale(vals, maxval, 65535 if mode == "I" else 255)
        return Raster(out.astype(np.int32 if mode == "I" else np.uint8).reshape((h, w, 3) if bands == 3 else (h, w)),
                      mode)
    if magic == "P4":
        row = (w + 7) // 8
        if len(body) < row * h:
            raise ValueError(f"{path}: truncated PBM ({len(body)} of {row * h} bytes)")
        bits = np.unpackbits(np.frombuffer(body[: row * h], np.uint8).reshape(h, row), axis=1)[:, :w]
        return Raster(bits == 0, mode)
    if magic == "Pf":
        if len(body) < 4 * n:
            raise ValueError(f"{path}: truncated PFM ({len(body)} of {4 * n} bytes)")
        px = np.frombuffer(body[: 4 * n], "<f4" if maxval < 0 else ">f4").reshape(h, w)
        return Raster(np.ascontiguousarray(px[::-1]).astype(np.float32), mode)
    size = 1 if maxval < 256 else 2
    if len(body) < size * n:
        raise ValueError(f"{path}: truncated Netpbm file ({len(body)} of {size * n} bytes)")
    vals = np.frombuffer(body[: size * n], np.uint8 if size == 1 else ">u2")
    if mode == "I":
        out = vals.astype(np.int32) if maxval == 65535 else np.minimum(65535, _scale(vals, maxval, 65535))
        out = out.astype(np.int32)
    elif maxval == 255:
        out = vals
    else:
        out = np.minimum(255, _scale(vals, maxval, 255)).astype(np.uint8)
    out = np.ascontiguousarray(out).reshape((h, w, bands) if bands > 1 else (h, w))
    return Raster(out, mode, np.zeros((0, 3), np.uint8) if mode == "P" else None)


def encode_pnm(img: np.ndarray, mode: str) -> bytes:
    """PIL's PPM-family bytes of `img` in `mode` (module note)."""
    img = np.asarray(img)
    h, w = img.shape[:2]
    size = b"\n%d %d\n" % (w, h)
    if mode == "1":
        return b"P4" + size + np.packbits(~img.astype(bool), axis=1).tobytes()
    if mode == "L":
        return b"P5" + size + b"255\n" + img.astype(np.uint8).tobytes()
    if mode in ("I", "I;16"):
        return b"P5" + size + b"65535\n" + np.clip(img.astype(np.int64), 0, 65535).astype(">u2").tobytes()
    if mode in ("RGB", "RGBA"):
        return b"P6" + size + b"255\n" + np.ascontiguousarray(img[..., :3], np.uint8).tobytes()
    if mode == "F":
        return b"Pf" + size + b"-1.0\n" + np.ascontiguousarray(img[::-1], "<f4").tobytes()
    raise OSError(f"cannot write mode {mode} as PPM")


def write_pnm(path, img: np.ndarray, mode: str) -> None:
    """Write `img` as PIL's `img.save(path)` writes a PBM/PGM/PPM/PFM
    (whichever of .pbm, .pgm, .ppm, .pnm or .pfm it is named) of `mode`."""
    Path(path).write_bytes(encode_pnm(img, mode))
