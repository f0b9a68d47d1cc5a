#!/usr/bin/env python3
"""Write the GIF fixtures that hold the port's reader (io/gif.py,
io/csrc/gif.cpp) to PIL's where there is no PIL (the card's machine): small
files under tests/data/gif/, and tests/data/gif/pil_digests.json with

- "files": for each fixture, what PIL makes of it: its mode, size, the
  shape, dtype and sha256 of `np.asarray(Image.open(path))`, the palette
  (`getpalette()`: its number of colours and the sha256 of its bytes,
  `palette_digest`), the transparency index, and the sha256 of its
  `convert("RGB")`; or `"raises": true` where PIL's open or load raises;
- "canvas": for each of CANVAS_CHECKS, the digest (chip_smoke.canvas_digest)
  of the JAX package's decode_to_canvas over every fixture PIL decodes;
- "depth": for each of DEPTH, the sha256 of the JAX package's
  `load_depth_file` (float64).

    python3 scripts/make_gif_fixtures.py

PIL writes the kinds Pillow's `save` writes (P at palette sizes 2 to 256,
L, interlaced or not, with transparency, optimize on and off, an
animation). The writer below makes the rest: GIF87a, a local palette and no
global one, frame 0 at an offset and smaller than the screen (with and
without transparency), a frame that reaches past the screen, minimum code
sizes 2-8, a full table with no clear code, an early end code (PIL refuses
it), sub-blocks of odd lengths, comment, NETSCAPE and plain-text
extensions before the frame, an animation, and indices past the palette.
Its bytes are nobody's in particular; PIL decodes them. The tests import
this module to make more such files (`gif_bytes`, `lzw_codes`).

tests/test_torch_gif.py checks the digests against PIL and the JAX package
on every run, so the file cannot go stale; chip_smoke.py's phase formats
checks the port against them on the card.
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

OUT = chip_smoke.GIF_FIXTURES

# ---------------------------------------------------------------- the writer


def lzw_codes(indices, bits: int, *, clear_when_full: bool = True, clear_every: int = 0) -> list[int]:
    """LZW codes of a sequence of indices at minimum code size `bits`: a
    clear code first; when the table is full, a clear (or, without
    `clear_when_full`, no clear: the table stays as it is and the codes
    12 bits wide); a clear after every `clear_every` codes too; an end code
    last."""
    clear, end = 1 << bits, (1 << bits) + 1
    codes = [clear]
    table: dict[tuple[int, int], int] = {}
    nxt = clear + 2
    since = 0
    it = iter(int(v) for v in indices)
    prefix = next(it, None)
    for v in it:
        code = table.get((prefix, v))
        if code is not None:
            prefix = code
            continue
        codes.append(prefix)
        since += 1
        if nxt < 4096:
            table[(prefix, v)] = nxt
            nxt += 1
        if (nxt == 4096 and clear_when_full) or (clear_every and since >= clear_every):
            codes.append(clear)
            table, nxt, since = {}, clear + 2, 0
        prefix = v
    if prefix is not None:
        codes.append(prefix)
    return codes + [end]


def pack_codes(codes: list[int], bits: int) -> bytes:
    """The codes packed least significant bit first, each as wide as
    Pillow's decoder reads it: `bits` + 1 after a clear, one bit more once
    entry 2^n - 1 is added, at most 12."""
    clear = 1 << bits
    acc = nacc = 0
    out = bytearray()
    size, nxt, first = bits + 1, clear + 2, True
    for c in codes:
        acc |= c << nacc
        nacc += size
        while nacc >= 8:
            out.append(acc & 255)
            acc >>= 8
            nacc -= 8
        if c == clear:
            size, nxt, first = bits + 1, clear + 2, True
        elif first:
            first = False
        elif nxt < 4096:
            if nxt == (1 << size) - 1 and size < 12:
                size += 1
            nxt += 1
    if nacc:
        out.append(acc & 255)
    return bytes(out)


def sub_blocks(data: bytes, sizes=(255,)) -> bytes:
    """`data` as sub-blocks whose lengths cycle through `sizes`, then the
    terminator."""
    out, i, k = bytearray(), 0, 0
    while i < len(data):
        n = sizes[k % len(sizes)]
        out += bytes([len(data[i: i + n])]) + data[i: i + n]
        i, k = i + n, k + 1
    return bytes(out + b"\x00")


def colour_table(palette) -> tuple[int, bytes]:
    """(size field, table bytes) of an (n, 3) palette, n a power of two from
    2 to 256."""
    pal = np.asarray(palette, np.uint8).reshape(-1, 3)
    size = max(int(len(pal) - 1).bit_length(), 1) - 1
    if len(pal) != 2 << size:
        raise ValueError(f"a colour table holds 2 << n entries, got {len(pal)}")
    return size, pal.tobytes()


def interlaced(rows: np.ndarray) -> np.ndarray:
    h = rows.shape[0]
    order = np.concatenate([np.arange(0, h, 8), np.arange(4, h, 8), np.arange(2, h, 4), np.arange(1, h, 2)])
    return rows[order]


def image_block(indices: np.ndarray, *, x: int = 0, y: int = 0, palette=None, interlace: bool = False,
                bits: int = 8, sizes=(255,), codes: list[int] | None = None, size=None, **lzw) -> bytes:
    """An image descriptor (of the indices' size, or of `size` (w, h)), its
    local colour table, the minimum code size and the LZW data of (h, w)
    `indices` (or of `codes` as they are)."""
    h, w = indices.shape if size is None else size[::-1]
    flags = 64 if interlace else 0
    table = b""
    if palette is not None:
        size, table = colour_table(palette)
        flags |= 128 | size
    if codes is None:
        codes = lzw_codes((interlaced(indices) if interlace else indices).reshape(-1), bits, **lzw)
    return (b"," + struct.pack("<HHHHB", x, y, w, h, flags) + table + bytes([bits])
            + sub_blocks(pack_codes(codes, bits), sizes))


def gce(transparency: int | None = None, disposal: int = 0, delay: int = 0) -> bytes:
    flags = (disposal << 2) | (1 if transparency is not None else 0)
    return b"!\xf9\x04" + struct.pack("<BHB", flags, delay, transparency or 0) + b"\x00"


def comment(text: bytes) -> bytes:
    return b"!\xfe" + sub_blocks(text, (7, 255))


def netscape(loops: int = 0) -> bytes:
    return b"!\xff\x0bNETSCAPE2.0\x03\x01" + struct.pack("<H", loops) + b"\x00"


def plain_text(text: bytes) -> bytes:
    return b"!\x01\x0c" + struct.pack("<HHHHBBBB", 0, 0, 40, 8, 8, 8, 1, 0) + sub_blocks(text)


def gif_bytes(width: int, height: int, blocks: list[bytes], *, palette=None, version: bytes = b"GIF89a",
              background: int = 0, trailer: bool = True) -> bytes:
    """A GIF: the logical screen and its global colour table, then
    `blocks` (extensions and images) as they are, then the trailer."""
    flags, table = 0, b""
    if palette is not None:
        size, table = colour_table(palette)
        flags = 128 | size
    head = version + struct.pack("<HHBBB", width, height, flags, background, 0) + table
    return head + b"".join(blocks) + (b";" if trailer else b"")


# ---------------------------------------------------------------- the images


def photo(h: int, w: int, seed: int) -> np.ndarray:
    """A smooth RGB ramp plus noise, from a seed."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w]
    base = np.stack([xx * 255 / max(w - 1, 1), yy * 255 / max(h - 1, 1), (xx + yy) * 127 / max(h + w - 2, 1)], -1)
    return np.clip(base + rng.normal(0, 20, (h, w, 3)), 0, 255).astype(np.uint8)


def indices(h: int, w: int, n: int, seed: int) -> np.ndarray:
    """(h, w) indices below n: bands with some noise, so LZW finds runs."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w]
    base = (xx // 3 + yy // 2) % n
    return np.where(rng.random((h, w)) < 0.15, rng.integers(0, n, (h, w)), base).astype(np.uint8)


def palette(n: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (n, 3)).astype(np.uint8)


GREY = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, axis=1)


def _pil_save(img, **opts) -> bytes:
    buf = io.BytesIO()
    img.save(buf, format="GIF", **opts)
    return buf.getvalue()


def _pil_p(n: int, seed: int, h: int = 29, w: int = 37):
    from PIL import Image

    return Image.fromarray(photo(h, w, seed)).quantize(n)


def _pil_kinds() -> dict:
    from PIL import Image

    def p_transparent():
        im = _pil_p(32, 7)
        im.info["transparency"] = 5
        return _pil_save(im)

    def animation():
        frames = [_pil_p(16, 20 + k, 24, 30) for k in range(3)]
        return _pil_save(frames[0], save_all=True, append_images=frames[1:], duration=40, loop=0)

    gray = photo(29, 37, 9)[..., 1]
    ramp = np.arange(64 * 64, dtype=np.uint32).reshape(64, 64) % 256  # every grey level: reads back as L
    return {
        "pil_p2.gif": lambda: _pil_save(_pil_p(2, 1)),
        "pil_p4.gif": lambda: _pil_save(_pil_p(4, 2)),
        "pil_p16.gif": lambda: _pil_save(_pil_p(16, 3)),
        "pil_p64.gif": lambda: _pil_save(_pil_p(64, 4)),
        "pil_p256.gif": lambda: _pil_save(_pil_p(256, 5, 40, 48)),
        "pil_p256_interlaced.gif": lambda: _pil_save(_pil_p(256, 6, 40, 48), interlace=True),
        "pil_p64_not_interlaced.gif": lambda: _pil_save(_pil_p(64, 6, 40, 48), interlace=False),
        "pil_p_optimize_off.gif": lambda: _pil_save(_pil_p(16, 8), optimize=False),
        "pil_p_transparency.gif": p_transparent,
        "pil_l.gif": lambda: _pil_save(Image.fromarray(gray)),
        "pil_l_ramp.gif": lambda: _pil_save(Image.fromarray(ramp.astype(np.uint8))),
        "pil_l_transparency.gif": lambda: _pil_save(Image.fromarray(gray), transparency=int(gray[3, 4])),
        "pil_animation.gif": animation,
    }


def _written_kinds() -> dict:
    h, w = 23, 31
    idx16, idx256 = indices(h, w, 16, 30), indices(h, w, 256, 31)
    pal16, pal256 = palette(16, 32), palette(256, 33)
    small = indices(11, 13, 16, 34)
    past = indices(h, w, 16, 35)  # indices up to 15 under a table of 8
    noise = np.random.default_rng(36).integers(0, 256, (72, 96)).astype(np.uint8)
    anim2 = indices(h, w, 16, 37)
    kinds = {
        "gif87a.gif": lambda: gif_bytes(w, h, [image_block(idx16, bits=4)], palette=pal16, version=b"GIF87a"),
        "local_palette_only.gif": lambda: gif_bytes(w, h, [image_block(idx16, palette=pal16, bits=4)]),
        "local_over_global.gif": lambda: gif_bytes(w, h, [image_block(idx16, palette=pal16, bits=4)],
                                                   palette=palette(4, 38)),
        "offset_frame.gif": lambda: gif_bytes(w + 9, h + 6, [image_block(small, x=5, y=4, bits=4)], palette=pal16),
        "offset_frame_transparency.gif": lambda: gif_bytes(
            w + 9, h + 6, [gce(transparency=7), image_block(small, x=5, y=4, bits=4)], palette=pal16),
        "frame_past_the_screen.gif": lambda: gif_bytes(12, 9, [image_block(idx16, x=3, y=2, bits=4)], palette=pal16),
        "full_table_no_clear.gif": lambda: gif_bytes(96, 72, [image_block(noise, clear_when_full=False)],
                                                     palette=pal256),
        "clear_every_50_codes.gif": lambda: gif_bytes(w, h, [image_block(idx256, clear_every=50)], palette=pal256),
        "odd_sub_blocks.gif": lambda: gif_bytes(w, h, [image_block(idx256, sizes=(1, 7, 100, 254, 3))],
                                                palette=pal256),
        "extensions_before_the_frame.gif": lambda: gif_bytes(
            w, h, [comment(b"written by scripts/make_gif_fixtures.py"), netscape(3), plain_text(b"acezero"),
                   gce(transparency=2), comment(b"a second comment"), image_block(idx16, bits=4)], palette=pal16),
        "animation_local_palettes.gif": lambda: gif_bytes(
            w, h, [netscape(0), gce(disposal=2, delay=10), image_block(idx16, palette=pal16, bits=4),
                   gce(transparency=1, disposal=1, delay=10), image_block(anim2[3:15, 2:20], x=2, y=3,
                                                                          palette=palette(16, 39), bits=4)],
            palette=palette(2, 40)),
        "indices_past_the_palette.gif": lambda: gif_bytes(w, h, [image_block(past, bits=4)], palette=palette(8, 41)),
        "grey_ramp_global.gif": lambda: gif_bytes(w, h, [image_block(idx256)], palette=GREY),
        "grey_ramp_local_over_global.gif": lambda: gif_bytes(w, h, [image_block(idx16, palette=GREY[:16], bits=4)],
                                                             palette=pal16),
        "grey_ramp_transparency.gif": lambda: gif_bytes(w, h, [gce(transparency=9), image_block(idx16, bits=4)],
                                                        palette=GREY[:16]),
        "no_palette.gif": lambda: gif_bytes(w, h, [image_block(idx256)]),
        "interlaced_written.gif": lambda: gif_bytes(w, h, [image_block(idx256, interlace=True)], palette=pal256),
        "early_end_code.gif": lambda: gif_bytes(w, h, [image_block(idx16, bits=4, codes=lzw_codes(
            idx16.reshape(-1)[: h * w // 2], 4))], palette=pal16),
        # Pillow's quirks: a frame at x 0 of width 0 is decoded over the
        # whole screen (its extent (0, y0, 0, y1) reads as "all"); a graphic
        # control extension whose first sub-block is empty skips the next
        # bytes as sub-blocks (here a comment's), its transparency unread
        "zero_width_frame_at_x0.gif": lambda: gif_bytes(w, h, [image_block(idx16, bits=4, size=(0, 5))],
                                                        palette=pal16),
        "empty_extension_block.gif": lambda: gif_bytes(
            w, h, [b"!\xf9\x00", b"\x03abc\x00", gce(transparency=3), image_block(idx16, bits=4)], palette=pal16),
    }
    for b in range(2, 9):
        n = 1 << b
        kinds[f"code_size_{b}.gif"] = (lambda b=b, n=n: gif_bytes(w, h, [image_block(indices(h, w, n, 50 + b),
                                                                                      bits=b)],
                                                                  palette=palette(n, 60 + b)))
    return kinds


def _fixtures() -> dict:
    return {**_pil_kinds(), **_written_kinds()}


FIXTURES = _fixtures()
# the fixtures the depth check reads (PIL's indices, or grey levels, over 1,000)
DEPTH = ("pil_l.gif", "pil_l_ramp.gif", "pil_p16.gif", "grey_ramp_global.gif", "offset_frame_transparency.gif")
# decode_to_canvas over every fixture PIL decodes: (short side, explicit canvas or None)
CANVAS_CHECKS = ((40, None), (24, (16, 24)))


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
                    "transparency": im.info.get("transparency"),
                    "rgb_sha256": chip_smoke.array_digest(np.asarray(im.convert("RGB")))}
    except Exception:
        return {"raises": True}


def fixture_paths(decoded_only: bool = True) -> list[str]:
    names = sorted(FIXTURES)
    if decoded_only:
        digests = json.loads((OUT / "pil_digests.json").read_text())["files"]
        names = [n for n in names if not digests[n].get("raises")]
    return [str(OUT / n) for n in names]


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
    return {"files": files, "canvas": canvas, "depth": depth}


def main() -> None:
    OUT.mkdir(parents=True, exist_ok=True)
    for name, make in FIXTURES.items():
        (OUT / name).write_bytes(make())
    (OUT / "pil_digests.json").write_text(json.dumps(digests(), indent=1) + "\n")
    total = sum(p.stat().st_size for p in OUT.iterdir())
    print(f"wrote {len(FIXTURES)} fixtures and pil_digests.json to {OUT} ({total} bytes)")


if __name__ == "__main__":
    main()
