#!/usr/bin/env python3
"""Differential sweep of the port's TGA, SGI, PCX, DCX, Sun raster and QOI
readers against PIL on corrupted and synthetic files (CPU; needs PIL, so
not on the card's machine):

    JAX_PLATFORMS=cpu python3 scripts/raster_sweep.py --files 12000 --workers 6

Each file is a fixture of tests/data/raster (scripts/make_raster_fixtures.py)
truncated, with header bytes replaced, bits flipped, bytes replaced, an SGI
offset table edited or a header field set to an edge value; or, one in
seven, a synthetic header: a TGA header of random fields, a PCX of version
0 (which Pillow may give up on and read as TGA), or random bytes after
one of the six signatures or CUR's and ICO's. For each, PIL's open and
load against the port's `file_kind`, `header` and `read_image`, counted
as:
  - equal: both decode, to the same pixels and mode, with the port's
    header giving PIL's mode and size;
  - both_raise: PIL's open or load raises, and so do the port's reader
    and (where PIL's open raises) its header;
  - port_raises_pil_decodes: a ValueError naming the file where PIL
    decodes (allowed: the port refuses rather than guess), also counted by
    the format the refusal names (`..._as_CUR`, or `_as_its_own_format`);
  - skipped_big: PIL opens an image of over 4 MP (a corrupted size);
and the faults, which must stay at 0: port_decodes_pil_raises, differs
(other pixels, mode or header), header_differs, header_answers (the
header answers where PIL's open raises), unnamed_raise (a refusal that
does not name the file) and crash_exc (an exception other than
ValueError or OSError). The faulty files are kept under --out/faults.
Prints the counts as one JSON object.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing as mp
import struct
import sys
import tempfile
import traceback
import warnings
from collections import Counter
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
FAULTS = ("crash_exc", "port_decodes_pil_raises", "differs", "header_differs", "unnamed_raise", "header_answers")


def pil(path):
    from PIL import Image

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        try:
            im = Image.open(path)
        except Exception as e:  # noqa: BLE001 - any refusal of PIL's open
            return ("open_raises", type(e).__name__)
        try:
            with im:
                opened = (im.format, im.mode, im.size)
                if im.size[0] * im.size[1] > 4_000_000:
                    return ("big", opened)
                return ("decodes", opened, np.asarray(im))
        except Exception as e:  # noqa: BLE001 - any refusal of PIL's load
            return ("load_raises", opened, type(e).__name__)


def port(path) -> dict:
    from acezero_tpu_torch.data import images as timg
    from acezero_tpu_torch.io import formats

    out = {}
    try:
        formats.file_kind(path)
        w, h, mode = formats.header(path)
        out["header"] = (mode, (w, h))
    except (ValueError, OSError):
        out["header"] = None
    except Exception:  # noqa: BLE001 - a crash is what the sweep looks for
        out["crash"] = traceback.format_exc()[-600:]
    try:
        out["arr"] = timg.pil_array(timg.read_image(path))
    except (ValueError, OSError) as e:
        out["arr"] = None
        out["named"] = str(path) in str(e)
    except Exception:  # noqa: BLE001
        out["crash"] = traceback.format_exc()[-600:]
    return out


def refused_as(data: bytes) -> str:
    """The format a refusal names, where the port refuses a file by the
    name of a plugin Pillow tries first."""
    from acezero_tpu_torch.io import formats

    head = data[: formats.HEAD_BYTES]
    return formats._queued(head) or formats._pil_first(head) or "its_own_format"


def verdict(p, q) -> str:
    if "crash" in q:
        return "crash_exc"
    if p[0] == "big":
        return "skipped_big"
    if p[0] == "open_raises":
        if q["arr"] is not None:
            return "port_decodes_pil_raises"
        return "both_raise" if q["header"] is None else "header_answers"
    if p[0] == "load_raises":
        if q["arr"] is not None:
            return "port_decodes_pil_raises"
        return "both_raise" if q["header"] in (None, (p[1][1], p[1][2])) else "header_differs"
    if q["arr"] is None:
        return "port_raises_pil_decodes" if q["named"] else "unnamed_raise"
    same = q["arr"].shape == p[2].shape and np.array_equal(q["arr"], p[2])
    return "equal" if same and q["header"] == (p[1][1], p[1][2]) else "differs"


def corrupt(rng, data: bytes, name: str) -> bytes:
    b = bytearray(data)
    kind = int(rng.integers(0, 6))
    if kind == 0 or len(b) < 4:
        return bytes(b[: int(rng.integers(0, len(b) + 1))])
    if kind == 1:
        for _ in range(int(rng.integers(1, 4))):
            b[int(rng.integers(0, min(len(b), 40)))] = int(rng.integers(0, 256))
    elif kind == 2:
        for _ in range(int(rng.integers(1, 4))):
            b[int(rng.integers(0, len(b)))] ^= 1 << int(rng.integers(0, 8))
    elif kind == 3:
        for _ in range(int(rng.integers(1, 6))):
            b[int(rng.integers(0, len(b)))] = int(rng.integers(0, 256))
    elif kind == 4 and name.endswith(".sgi") and len(b) > 520:
        for _ in range(int(rng.integers(1, 3))):
            b[int(rng.integers(512, min(len(b), 512 + 8 * 80)))] = int(rng.integers(0, 256))
    else:
        b[int(rng.integers(0, min(len(b), 70)))] = int(rng.choice([0, 1, 2, 3, 5, 8, 9, 10, 11, 12, 16, 24, 32,
                                                                    0x80, 0xC0, 0xFF]))
    return bytes(b)


def synthetic(rng) -> bytes:
    t = int(rng.integers(0, 3))
    if t == 0:
        w, h = int(rng.integers(1, 20)), int(rng.integers(1, 20))
        head = bytes([int(rng.integers(0, 4)), int(rng.integers(0, 2)), int(rng.choice([1, 2, 3, 9, 10, 11, 0, 4]))])
        head += struct.pack("<HHB", int(rng.integers(0, 4)), int(rng.integers(0, 20)),
                            int(rng.choice([15, 16, 24, 32, 8])))
        head += struct.pack("<HHHHBB", 0, 0, w, h, int(rng.choice([1, 8, 16, 24, 32, 15])), int(rng.integers(0, 256)))
        return head + rng.integers(0, 256, int(rng.integers(0, 4 * w * h + 200)), dtype=np.uint8).tobytes()
    if t == 1:
        head = struct.pack("<BBBBHHHHHH", 10, 0, int(rng.choice([1, 2, 3, 9])), int(rng.choice([1, 8])),
                           int(rng.integers(0, 10)), 0, int(rng.integers(0, 10)), int(rng.integers(0, 10)),
                           int(rng.integers(1, 30)), int(rng.integers(1, 30)))
        head += bytes([int(rng.choice([8, 16, 24, 32, 1])), int(rng.integers(0, 256))])
        return head + rng.integers(0, 256, int(rng.integers(0, 3000)), dtype=np.uint8).tobytes()
    sigs = (b"\x01\xda", b"\x59\xa6\x6a\x95", b"qoif", b"\xb1\x68\xde\x3a", b"\x0a\x05", b"\x00\x00\x02\x00",
            b"\x00\x00\x01\x00")
    return sigs[int(rng.integers(0, len(sigs)))] + rng.integers(0, 256, int(rng.integers(0, 2000)),
                                                                dtype=np.uint8).tobytes()


def run(args) -> tuple[dict, list]:
    seed, n, out = args
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "scripts"))
    import make_raster_fixtures as fx

    rng = np.random.default_rng(seed)
    names = sorted(fx.FIXTURES)
    work = Path(out) / f"w{seed}"
    work.mkdir(parents=True, exist_ok=True)
    counts, faults = Counter(), []
    for i in range(n):
        if rng.random() < 1 / 7:
            name, data = f"synthetic{i}.bin", synthetic(rng)
        else:
            name = names[int(rng.integers(0, len(names)))]
            data = corrupt(rng, (fx.OUT / name).read_bytes(), name)
        path = work / f"{i}_{name}"
        path.write_bytes(data)
        v = verdict(pil(path), port(path))
        counts[v] += 1
        if v == "port_raises_pil_decodes":
            counts[f"{v}_as_{refused_as(data)}"] += 1
        if v in FAULTS:
            keep = Path(out) / "faults" / f"{v}_{seed}_{i}_{name}"
            keep.parent.mkdir(exist_ok=True)
            keep.write_bytes(data)
            faults.append(str(keep))
        path.unlink()
    return dict(counts), faults


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--files", type=int, default=12000)
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="where the files are made (default: a temporary directory)")
    args = ap.parse_args()
    per = 250
    with tempfile.TemporaryDirectory() as tmp:
        out = args.out or tmp
        jobs = [(args.seed + k, per, out) for k in range(max(1, args.files // per))]
        counts, faults = Counter(), []
        with mp.get_context("spawn").Pool(args.workers) as pool:
            for c, f in pool.imap_unordered(run, jobs):
                counts.update(c)
                faults += f
        files = sum(v for k, v in counts.items() if "_as_" not in k)
        print(json.dumps({"files": files, **dict(sorted(counts.items())),
                          "faults": sum(counts[k] for k in FAULTS), "fault_files": faults[:50]}))


if __name__ == "__main__":
    main()
