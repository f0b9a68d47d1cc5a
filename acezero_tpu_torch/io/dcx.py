"""DCX files (Intel's multi-page PCX container) without an image library,
read as Pillow's DcxImagePlugin opens them: the little-endian magic
987654321, a table of up to 1,024 page offsets ended by a 0, and page 0
read by io/pcx.py from its offset (an 8-bit page's palette still taken 769
bytes from the end of the whole file, as Pillow seeks it). A table cut
short, no pages, or a page PcxImageFile gives up on makes Pillow try the
later plugins, none of which opens a DCX: the port raises ValueError. PIL
writes no DCX, and neither does the port.
"""

from __future__ import annotations

import struct

from acezero_tpu_torch.io import pcx, raster
from acezero_tpu_torch.io.formats import Raster

MAGIC = 0x3ADE68B1
MAX_PAGES = 1024


def is_dcx(head: bytes) -> bool:
    """Pillow's _accept: the magic."""
    return len(head) >= 4 and struct.unpack_from("<I", head)[0] == MAGIC


def page_offsets(b, path) -> list[int]:
    """DcxImageFile._open's offset table; ValueError where PIL identifies
    no image (a table cut short, or none)."""
    offsets = []
    for i in range(MAX_PAGES):
        at = 4 + 4 * i
        if at + 4 > len(b):
            raise ValueError(f"{path}: DCX page table cut short (PIL identifies no image)")
        (offset,) = struct.unpack_from("<I", b, at)
        if not offset:
            break
        offsets.append(offset)
    if not offsets:
        raise ValueError(f"{path}: a DCX of no pages (PIL identifies no image)")
    return offsets


def dcx_open(b, path) -> pcx.PcxHeader:
    return pcx.pcx_open(b, page_offsets(b, path)[0], path, "DCX")


def dcx_header(path) -> pcx.PcxHeader:
    return raster.read_mapped(path, lambda b: dcx_open(b, path))


def read_dcx(path) -> Raster:
    """Page 0 of a DCX file as PIL gives it: a `Raster` of mode 1, L, P or
    RGB (io/pcx.py). ValueError naming the file where PIL's open or load
    raises."""

    def read(b):
        hdr = dcx_open(b, path)
        return Raster(pcx.decode(b, hdr, path, "DCX"), hdr.mode, hdr.palette)

    return raster.read_mapped(path, read)
