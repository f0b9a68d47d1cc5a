"""WebP files without an image library: the RIFF container here, the VP8,
VP8L and ALPH bitstreams in io/csrc/webp.cpp through ctypes.

`read_webp(path)` gives a `Raster` (io/formats.py) of the pixels of
`np.asarray(Image.open(path))`: PIL opens every WebP with libwebp's
WebPAnimDecoder, which decodes the first frame onto a zeroed canvas
(VP8X's size, or the frame's), at the frame's ANMF offset without
blending, as RGBA; PIL keeps RGBA when WebPGetFeatures reports alpha (the
VP8X flag, the VP8L header's alpha bit, or an ALPH chunk) and RGB
otherwise. ICCP, EXIF and XMP chunks are skipped (PIL applies none to the
pixels); later frames, the loop count, the durations and the background
colour are not read. The container checks are libwebp's own, in its
order: WebPGetFeatures on the file (`_features`), the demuxer's
validation (`_demux`), then the decode of the first frame's chunks, so the
port raises ValueError naming the file exactly where PIL's `Image.open` or
`load` raises, and otherwise gives PIL's pixels.

`webp_header(path)` gives (width, height, PIL's mode) without decoding,
after the same container checks. `write_webp(path, img)` writes an RGB or
RGBA uint8 image as a lossless VP8L file (subtract green, one prefix-code
group), its alpha-is-used bit set for RGBA, so that PIL reads it back to
the same pixels in the same mode.
"""

from __future__ import annotations

import ctypes
import functools
import struct
from pathlib import Path

import numpy as np

from acezero_tpu_torch.io.formats import Raster, check_size, mapped
from acezero_tpu_torch.ops import build

SOURCE = Path(__file__).resolve().parent / "csrc" / "webp.cpp"
_ERR_BYTES = 512

CHUNK_HEADER = 8
RIFF_HEADER = 12
VP8X_CHUNK = 10
ANMF_CHUNK = 16
ANIM_CHUNK = 6
MAX_CHUNK_PAYLOAD = 0xFFFFFFFF - CHUNK_HEADER - 1
MAX_IMAGE_AREA = 1 << 32
ANIMATION_FLAG, XMP_FLAG, EXIF_FLAG, ALPHA_FLAG, ICCP_FLAG = 0x02, 0x04, 0x08, 0x10, 0x20
ALL_VALID_FLAGS = ALPHA_FLAG | ANIMATION_FLAG | EXIF_FLAG | ICCP_FLAG | XMP_FLAG
IMAGE_TAGS = (b"VP8 ", b"VP8L")


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load_host(SOURCE)
    p, n, err, i = ctypes.c_void_p, ctypes.c_size_t, ctypes.c_char_p, ctypes.c_int
    i64 = ctypes.c_int64
    lib.acz_webp_vp8.argtypes = [p, n, p, n, i, i, i, p, i64, i, err, i]
    lib.acz_webp_vp8.restype = i
    lib.acz_webp_vp8l.argtypes = [p, n, i, i, p, i64, i, err, i]
    lib.acz_webp_vp8l.restype = i
    lib.acz_webp_vp8l_encode.argtypes = [p, i, i, i, i, ctypes.POINTER(ctypes.c_void_p), err, i]
    lib.acz_webp_vp8l_encode.restype = i64
    lib.acz_webp_free.argtypes = [p]
    lib.acz_webp_free.restype = None
    return lib


def is_webp(head: bytes) -> bool:
    """Pillow's _accept: RIFF, WEBP, then a VP8, VP8L or VP8X chunk."""
    return head[:4] == b"RIFF" and head[8:12] == b"WEBP" and head[12:16] in (b"VP8 ", b"VP8L", b"VP8X")


def _le32(b, at: int) -> int:
    return struct.unpack_from("<I", b, at)[0]


def _le24(b, at: int) -> int:
    return b[at] | (b[at + 1] << 8) | (b[at + 2] << 16)


def _vp8_info(b, at: int, size: int, chunk_size: int):
    """VP8GetInfo: (width, height) of a VP8 frame header, or None."""
    if size < 10 or bytes(b[at + 3: at + 6]) != b"\x9d\x01\x2a":
        return None
    bits = b[at] | (b[at + 1] << 8) | (b[at + 2] << 16)
    w = ((b[at + 7] << 8) | b[at + 6]) & 0x3FFF
    h = ((b[at + 9] << 8) | b[at + 8]) & 0x3FFF
    if bits & 1 or ((bits >> 1) & 7) > 3 or not (bits >> 4) & 1 or (bits >> 5) >= chunk_size or not w or not h:
        return None
    return w, h


def _vp8l_info(b, at: int, size: int):
    """VP8LGetInfo: (width, height, alpha bit) of a VP8L header, or None."""
    if size < 5 or b[at] != 0x2F or b[at + 4] >> 5:
        return None
    v = int.from_bytes(bytes(b[at + 1: at + 5]), "little")
    return (v & 0x3FFF) + 1, ((v >> 14) & 0x3FFF) + 1, (v >> 28) & 1


class _Status:
    OK, NOT_ENOUGH_DATA, ERROR = 0, 1, 2


def _optional_chunks(b, pos: int, size: int, riff_size: int):
    """ParseOptionalChunks: skip to the VP8/VP8L chunk, noting the last
    ALPH payload. (status, pos, size, alpha (offset, size) or None)."""
    total = 4 + CHUNK_HEADER + VP8X_CHUNK
    alpha = None
    while True:
        if size < CHUNK_HEADER:
            return _Status.NOT_ENOUGH_DATA, pos, size, alpha
        chunk_size = _le32(b, pos + 4)
        if chunk_size > MAX_CHUNK_PAYLOAD:
            return _Status.ERROR, pos, size, alpha
        disk = (CHUNK_HEADER + chunk_size + 1) & ~1
        total = (total + disk) & 0xFFFFFFFF
        if riff_size > 0 and total > riff_size:
            return _Status.ERROR, pos, size, alpha
        if bytes(b[pos: pos + 4]) in IMAGE_TAGS:
            return _Status.OK, pos, size, alpha
        if size < disk:
            return _Status.NOT_ENOUGH_DATA, pos, size, alpha
        if bytes(b[pos: pos + 4]) == b"ALPH":
            alpha = (pos + CHUNK_HEADER, chunk_size)
        pos += disk
        size -= disk


def _headers(b, start: int, end: int, have_all_data: bool, want_headers: bool):
    """libwebp's ParseHeadersInternal over b[start:end]: None where it
    fails, else a dict of width, height, has_alpha, animation and, with
    `want_headers`, the payload's offset, whether it is lossless and the
    ALPH payload."""
    pos, size = start, end - start
    if size < RIFF_HEADER:
        return None
    riff_size = 0
    if bytes(b[pos: pos + 4]) == b"RIFF":  # ParseRIFF
        if bytes(b[pos + 8: pos + 12]) != b"WEBP":
            return None
        rs = _le32(b, pos + 4)
        if rs < 4 + CHUNK_HEADER or rs > MAX_CHUNK_PAYLOAD:
            return None
        if have_all_data and rs > size - CHUNK_HEADER:
            return None
        riff_size, pos, size = rs, pos + RIFF_HEADER, size - RIFF_HEADER
    if size < CHUNK_HEADER:  # ParseVP8X
        return None
    found_vp8x, flags, cw, ch = False, 0, 0, 0
    if bytes(b[pos: pos + 4]) == b"VP8X":
        if _le32(b, pos + 4) != VP8X_CHUNK or size < CHUNK_HEADER + VP8X_CHUNK:
            return None
        flags = _le32(b, pos + 8)
        cw, ch = 1 + _le24(b, pos + 12), 1 + _le24(b, pos + 15)
        if cw * ch >= MAX_IMAGE_AREA:
            return None
        pos, size, found_vp8x = pos + CHUNK_HEADER + VP8X_CHUNK, size - CHUNK_HEADER - VP8X_CHUNK, True
    animation = bool(flags & ANIMATION_FLAG)
    if riff_size == 0 and found_vp8x:
        return None
    out = {"width": cw, "height": ch, "has_alpha": bool(flags & ALPHA_FLAG), "animation": animation}
    if found_vp8x and animation and not want_headers:
        return out
    status, alpha = _Status.OK, None
    if size < 4:
        status = _Status.NOT_ENOUGH_DATA
    elif (riff_size and found_vp8x) or (not riff_size and not found_vp8x and bytes(b[pos: pos + 4]) == b"ALPH"):
        status, pos, size, alpha = _optional_chunks(b, pos, size, riff_size)
    lossless = False
    if status == _Status.OK:  # ParseVP8Header
        if size < CHUNK_HEADER:
            status = _Status.NOT_ENOUGH_DATA
        elif bytes(b[pos: pos + 4]) in IMAGE_TAGS:
            compressed = _le32(b, pos + 4)
            if riff_size >= 4 + CHUNK_HEADER and compressed > riff_size - (4 + CHUNK_HEADER):
                return None
            if have_all_data and compressed > size - CHUNK_HEADER:
                return None
            lossless = bytes(b[pos: pos + 4]) == b"VP8L"
            pos, size = pos + CHUNK_HEADER, size - CHUNK_HEADER
        else:  # a raw bitstream
            lossless = size >= 5 and b[pos] == 0x2F and b[pos + 4] >> 5 == 0
            compressed = size
    if status == _Status.OK:
        if compressed > MAX_CHUNK_PAYLOAD:
            return None
        if not lossless:
            if size < 10:
                status = _Status.NOT_ENOUGH_DATA
            else:
                info = _vp8_info(b, pos, size, compressed)
                if info is None:
                    return None
                out["width"], out["height"] = info
        elif size < 5:
            status = _Status.NOT_ENOUGH_DATA
        else:
            info = _vp8l_info(b, pos, size)
            if info is None:
                return None
            out["width"], out["height"], out["has_alpha"] = info[0], info[1], bool(info[2])
        if status == _Status.OK and found_vp8x and (cw, ch) != (out["width"], out["height"]):
            return None
    if status == _Status.OK or (status == _Status.NOT_ENOUGH_DATA and found_vp8x and not want_headers):
        out["has_alpha"] = out["has_alpha"] or alpha is not None
        if want_headers:
            if status != _Status.OK or animation:
                return None
            out.update(offset=pos, lossless=lossless, alpha=alpha)
        return out
    return None


class _Frame:
    def __init__(self):
        self.frame_num = 0
        self.x_offset = self.y_offset = self.width = self.height = 0
        self.complete = False
        self.image = (0, 0)  # (offset of the chunk, chunk size with the available payload)
        self.alpha = (0, 0)


class _DemuxError(Exception):
    pass


class _Demux:
    """WebPDemux (a complete file: allow_partial = 0) over b: the canvas,
    the feature flags and the frames, or _DemuxError where it fails. A
    chunk that runs past the data fails at once: libwebp's "need more
    data" becomes an error in a complete file, whatever it parses next."""

    def __init__(self, b):
        self.b = b
        n = len(b)
        if n < RIFF_HEADER + CHUNK_HEADER or bytes(b[:4]) != b"RIFF" or bytes(b[8:12]) != b"WEBP":
            raise _DemuxError("not a RIFF WEBP file")
        riff_size = _le32(b, 4)
        if riff_size < CHUNK_HEADER or riff_size > MAX_CHUNK_PAYLOAD:
            raise _DemuxError("bad RIFF size")
        self.riff_end = riff_size + CHUNK_HEADER
        self.end = min(n, self.riff_end)
        if n < self.riff_end:
            raise _DemuxError("truncated file (shorter than its RIFF size)")
        self.start = RIFF_HEADER
        self.is_ext = False
        self.flags = 0
        self.canvas = (0, 0)
        self.frames: list[_Frame] = []
        self.num_frames = 0
        tag = bytes(b[self.start: self.start + 4])
        if tag in IMAGE_TAGS:
            self._single_image()
            self._valid_simple()
        elif tag == b"VP8X":
            self._vp8x()
            self._valid_extended()
        else:
            raise _DemuxError(f"first chunk {tag!r}")

    def _need(self, size: int) -> None:
        if self._data_size() < size:
            raise _DemuxError("truncated chunk")

    def _data_size(self) -> int:
        return self.end - self.start

    def _size_invalid(self, size: int) -> bool:
        return size > self.riff_end - self.start

    def _u32(self) -> int:
        v = _le32(self.b, self.start)
        self.start += 4
        return v

    def _u24(self) -> int:
        v = _le24(self.b, self.start)
        self.start += 3
        return v

    def _store_frame(self, frame_num: int, min_size: int, frame: _Frame) -> None:
        """StoreFrame: the ALPH and image chunks of one frame."""
        alpha_chunks = image_chunks = 0
        self._need(max(CHUNK_HEADER, min_size))
        while True:
            chunk_start = self.start
            fourcc = bytes(self.b[self.start: self.start + 4])
            self.start += 4
            payload_size = self._u32()
            if payload_size > MAX_CHUNK_PAYLOAD:
                raise _DemuxError("chunk size")
            padded = payload_size + (payload_size & 1)
            available = min(padded, self._data_size())
            chunk_size = CHUNK_HEADER + available
            if self._size_invalid(padded):
                raise _DemuxError("chunk past the RIFF end")
            self._need(padded)
            done = False
            if fourcc == b"VP8L" and alpha_chunks > 0:
                raise _DemuxError("ALPH before VP8L")
            if fourcc == b"ALPH" and alpha_chunks == 0:
                alpha_chunks = 1
                frame.alpha = (chunk_start, chunk_size)
                frame.frame_num = frame_num
                self.start += available
            elif fourcc in IMAGE_TAGS and image_chunks == 0:
                feats = _headers(self.b, chunk_start, chunk_start + chunk_size, False, False)
                if feats is None:
                    raise _DemuxError("bad image chunk")
                image_chunks = 1
                frame.image = (chunk_start, chunk_size)
                frame.width, frame.height = feats["width"], feats["height"]
                frame.frame_num = frame_num
                frame.complete = True
                self.start += available
            else:
                self.start -= CHUNK_HEADER
                done = True
            if self.start == self.riff_end:
                return
            self._need(CHUNK_HEADER)
            if done:
                return

    def _single_image(self) -> None:
        if self.frames:
            raise _DemuxError("a second image")
        if self._size_invalid(CHUNK_HEADER):
            raise _DemuxError("chunk past the RIFF end")
        self._need(CHUNK_HEADER)
        frame = _Frame()
        self._store_frame(1, 0, frame)
        if not self.flags & ALPHA_FLAG and frame.alpha[1] > 0:  # VP8X without the alpha flag drops ALPH
            frame.alpha = (0, 0)
        if not self.is_ext and frame.width > 0 and frame.height > 0:
            self.canvas = (frame.width, frame.height)
        self.frames.append(frame)
        self.num_frames = 1

    def _vp8x(self) -> None:
        self._need(CHUNK_HEADER)
        self.is_ext = True
        self.start += 4
        size = self._u32()
        if size > MAX_CHUNK_PAYLOAD or size < VP8X_CHUNK:
            raise _DemuxError("VP8X size")
        size += size & 1
        if self._size_invalid(size):
            raise _DemuxError("VP8X past the RIFF end")
        self._need(size)
        self.flags = self.b[self.start]
        self.start += 4
        self.canvas = (1 + self._u24(), 1 + self._u24())
        if self.canvas[0] * self.canvas[1] >= MAX_IMAGE_AREA:
            raise _DemuxError("canvas too large")
        self.start += size - VP8X_CHUNK
        if self._size_invalid(CHUNK_HEADER):
            raise _DemuxError("chunk past the RIFF end")
        self._need(CHUNK_HEADER)
        self._vp8x_chunks()

    def _vp8x_chunks(self) -> None:
        is_animation = bool(self.flags & ANIMATION_FLAG)
        anim_chunks = 0
        while True:
            fourcc = bytes(self.b[self.start: self.start + 4])
            self.start += 4
            chunk_size = self._u32()
            if chunk_size > MAX_CHUNK_PAYLOAD:
                raise _DemuxError("chunk size")
            padded = chunk_size + (chunk_size & 1)
            if self._size_invalid(padded):
                raise _DemuxError("chunk past the RIFF end")
            if fourcc == b"VP8X":
                raise _DemuxError("a second VP8X")
            if fourcc in (b"ALPH", b"VP8 ", b"VP8L"):
                if anim_chunks > 0 or is_animation:
                    raise _DemuxError("an image outside ANMF in an animation")
                self.start -= CHUNK_HEADER
                self._single_image()
            elif fourcc == b"ANIM":
                if padded < ANIM_CHUNK:
                    raise _DemuxError("ANIM size")
                self._need(padded)
                anim_chunks = 1  # a second ANIM is skipped
                self.start += padded
            elif fourcc == b"ANMF":
                if anim_chunks == 0:
                    raise _DemuxError("ANMF before ANIM")
                self._animation_frame(padded)
            else:  # ICCP, EXIF, XMP, unknown chunks: skipped
                self._need(padded)
                self.start += padded
            if self.start == self.riff_end:
                return
            self._need(CHUNK_HEADER)

    def _animation_frame(self, frame_chunk_size: int) -> None:
        is_animation = bool(self.flags & ANIMATION_FLAG)
        if self._size_invalid(ANMF_CHUNK) or frame_chunk_size < ANMF_CHUNK:
            raise _DemuxError("ANMF size")
        self._need(ANMF_CHUNK)
        payload_size = frame_chunk_size - ANMF_CHUNK
        frame = _Frame()
        frame.x_offset = 2 * self._u24()
        frame.y_offset = 2 * self._u24()
        frame.width, frame.height = 1 + self._u24(), 1 + self._u24()  # the image chunk's size replaces these
        self.start += 4  # duration, flags
        if frame.width * frame.height >= MAX_IMAGE_AREA:
            raise _DemuxError("frame too large")
        start = self.start
        self._store_frame(self.num_frames + 1, payload_size, frame)
        if self.start - start > payload_size:
            raise _DemuxError("ANMF payload overrun")
        if is_animation and frame.frame_num > 0:
            self.frames.append(frame)
            self.num_frames += 1

    def _valid_simple(self) -> None:
        if self.canvas[0] <= 0 or self.canvas[1] <= 0 or not self.frames:
            raise _DemuxError("no image")
        if self.frames[0].width <= 0 or self.frames[0].height <= 0:
            raise _DemuxError("no image")

    def _valid_extended(self) -> None:
        is_animation = bool(self.flags & ANIMATION_FLAG)
        if not self.frames:
            raise _DemuxError("no frame")
        if self.flags & ~ALL_VALID_FLAGS:
            raise _DemuxError(f"reserved VP8X flags 0x{self.flags:02x}")
        cw, ch = self.canvas
        for f in self.frames:
            if not is_animation and f.frame_num > 1:
                raise _DemuxError("frames in a still image")
            if not f.complete:
                raise _DemuxError("an incomplete frame")
            if f.alpha[1] == 0 and f.image[1] == 0:
                raise _DemuxError("an empty frame")
            if f.alpha[1] > 0 and f.alpha[0] > f.image[0]:
                raise _DemuxError("ALPH after the image")
            if f.width <= 0 or f.height <= 0:
                raise _DemuxError("an empty frame")
            if is_animation:
                if f.x_offset + f.width > cw or f.y_offset + f.height > ch:
                    raise _DemuxError("a frame outside the canvas")
            elif f.x_offset or f.y_offset or (f.width, f.height) != (cw, ch):
                raise _DemuxError("frame and canvas sizes differ")


def _open(b, path):
    """What PIL's Image.open makes of the file's bytes: (the demuxer, PIL's
    mode), after WebPGetFeatures and the demuxer's checks."""
    if not is_webp(bytes(b[:16])):
        raise ValueError(f"{path}: not a WebP file")
    feats = _headers(b, 0, len(b), False, False)
    if feats is None:
        raise ValueError(f"{path}: corrupt WebP (WebPGetFeatures fails)")
    try:
        dmux = _Demux(b)
    except _DemuxError as e:
        raise ValueError(f"{path}: corrupt WebP container ({e})") from None
    check_size(*dmux.canvas, path)
    return dmux, "RGBA" if feats["has_alpha"] else "RGB"


def webp_header(path) -> tuple[int, int, str]:
    """(width, height, PIL's mode) of a WebP file: the canvas's size, and RGB
    or RGBA."""
    with mapped(path) as b:
        dmux, mode = _open(b, path)
    return dmux.canvas[0], dmux.canvas[1], mode


def read_webp(path) -> Raster:
    """The first frame of a WebP file as PIL gives it (module note)."""
    with mapped(path) as b:
        mode, canvas, rc, err = _decode_first_frame(b, path)
    if rc:
        raise ValueError(f"{path}: {err.value.decode(errors='replace')}")
    return Raster(canvas, mode)


def _decode_first_frame(b, path):
    """(PIL's mode, the canvas, the codec's return code, its message) of the
    mapped file `b`; no view of `b` outlives the call."""
    dmux, mode = _open(b, path)
    cw, ch = dmux.canvas
    frame = next(f for f in dmux.frames if f.frame_num == 1)
    img_off, img_size = frame.image
    start, size = img_off, img_size
    if frame.alpha[1] > 0:  # the fragment runs from the ALPH chunk to the image's end
        start, size = frame.alpha[0], img_off + img_size - frame.alpha[0]
    hdr = _headers(b, start, start + size, True, True)
    if hdr is None:
        raise ValueError(f"{path}: corrupt WebP frame")
    canvas = np.zeros((ch, cw, len(mode)), np.uint8)  # RGB or RGBA
    w, h = hdr["width"], hdr["height"]
    out = canvas[frame.y_offset: frame.y_offset + h, frame.x_offset: frame.x_offset + w]
    data = np.frombuffer(b, np.uint8)
    payload = data[hdr["offset"]: start + size]
    err = ctypes.create_string_buffer(_ERR_BYTES)
    stride = canvas.strides[0]
    if hdr["lossless"]:
        rc = _lib().acz_webp_vp8l(payload.ctypes.data, payload.size, w, h, out.ctypes.data, stride, len(mode), err,
                                  _ERR_BYTES)
    else:
        alpha = hdr["alpha"]
        a_ptr, a_size = (data[alpha[0]:].ctypes.data, alpha[1]) if alpha is not None else (None, 0)
        rc = _lib().acz_webp_vp8(payload.ctypes.data, payload.size, a_ptr, a_size, int(alpha is not None), w, h,
                                 out.ctypes.data, stride, len(mode), err, _ERR_BYTES)
    return mode, canvas, rc, err


def encode_webp(img: np.ndarray) -> bytes:
    """A lossless WebP file of an (h, w, 3) or (h, w, 4) uint8 image."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim != 3 or img.shape[2] not in (3, 4):
        raise ValueError(f"cannot write an array of shape {img.shape} as WebP")
    h, w, c = img.shape
    out = ctypes.c_void_p()
    err = ctypes.create_string_buffer(_ERR_BYTES)
    n = _lib().acz_webp_vp8l_encode(img.ctypes.data, w, h, c, int(c == 4), ctypes.byref(out), err, _ERR_BYTES)
    if n < 0:
        raise ValueError(err.value.decode(errors="replace"))
    try:
        payload = ctypes.string_at(out, n)
    finally:
        _lib().acz_webp_free(out)
    pad = b"\x00" * (n & 1)
    return (b"RIFF" + struct.pack("<I", 4 + CHUNK_HEADER + n + len(pad)) + b"WEBP" + b"VP8L" + struct.pack("<I", n)
            + payload + pad)


def write_webp(path, img: np.ndarray) -> None:
    """Write `img` as a lossless WebP file (`encode_webp`)."""
    Path(path).write_bytes(encode_webp(img))
