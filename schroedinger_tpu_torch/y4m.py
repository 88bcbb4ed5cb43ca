"""YUV4MPEG2 (.y4m) streaming reader/writer — the pipe frontend.

A whole copy of `schroedinger_tpu/y4m.py` (pure host code) for the port.
The reference integrates with media pipelines through its GStreamer
elements (gst/gstschroenc.c); the equivalent here is this Y4M codec over
files or pipes, so any ffmpeg build can front the encoder:

    ffmpeg -i clip.mp4 -f yuv4mpegpipe - | \
        python -m schroedinger_tpu_torch.tools.schro_tpu encode - out.drc \
        --profile longgop

Supports C420 (jpeg/mpeg2/paldv siting treated alike), C422, C444 at
8 bits, and C420p10/C422p10/C444p10 16-bit-LE deep variants; interlace
flags It/Ib/Ip map onto VideoFormat.interlaced/top_field_first.
Frames stream lazily: read_frames() is a generator, safe on pipes.
"""
from __future__ import annotations

import io
from dataclasses import dataclass
from typing import BinaryIO, Iterable, Iterator, Optional, Tuple

import numpy as np

from schroedinger_tpu_torch.video_format import ChromaFormat, VideoFormat

_CHROMA = {
    "420": (ChromaFormat.C420, 8), "420jpeg": (ChromaFormat.C420, 8),
    "420mpeg2": (ChromaFormat.C420, 8), "420paldv": (ChromaFormat.C420, 8),
    "422": (ChromaFormat.C422, 8), "444": (ChromaFormat.C444, 8),
    "420p10": (ChromaFormat.C420, 10), "422p10": (ChromaFormat.C422, 10),
    "444p10": (ChromaFormat.C444, 10),
}
_CHROMA_TAG = {(ChromaFormat.C420, 8): "420mpeg2",
               (ChromaFormat.C422, 8): "422",
               (ChromaFormat.C444, 8): "444",
               (ChromaFormat.C420, 10): "420p10",
               (ChromaFormat.C422, 10): "422p10",
               (ChromaFormat.C444, 10): "444p10"}


@dataclass
class Y4MHeader:
    width: int
    height: int
    fps_num: int = 25
    fps_den: int = 1
    interlace: str = "p"       # p / t / b (t = top field first)
    aspect_num: int = 0
    aspect_den: int = 0
    chroma: ChromaFormat = ChromaFormat.C420
    bit_depth: int = 8

    def video_format(self) -> VideoFormat:
        vf = VideoFormat(width=self.width, height=self.height,
                         clean_width=self.width, clean_height=self.height,
                         chroma_format=self.chroma,
                         frame_rate_numerator=max(self.fps_num, 1),
                         frame_rate_denominator=max(self.fps_den, 1))
        if self.aspect_num and self.aspect_den:
            vf.aspect_ratio_numerator = self.aspect_num
            vf.aspect_ratio_denominator = self.aspect_den
        if self.interlace in ("t", "b"):
            vf.interlaced = True
            vf.top_field_first = self.interlace == "t"
        if self.bit_depth > 8:
            vf.luma_offset = 64 << (self.bit_depth - 10)
            vf.luma_excursion = 876 << (self.bit_depth - 10)
            vf.chroma_offset = 512 << (self.bit_depth - 10)
            vf.chroma_excursion = 896 << (self.bit_depth - 10)
        return vf


def _plane_shapes(h: Y4MHeader) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    if h.chroma == ChromaFormat.C420:
        c = (h.height // 2, h.width // 2)
    elif h.chroma == ChromaFormat.C422:
        c = (h.height, h.width // 2)
    else:
        c = (h.height, h.width)
    return (h.height, h.width), c


def parse_header(line: bytes) -> Y4MHeader:
    if not line.startswith(b"YUV4MPEG2"):
        raise ValueError("not a YUV4MPEG2 stream")
    h = Y4MHeader(width=0, height=0)
    for tok in line.decode("ascii", "replace").split()[1:]:
        tag, val = tok[0], tok[1:]
        if tag == "W":
            h.width = int(val)
        elif tag == "H":
            h.height = int(val)
        elif tag == "F":
            h.fps_num, h.fps_den = (int(t) for t in val.split(":"))
        elif tag == "I":
            h.interlace = val or "p"
        elif tag == "A":
            try:
                h.aspect_num, h.aspect_den = (int(t) for t in val.split(":"))
            except ValueError:
                pass
        elif tag == "C":
            if val not in _CHROMA:
                raise ValueError(f"unsupported Y4M chroma C{val}")
            h.chroma, h.bit_depth = _CHROMA[val]
    if not (h.width and h.height):
        raise ValueError("Y4M header missing W/H")
    return h


def _read_exact(f: BinaryIO, n: int) -> Optional[bytes]:
    buf = bytearray()
    while len(buf) < n:
        piece = f.read(n - len(buf))
        if not piece:
            return None
        buf += piece
    return bytes(buf)


class Y4MReader:
    """Lazy frame reader over a file object or path (pipes welcome)."""

    def __init__(self, src):
        self._own = isinstance(src, (str, bytes))
        self._f: BinaryIO = open(src, "rb") if self._own else src
        line = self._f.readline()
        self.header = parse_header(line)

    def read_frames(self) -> Iterator[Tuple[np.ndarray, ...]]:
        h = self.header
        (yh, yw), (ch, cw) = _plane_shapes(h)
        dt = np.uint8 if h.bit_depth == 8 else np.dtype("<u2")
        nbytes = dt.itemsize if hasattr(dt, "itemsize") else 1
        nbytes = np.dtype(dt).itemsize
        while True:
            marker = self._f.readline()
            if not marker:
                break
            if not marker.startswith(b"FRAME"):
                raise ValueError("bad Y4M frame marker %r" % marker[:16])
            y = _read_exact(self._f, yh * yw * nbytes)
            u = _read_exact(self._f, ch * cw * nbytes)
            v = _read_exact(self._f, ch * cw * nbytes)
            if y is None or u is None or v is None:
                break  # truncated tail: stop cleanly (pipe hangup)
            yield (np.frombuffer(y, dt).reshape(yh, yw),
                   np.frombuffer(u, dt).reshape(ch, cw),
                   np.frombuffer(v, dt).reshape(ch, cw))
        if self._own:
            self._f.close()


class Y4MWriter:
    def __init__(self, dst, vf: VideoFormat, bit_depth: int = 8):
        self._own = isinstance(dst, (str, bytes))
        self._f: BinaryIO = open(dst, "wb") if self._own else dst
        tag = _CHROMA_TAG[(vf.chroma_format, bit_depth)]
        inter = "p"
        if getattr(vf, "interlaced", False):
            inter = "t" if getattr(vf, "top_field_first", True) else "b"
        hdr = "YUV4MPEG2 W%d H%d F%d:%d I%s A%d:%d C%s\n" % (
            vf.width, vf.height, vf.frame_rate_numerator,
            vf.frame_rate_denominator, inter,
            vf.aspect_ratio_numerator, vf.aspect_ratio_denominator, tag)
        self._f.write(hdr.encode("ascii"))
        self._dt = np.uint8 if bit_depth == 8 else np.dtype("<u2")

    def write_frame(self, planes) -> None:
        self._f.write(b"FRAME\n")
        for p in planes:
            self._f.write(np.ascontiguousarray(p, self._dt).tobytes())

    def write_frames(self, frames: Iterable) -> int:
        n = 0
        for f in frames:
            self.write_frame(f)
            n += 1
        return n

    def close(self) -> None:
        self._f.flush()
        if self._own:
            self._f.close()


def read_y4m(src):
    """(video_format, frames_iterator, bit_depth) from a path or pipe."""
    r = Y4MReader(src)
    return r.header.video_format(), r.read_frames(), r.header.bit_depth
