"""Video format description + Dirac standard format tables.

Mirrors SchroVideoFormat semantics (reference: schrovideoformat.c,
schrobitstream.h:55-121) as a plain dataclass usable inside jit-static
configuration.

Whole copy of `schroedinger_tpu/video_format.py`: the port imports nothing of
the JAX package, and later slices find their entry points here.
"""
from __future__ import annotations

import dataclasses
import enum


class ChromaFormat(enum.IntEnum):
    C444 = 0
    C422 = 1
    C420 = 2

    @property
    def h_shift(self) -> int:
        return 0 if self == ChromaFormat.C444 else 1

    @property
    def v_shift(self) -> int:
        return 1 if self == ChromaFormat.C420 else 0


@dataclasses.dataclass
class VideoFormat:
    index: int = 0
    width: int = 640
    height: int = 480
    chroma_format: ChromaFormat = ChromaFormat.C420

    interlaced: bool = False
    top_field_first: bool = False

    frame_rate_numerator: int = 24000
    frame_rate_denominator: int = 1001
    aspect_ratio_numerator: int = 1
    aspect_ratio_denominator: int = 1

    clean_width: int = 640
    clean_height: int = 480
    left_offset: int = 0
    top_offset: int = 0

    luma_offset: int = 0
    luma_excursion: int = 255
    chroma_offset: int = 128
    chroma_excursion: int = 255

    colour_primaries: int = 0
    colour_matrix: int = 0
    transfer_function: int = 0

    interlaced_coding: bool = False

    @property
    def bit_depth(self) -> int:
        """Luma bit depth derived from excursion (schrovideoformat.h:47-76)."""
        if self.luma_excursion < 256:
            return 8
        if self.luma_excursion < 1024:
            return 10
        if self.luma_excursion < 4096:
            return 12
        return 16

    @property
    def chroma_width(self) -> int:
        return -(-self.width // (1 << self.chroma_format.h_shift))

    @property
    def chroma_height(self) -> int:
        return -(-self.height // (1 << self.chroma_format.v_shift))

    def picture_luma_size(self):
        """Picture size as coded (handles interlaced coding field split)."""
        h = self.height
        if self.interlaced_coding:
            h = -(-h // 2)
        return self.width, h

    def picture_chroma_size(self):
        w, h = self.picture_luma_size()
        return (-(-w // (1 << self.chroma_format.h_shift)),
                -(-h // (1 << self.chroma_format.v_shift)))


# Standard format table, index 0..20 (schrovideoformat.c:117-264).
# Tuple: (width, height, chroma, interlaced, tff, fr_num, fr_den, ar_num,
#         ar_den, clean_w, clean_h, left_off, top_off, luma_off, luma_exc,
#         chroma_off, chroma_exc, colour_spec_index)
_STD = [
    (640, 480, 2, 0, 0, 24000, 1001, 1, 1, 640, 480, 0, 0, 0, 255, 128, 255, 0),
    (176, 120, 2, 0, 0, 15000, 1001, 10, 11, 176, 120, 0, 0, 0, 255, 128, 255, 1),
    (176, 144, 2, 0, 1, 25, 2, 12, 11, 176, 144, 0, 0, 0, 255, 128, 255, 2),
    (352, 240, 2, 0, 0, 15000, 1001, 10, 11, 352, 240, 0, 0, 0, 255, 128, 255, 1),
    (352, 288, 2, 0, 1, 25, 2, 12, 11, 352, 288, 0, 0, 0, 255, 128, 255, 2),
    (704, 480, 2, 0, 0, 15000, 1001, 10, 11, 704, 480, 0, 0, 0, 255, 128, 255, 1),
    (704, 576, 2, 0, 1, 25, 2, 12, 11, 704, 576, 0, 0, 0, 255, 128, 255, 2),
    (720, 480, 1, 1, 0, 30000, 1001, 10, 11, 704, 480, 8, 0, 64, 876, 512, 896, 1),
    (720, 576, 1, 1, 1, 25, 1, 12, 11, 704, 576, 8, 0, 64, 876, 512, 896, 2),
    (1280, 720, 1, 0, 1, 60000, 1001, 1, 1, 1280, 720, 0, 0, 64, 876, 512, 896, 0),
    (1280, 720, 1, 0, 1, 50, 1, 1, 1, 1280, 720, 0, 0, 64, 876, 512, 896, 0),
    (1920, 1080, 1, 1, 1, 30000, 1001, 1, 1, 1920, 1080, 0, 0, 64, 876, 512, 896, 0),
    (1920, 1080, 1, 1, 1, 25, 1, 1, 1, 1920, 1080, 0, 0, 64, 876, 512, 896, 0),
    (1920, 1080, 1, 0, 1, 60000, 1001, 1, 1, 1920, 1080, 0, 0, 64, 876, 512, 896, 0),
    (1920, 1080, 1, 0, 1, 50, 1, 1, 1, 1920, 1080, 0, 0, 64, 876, 512, 896, 0),
    (2048, 1080, 0, 0, 1, 24, 1, 1, 1, 2048, 1080, 0, 0, 256, 3504, 2048, 3584, 3),
    (4096, 2160, 0, 0, 1, 24, 1, 1, 1, 2048, 1536, 0, 0, 256, 3504, 2048, 3584, 3),
    (3840, 2160, 1, 0, 1, 60000, 1001, 1, 1, 3840, 2160, 0, 0, 64, 876, 512, 896, 0),
    (3840, 2160, 1, 0, 1, 50, 1, 1, 1, 3840, 2160, 0, 0, 64, 876, 512, 896, 0),
    (7680, 4320, 1, 0, 1, 60000, 1001, 1, 1, 7680, 4320, 0, 0, 64, 876, 512, 896, 0),
    (7680, 4320, 1, 0, 1, 50, 1, 1, 1, 7680, 4320, 0, 0, 64, 876, 512, 896, 0),
]

# Colour spec table index -> (primaries, matrix, transfer function)
# (schrovideoformat.c:636-658)
_COLOUR_SPECS = [(0, 0, 0), (1, 1, 0), (2, 1, 0), (0, 0, 0), (3, 0, 0)]

# Standard tables used by sequence-header coding (schrovideoformat.c:421-570).
STD_FRAME_RATES = [(0, 0), (24000, 1001), (24, 1), (25, 1), (30000, 1001),
                   (30, 1), (50, 1), (60000, 1001), (60, 1), (15000, 1001), (25, 2)]
STD_ASPECT_RATIOS = [(0, 0), (1, 1), (10, 11), (12, 11), (40, 33), (16, 11), (4, 3)]
STD_SIGNAL_RANGES = [(0, 0, 0, 0), (0, 255, 128, 255), (16, 219, 128, 224),
                     (64, 876, 512, 896), (256, 3504, 2048, 3584)]


def std_video_format(index: int) -> VideoFormat:
    """Build a VideoFormat from a Dirac standard format index (0..20)."""
    (w, h, cf, il, tff, frn, frd, arn, ard, cw, ch, lo, to,
     loff, lexc, coff, cexc, cspec) = _STD[index]
    prim, mat, tf = _COLOUR_SPECS[cspec]
    return VideoFormat(
        index=index, width=w, height=h, chroma_format=ChromaFormat(cf),
        interlaced=bool(il), top_field_first=bool(tff),
        frame_rate_numerator=frn, frame_rate_denominator=frd,
        aspect_ratio_numerator=arn, aspect_ratio_denominator=ard,
        clean_width=cw, clean_height=ch, left_offset=lo, top_offset=to,
        luma_offset=loff, luma_excursion=lexc,
        chroma_offset=coff, chroma_excursion=cexc,
        colour_primaries=prim, colour_matrix=mat, transfer_function=tf)


def guess_std_index(vf: VideoFormat) -> int:
    """Best matching standard index for header coding (metric as reference)."""
    best, best_score = 0, -1
    for i in range(len(_STD)):
        std = std_video_format(i)
        score = 0
        if std.width == vf.width and std.height == vf.height:
            score += 2
        if (std.frame_rate_numerator == vf.frame_rate_numerator
                and std.frame_rate_denominator == vf.frame_rate_denominator):
            score += 1
        if std.interlaced == vf.interlaced:
            score += 1
        # top_field_first is NOT explicitly coded in the stream — it can
        # only come from the base index, so a match is a hard requirement
        # for interlaced sources (schrovideoformat.c:295-299, weight 0x8000)
        if vf.interlaced and std.top_field_first == vf.top_field_first:
            score += 0x8000
        if score > best_score:
            best, best_score = i, score
    return best
