"""The port's slices: the encoder configurations and their input frames.

`GopEncoder(video_format(w, h), device=..., **CONFIG)` is the
fixed-quantiser backref long-GOP encode (quarter-pel MVs, MD5 aux
units); `**CONFIG_FLAGSHIP` is the flagship: the biref engine (I, two-
reference P, subgroups of three two-reference B pictures) under TM5 CBR
at 8 Mbit/s and 25 frames/s with the on-device RD pick, MD5 on so that a
decoder can check every picture.  The smoke run, the profiler and the
parity tests drive both; `make_frames` makes their pan + noise input from
a seed.  `**CONFIG_FLAGSHIP_DRAINING` is the flagship at 1 Mbit/s with
its reservoir half empty at the start: at 1080p the per-picture lambda
fit then binds (the reservoir is below 0.7 of its size and a P picture's
allocation is less than its cost at the controller's lambda), which the
full reservoir of a stream's first pictures never shows.
`**CONFIG_BENCH` is `bench.py`'s headline encoder (`bench.py:136-139`):
the biref TM5 CBR encode at 8 Mbit/s with the JAX defaults otherwise, so
MD5 off and a full subgroup's B pictures coded as one batch;
`make_frames(n, 1920, 1080)` is `bench.py`'s `make_frames(n)`; with
`chroma_format` and `bit_depth` it makes the same pan + noise at another
chroma format, scaled to 10, 12 or 16 bits, for `video_format(w, h,
chroma_format, bit_depth)` (y4m's deep offsets), the VC-2 profiles'
input.
"""
from __future__ import annotations

import numpy as np

from schroedinger_tpu_torch.video_format import ChromaFormat, VideoFormat

CONFIG = dict(gop_structure="backref", bitrate=0, mv_precision=2,
              enable_md5=True)
CONFIG_FLAGSHIP = dict(gop_structure="biref", bitrate=8_000_000, fps=25,
                       mv_precision=2, gop_length=24, subgroup_length=4,
                       enable_md5=True, enable_b_batch=False)
CONFIG_FLAGSHIP_DRAINING = dict(CONFIG_FLAGSHIP, bitrate=1_000_000,
                                buffer_level=1_500_000)
CONFIG_BENCH = dict(gop_length=24, mv_precision=2, bitrate=8_000_000, fps=25,
                    gop_structure="biref")


def video_format(width, height, chroma_format=ChromaFormat.C420,
                 bit_depth=8):
    """Progressive 25 frames/s, 8-bit 4:2:0 unless asked otherwise; a deep
    format takes the offsets and excursions y4m gives it (studio range,
    `y4m.Y4MHeader.video_format`)."""
    deep = {}
    if bit_depth > 8:
        s = bit_depth - 10
        deep = dict(luma_offset=64 << s, luma_excursion=876 << s,
                    chroma_offset=512 << s, chroma_excursion=896 << s)
    vf = VideoFormat(width=width, height=height, clean_width=width,
                     clean_height=height, chroma_format=chroma_format,
                     frame_rate_numerator=25, frame_rate_denominator=1,
                     **deep)
    assert vf.bit_depth == bit_depth
    return vf


def make_frames(n, width, height, seed=0, chroma_format=ChromaFormat.C420,
                bit_depth=8):
    """n frames of pan + noise (numpy default_rng(seed)): a smooth luma
    pattern shifted 2 px right per frame plus N(0, 4) noise, fixed
    chroma, all scaled by 2^(bit_depth - 8).  Returns [(y, u, v) u8
    arrays], u16 when deep."""
    rng = np.random.default_rng(seed)
    scale = 1 << (bit_depth - 8)
    top = (1 << bit_depth) - 1
    dt = np.uint8 if bit_depth == 8 else np.uint16
    yy, xx = np.mgrid[0:height, 0:width]
    cy = yy[::1 << chroma_format.v_shift, ::1 << chroma_format.h_shift]
    cx = xx[::1 << chroma_format.v_shift, ::1 << chroma_format.h_shift]
    base_y = 128 + 64 * np.sin(xx / 37.0) * np.cos(yy / 23.0)
    u = ((128 + 24 * np.cos(cx / 31.0)) * scale).clip(0, top).astype(dt)
    v = ((128 + 24 * np.sin(cy / 29.0)) * scale).clip(0, top).astype(dt)
    return [(((np.roll(base_y, i * 2, axis=1)
               + rng.normal(0, 4, (height, width))) * scale).clip(
                   0, top).astype(dt), u, v) for i in range(n)]
