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
`make_frames(n, 1920, 1080)` is `bench.py`'s `make_frames(n)`.
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


def video_format(width, height):
    """Progressive 8-bit 4:2:0 at 25 frames/s."""
    return VideoFormat(width=width, height=height, clean_width=width,
                       clean_height=height, chroma_format=ChromaFormat.C420,
                       frame_rate_numerator=25, frame_rate_denominator=1)


def make_frames(n, width, height, seed=0):
    """n frames of 4:2:0 pan + noise (numpy default_rng(seed)): a smooth
    luma pattern shifted 2 px right per frame plus N(0, 4) noise, fixed
    chroma.  Returns [(y, u, v) u8 arrays]."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:height, 0:width]
    base_y = 128 + 64 * np.sin(xx / 37.0) * np.cos(yy / 23.0)
    u = (128 + 24 * np.cos(xx[::2, ::2] / 31.0)).clip(0, 255).astype(
        np.uint8)
    v = (128 + 24 * np.sin(yy[::2, ::2] / 29.0)).clip(0, 255).astype(
        np.uint8)
    return [((np.roll(base_y, i * 2, axis=1)
              + rng.normal(0, 4, (height, width))).clip(0, 255).astype(
                  np.uint8), u, v) for i in range(n)]
