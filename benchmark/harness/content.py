"""The benchmark's test content: frozen copies of the port's content makers.

`bench.py`'s `make_frames` (pan + noise), `make_frames_zoomrot` and
`make_frames_scenecut`, and `slice_config.make_frames`'s deep 4:2:2 form,
with the same patterns, pans, cuts and noise levels.  A mix may ask for
several clips (`passes`): each starts the pattern at a horizontal phase
of its own and has noise of its own, so that no clip repeats another.
The noise is drawn on the device from a `torch.Generator` seeded with
the run's seed, in one call per frame, and the phases from a NumPy
generator seeded alike, so a seed gives the same clips on the same kind
of device; only the noise and the phases change from seed to seed, never
the sizes or the motion.  Frames come back as host numpy planes (y, u, v), uint8, or
uint16 above 8 bits, as the codec's API takes them.
"""
from __future__ import annotations

import math

import numpy as np
import torch

# (vertical, horizontal) chroma subsampling shifts
CHROMA_SHIFTS = {"444": (0, 0), "422": (0, 1), "420": (1, 1)}


def _grid(height, width, device):
    yy = torch.arange(height, device=device, dtype=torch.float64)[:, None]
    xx = torch.arange(width, device=device, dtype=torch.float64)[None, :]
    return yy.expand(height, width), xx.expand(height, width)


def _to_host(plane, bit_depth):
    top = (1 << bit_depth) - 1
    dt = torch.uint8 if bit_depth == 8 else torch.int32
    out = plane.clamp(0, top).to(dt).cpu().numpy()
    return out if bit_depth == 8 else out.astype(np.uint16)


def _chroma(height, width, chroma, bit_depth, device):
    """The fixed chroma of every content: cos / sin ramps at the chroma
    grid's luma coordinates, scaled to the bit depth."""
    vs, hs = CHROMA_SHIFTS[chroma]
    yy, xx = _grid(height, width, device)
    cy, cx = yy[::1 << vs, ::1 << hs], xx[::1 << vs, ::1 << hs]
    scale = 1 << (bit_depth - 8)
    u = (128 + 24 * torch.cos(cx / 31.0)) * scale
    v = (128 + 24 * torch.sin(cy / 29.0)) * scale
    return _to_host(u, bit_depth), _to_host(v, bit_depth)


def make_clips(traffic, width, height, chroma, bit_depth, seed, device):
    """The clips a traffic mix names (`passes` of them, 1 by default):
    `content` is "pan" (a smooth pattern panned `pan_px` a frame,
    `bench.py`'s headline content), "zoomrot" (slow zoom and rotation
    about the centre) or "scenecut" (a pan of `pan_px` with a cut to the
    next of three scenes every `cut_every` frames); noise of standard
    deviation `noise` on the luma, `frames` frames each.  The first clip
    starts at phase 0, as the port's content makers do; zoomrot has no
    phase."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    passes = int(traffic.get("passes", 1))
    phases = [0] + np.random.default_rng(int(seed)).integers(
        0, width, passes - 1).tolist()
    return [_make_clip(traffic, width, height, chroma, bit_depth, gen,
                       int(ph), device) for ph in phases]


def _make_clip(traffic, width, height, chroma, bit_depth, gen, phase,
               device):
    kind = traffic["content"]
    n = int(traffic["frames"])
    noise = float(traffic["noise"])
    yy, xx = _grid(height, width, device)
    scale = 1 << (bit_depth - 8)
    u, v = _chroma(height, width, chroma, bit_depth, device)
    if kind == "pan":
        scenes = [128 + 64 * torch.sin(xx / 37.0) * torch.cos(yy / 23.0)]
    elif kind == "scenecut":
        scenes = [128 + 64 * torch.sin(xx / p) * torch.cos(yy / q)
                  for (p, q) in ((37.0, 23.0), (11.0, 47.0), (71.0, 13.0))]
    elif kind != "zoomrot":
        raise ValueError(f"unknown content {kind!r}")
    frames = []
    for i in range(n):
        if kind == "zoomrot":
            ang, zoom = 0.004 * i, 1.0 + 0.002 * i
            ca, sa = math.cos(ang) / zoom, math.sin(ang) / zoom
            cy, cx = height / 2.0, width / 2.0
            sx = ca * (xx - cx) - sa * (yy - cy) + cx
            sy = sa * (xx - cx) + ca * (yy - cy) + cy
            base = (128 + 52 * torch.sin(sx / 17.0) * torch.cos(sy / 13.0)
                    + 28 * torch.sin((sx + 2 * sy) / 53.0))
        else:
            cut = int(traffic.get("cut_every", 0) or 0)
            scene = scenes[(i // cut) % len(scenes)] if cut else scenes[0]
            base = torch.roll(scene, phase + i * int(traffic["pan_px"]),
                              dims=1)
        grain = torch.randn((height, width), generator=gen, device=device,
                            dtype=torch.float32).double() * noise
        frames.append((_to_host((base + grain) * scale, bit_depth), u, v))
    return frames
