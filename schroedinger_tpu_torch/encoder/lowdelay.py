"""Encoder-side plane preparation and forward transform shared by the intra
and inter coders (port of `schroedinger_tpu/encoder/lowdelay.py`
`_prep_plane` and `_forward`; the VC-2 low-delay profile itself is not
ported yet)."""
from __future__ import annotations

import torch

from schroedinger_tpu_torch.ops import wavelet as wv
from schroedinger_tpu_torch.ops.pad import pad_edge


def _prep_plane(plane_u8, out_h: int, out_w: int):
    """u8 -> s16 - 128, edge-extended to (out_h, out_w)."""
    x = plane_u8.to(torch.int16) - 128
    h, w = x.shape
    return pad_edge(x, 0, out_h - h, 0, out_w - w)


def _forward(plane, depth, wavelet):
    return wv.forward(plane, depth, wavelet)
