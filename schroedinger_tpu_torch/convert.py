"""Carry codec state between the JAX package and the port.

A codec has no weights: the state that crosses a picture boundary is the
reference buffer.  `ref_frame_from_numpy` builds the port's RefFrame from
numpy planes (for example a JAX `RefFrame`'s planes and, optionally, its
interleaved half-pel planes), and `ref_frame_to_numpy` returns them.
`Params` and the tables are shared by both packages as they are.
"""
from __future__ import annotations

import numpy as np
import torch

from schroedinger_tpu_torch.decoder.core import RefFrame


def ref_frame_from_numpy(planes, upsampled=None, device="cpu") -> RefFrame:
    """(y, u, v) u8 planes [+ their three (2h, 2w) half-pel planes] ->
    RefFrame of u8 tensors on `device`."""
    def dev(a):
        return torch.tensor(np.asarray(a, np.uint8), device=device)

    ups = None if upsampled is None else [dev(u) for u in upsampled]
    return RefFrame(tuple(dev(pl) for pl in planes), upsampled=ups)


def ref_frame_to_numpy(ref: RefFrame):
    """RefFrame -> ((y, u, v) numpy u8 planes, half-pel planes or None)."""
    planes = tuple(pl.cpu().numpy() for pl in ref.planes)
    ups = (None if ref.upsampled is None
           else [u.cpu().numpy() for u in ref.upsampled])
    return planes, ups
