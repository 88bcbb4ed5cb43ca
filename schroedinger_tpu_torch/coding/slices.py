"""Subband pyramid <-> flat layouts (torch twins of
`schroedinger_tpu/coding/slices.py` subband_arrays / arrays_to_pyramid /
flatten_pyramid and unflatten_host; the low-delay slice helpers there
are not ported yet)."""
from __future__ import annotations

import torch

from schroedinger_tpu_torch.params import subband_count, subband_info


def subband_arrays(pyr, depth: int):
    """Pyramid dict -> list of subband arrays in Dirac subband-index order."""
    out = []
    for i in range(subband_count(depth)):
        level, name = subband_info(i, depth)
        out.append(pyr["ll"] if i == 0 else pyr["levels"][level][name])
    return out


def arrays_to_pyramid(arrays, depth: int):
    """Inverse of subband_arrays."""
    levels = [dict() for _ in range(depth)]
    pyr = {"ll": arrays[0], "levels": levels}
    for i in range(1, subband_count(depth)):
        level, name = subband_info(i, depth)
        levels[level][name] = arrays[i]
    return pyr


def flatten_pyramid(pyr, depth: int):
    """Concatenate all subbands into one flat tensor (one per leading
    index of a batched pyramid: (..., n)).

    Returns (flat, shapes) where shapes[i] is the (h, w) of subband i."""
    arrays = subband_arrays(pyr, depth)
    shapes = [tuple(a.shape[-2:]) for a in arrays]
    flat = torch.cat([a.reshape(*a.shape[:-2], -1) for a in arrays], -1)
    return flat, shapes


def unflatten(flat, shapes):
    """Split a flat band tensor (..., n) back into (..., h, w) views
    (device twin of `schroedinger_tpu.coding.slices.unflatten_host`)."""
    out = []
    pos = 0
    for (h, w) in shapes:
        out.append(flat[..., pos:pos + h * w].reshape(*flat.shape[:-1], h,
                                                      w))
        pos += h * w
    return out
