"""Padding of the last two dims: edge replication (jnp.pad mode="edge")
and bottom/right zero fill, for any dtype on any device."""
from __future__ import annotations

import torch


def pad_edge(x, top: int, bottom: int, left: int, right: int):
    """Edge-replicating pad of the last two dims (jnp.pad mode="edge")."""
    h, w = x.shape[-2:]
    if top or bottom:
        ys = torch.arange(-top, h + bottom, device=x.device).clamp(0, h - 1)
        x = x.index_select(x.ndim - 2, ys)
    if left or right:
        xs = torch.arange(-left, w + right, device=x.device).clamp(0, w - 1)
        x = x.index_select(x.ndim - 1, xs)
    return x


def pad_zero(x, out_h: int, out_w: int):
    """Zero pad of the last two dims at the bottom/right to (out_h, out_w)."""
    h, w = x.shape[-2:]
    if (h, w) == (out_h, out_w):
        return x
    out = torch.zeros(x.shape[:-2] + (out_h, out_w), dtype=x.dtype,
                      device=x.device)
    out[..., :h, :w] = x
    return out
