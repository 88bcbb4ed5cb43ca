"""Subband pyramid <-> flat and VC-2 low-delay slice layouts.

Port of `schroedinger_tpu/coding/slices.py`.  A slice (sy, sx) owns the
codeblock [h*sy/ny, h*(sy+1)/ny) x [w*sx/nx, ...) of every subband
(schroframe.c schro_frame_data_get_codeblock).  With the standard
constraint that subband dims divide by the slice counts
(schrolowdelay.c:581-584 asserts), each subband reshapes cleanly into
(ny, bh, nx, bw); slices then become dense (ny, nx, S) arrays, every
slice a row.  The slice helpers take numpy arrays or torch tensors and
return the same kind; the dtype passes through (int16 on the wire at 8
bits, int32 when deep).
"""
from __future__ import annotations

import numpy as np
import torch

from schroedinger_tpu_torch.params import Params, subband_count, subband_info


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


def _swap(a, i: int, j: int):
    return a.swapaxes(i, j) if isinstance(a, np.ndarray) else a.transpose(i,
                                                                          j)


def to_slices(arrays, ny: int, nx: int):
    """Subband arrays -> (slices (ny, nx, S), per-position subband index
    (S,) int32 numpy).

    Requires every subband's dims to divide by ny/nx (the reference's fast
    path constraint)."""
    parts = []
    band_idx = []
    for i, a in enumerate(arrays):
        h, w = a.shape[-2:]
        assert h % ny == 0 and w % nx == 0, (i, h, w, ny, nx)
        bh, bw = h // ny, w // nx
        r = _swap(a.reshape(a.shape[:-2] + (ny, bh, nx, bw)), -3, -2)
        parts.append(r.reshape(a.shape[:-2] + (ny, nx, bh * bw)))
        band_idx.extend([i] * (bh * bw))
    cat = (np.concatenate(parts, axis=-1) if isinstance(parts[0], np.ndarray)
           else torch.cat(parts, -1))
    return cat, np.asarray(band_idx, dtype=np.int32)


def from_slices(sliced, shapes, ny: int, nx: int):
    """(ny, nx, S) array -> list of subband arrays with given (h, w) shapes."""
    out = []
    pos = 0
    for (h, w) in shapes:
        bh, bw = h // ny, w // nx
        n = bh * bw
        part = sliced[..., pos:pos + n]
        part = _swap(part.reshape(part.shape[:-3] + (ny, nx, bh, bw)), -3, -2)
        out.append(part.reshape(part.shape[:-4] + (h, w)))
        pos += n
    assert pos == sliced.shape[-1]
    return out


def band_sizes(arrays, ny: int, nx: int):
    return [(a.shape[-2] // ny) * (a.shape[-1] // nx) for a in arrays]


def qmat_offsets(params: Params, band_idx):
    """Per-position quant-matrix value (base_index - this = quant index)."""
    qm = np.asarray(
        params.quant_matrix[: subband_count(params.transform_depth)],
        dtype=np.int32)
    return qm[band_idx]


def flatten_pyramid(pyr, depth: int):
    """Concatenate all subbands into one flat tensor (one per leading
    index of a batched pyramid: (..., n)).

    Returns (flat, shapes) where shapes[i] is the (h, w) of subband i."""
    arrays = subband_arrays(pyr, depth)
    shapes = [tuple(a.shape[-2:]) for a in arrays]
    flat = torch.cat([a.reshape(*a.shape[:-2], -1) for a in arrays], -1)
    return flat, shapes


def unflatten(flat, shapes):
    """Split a flat band array (..., n), numpy or tensor, back into
    (..., h, w) views."""
    out = []
    pos = 0
    for (h, w) in shapes:
        out.append(flat[..., pos:pos + h * w].reshape(*flat.shape[:-1], h,
                                                      w))
        pos += h * w
    return out


def unflatten_host(flat_np, shapes):
    """Host-side split of a flattened band array back into 2-D views."""
    return unflatten(flat_np, shapes)
