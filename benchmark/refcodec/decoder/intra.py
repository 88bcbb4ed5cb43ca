"""Dirac intra picture and residual decoding (arithmetic-coded subbands,
8 bits).

A frozen copy of the port's `decoder/intra.py`: per-subband lengths,
quant indices and codeblock decode on the host (native C++), DC
prediction of band 0 on the host, the inverse wavelet and the output
conversion on the caller's device.
"""
from __future__ import annotations

import numpy as np
import torch

from refcodec.coding import native as _native
from refcodec.coding.bitio import BitReader
from refcodec.devices import resolve_device
from refcodec.ops import wavelet as wv
from refcodec.params import (Params, subband_count, subband_info,
                             subband_position)


def _to_u8(plane_s16, h: int, w: int):
    x = plane_s16[:h, :w] + 128
    return x.clamp(0, 255).to(torch.uint8)


def arrays_to_pyramid(arrays, depth: int):
    """Subband arrays in coding order -> the wavelet's pyramid."""
    levels = [dict() for _ in range(depth)]
    pyr = {"ll": arrays[0], "levels": levels}
    for i in range(1, subband_count(depth)):
        level, name = subband_info(i, depth)
        levels[level][name] = arrays[i]
    return pyr


def _band_shapes(p: Params, comp: int):
    depth = p.transform_depth
    iwt_h = p.iwt_luma_height if comp == 0 else p.iwt_chroma_height
    iwt_w = p.iwt_luma_width if comp == 0 else p.iwt_chroma_width
    shapes = [(iwt_h >> depth, iwt_w >> depth)]
    for i in range(1, subband_count(depth)):
        shift = depth - ((i - 1) // 3)
        shapes.append((iwt_h >> shift, iwt_w >> shift))
    return shapes


def decode_bands(r: BitReader, payload: bytes, p: Params):
    """Host entropy decode of the transform data -> 3 lists of numpy
    subband arrays (DC-predicted for intra).  `r` is positioned at the
    first subband, byte aligned."""
    nb = subband_count(p.transform_depth)
    comps = []
    for comp in range(3):
        shapes = _band_shapes(p, comp)
        bands = [None] * nb
        for index in range(nb):
            r.sync()
            h, w = shapes[index]
            length = r.read_uint()
            if length == 0:
                r.sync()
                bands[index] = np.zeros((h, w), dtype=np.int64)
                continue
            quant_index = r.read_uint()
            r.sync()
            start = r.bits_read // 8
            data = payload[start:start + length]
            r.skip_bits(length * 8)
            position = subband_position(index)
            hcb, vcb = _codeblock_counts(p, index)
            parent = bands[index - 3] if position >= 4 else None
            intra = p.num_refs == 0
            bands[index] = _native.decode_subband_arith(
                data, (h, w), quant_index, parent, position, hcb, vcb,
                p.codeblock_mode_index == 1, intra, 0 if intra else 1)
        if p.num_refs == 0:
            bands[0] = _native.dc_predict_integrate(bands[0])
        comps.append(bands)
    return comps


def bands_to_plane(bands, p: Params, device):
    """Inverse wavelet of one component's numpy bands -> s16 tensor."""
    pyr = arrays_to_pyramid(
        [torch.as_tensor(np.asarray(b, dtype=np.int16), device=device)
         for b in bands], p.transform_depth)
    return wv.inverse(pyr, p.wavelet_filter_index)


def decode_picture(payload: bytes, p: Params, device=None):
    """Decode intra transform data (payload starts at the first subband,
    byte aligned). Returns (y, u, v) uint8 tensors on `device` (None: the
    card)."""
    device = resolve_device(device)
    pic_sizes = [p.video_format.picture_luma_size(),
                 p.video_format.picture_chroma_size(),
                 p.video_format.picture_chroma_size()]
    out = []
    for bands, (w_pic, h_pic) in zip(
            decode_bands(BitReader(payload), payload, p), pic_sizes):
        plane = bands_to_plane(bands, p, device)
        out.append(_to_u8(plane, h_pic, w_pic))
    return tuple(out)


def _codeblock_counts(p: Params, index: int):
    """(horizontal, vertical) codeblocks of subband `index`."""
    position = subband_position(index)
    if index == 0:
        return p.horiz_codeblocks[0], p.vert_codeblocks[0]
    level = position >> 2
    return p.horiz_codeblocks[level + 1], p.vert_codeblocks[level + 1]
