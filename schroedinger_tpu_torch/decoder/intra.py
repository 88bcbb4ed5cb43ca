"""Dirac intra picture decoder (arith / no-arith residuals, 8-bit and
deep).

Port of `schroedinger_tpu/decoder/intra.py`: per-subband lengths/quant
indices and codeblock decode on the host (native C++), DC prediction of
band 0 on the host, the inverse wavelet and the output conversion on the
caller's device.  Deep (>8-bit) pictures run the s32 path and come out
as uint16 planes with ST 2042-1's offset, 2^(bit depth - 1), added back,
which the JAX version leaves out; like it they clip where the reference
wraps (see `decoder.lowdelay._to_u16`).
"""
from __future__ import annotations

import numpy as np
import torch
from torch.profiler import record_function

from schroedinger_tpu_torch.coding.bitio import BitReader
from schroedinger_tpu_torch.params import Params, subband_count, subband_position
from schroedinger_tpu_torch.coding import slices as sl
from schroedinger_tpu_torch.devices import resolve_device
from schroedinger_tpu_torch.decoder.lowdelay import (_inverse, _to_u8,
                                                     dc_predict_integrate)
from schroedinger_tpu_torch.decoder.lowdelay import _to_u16 as _to_deep
from schroedinger_tpu_torch.encoder.intra import _codeblock_counts
from schroedinger_tpu_torch.coding import native as _native


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
            if p.is_noarith:
                with record_function("decode_subband_noarith"):
                    bands[index] = _native.decode_subband_noarith(
                        data, (h, w), quant_index, position, hcb, vcb,
                        p.codeblock_mode_index == 1, num_refs=p.num_refs)
                continue
            with record_function("decode_subband_arith"):
                bands[index] = _native.decode_subband_arith(
                    data, (h, w), quant_index, parent, position, hcb, vcb,
                    p.codeblock_mode_index == 1, is_intra=(p.num_refs == 0),
                    num_refs=p.num_refs)
        if p.num_refs == 0:
            bands[0] = dc_predict_integrate(
                bands[0], deep=p.video_format.bit_depth > 8)
        comps.append(bands)
    return comps


def bands_to_plane(bands, p: Params, device):
    """Inverse wavelet of one component's numpy bands -> s16 tensor (s32
    when deep)."""
    dt = np.int32 if p.video_format.bit_depth > 8 else np.int16
    pyr = sl.arrays_to_pyramid(
        [torch.as_tensor(np.asarray(b, dtype=dt), device=device)
         for b in bands], p.transform_depth)
    return _inverse(pyr, p.wavelet_filter_index)


def decode_picture(payload: bytes, p: Params, device=None):
    """Decode intra transform data (payload starts at the first subband,
    byte aligned). Returns (y, u, v) tensors on `device` (None: the card):
    uint8, or uint16 when deep."""
    device = resolve_device(device)
    bit_depth = p.video_format.bit_depth
    pic_sizes = [p.video_format.picture_luma_size(),
                 p.video_format.picture_chroma_size(),
                 p.video_format.picture_chroma_size()]
    out = []
    for bands, (w_pic, h_pic) in zip(
            decode_bands(BitReader(payload), payload, p), pic_sizes):
        plane = bands_to_plane(bands, p, device)
        out.append(_to_deep(plane, h_pic, w_pic, bit_depth) if bit_depth > 8
                   else _to_u8(plane, h_pic, w_pic))
    return tuple(out)
