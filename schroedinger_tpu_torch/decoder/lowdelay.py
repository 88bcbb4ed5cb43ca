"""VC-2 low-delay picture decoder, and the helpers that the intra and
inter decoders share (`dc_predict_integrate`, `_inverse`, `_to_u8`).

Port of `schroedinger_tpu/decoder/lowdelay.py`.  The slice payloads
decode on the host in the native C++ coder (`ld_decode`: VLC decode and
dequantisation of every slice), then the LL band's DC prediction is
integrated on the host (the one sequential step, schrodecoder.c:
3220-3247) and the subband assembly, the inverse wavelet and the output
conversion run on the device.  The JAX module's lockstep Python VLC
decode for a missing native coder is not carried over: the port's C++
coder has no Python fallback.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.profiler import record_function

from schroedinger_tpu_torch import tables
from schroedinger_tpu_torch.coding import native as _native
from schroedinger_tpu_torch.coding import slices as sl
from schroedinger_tpu_torch.devices import resolve_device
from schroedinger_tpu_torch.encoder import lowdelay as loe
from schroedinger_tpu_torch.ops import wavelet as wv
from schroedinger_tpu_torch.params import Params

QF = tables.QUANT_FACTOR.astype(np.int64)
QO = tables.QUANT_OFFSET_1_2.astype(np.int64)


def ilog2up(x: int) -> int:
    return int(x).bit_length()


def divide3(a):
    return (np.int32(a) * np.int32(21845) + np.int32(10922)) >> np.int32(16)


def divide3_s32(a):
    """Deep (s32) DC divide: schro_divide(a, 3), schrodecoder.c:3271."""
    a = int(a)
    return (a - 2) // 3 if a < 0 else a // 3


def dequantise_np(q, qf, qo):
    q = np.asarray(q, dtype=np.int64)
    mag = (np.abs(q) * qf + qo + 2) >> 2
    return np.where(q == 0, 0, np.where(q < 0, -mag, mag)).astype(np.int64)


def dc_predict_integrate(band: np.ndarray, deep: bool = False) -> np.ndarray:
    """DC prediction integration of an intra band 0 (host, native C++;
    schro_decoder_subband_dc_predict, the _s32 variant with schro_divide,
    schrodecoder.c:3250-3275)."""
    return _native.dc_predict_integrate(band, deep=deep)


def _inverse(pyr, wavelet):
    return wv.inverse(pyr, wavelet)


def _to_u8(plane_s16, h: int, w: int):
    x = plane_s16[:h, :w] + 128
    return x.clamp(0, 255).to(torch.uint8)


def _to_u16(plane_s32, h: int, w: int, bit_depth: int):
    """Deep (10/16-bit) output conversion (schrolowdelay.c s32 paths), the
    `_to_u16` and `_to_deep` of the JAX decoders: values are offset-binary
    already — the deep path never recentres (plain orc_convert_*
    widen/narrow).  The reference plain-narrows S32 -> S16 (wrap); this
    clips to the legal range instead, as the JAX decoders do."""
    x = plane_s32[:h, :w].to(torch.int32)
    return x.clamp(0, (1 << bit_depth) - 1).to(torch.uint16)


def decode_picture(payload: bytes, params: Params, device=None):
    """Decode low-delay slice data (after transform parameters, byte
    aligned).  Returns (y, u, v) tensors on `device` (None: the card) at
    picture sizes: u8, or u16 when deep."""
    p = params
    device = resolve_device(device)
    y_qmo, uv_qmo, sbytes = loe._host_arrays(p)
    with record_function("ld_decode"):
        dy, du, dv, _bases = _native.ld_decode(
            payload, y_qmo, uv_qmo, p.n_vert_slices, p.n_horiz_slices,
            y_qmo.size, uv_qmo.size, sbytes)
    return _finish(dy, du, dv, p,
                   loe._band_shapes(p, p.iwt_luma_height, p.iwt_luma_width),
                   loe._band_shapes(p, p.iwt_chroma_height,
                                    p.iwt_chroma_width),
                   p.n_vert_slices, p.n_horiz_slices, device)


def _finish(dy, du, dv, p: Params, y_shapes, uv_shapes, ny, nx, device):
    """DC integration of band 0 (host), then one upload per component of
    its slice array, subband assembly, inverse wavelet and output
    conversion on the device."""
    depth = p.transform_depth
    pic_sizes = [p.video_format.picture_luma_size(),
                 p.video_format.picture_chroma_size(),
                 p.video_format.picture_chroma_size()]
    bd = p.video_format.bit_depth
    band_dtype = np.int32 if bd > 8 else np.int16
    out = []
    for data, shapes, (w_pic, h_pic) in zip((dy, du, dv),
                                            (y_shapes, uv_shapes, uv_shapes),
                                            pic_sizes):
        (h0, w0) = shapes[0]
        dcs = (h0 // ny) * (w0 // nx)
        data = np.array(data, dtype=np.int32)
        band0 = sl.from_slices(data[..., :dcs], [(h0, w0)], ny, nx)[0]
        band0 = dc_predict_integrate(band0, deep=bd > 8)
        data[..., :dcs] = sl.to_slices([band0], ny, nx)[0]
        # the 8-bit path narrows to int16 with wrap, as the JAX decoder
        slc = torch.as_tensor(data.astype(band_dtype), device=device)
        with record_function("ld_inverse"):
            bands = sl.from_slices(slc, shapes, ny, nx)
            plane = _inverse(sl.arrays_to_pyramid(bands, depth),
                             p.wavelet_filter_index)
            out.append(_to_u16(plane, h_pic, w_pic, bd) if bd > 8
                       else _to_u8(plane, h_pic, w_pic))
    return tuple(out)
