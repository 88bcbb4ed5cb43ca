"""VC-2 low-delay picture encoder, and the plane preparation and forward
transform that the intra and inter coders share.

Port of `schroedinger_tpu/encoder/lowdelay.py`.  The wavelet transform
and the all-quant estimation run on the device (`pipeline.py`); the
per-slice quant-index search, the small DC prediction chains and the
packing run on the host in the native C++ coder, mirroring the reference
encoder bit for bit (schrolowdelay.c:766-1200):

- slice grid with exact byte budget via num/denom accumulator
- per-slice binary search of the base quant index (7 probes, :1117-1148)
- DC subbands coded as prediction residuals against the evolving
  reconstruction, raster order across slices
- trailing zero coefficients elided (decoder guard bits regenerate them)

Two host halves give the same bytes: `encode_picture_from_analysis`
looks the bit counts up in the device's 61-base tables ("table"),
`encode_picture_from_slices` probes on the coefficients ("direct").  The
JAX module's pure-Python search for a missing native coder is not
carried over: the port's C++ coder has no Python fallback.
"""
from __future__ import annotations

import threading

import numpy as np
import torch
from torch.profiler import record_function

from schroedinger_tpu_torch import tables
from schroedinger_tpu_torch.bitstream import (BitWriter, parse_code_picture,
                                              write_parse_info,
                                              write_picture_header,
                                              write_transform_parameters)
from schroedinger_tpu_torch.coding import native as _native
from schroedinger_tpu_torch.coding import slices as sl
from schroedinger_tpu_torch.devices import resolve_device
from schroedinger_tpu_torch.ops import wavelet as wv
from schroedinger_tpu_torch.ops.pad import pad_edge
from schroedinger_tpu_torch.params import Params, subband_count
from schroedinger_tpu_torch.pipeline import (make_lowdelay_analyze,
                                             make_lowdelay_transform,
                                             planes_to_device)

QF = tables.QUANT_FACTOR.astype(np.int32)
QO = tables.QUANT_OFFSET_1_2.astype(np.int32)


def ilog2up(x: int) -> int:
    return int(x).bit_length()


def divide3(a):
    """Fixed-point divide-by-3 (schroutils.h:64), int32 semantics."""
    return (np.int32(a) * np.int32(21845) + np.int32(10922)) >> np.int32(16)


def divide3_s32(a):
    """The deep (s32) DC divide: schro_divide(a, 3) (schroutils.h:63),
    truncating division floored for negatives (schroencoder.c:3648)."""
    a = int(a)
    return (a - 2) // 3 if a < 0 else a // 3


def quantise_np(v, qf, qo):
    v = np.asarray(v, dtype=np.int64)
    x = np.abs(v) << 2
    offset = qo - qf // 2
    mag = np.where(x < qo, 0, (x - offset) // qf)
    return np.where(v < 0, -mag, mag).astype(np.int64)


def dequantise_np(q, qf, qo):
    q = np.asarray(q, dtype=np.int64)
    mag = (np.abs(q) * qf + qo + 2) >> 2
    return np.where(q == 0, 0, np.where(q < 0, -mag, mag)).astype(np.int64)


def _prep_plane(plane_u8, out_h: int, out_w: int):
    """u8 -> s16 - 128, edge-extended to (out_h, out_w)."""
    x = plane_u8.to(torch.int16) - 128
    h, w = x.shape
    return pad_edge(x, 0, out_h - h, 0, out_w - w)


def _forward(plane, depth, wavelet):
    return wv.forward(plane, depth, wavelet)


_ANALYZE_CACHE = {}
_TRANSFORM_CACHE = {}
_HOST_CACHE = {}
# guards the three build-once caches: encoders may run on several threads
_BUILD_LOCK = threading.Lock()


def _params_key(p: Params):
    return (p.iwt_luma_width, p.iwt_luma_height, p.iwt_chroma_width,
            p.iwt_chroma_height, p.transform_depth,
            int(p.wavelet_filter_index), p.n_horiz_slices, p.n_vert_slices,
            tuple(p.quant_matrix[: subband_count(p.transform_depth)]),
            p.video_format.bit_depth)


def _get_analyze_fn(p: Params):
    key = _params_key(p)
    with _BUILD_LOCK:
        fn = _ANALYZE_CACHE.get(key)
        if fn is None:
            fn = _ANALYZE_CACHE[key] = make_lowdelay_analyze(p)
    return fn


def _get_transform_fn(p: Params):
    key = _params_key(p)
    with _BUILD_LOCK:
        fn = _TRANSFORM_CACHE.get(key)
        if fn is None:
            fn = _TRANSFORM_CACHE[key] = make_lowdelay_transform(p)
    return fn


def _band_shapes(p: Params, iwt_h: int, iwt_w: int):
    """(h, w) of every subband of a component of iwt size (iwt_h, iwt_w)."""
    depth = p.transform_depth
    out = [(iwt_h >> depth, iwt_w >> depth)]
    for i in range(1, subband_count(depth)):
        shift = depth - ((i - 1) // 3)
        out.append((iwt_h >> shift, iwt_w >> shift))
    return out


def _band_pos_offsets(p: Params):
    """Per-position quant matrix offsets of the slice tensors (luma,
    chroma)."""
    qm = np.asarray(p.quant_matrix[:subband_count(p.transform_depth)],
                    dtype=np.int32)
    ny, nx = p.n_vert_slices, p.n_horiz_slices

    def offsets(shps):
        idx = np.concatenate([
            np.full((h // ny) * (w // nx), i, dtype=np.int32)
            for i, (h, w) in enumerate(shps)])
        return qm[idx]

    return (offsets(_band_shapes(p, p.iwt_luma_height, p.iwt_luma_width)),
            offsets(_band_shapes(p, p.iwt_chroma_height,
                                 p.iwt_chroma_width)))


class DCChain:
    """Encoder-side DC prediction chain over one component's LL band, in
    Python (the native coder runs its own copy inside `ld_encode`).

    Matches quantise_dc_block/schro_dc_predict (schrolowdelay.c:766-905).
    """

    def __init__(self, ll: np.ndarray, deep: bool = False):
        self.orig = ll.astype(np.int32)
        self.recon = np.zeros_like(self.orig)
        self._div3 = divide3_s32 if deep else divide3

    def quantise_block(self, y0, y1, x0, x1, qi):
        qf, qo = int(QF[qi]), int(QO[qi])
        out = np.empty((y1 - y0) * (x1 - x0), dtype=np.int64)
        n = 0
        rec = self.recon
        for y in range(y0, y1):
            for x in range(x0, x1):
                if y > 0:
                    if x > 0:
                        pred = int(self._div3(int(rec[y, x - 1])
                                              + int(rec[y - 1, x])
                                              + int(rec[y - 1, x - 1]) + 1))
                    else:
                        pred = int(rec[y - 1, x])
                else:
                    pred = int(rec[y, x - 1]) if x > 0 else 0
                d = int(self.orig[y, x]) - pred
                q = int(quantise_np(d, qf, qo))
                rec[y, x] = pred + int(dequantise_np(q, qf, qo))
                out[n] = q
                n += 1
        return out


def _slice_bytes_array(p: Params):
    n_slices = p.n_vert_slices * p.n_horiz_slices
    n_bytes = p.slice_bytes_num // p.slice_bytes_denom
    remainder = p.slice_bytes_num % p.slice_bytes_denom
    out = np.zeros(n_slices, dtype=np.int64)
    acc = 0
    for i in range(n_slices):
        acc += remainder
        if acc >= p.slice_bytes_denom:
            out[i] = n_bytes + 1
            acc -= p.slice_bytes_denom
        else:
            out[i] = n_bytes
    return out


def _picture_headers(p: Params, frame_number: int, is_ref: bool) -> bytes:
    w = BitWriter()
    write_parse_info(w, parse_code_picture(is_ref, 0, True, False))
    write_picture_header(w, frame_number,
                         retired_delta=0 if is_ref else None)
    w.sync()
    write_transform_parameters(w, p)
    w.sync()
    return w.get_bytes()


def _host_arrays(p: Params):
    key = _params_key(p) + (p.slice_bytes_num, p.slice_bytes_denom)
    with _BUILD_LOCK:
        v = _HOST_CACHE.get(key)
        if v is None:
            y_qmo, uv_qmo = _band_pos_offsets(p)
            v = _HOST_CACHE[key] = (np.ascontiguousarray(y_qmo, np.int32),
                                    np.ascontiguousarray(uv_qmo, np.int32),
                                    _slice_bytes_array(p))
    return v


def _ll_bands(y_sl, u_sl, v_sl, p: Params):
    """The LL (DC) bands of the three components, from the slice arrays."""
    depth = p.transform_depth
    ny, nx = p.n_vert_slices, p.n_horiz_slices
    out = []
    for slc, (ih, iw) in zip((y_sl, u_sl, v_sl),
                             ((p.iwt_luma_height, p.iwt_luma_width),
                              (p.iwt_chroma_height, p.iwt_chroma_width),
                              (p.iwt_chroma_height, p.iwt_chroma_width))):
        llh, llw = ih >> depth, iw >> depth
        dcs = (llh // ny) * (llw // nx)
        out.append(sl.from_slices(slc[..., :dcs], [(llh, llw)], ny, nx)[0])
    return out


def _ld_geometry(p: Params):
    """(ny, nx, y_bh, y_bw, uv_bh, uv_bw): slice grid and the DC block of
    a slice in each component's LL band."""
    depth = p.transform_depth
    ny, nx = p.n_vert_slices, p.n_horiz_slices
    return (ny, nx, (p.iwt_luma_height >> depth) // ny,
            (p.iwt_luma_width >> depth) // nx,
            (p.iwt_chroma_height >> depth) // ny,
            (p.iwt_chroma_width >> depth) // nx)


def encode_picture_from_slices(y_sl, u_sl, v_sl, p: Params,
                               frame_number: int, is_ref: bool) -> bytes:
    """Host half of the "direct" path: native C++ slice search + packing
    on the device's slice arrays (int16 or int32)."""
    y_sl, u_sl, v_sl = (np.ascontiguousarray(np.asarray(a), np.int32)
                        for a in (y_sl, u_sl, v_sl))
    y_ll, u_ll, v_ll = _ll_bands(y_sl, u_sl, v_sl, p)
    y_qmo, uv_qmo, sbytes = _host_arrays(p)
    with record_function("ld_pack"):
        payload, _bases = _native.ld_encode(
            y_sl, u_sl, v_sl, y_qmo, uv_qmo, *_ld_geometry(p),
            y_ll, u_ll, v_ll, int(p.quant_matrix[0]), sbytes,
            deep=p.video_format.bit_depth > 8)
    return _picture_headers(p, frame_number, is_ref) + payload


def encode_picture_from_analysis(host_data, p: Params, frame_number: int,
                                 is_ref: bool) -> bytes:
    """Host half of the "table" path: the device computed the per-base
    bit aggregates, so the search only runs DC chains + lookups."""
    (y_sl, u_sl, v_sl, yb, yl, ub, ul, vb, vl) = host_data
    y_ll, u_ll, v_ll = _ll_bands(y_sl, u_sl, v_sl, p)
    y_qmo, uv_qmo, sbytes = _host_arrays(p)
    with record_function("ld_pack"):
        payload, _bases = _native.ld_encode_tab(
            y_sl, u_sl, v_sl, y_qmo, uv_qmo, *_ld_geometry(p),
            y_ll, u_ll, v_ll, int(p.quant_matrix[0]), sbytes,
            yb, yl, ub, ul, vb, vl, deep=p.video_format.bit_depth > 8)
    return _picture_headers(p, frame_number, is_ref) + payload


def fetch(tensors):
    """Device tensors -> host numpy arrays (slice arrays widened to
    int32), in one device-to-host copy."""
    parts = [t.contiguous() for t in tensors]
    wire = torch.cat([t.view(torch.uint8).reshape(-1) for t in parts])
    wire = wire.cpu().numpy()
    out = []
    off = 0
    for t in parts:
        dt = np.dtype(str(t.dtype).replace("torch.", ""))
        n = t.numel() * dt.itemsize
        a = wire[off:off + n].view(dt).reshape(tuple(t.shape))
        out.append(np.ascontiguousarray(a, np.int32))
        off += n
    return out


def fetch_analysis(dev_out):
    """Outputs of make_lowdelay_analyze -> host arrays (int32): (ys, us,
    vs, y_bits, y_lastnz, u_bits, u_lastnz, v_bits, v_lastnz)."""
    ys, us, vs, y_agg, u_agg, v_agg = dev_out
    return tuple(fetch([ys, us, vs, *y_agg, *u_agg, *v_agg]))


def encode_picture(planes, params: Params, frame_number: int,
                   is_ref: bool = False, device=None) -> bytes:
    """Encode one low-delay intra picture; returns a parse unit (offsets
    0).  planes: (y, u, v) u8 (u16 when deep) numpy arrays or tensors at
    picture sizes; the analysis runs on `device` (None: the card)."""
    p = params
    dev = resolve_device(device)
    dev_out = _get_analyze_fn(p)(*planes_to_device(
        planes, p.video_format.bit_depth, dev))
    return encode_picture_from_analysis(fetch_analysis(dev_out), p,
                                        frame_number, is_ref)
