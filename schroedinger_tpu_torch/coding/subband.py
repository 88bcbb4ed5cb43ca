"""Dirac subband codeblock coding (arith and no-arith variants).

Reference semantics: schroencoder.c schro_encoder_encode_subband
(:3798-4072) and schrodecoder.c codeblock decode (:3018-3100, :3524-3640):

- codeblock grid per subband from horiz/vert_codeblocks[level]
- zero-codeblock flags when the grid is split
- per-codeblock quant-index deltas when codeblock_mode_index == 1
- coefficient contexts from parent (coarser, same orientation), neighborhood
  (left/above/above-left), and sign of the oriented previous value.

Scalar Python path (conformance reference); the C++ native module provides
the fast path with identical output.

Whole copy of `schroedinger_tpu/coding/subband.py`: the port imports nothing of
the JAX package, and later slices find their entry points here.
"""
from __future__ import annotations

import numpy as np

from schroedinger_tpu_torch.coding import arith as A
from schroedinger_tpu_torch.coding.bitio import BitReader, BitWriter
from schroedinger_tpu_torch import tables

from schroedinger_tpu_torch.coding import native as _native


def codeblock_bounds(size: int, n: int):
    """[(min, max)] per codeblock along one axis ((size*i)/n boundaries)."""
    return [((size * i) // n, (size * (i + 1)) // n) for i in range(n)]


def is_horiz_oriented(position: int) -> bool:
    return (position & 3) == 2


def is_vert_oriented(position: int) -> bool:
    return (position & 3) == 1


def quantise_scalar(value, qf, qo):
    if value == 0:
        return 0
    dead_zone = qo
    offset = qo - qf // 2
    x = abs(value) << 2
    if x < dead_zone:
        q = 0
    else:
        q = (x - offset) // qf
    return -q if value < 0 else q


def dequantise_scalar(q, qf, qo):
    if q == 0:
        return 0
    m = (abs(q) * qf + qo + 2) >> 2
    return -m if q < 0 else m


def quantise_subband(data: np.ndarray, quant_indices, position: int,
                     hcb: int, vcb: int, is_intra: bool,
                     deep: bool = False):
    """Quantise a subband in codeblock order; returns (qdata, dequantised).

    data: int numpy array (modified copy returned as dequantised).
    quant_indices: (vcb, hcb) per-codeblock quant index array.
    DC prediction applies when is_intra and position == 0
    (schro_frame_data_quantise_dc_predict).
    """
    if _native is not None:
        qi_full = np.broadcast_to(np.asarray(quant_indices), (vcb, hcb))
        return _native.subband_quantise(data, position, hcb, vcb, qi_full,
                                        is_intra, 0 if is_intra else 1,
                                        deep=deep)
    h, w = data.shape
    deq = data.astype(np.int64).copy()
    qdata = np.zeros((h, w), dtype=np.int64)
    ybounds = codeblock_bounds(h, vcb)
    xbounds = codeblock_bounds(w, hcb)
    if deep:
        # deep (s32) DC divide is schro_divide(a, 3) (schroencoder.c:3648)
        div3 = lambda a: (int(a) - 2) // 3 if a < 0 else int(a) // 3
    else:
        div3 = lambda a: (np.int32(a) * np.int32(21845)
                          + np.int32(10922)) >> np.int32(16)

    for cy, (y0, y1) in enumerate(ybounds):
        for cx, (x0, x1) in enumerate(xbounds):
            qi = int(quant_indices[cy, cx])
            qf = int(tables.QUANT_FACTOR[qi])
            qo = int((tables.QUANT_OFFSET_1_2 if is_intra
                      else tables.QUANT_OFFSET_3_8)[qi])
            if is_intra and position == 0:
                # sequential DC prediction against dequantised neighbors
                for j in range(y0, y1):
                    for i in range(x0, x1):
                        if j > 0:
                            if i > 0:
                                pred = int(div3(int(deq[j, i - 1])
                                                + int(deq[j - 1, i])
                                                + int(deq[j - 1, i - 1]) + 1))
                            else:
                                pred = int(deq[j - 1, i])
                        else:
                            pred = int(deq[j, i - 1]) if i > 0 else 0
                        q = quantise_scalar(int(data[j, i]) - pred, qf, qo)
                        qdata[j, i] = q
                        deq[j, i] = dequantise_scalar(q, qf, qo) + pred
            else:
                blk = data[y0:y1, x0:x1].astype(np.int64)
                x4 = np.abs(blk) << 2
                offset = qo - qf // 2
                mag = np.where(x4 < qo, 0, (x4 - offset) // qf)
                q = np.where(blk < 0, -mag, mag)
                qdata[y0:y1, x0:x1] = q
                dmag = (np.abs(q) * qf + qo + 2) >> 2
                deq[y0:y1, x0:x1] = np.where(q == 0, 0,
                                             np.where(q < 0, -dmag, dmag))
    return qdata, deq


def encode_subband_arith(qdata: np.ndarray, parent_deq, position: int,
                         hcb: int, vcb: int, have_quant_offset: bool,
                         quant_indices) -> tuple:
    """Arith-encode a quantised subband; returns (payload, first_quant_index).

    qdata: quantised coefficients; parent_deq: dequantised parent subband
    (or None). Caller handles the all-zero case.
    """
    if _native is not None:
        return _native.encode_subband_arith(
            qdata, parent_deq, position, hcb, vcb, have_quant_offset,
            np.asarray(quant_indices, dtype=np.int32))
    h, w = qdata.shape
    enc = A.ArithEncoder()
    have_zero_flags = hcb > 1 or vcb > 1
    ybounds = codeblock_bounds(h, vcb)
    xbounds = codeblock_bounds(w, hcb)
    first_qi = -1
    run_qi = 0

    horiz = is_horiz_oriented(position)
    vert = is_vert_oriented(position)
    have_parent = position >= 4

    q = qdata
    for cy, (y0, y1) in enumerate(ybounds):
        for cx, (x0, x1) in enumerate(xbounds):
            if have_zero_flags:
                zero = not np.any(q[y0:y1, x0:x1])
                enc.encode_bit(A.CTX_ZERO_CODEBLOCK, 1 if zero else 0)
                if zero:
                    continue
            if have_quant_offset:
                new_qi = int(quant_indices[cy, cx])
                if first_qi == -1:
                    run_qi = new_qi
                    first_qi = new_qi
                enc.encode_sint(A.CTX_QUANTISER_CONT, A.CTX_QUANTISER_VALUE,
                                A.CTX_QUANTISER_SIGN, new_qi - run_qi)
                run_qi = new_qi
            for j in range(y0, y1):
                for i in range(x0, x1):
                    parent = int(parent_deq[j >> 1, i >> 1]) if have_parent else 0
                    nhood = 0
                    if j > 0:
                        nhood |= int(q[j - 1, i])
                    if i > 0:
                        nhood |= int(q[j, i - 1])
                    if i > 0 and j > 0:
                        nhood |= int(q[j - 1, i - 1])
                    prev_v = 0
                    if horiz:
                        if i > 0:
                            prev_v = int(q[j, i - 1])
                    elif vert:
                        if j > 0:
                            prev_v = int(q[j - 1, i])
                    if prev_v < 0:
                        sign_ctx = A.CTX_SIGN_NEG
                    elif prev_v > 0:
                        sign_ctx = A.CTX_SIGN_POS
                    else:
                        sign_ctx = A.CTX_SIGN_ZERO
                    if parent == 0:
                        cont = A.CTX_ZPNN_F1 if nhood else A.CTX_ZPZN_F1
                    else:
                        cont = A.CTX_NPNN_F1 if nhood else A.CTX_NPZN_F1
                    enc.encode_sint(cont, A.CTX_COEFF_DATA, sign_ctx,
                                    int(q[j, i]))
    return enc.flush(), first_qi


def decode_subband_arith(payload: bytes, shape, quant_index: int,
                         parent_deq, position: int, hcb: int, vcb: int,
                         have_quant_offset: bool, is_intra: bool) -> np.ndarray:
    """Decode + dequantise one subband (dequantised values, no DC predict)."""
    if _native is not None:
        return _native.decode_subband_arith(
            payload, shape, quant_index, parent_deq, position, hcb, vcb,
            have_quant_offset, is_intra, 0 if is_intra else 1)
    h, w = shape
    out = np.zeros((h, w), dtype=np.int64)
    dec = A.ArithDecoder(payload)
    have_zero_flags = hcb > 1 or vcb > 1
    horiz = is_horiz_oriented(position)
    vert = is_vert_oriented(position)
    have_parent = position >= 4
    qi = quant_index

    for (y0, y1) in codeblock_bounds(h, vcb):
        for (x0, x1) in codeblock_bounds(w, hcb):
            if have_zero_flags:
                if dec.decode_bit(A.CTX_ZERO_CODEBLOCK):
                    continue
            if have_quant_offset:
                qi += dec.decode_sint(A.CTX_QUANTISER_CONT,
                                      A.CTX_QUANTISER_VALUE,
                                      A.CTX_QUANTISER_SIGN)
                qi = max(0, min(60, qi))
            qf = int(tables.QUANT_FACTOR[qi])
            qo = int((tables.QUANT_OFFSET_1_2 if is_intra
                      else tables.QUANT_OFFSET_3_8)[qi])
            for j in range(y0, y1):
                for i in range(x0, x1):
                    parent = int(parent_deq[j >> 1, i >> 1]) if have_parent else 0
                    nhood = 0
                    if j > 0:
                        nhood |= int(out[j - 1, i])
                    if i > 0:
                        nhood |= int(out[j, i - 1])
                    if i > 0 and j > 0:
                        nhood |= int(out[j - 1, i - 1])
                    prev_v = 0
                    if horiz:
                        if i > 0:
                            prev_v = int(out[j, i - 1])
                    elif vert:
                        if j > 0:
                            prev_v = int(out[j - 1, i])
                    if prev_v < 0:
                        sign_ctx = A.CTX_SIGN_NEG
                    elif prev_v > 0:
                        sign_ctx = A.CTX_SIGN_POS
                    else:
                        sign_ctx = A.CTX_SIGN_ZERO
                    if parent == 0:
                        cont = A.CTX_ZPNN_F1 if nhood else A.CTX_ZPZN_F1
                    else:
                        cont = A.CTX_NPNN_F1 if nhood else A.CTX_NPZN_F1
                    v = dec.decode_uint(cont, A.CTX_COEFF_DATA)
                    if v:
                        v = (qo + qf * v + 2) >> 2
                        if dec.decode_bit(sign_ctx):
                            v = -v
                    out[j, i] = v
    return out
