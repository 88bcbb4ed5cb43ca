"""Dirac intra picture encoder.

Port of `schroedinger_tpu/encoder/intra.py`.  `encode_picture` codes at
given quant indices, 8-bit or deep (s32), with arithmetic or no-arith
(VLC) residuals: the forward wavelet runs on the device, subband
quantisation with per-codeblock quant indices and the entropy coding on
the host (native C++).  `encode_picture_fused` is the rate-controlled
8-bit arith path: transform, 61-way stat tables, per-band RD pick and
quantisation on the device, entropy coding on the host, reconstruction
on the device.  Both run on the card unless the caller passes
device="cpu".
"""
from __future__ import annotations

import threading

import numpy as np
import torch
from torch.profiler import record_function

from schroedinger_tpu_torch.bitstream import (BitWriter,
                                              parse_code_picture,
                                              write_parse_info,
                                              write_picture_header,
                                              write_transform_parameters)
from schroedinger_tpu_torch.coding import native as _native
from schroedinger_tpu_torch.coding import subband as sb
from schroedinger_tpu_torch.devices import resolve_device
from schroedinger_tpu_torch.params import (Params, subband_count,
                                           subband_position)
from schroedinger_tpu_torch.coding import slices as sl
from schroedinger_tpu_torch.decoder.lowdelay import _inverse, _to_u8, _to_u16
from schroedinger_tpu_torch.encoder.lowdelay import _forward, _prep_plane
from schroedinger_tpu_torch.encoder.ratecontrol import band_tables, rd_pick
from schroedinger_tpu_torch.ops import quant as q
from schroedinger_tpu_torch.ops.pad import pad_edge
from schroedinger_tpu_torch.pipeline import planes_to_device


def _prep_plane_deep(plane, out_h: int, out_w: int):
    """Deep (10/16-bit) input prep: the reference widens S16 input to its
    S32 internal frames with a PLAIN convert — no recentring; only the
    8-bit path subtracts 128 (orc_convert_s32_s16 schroorc.orc:479-487 vs
    orc_offsetconvert_s16_u8 :524-530)."""
    x = plane.to(torch.int32)
    h, w = x.shape
    return pad_edge(x, 0, out_h - h, 0, out_w - w)


def _codeblock_counts(p: Params, index: int):
    position = subband_position(index)
    if index == 0:
        return p.horiz_codeblocks[0], p.vert_codeblocks[0]
    level = position >> 2
    return p.horiz_codeblocks[level + 1], p.vert_codeblocks[level + 1]


def encode_picture(planes_u8, p: Params, frame_number: int,
                   quant_indices=None, is_ref: bool = False,
                   retired: int | None = None,
                   return_recon: bool = False,
                   band_bits_out: list | None = None, device=None):
    """Encode one intra picture; quant_indices: None (all zero:
    lossless), an int, or a map (component, subband) -> (vcb, hcb) array.

    planes_u8: three u8 planes (u16 when deep; numpy arrays or tensors).
    With return_recon the decoder-exact reconstruction comes back as
    three u8 (u16) tensors on `device` (None: the card).  band_bits_out:
    optional list; when given, a (3*nb,) per-(component, band)
    coded-payload-bits array is appended (actual_subband_bits analog,
    schroencoder.c:2548-2568, for the arith-correction EMA)."""
    device = resolve_device(device)
    bit_depth = p.video_format.bit_depth
    depth = p.transform_depth
    nb = subband_count(depth)
    iwt_dims = [(p.iwt_luma_height, p.iwt_luma_width),
                (p.iwt_chroma_height, p.iwt_chroma_width),
                (p.iwt_chroma_height, p.iwt_chroma_width)]
    pic_sizes = [p.video_format.picture_luma_size(),
                 p.video_format.picture_chroma_size(),
                 p.video_format.picture_chroma_size()]

    w = BitWriter()
    write_parse_info(w, parse_code_picture(is_ref, 0, False, p.is_noarith))
    retired_delta = None
    if is_ref:
        retired_delta = 0 if retired is None else retired - frame_number
    write_picture_header(w, frame_number, retired_delta=retired_delta)
    w.sync()
    write_transform_parameters(w, p)
    w.sync()

    band_bits = np.zeros(3 * nb, np.float64)
    recon_planes = []
    for comp, (plane, (oh, ow)) in enumerate(zip(
            planes_to_device(planes_u8, bit_depth, device), iwt_dims)):
        prepped = (_prep_plane_deep(plane, oh, ow) if bit_depth > 8
                   else _prep_plane(plane, oh, ow))
        pyr = _forward(prepped, depth, p.wavelet_filter_index)
        bands = [b.cpu().numpy().astype(np.int64)
                 for b in sl.subband_arrays(pyr, depth)]

        deq_bands = [None] * nb
        for index in range(nb):
            hcb, vcb = _codeblock_counts(p, index)
            position = subband_position(index)
            if quant_indices is None:
                qi_arr = np.zeros((vcb, hcb), dtype=np.int32)
            elif np.isscalar(quant_indices):
                qi_arr = np.full((vcb, hcb), int(quant_indices), np.int32)
            else:
                qi_arr = np.asarray(quant_indices[(comp, index)], np.int32)

            qdata, deq = sb.quantise_subband(
                bands[index], qi_arr, position, hcb, vcb,
                is_intra=(p.num_refs == 0), deep=bit_depth > 8)
            deq_bands[index] = deq

            w.sync()
            if not np.any(qdata):
                w.write_uint(0)
                continue
            have_qo = p.codeblock_mode_index == 1
            if p.is_noarith:
                with record_function("encode_subband_noarith"):
                    payload = _native.encode_subband_noarith(
                        qdata, position, hcb, vcb, have_qo)
                first_qi = int(qi_arr[0, 0])
            else:
                parent_deq = deq_bands[index - 3] if position >= 4 else None
                with record_function("encode_subband_arith"):
                    payload, first_qi = sb.encode_subband_arith(
                        qdata, parent_deq, position, hcb, vcb, have_qo,
                        qi_arr)
            band_bits[comp * nb + index] = 8 * len(payload)
            w.write_uint(len(payload))
            if first_qi == -1:
                first_qi = int(qi_arr[0, 0])
            if len(payload) > 0:
                w.write_uint(first_qi)
                w.sync()
                w.write_bytes(bytes(payload))
        if return_recon:
            dt = np.int32 if bit_depth > 8 else np.int16
            rpyr = sl.arrays_to_pyramid(
                [torch.as_tensor(np.asarray(b, dtype=dt), device=device)
                 for b in deq_bands], depth)
            rplane = _inverse(rpyr, p.wavelet_filter_index)
            (w_pic, h_pic) = pic_sizes[comp]
            recon_planes.append(
                _to_u16(rplane, h_pic, w_pic, bit_depth) if bit_depth > 8
                else _to_u8(rplane, h_pic, w_pic))
    w.sync()
    if band_bits_out is not None:
        band_bits_out.append(band_bits)
    if return_recon:
        return w.get_bytes(), tuple(recon_planes)
    return w.get_bytes()


_I_STEP_CACHE = {}
# guards _I_STEP_CACHE: encoders may run on several threads
_I_STEP_LOCK = threading.Lock()


def get_i_step(p: Params, error_power: float = 4.0):
    """(step1, step2, layout) of the fused 8-bit arith intra picture (the
    intra twin of inter.make_p_step), built once per picture variant.

      step1(planes, lam_bands, target_bits, corr_bands) -> dict
        forward IWT x3, 61-way (bits, error) stat tables (band 0
        estimated on horizontal first differences), per-(component, band)
        RD argmin on the device, quantise bands >= 1.  Band 0 needs the
        serial decoder-mirrored DC-predict quantiser
        (schroencoder.c:3486-3668), so its raw coefficients go to the
        host.  The dict holds rc_bits, rc_err, qi_bands, qflats (band 0
        zeroed) and raw0.
      step2(qflats, qi_bands, dq0) -> 3 u8 recon planes
        dequantises bands >= 1, splices the host's dequantised band 0,
        inverse IWT, +128, clip: the decoder-exact reconstruction."""
    with _I_STEP_LOCK:
        return _get_i_step(p, error_power)


def _get_i_step(p: Params, error_power: float):
    vf = p.video_format
    depth = p.transform_depth
    wavelet = p.wavelet_filter_index
    key = vf.picture_luma_size() + (depth, int(wavelet), vf.chroma_format,
                                    round(error_power * 16))
    hit = _I_STEP_CACHE.get(key)
    if hit is not None:
        return hit

    nb = subband_count(depth)
    iwt_dims = [(p.iwt_luma_height, p.iwt_luma_width),
                (p.iwt_chroma_height, p.iwt_chroma_width),
                (p.iwt_chroma_height, p.iwt_chroma_width)]
    pic_sizes = [vf.picture_luma_size(), vf.picture_chroma_size(),
                 vf.picture_chroma_size()]
    shapes3 = [[(oh >> depth, ow >> depth)]
               + [(oh >> (depth - (i - 1) // 3), ow >> (depth - (i - 1) // 3))
                  for i in range(1, nb)] for (oh, ow) in iwt_dims]
    sizes3 = [[h * w for (h, w) in shapes] for shapes in shapes3]
    bounds = []
    boff = 0
    for ci, sizes in enumerate(sizes3):
        for bi, bn in enumerate(sizes):
            bounds.append((ci * nb + bi, boff, boff + bn))
            boff += bn

    def quant_rows(qi_bands, ci, dev, n):
        qi_c = qi_bands[ci * nb:(ci + 1) * nb].long()
        sizes_t = torch.as_tensor(sizes3[ci], device=dev)
        qf = torch.repeat_interleave(q.quant_factor(qi_c, dev), sizes_t,
                                     output_size=n)
        qo = torch.repeat_interleave(q.quant_offset(qi_c, True, dev),
                                     sizes_t, output_size=n)
        return qf, qo

    def step1(planes, lam_bands, target_bits, corr_bands):
        flats = []
        for plane, (oh, ow) in zip(planes, iwt_dims):
            pyr = _forward(_prep_plane(plane, oh, ow), depth, wavelet)
            flats.append(sl.flatten_pyramid(pyr, depth)[0])
        # estimate flat: band 0 as horizontal first differences (the
        # DC-predict histogram analog, schrohistogram.c:360)
        est_parts = []
        for flat, shapes in zip(flats, shapes3):
            b0h, b0w = shapes[0]
            b0 = flat[:b0h * b0w].reshape(b0h, b0w).to(torch.int32)
            d0 = torch.cat([b0[:, :1], b0[:, 1:] - b0[:, :-1]], 1)
            est_parts += [d0.reshape(-1), flat[b0h * b0w:].to(torch.int32)]
        with record_function("stat_tables"):
            bits, err = band_tables(torch.cat(est_parts), bounds, 3 * nb,
                                    True, error_power)
        # RD pick with arith-correction-scaled bits; target_bits > 0
        # engages the lambda fit to the intra allocation, in both
        # directions (entropy_to_lambda, schroquantiser.c:887-960)
        with record_function("rd_pick"):
            qi_bands, _ = rd_pick(bits, err, lam_bands, corr_bands,
                                  target_bits, s_hi=16384.0)
        outq = []
        raw0 = []
        for ci, (flat, sizes) in enumerate(zip(flats, sizes3)):
            n0 = sizes[0]
            qf, qo = quant_rows(qi_bands, ci, flat.device, flat.numel())
            qq = q.quantise(flat, qf, qo).to(torch.int16)
            qq[:n0] = 0                 # band 0 is DC-predicted on the host
            outq.append(qq)
            raw0.append(flat[:n0].to(torch.int16))
        return {"rc_bits": bits, "rc_err": err, "qi_bands": qi_bands,
                "qflats": tuple(outq), "raw0": tuple(raw0)}

    def step2(qflats, qi_bands, dq0):
        outs = []
        for ci, (qflat, d0, shapes, sizes, (wpic, hpic)) in enumerate(
                zip(qflats, dq0, shapes3, sizes3, pic_sizes)):
            qf, qo = quant_rows(qi_bands, ci, qflat.device, qflat.numel())
            dq = q.dequantise(qflat.to(torch.int32), qf, qo)
            dq[:sizes[0]] = d0.to(torch.int32)
            rres = _inverse(sl.arrays_to_pyramid(
                sl.unflatten(dq.to(torch.int16), shapes), depth), wavelet)
            outs.append(_to_u8(rres, hpic, wpic))
        return tuple(outs)

    layout = {"nb": nb, "shapes3": shapes3, "sizes3": sizes3}
    hit = _I_STEP_CACHE[key] = (step1, step2, layout)
    return hit


def encode_picture_fused(planes_u8, p: Params, frame_number: int,
                         lam_bands, is_ref: bool = True,
                         retired: int | None = None,
                         corr=None, error_power: float = 4.0,
                         target_bits: float = 0.0, device=None):
    """Fused-path intra encode: transform, stat tables, RD pick and
    quantisation on `device` (None: the card), one fetch, host native
    entropy coding + DC-predict band 0, then the decoder-exact
    reconstruction on the device.

    lam_bands: (3nb,) per-(component, band) RD lambdas (perceptual scales
    included); corr: optional (3nb,) arith-correction ratios that scale
    the bit estimates.  Returns (unit_bytes, recon tensors, qi_bands,
    (bits61, err61), band_bits_actual, band_bits_est)."""
    if p.video_format.bit_depth != 8 or p.is_noarith:
        # a caller's error, not a missing feature: deep and no-arith
        # pictures take encode_picture
        raise ValueError("the fused intra step codes 8-bit arith pictures")
    dev = resolve_device(device)
    nb = subband_count(p.transform_depth)
    step1, step2, lay = get_i_step(p, error_power=error_power)
    lam = np.asarray(lam_bands, np.float64)
    cb = (np.ones(lam.size) if corr is None
          else np.maximum(np.asarray(corr, np.float64), 1e-3))
    planes = tuple(pl.to(dev) if torch.is_tensor(pl) else
                   torch.tensor(np.asarray(pl, np.uint8), device=dev)
                   for pl in planes_u8)
    outs = step1(planes, torch.as_tensor(lam.astype(np.float32), device=dev),
                 float(np.float32(target_bits or 0.0)),
                 torch.as_tensor(cb.astype(np.float32), device=dev))
    stats = torch.stack([outs["rc_bits"], outs["rc_err"]]).cpu().numpy()
    wire = torch.cat([outs["qi_bands"].to(torch.int16), *outs["qflats"],
                      *outs["raw0"]]).cpu().numpy()
    qi_bands = wire[:3 * nb].astype(np.int32)
    off = 3 * nb
    host_q = []
    for sizes in lay["sizes3"]:
        n = sum(sizes)
        host_q.append(wire[off:off + n])
        off += n
    raw0 = []
    for sizes in lay["sizes3"]:
        raw0.append(wire[off:off + sizes[0]])
        off += sizes[0]

    # host: serial DC-predict quantise of band 0 (decoder-mirrored,
    # schroencoder.c:3486-3668) at the device-picked qi
    qdata0 = []
    deq0 = []
    for ci in range(3):
        b0h, b0w = lay["shapes3"][ci][0]
        hcb, vcb = _codeblock_counts(p, 0)
        qi_arr = np.full((vcb, hcb), int(qi_bands[ci * nb]), np.int32)
        qd, dq = sb.quantise_subband(
            raw0[ci].astype(np.int64).reshape(b0h, b0w), qi_arr, 0,
            hcb, vcb, is_intra=True)
        qdata0.append(qd)
        deq0.append(dq)

    w = BitWriter()
    write_parse_info(w, parse_code_picture(is_ref, 0, False, False))
    retired_delta = None
    if is_ref:
        retired_delta = 0 if retired is None else retired - frame_number
    write_picture_header(w, frame_number, retired_delta=retired_delta)
    w.sync()
    write_transform_parameters(w, p)
    w.sync()
    band_bits = np.zeros(3 * nb, np.float64)
    for comp in range(3):
        bands = sl.unflatten(host_q[comp], lay["shapes3"][comp])
        bands[0] = qdata0[comp]
        for index in range(nb):
            hcb, vcb = _codeblock_counts(p, index)
            position = subband_position(index)
            qi = int(qi_bands[comp * nb + index])
            qdata = bands[index]
            w.sync()
            if not np.any(qdata):
                w.write_uint(0)
                continue
            # parent context is a zero test: quantised values suffice
            parent = bands[index - 3] if position >= 4 else None
            with record_function("encode_subband_arith"):
                payload, first_qi = sb.encode_subband_arith(
                    qdata, parent, position, hcb, vcb, False,
                    np.full((vcb, hcb), qi, np.int32))
            band_bits[comp * nb + index] = 8 * len(payload)
            w.write_uint(len(payload))
            if first_qi == -1:
                first_qi = qi
            if len(payload) > 0:
                w.write_uint(first_qi)
                w.sync()
                w.write_bytes(bytes(payload))
    w.sync()
    unit = w.get_bytes()

    recon = step2(outs["qflats"], outs["qi_bands"],
                  [torch.as_tensor(np.asarray(d, np.int16).ravel(),
                                   device=dev) for d in deq0])
    est = stats[0][np.clip(qi_bands, 0, 60), np.arange(3 * nb)]
    return unit, recon, qi_bands, (stats[0].copy(), stats[1].copy()), \
        band_bits, est
