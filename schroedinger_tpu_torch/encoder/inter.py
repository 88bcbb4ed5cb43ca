"""Dirac inter (long-GOP) picture encoder, one reference, fixed quantiser.

Port of `schroedinger_tpu/encoder/inter.py` for the one-ref P picture at
fixed quant indices.  Per picture:
  device: hierarchical ME (the patch-refine kernel on CUDA) -> subpel
          refine -> DC stats -> RD split + mode -> OBMC render ->
          residual -> forward IWT -> quantise -> reconstruction
  host:   MV entropy coding, subband arith coding (shared native C++)

`start_inter_picture` queues the device work and returns a pending dict
whose `recon` tensors can serve as the next picture's reference at once;
`finish_inter_picture` fetches the coded data with one copy to the host
and writes the parse unit.

Not ported yet: two references (biref / B pictures and their batching),
the 61-way stat tables and on-device RD quantiser pick, multiquant
refinement, phase-correlation candidates and the estimation switches.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch.profiler import record_function

from schroedinger_tpu import tables
from schroedinger_tpu.bitstream import (BitWriter, parse_code_picture,
                                        write_parse_info, write_picture_header)
from schroedinger_tpu.coding import native as _native
from schroedinger_tpu.coding import subband as sb
from schroedinger_tpu.params import (Params, subband_count, subband_info,
                                     subband_position)
from schroedinger_tpu_torch.coding import slices as sl
from schroedinger_tpu_torch.decoder.core import RefFrame
from schroedinger_tpu_torch.encoder import me as me_mod
from schroedinger_tpu_torch.encoder.intra import _codeblock_counts
from schroedinger_tpu_torch.encoder.lowdelay import _forward
from schroedinger_tpu_torch.ops.pad import pad_edge, pad_zero
from schroedinger_tpu_torch.decoder.lowdelay import _inverse
from schroedinger_tpu_torch.ops import obmc
from schroedinger_tpu_torch.ops import quant as q

_P_FIELD_ORDER = ("split", "pred_mode", "using_global", "dx1", "dy1",
                  "dx2", "dy2", "dc0", "dc1", "dc2")


def _block_mean_f32(c, ynb, bsep_y, xnb, bsep_x):
    """Per-block float32 mean of an int32 plane on the block grid (the
    integer sums are exact in float32 at these block sizes)."""
    s = c.reshape(ynb, bsep_y, xnb, bsep_x).sum((1, 3), dtype=torch.int64)
    return s.to(torch.float32) / float(bsep_y * bsep_x)


def _dc_stats(cur_y, ybsep, xbsep, ynb, xnb):
    """Per-block SAD of the DC (mean) prediction + block means."""
    H, W = ybsep * ynb, xbsep * xnb
    h, w = cur_y.shape
    c = pad_edge(cur_y, 0, H - h, 0, W - w).to(torch.int32)
    bmean_i = torch.round(_block_mean_f32(c, ynb, ybsep, xnb, xbsep)).to(
        torch.int32)
    rep = bmean_i.repeat_interleave(ybsep, 0).repeat_interleave(xbsep, 1)
    sad_dc = (c - rep).abs().reshape(ynb, ybsep, xnb, xbsep).sum(
        (1, 3), dtype=torch.int32)
    return sad_dc, bmean_i


def _block_means(plane, bsep_y, bsep_x, ynb, xnb):
    H, W = bsep_y * ynb, bsep_x * xnb
    h, w = plane.shape
    c = pad_edge(plane, 0, H - h, 0, W - w).to(torch.int32)
    return torch.round(_block_mean_f32(c, ynb, bsep_y, xnb, bsep_x)).to(
        torch.int32)


def _band_shapes(oh: int, ow: int, depth: int):
    """Static (h, w) of each Mallat subband in Dirac index order."""
    shapes = [(oh >> depth, ow >> depth)]
    for i in range(1, subband_count(depth)):
        level, _ = subband_info(i, depth)
        shapes.append((oh >> (level + 1), ow >> (level + 1)))
    return shapes


def _pool2(a):
    """2x2 sum, added in a fixed order: float sums then round the same on
    every device."""
    r = a.reshape(a.shape[0] // 2, 2, a.shape[1] // 2, 2)
    return ((r[:, 0, :, 0] + r[:, 0, :, 1]) + r[:, 1, :, 0]) + r[:, 1, :, 1]


def _sbits(v):
    """exp-Golomb sint size 2n - 1 + (m != 0), n = bit_length(|v| + 1), as
    float32 (matches ratecontrol._sint_bits)."""
    m = v.to(torch.int32).abs()
    n = torch.frexp((m + 1).to(torch.float64))[1]
    return (2 * n - 1 + (m != 0).to(torch.int32)).to(torch.float32)


def make_rd_split_body(p: Params):
    """Per-superblock RD split + mode search (schro_mode_decision analog,
    schromotionest.c:520-695): DC-vs-MC prediction cost per block (split
    2), per 2x2 quad (split 1) and per superblock (split 0); each
    superblock takes the granularity minimising
        sum(distortion) + lambda * estimated_bits.

        body(c, ref_y, dy, dx, sad_mc, sad_dc, mean_y, mean_u, mean_v, lam)
          -> MV-field dict
    where c is the edge-padded int32 luma on the block grid, dy/dx are
    per-block MVs in 1/2^prec-pel units and lam a float32 scalar tensor."""
    ynb, xnb = p.y_num_blocks, p.x_num_blocks
    ybsep, xbsep = p.ybsep_luma, p.xbsep_luma
    prec = p.mv_precision
    pad_h, pad_w = ybsep * ynb, xbsep * xnb
    margin = me_mod.ME_BOUND_PEL + 16
    B = me_mod.ME_BOUND_PEL

    def iavg(a, n):  # rounded integer mean of an n-sum
        return torch.round(a.to(torch.float32) / n).to(torch.int32)

    def e2(a):
        return a.repeat_interleave(2, 0).repeat_interleave(2, 1)

    def e4(a):
        return a.repeat_interleave(4, 0).repeat_interleave(4, 1)

    def clip8(v):
        return (v - 128).clamp(-128, 127)

    def body(c, ref_y, dy, dx, sad_mc, sad_dc, mean_y, mean_u, mean_v, lam):
        f32 = torch.float32
        # aggregate MVs per quad / superblock (subpel units)
        qdy, qdx = iavg(_pool2(dy), 4), iavg(_pool2(dx), 4)
        sdy, sdx = iavg(_pool2(_pool2(dy)), 16), iavg(_pool2(_pool2(dx)), 16)

        def to_fullpel(v):
            if prec == 0:
                return v
            return torch.round(v.to(f32) / (1 << prec)).to(torch.int32)

        h, w = ref_y.shape
        P = pad_edge(pad_edge(ref_y, 0, pad_h - h, 0, pad_w - w),
                     margin, margin, margin, margin)

        # MC SAD of the aggregate vectors, evaluated at unit granularity
        # (the clips only guard the margin: block MVs are already bounded)
        cbq = me_mod._to_blocks(c, ynb // 2, 2 * ybsep, xnb // 2, 2 * xbsep)
        sad_q = me_mod.block_sads_at(
            cbq, P, to_fullpel(qdy).clamp(-B, B),
            to_fullpel(qdx).clamp(-B, B),
            ynb // 2, xnb // 2, 2 * ybsep, 2 * xbsep, margin)
        cbs = me_mod._to_blocks(c, ynb // 4, 4 * ybsep, xnb // 4, 4 * xbsep)
        sad_s = me_mod.block_sads_at(
            cbs, P, to_fullpel(sdy).clamp(-B, B),
            to_fullpel(sdx).clamp(-B, B),
            ynb // 4, xnb // 4, 4 * ybsep, 4 * xbsep, margin)

        # DC SAD at quad / superblock granularity (vs the unit mean)
        mq = torch.round(_block_mean_f32(c, ynb // 2, 2 * ybsep, xnb // 2,
                                         2 * xbsep)).to(torch.int32)
        cq = c.reshape(ynb // 2, 2 * ybsep, xnb // 2, 2 * xbsep)
        sad_dc_q = (cq - mq[:, None, :, None]).abs().sum(
            (1, 3), dtype=torch.int32)
        ms = torch.round(_block_mean_f32(c, ynb // 4, 4 * ybsep, xnb // 4,
                                         4 * xbsep)).to(torch.int32)
        cs = c.reshape(ynb // 4, 4 * ybsep, xnb // 4, 4 * xbsep)
        sad_dc_s = (cs - ms[:, None, :, None]).abs().sum(
            (1, 3), dtype=torch.int32)

        # unit DC values (chroma units = mean of block means)
        d0, d1, d2 = clip8(mean_y), clip8(mean_u), clip8(mean_v)
        d0q, d1q, d2q = (clip8(mq), clip8(iavg(_pool2(mean_u), 4)),
                         clip8(iavg(_pool2(mean_v), 4)))
        d0s, d1s, d2s = (clip8(ms), clip8(iavg(_pool2(_pool2(mean_u)), 16)),
                         clip8(iavg(_pool2(_pool2(mean_v)), 16)))

        # per-granularity mode: MC wins unless DC is >=10% better
        mc2 = (sad_mc * 10 < sad_dc * 11).to(torch.int32)
        mcq = (sad_q * 10 < sad_dc_q * 11).to(torch.int32)
        mcs = (sad_s * 10 < sad_dc_s * 11).to(torch.int32)

        sdy_b, sdx_b = e4(sdy), e4(sdx)
        bits2 = 1 + torch.where(mc2 == 1,
                                _sbits(dy - sdy_b) + _sbits(dx - sdx_b),
                                _sbits(d0) + _sbits(d1) + _sbits(d2))
        sdy_q, sdx_q = e2(sdy), e2(sdx)  # super grid -> quad grid
        bits1 = 1 + torch.where(mcq == 1,
                                _sbits(qdy - sdy_q) + _sbits(qdx - sdx_q),
                                _sbits(d0q) + _sbits(d1q) + _sbits(d2q))
        bits0 = 1 + torch.where(mcs == 1, _sbits(sdy) + _sbits(sdx),
                                _sbits(d0s) + _sbits(d1s) + _sbits(d2s))

        k11 = torch.tensor(1.1, dtype=f32, device=c.device)
        dist2 = torch.where(mc2 == 1, sad_mc.to(f32), sad_dc.to(f32) * k11)
        dist1 = torch.where(mcq == 1, sad_q.to(f32), sad_dc_q.to(f32) * k11)
        dist0 = torch.where(mcs == 1, sad_s.to(f32), sad_dc_s.to(f32) * k11)

        cost2 = _pool2(_pool2(dist2 + lam * bits2))
        cost1 = _pool2(dist1 + lam * bits1)
        cost0 = dist0 + lam * bits0
        split_sb = torch.argmin(torch.stack([cost0, cost1, cost2]),
                                dim=0).to(torch.int32)
        sbf = e4(split_sb)

        def sel(blk, quad, sup):
            return torch.where(sbf == 2, blk,
                               torch.where(sbf == 1, e2(quad), e4(sup)))

        mc = sel(mc2, mcq, mcs)
        zero = torch.zeros((ynb, xnb), dtype=torch.int32, device=c.device)
        return {
            "split": sbf,
            "pred_mode": mc,
            "using_global": zero,
            "dx1": sel(dx, qdx, sdx) * mc,
            "dy1": sel(dy, qdy, sdy) * mc,
            "dx2": zero,
            "dy2": zero,
            "dc0": sel(d0, d0q, d0s) * (1 - mc),
            "dc1": sel(d1, d1q, d1s) * (1 - mc),
            "dc2": sel(d2, d2q, d2s) * (1 - mc),
        }

    return body


def make_p_step(p: Params, me_levels: int = 5, scan_distance: float = 4.0):
    """(front, back) of one one-ref, fixed-quantiser P picture.

      front(y, u, v, ref_y, up_y, up_u, up_v, qi_bands)
          -> (flats (3,), preds (3,), fields int16 (10, yb, xb))
      back(flats, preds, qi_bands) -> (qflats int16 (3,), recon u8 (3,))

    qi_bands: (3*nb,) host ints, component-major."""
    if p.num_refs != 1:
        raise NotImplementedError("two-reference inter coding is not ported")
    vf = p.video_format
    depth = p.transform_depth
    wavelet = p.wavelet_filter_index
    nb = subband_count(depth)
    xnb, ynb = p.x_num_blocks, p.y_num_blocks
    h_shift = vf.chroma_format.h_shift
    v_shift = vf.chroma_format.v_shift
    iwt_dims = [(p.iwt_luma_height, p.iwt_luma_width),
                (p.iwt_chroma_height, p.iwt_chroma_width),
                (p.iwt_chroma_height, p.iwt_chroma_width)]
    pic_sizes = [vf.picture_luma_size(), vf.picture_chroma_size(),
                 vf.picture_chroma_size()]
    shapes3 = [_band_shapes(oh, ow, depth) for (oh, ow) in iwt_dims]
    sizes3 = [np.asarray([h * w for (h, w) in shapes], np.int64)
              for shapes in shapes3]
    band_id3 = [np.repeat(np.arange(len(sizes)), sizes) for sizes in sizes3]

    pw0, ph0 = vf.picture_luma_size()
    # magic_scan_distance drives the exhaustive coarse-scan radius
    coarse_radius = max(1, round(2 * scan_distance))
    me_body = me_mod.make_me_body(ph0, pw0, p.xbsep_luma, p.ybsep_luma,
                                  xnb, ynb, levels=me_levels,
                                  coarse_radius=coarse_radius)
    subpel_body = (me_mod.make_subpel_body(
        ph0, pw0, p.xbsep_luma, p.ybsep_luma, xnb, ynb, p.mv_precision)
        if p.mv_precision > 0 else None)
    rd_split_body = make_rd_split_body(p)
    render_body = obmc.make_render_body(p, 1)
    pad_h, pad_w = p.ybsep_luma * ynb, p.xbsep_luma * xnb

    def front(y, u, v, ref_y, up_y, up_u, up_v, qi_bands):
        dev = y.device
        dy, dx, sad_mc = me_body(y, ref_y)
        sad_dc, mean_y = _dc_stats(y, p.ybsep_luma, p.xbsep_luma, ynb, xnb)
        mean_u = _block_means(u, p.ybsep_luma >> v_shift,
                              p.xbsep_luma >> h_shift, ynb, xnb)
        mean_v = _block_means(v, p.ybsep_luma >> v_shift,
                              p.xbsep_luma >> h_shift, ynb, xnb)
        if subpel_body is not None:
            dy, dx, sad_mc = subpel_body(y, up_y, dy, dx)
        # RD lambda scales with the quant step (QF/4), ~step/2 SAD per bit
        lam = torch.tensor(
            np.float32(tables.QUANT_FACTOR[int(np.max(qi_bands[:nb]))])
            / np.float32(8.0), dtype=torch.float32, device=dev)
        cpad = pad_edge(y, 0, pad_h - y.shape[0], 0,
                        pad_w - y.shape[1]).to(torch.int32)
        fields = rd_split_body(cpad, ref_y, dy, dx, sad_mc, sad_dc,
                               mean_y, mean_u, mean_v, lam)

        preds = render_body(fields, (up_y, up_u, up_v), None)
        flats = []
        for plane, pred, (oh, ow) in zip((y, u, v), preds, iwt_dims):
            res = plane.to(torch.int16) - 128 - pred.to(torch.int16)
            pyr = _forward(pad_zero(res, oh, ow), depth, wavelet)
            flats.append(sl.flatten_pyramid(pyr, depth)[0])
        f16 = torch.stack([fields[k].to(torch.int16)
                           for k in _P_FIELD_ORDER])
        return tuple(flats), tuple(preds), f16

    def back(flats, preds, qi_bands):
        dev = flats[0].device
        QF = torch.as_tensor(tables.QUANT_FACTOR, dtype=torch.int32,
                             device=dev)
        QO = torch.as_tensor(tables.QUANT_OFFSET_3_8, dtype=torch.int32,
                             device=dev)
        outq = []
        outr = []
        for ci, (flat, pred, shapes, (wpic, hpic)) in enumerate(
                zip(flats, preds, shapes3, pic_sizes)):
            qi_c = np.asarray(qi_bands[ci * nb:(ci + 1) * nb], np.int64)
            band_id = torch.as_tensor(qi_c[band_id3[ci]], device=dev)
            qf = QF[band_id]
            qo = QO[band_id]
            qq = q.quantise(flat, qf, qo)
            outq.append(qq.to(torch.int16))
            dq = q.dequantise(qq, qf, qo).to(torch.int16)
            rres = _inverse(sl.arrays_to_pyramid(
                sl.unflatten(dq, shapes), depth), wavelet)
            rec = (rres[:hpic, :wpic].to(torch.int32)
                   + pred.to(torch.int32) + 128)
            outr.append(rec.clamp(0, 255).to(torch.uint8))
        return tuple(outq), tuple(outr)

    return front, back, shapes3


def write_prediction_parameters(w: BitWriter, p: Params) -> None:
    """Mirror of read_picture_prediction_parameters (one-ref, no global
    motion)."""
    if p.have_global_motion:
        raise NotImplementedError("global motion is not ported")
    blocks = [(0, 0, 0, 0), (8, 8, 4, 4), (12, 12, 8, 8),
              (16, 16, 12, 12), (24, 24, 16, 16)]
    tup = (p.xblen_luma, p.yblen_luma, p.xbsep_luma, p.ybsep_luma)
    if tup in blocks[1:]:
        w.write_uint(blocks.index(tup))
    else:
        w.write_uint(0)
        for v in tup:
            w.write_uint(v)
    w.write_uint(p.mv_precision)
    w.write_bit(0)
    w.write_uint(p.picture_pred_mode)
    if (p.picture_weight_bits, p.picture_weight_1,
            p.picture_weight_2) == (1, 1, 1):
        w.write_bit(0)
    else:
        w.write_bit(1)
        w.write_uint(p.picture_weight_bits)
        w.write_sint(p.picture_weight_1)
        if p.num_refs > 1:
            w.write_sint(p.picture_weight_2)


def _to_device_planes(planes_u8, device):
    return tuple(pl.to(device) if torch.is_tensor(pl)
                 else torch.tensor(np.asarray(pl, np.uint8), device=device)
                 for pl in planes_u8)


def start_inter_picture(planes_u8, p: Params, ref1: RefFrame,
                        base_qi: int = 20, me_levels: int = 5,
                        scan_distance: float = 4.0) -> dict:
    """Queue the device work of one P picture (nothing waits for the
    device).  The pending dict's `recon` tensors can serve as the next
    picture's reference at once.  Tensors run on ref1's device."""
    nb = subband_count(p.transform_depth)
    qm = np.asarray(p.quant_matrix[:nb], np.int32)
    qi_bands = np.tile(np.clip(base_qi - qm, 0, 60), 3).astype(np.int32)
    front, back, shapes3 = make_p_step(p, me_levels=me_levels,
                                       scan_distance=scan_distance)
    dev = ref1.planes[0].device
    y, u, v = _to_device_planes(planes_u8, dev)
    ups = ref1.get_upsampled()
    flats, preds, f16 = front(y, u, v, ref1.planes[0], ups[0], ups[1],
                              ups[2], qi_bands)
    qflats, recon = back(flats, preds, qi_bands)
    return {"p": p, "qi_bands": qi_bands, "shapes3": shapes3,
            "fields": f16, "qflats": qflats, "recon": recon}


def finish_inter_picture(pending: dict, frame_number: int, ref1_num: int,
                         is_ref: bool = True,
                         retired: Optional[int] = None):
    """Fetch the picture's fields and quantised bands (one copy to the
    host) and entropy-code the parse unit.  Returns the unit's bytes and
    sets pending["dc_ratio"]."""
    f16 = pending["fields"]
    qflats = pending["qflats"]
    nf, yb, xb = f16.shape
    wire = torch.cat([f16.reshape(-1), *qflats]).cpu().numpy()
    off = nf * yb * xb
    fields = wire[:off].reshape(nf, yb, xb)
    host_q = []
    for qf in qflats:
        host_q.append(wire[off:off + qf.numel()])
        off += qf.numel()
    mv = {k: np.ascontiguousarray(fields[i].astype(np.int32))
          for i, k in enumerate(_P_FIELD_ORDER)}
    # DC-block ratio: the reference's intra-bailout signal
    # (schroencoder.c:2373-2384)
    pending["dc_ratio"] = float(np.mean(mv["pred_mode"] == 0))
    return _write_p_unit(pending["p"], frame_number, [ref1_num], is_ref,
                         retired, mv, host_q, pending["shapes3"],
                         pending["qi_bands"])


def encode_inter_picture(planes_u8, p: Params, frame_number: int,
                         ref1_num: int, ref1: RefFrame,
                         base_qi: int = 20, is_ref: bool = True,
                         retired: Optional[int] = None, me_levels: int = 5,
                         scan_distance: float = 4.0):
    """Encode one P picture (start + finish).  Returns (parse_unit_bytes,
    recon_planes, dc_ratio)."""
    pend = start_inter_picture(planes_u8, p, ref1, base_qi=base_qi,
                               me_levels=me_levels,
                               scan_distance=scan_distance)
    unit = finish_inter_picture(pend, frame_number, ref1_num,
                                is_ref=is_ref, retired=retired)
    return unit, pend["recon"], pend["dc_ratio"]


def _write_p_unit(p: Params, frame_number: int, refs, is_ref: bool,
                  retired: Optional[int], mv, host_q, shapes3, qi_bands):
    """Host entropy coding + parse-unit assembly for an inter picture.

    qi_bands: (3*nb,) quant indices, component-major."""
    if p.is_noarith:
        raise NotImplementedError("no-arith inter coding is not ported")
    nb = subband_count(p.transform_depth)
    num_refs = len(refs)
    w = BitWriter()
    write_parse_info(w, parse_code_picture(is_ref, num_refs, False, False))
    retired_delta = None
    if is_ref:
        retired_delta = (retired - frame_number) if retired is not None else 0
    write_picture_header(w, frame_number,
                         ref_deltas=[r - frame_number for r in refs],
                         retired_delta=retired_delta)
    w.sync()
    write_prediction_parameters(w, p)
    w.sync()
    with record_function("motion_encode"):
        bufs = _native.motion_encode(mv, p.x_num_blocks, p.y_num_blocks,
                                     num_refs, is_noarith=False)
    for s in range(9):
        if bufs[s] is None:
            continue
        w.write_uint(len(bufs[s]))
        w.sync()
        w.write_bytes(bytes(bufs[s]))
    w.sync()
    # transform parameters (zero_residual=0)
    w.write_bit(0)
    w.write_uint(int(p.wavelet_filter_index))
    w.write_uint(p.transform_depth)
    is_default_cb = all(p.horiz_codeblocks[i] == 1
                        and p.vert_codeblocks[i] == 1
                        for i in range(p.transform_depth + 1)) \
        and p.codeblock_mode_index == 0
    if is_default_cb:
        w.write_bit(0)
    else:
        w.write_bit(1)
        for i in range(p.transform_depth + 1):
            w.write_uint(p.horiz_codeblocks[i])
            w.write_uint(p.vert_codeblocks[i])
        w.write_uint(p.codeblock_mode_index)
    w.sync()

    for comp in range(3):
        bands = sl.unflatten(host_q[comp], shapes3[comp])
        for index in range(nb):
            hcb, vcb = _codeblock_counts(p, index)
            position = subband_position(index)
            qi = int(qi_bands[comp * nb + index])
            qdata = bands[index]
            w.sync()
            if not np.any(qdata):
                w.write_uint(0)
                continue
            # parent context is a zero-test, so quantised data is
            # equivalent to the dequantised values the spec describes
            parent_q = bands[index - 3] if position >= 4 else None
            with record_function("encode_subband_arith"):
                payload, first_qi = sb.encode_subband_arith(
                    qdata, parent_q, position, hcb, vcb,
                    p.codeblock_mode_index == 1,
                    np.full((vcb, hcb), qi, np.int32))
            w.write_uint(len(payload))
            if first_qi == -1:
                first_qi = qi
            w.write_uint(first_qi)
            w.sync()
            w.write_bytes(bytes(payload))
    w.sync()
    return w.get_bytes()
