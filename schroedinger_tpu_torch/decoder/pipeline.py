"""Pipelined stream decoder: host entropy decode overlaps device render.

Port of `schroedinger_tpu/decoder/pipeline.py`.  The reference decoder
overlaps CPU entropy decoding of picture N+1 with GPU motion render and
inverse wavelet of picture N (schrodecoder.c:1556-1568).  Here the host
arith-decodes a picture to quantised bands, packs them with the picture's
motion fields and quant indices into one blob, uploads it in one pinned,
non-blocking copy and queues the picture's device work (dequantise,
inverse IWT of each component, OBMC render and combine) on the card's
stream; it then moves on to the next picture while the card runs.  A
picture's planes come back to the host only `pipeline_depth` pictures
later, where its MD5 is checked, so the serial C++ arith decode runs in
the shadow of device work.  Reference pictures stay on the device.

Pictures outside the packed path's envelope go to `StreamDecoder`'s
per-picture path, still on the device: per-codeblock quantisers, global
motion, MVs beyond MV_BOUND_PEL (both rendered by the per-pixel gather),
low delay, no-arith, deep video and, with the telemetry overlay on,
every picture, as in the JAX package.
"""
from __future__ import annotations

import threading
from collections import deque

import numpy as np
import torch
from torch.profiler import record_function

from schroedinger_tpu_torch import bitstream as bs
from schroedinger_tpu_torch import tables
from schroedinger_tpu_torch.coding import native as _native
from schroedinger_tpu_torch.coding import slices as sl
from schroedinger_tpu_torch.coding.bitio import BitReader
from schroedinger_tpu_torch.decoder import intra as di
from schroedinger_tpu_torch.decoder.core import (BrokenPicture, RefFrame,
                                                 StreamDecoder)
from schroedinger_tpu_torch.decoder.lowdelay import (_inverse,
                                                     dc_predict_integrate)
from schroedinger_tpu_torch.encoder.intra import _codeblock_counts
from schroedinger_tpu_torch.ops import obmc
from schroedinger_tpu_torch.ops import quant as q
from schroedinger_tpu_torch.params import (Params, subband_count,
                                           subband_position)

_DEC_CACHE = {}
# guards _DEC_CACHE: decoders may run on several threads
_DEC_LOCK = threading.Lock()

_MV_FIELD_ORDER = ("split", "pred_mode", "using_global", "dx1", "dy1",
                   "dx2", "dy2", "dc0", "dc1", "dc2")

_N_COARSE = 4    # bands shipped as int16 (big values); the rest int8


def _get_dec_step(p: Params, wide: bool, device):
    """The device half of one picture's decode, fed by one packed uint8
    blob on `device`:

      blob = [mv fields i16 (10*ynb*xnb)]  (inter only)
             [qi_bands i16 (3*nb)]
             [coarse bands i16 x3 comps]   (quantised; intra band 0 is
                                            dequantised and DC-integrated
                                            on the host and passes through)
             [fine bands i8 x3 comps]      (i16 when wide: pictures with
                                            a fine |q| > 127)

    step(blob[, ups1[, ups2]]) -> u8 planes x3: the blob's parts are
    reinterpreted in place (every int16 part starts at an even offset),
    dequantised per band, inverse-transformed per component, and for an
    inter picture rendered from the references' half-pel planes and
    combined."""
    with _DEC_LOCK:
        return _build_dec_step(p, wide, device)


def _build_dec_step(p: Params, wide: bool, device):
    vf = p.video_format
    num_refs = p.num_refs
    key = (vf.picture_luma_size(), vf.picture_chroma_size(),
           p.transform_depth, int(p.wavelet_filter_index), num_refs,
           p.mv_precision, p.xbsep_luma, p.ybsep_luma, p.xblen_luma,
           p.yblen_luma, p.picture_weight_bits, p.picture_weight_1,
           p.picture_weight_2, bool(wide), str(device))
    hit = _DEC_CACHE.get(key)
    if hit is not None:
        return hit

    depth = p.transform_depth
    nb = subband_count(depth)
    wavelet = p.wavelet_filter_index
    shapes3 = [di._band_shapes(p, c) for c in range(3)]
    sizes3 = [np.asarray([h * w for (h, w) in shapes], np.int64)
              for shapes in shapes3]
    n_coarse = [int(s[:_N_COARSE].sum()) for s in sizes3]
    n_fine = [int(s[_N_COARSE:].sum()) for s in sizes3]
    cband_id = [torch.as_tensor(np.repeat(np.arange(_N_COARSE), s[:_N_COARSE]),
                                device=device) for s in sizes3]
    fband_id = [torch.as_tensor(np.repeat(np.arange(_N_COARSE, nb),
                                          s[_N_COARSE:]), device=device)
                for s in sizes3]
    pic_sizes = [vf.picture_luma_size(), vf.picture_chroma_size(),
                 vf.picture_chroma_size()]
    render_body = obmc.make_render_body(p, num_refs) if num_refs else None
    ynb, xnb = (p.y_num_blocks, p.x_num_blocks) if num_refs else (0, 0)
    n_mv = 10 * ynb * xnb if num_refs else 0
    QF = torch.as_tensor(tables.QUANT_FACTOR, dtype=torch.int32,
                         device=device)
    QO = torch.as_tensor(tables.QUANT_OFFSET_1_2 if num_refs == 0
                         else tables.QUANT_OFFSET_3_8, dtype=torch.int32,
                         device=device)
    fine_t = torch.int16 if wide else torch.int8
    fine_b = 2 if wide else 1

    def step(blob, ups1=None, ups2=None):
        off = 0
        if num_refs:
            mvpack = blob[:n_mv * 2].view(torch.int16).reshape(10, ynb, xnb)
            off += n_mv * 2
        qi_bands = blob[off:off + 3 * nb * 2].view(torch.int16).long()
        off += 3 * nb * 2
        coarse = []
        for ci in range(3):
            coarse.append(blob[off:off + n_coarse[ci] * 2].view(torch.int16))
            off += n_coarse[ci] * 2
        fine = []
        for ci in range(3):
            fine.append(blob[off:off + n_fine[ci] * fine_b].view(fine_t))
            off += n_fine[ci] * fine_b

        residuals = []
        for ci, shapes in enumerate(shapes3):
            qi_c = qi_bands[ci * nb:(ci + 1) * nb]
            qc = coarse[ci].to(torch.int32)
            cid = cband_id[ci]
            dq_c = q.dequantise(qc, QF[qi_c][cid], QO[qi_c][cid])
            if num_refs == 0:
                # intra band 0 arrives dequantised and DC-integrated
                n0 = int(sizes3[ci][0])
                dq_c = torch.cat([qc[:n0].to(dq_c.dtype), dq_c[n0:]])
            fid = fband_id[ci]
            dq_f = q.dequantise(fine[ci].to(torch.int32), QF[qi_c][fid],
                                QO[qi_c][fid])
            flat = torch.cat([dq_c, dq_f]).to(torch.int16)
            residuals.append(_inverse(sl.arrays_to_pyramid(
                sl.unflatten(flat, shapes), depth), wavelet))
        if num_refs == 0:
            return tuple((res[:h_pic, :w_pic] + 128).clamp(0, 255).to(
                torch.uint8) for res, (w_pic, h_pic) in zip(residuals,
                                                            pic_sizes))
        fields = {k: mvpack[i].to(torch.int32)
                  for i, k in enumerate(_MV_FIELD_ORDER)}
        with record_function("render"):
            preds = render_body(fields, ups1, ups2)
        return tuple(
            (res[:h_pic, :w_pic].to(torch.int32) + pred + 128).clamp(
                0, 255).to(torch.uint8)
            for res, pred, (w_pic, h_pic) in zip(residuals, preds,
                                                 pic_sizes))

    _DEC_CACHE[key] = step
    return step


class _Fallback(Exception):
    pass


class PipelinedStreamDecoder(StreamDecoder):
    """StreamDecoder with cross-picture host/device pipelining.  `device`
    None means the card (an error where there is none)."""

    def __init__(self, telemetry=None, pipeline_depth: int = 3,
                 device=None):
        super().__init__(telemetry=telemetry, device=device)
        self.pipeline_depth = int(pipeline_depth)

    def _decode_bands_raw(self, r, payload, p: Params):
        """Host arith decode to quantised bands + per-band quant indices.
        Returns (bands3 lists, qi_bands (3nb,) int32, wide flag) or raises
        _Fallback (per-codeblock quant variation needs per-coefficient
        dequantisation: the per-picture path decodes those streams)."""
        nb = subband_count(p.transform_depth)
        qi_bands = np.zeros(3 * nb, np.int32)
        comps = []
        wide = False
        for comp in range(3):
            shapes = di._band_shapes(p, comp)
            bands = [None] * nb
            for index in range(nb):
                r.sync()
                h, w = shapes[index]
                length = r.read_uint()
                if length == 0:
                    r.sync()
                    bands[index] = np.zeros((h, w), dtype=np.int32)
                    continue
                quant_index = r.read_uint()
                r.sync()
                start = r.bits_read // 8
                data = payload[start:start + length]
                r.skip_bits(length * 8)
                position = subband_position(index)
                hcb, vcb = _codeblock_counts(p, index)
                parent = bands[index - 3] if position >= 4 else None
                with record_function("decode_subband_arith"):
                    band, qi_map = _native.decode_subband_arith_raw(
                        data, (h, w), quant_index, parent, position, hcb,
                        vcb, p.codeblock_mode_index == 1)
                if not np.all(qi_map == qi_map.flat[0]):
                    raise _Fallback   # per-codeblock quant deltas
                qi_bands[comp * nb + index] = int(qi_map.flat[0])
                bands[index] = band
                if index >= _N_COARSE and not wide:
                    wide = bool(np.abs(band).max(initial=0) > 127)
            if p.num_refs == 0:
                # dequantise and DC-integrate band 0 on the host (serial);
                # it passes through the device dequantisation untouched
                qi0 = qi_bands[comp * nb]
                qf = int(tables.QUANT_FACTOR[qi0])
                qo = int(tables.QUANT_OFFSET_1_2[qi0])
                b0 = bands[0].astype(np.int64)
                mag = np.abs(b0)
                dq = np.where(mag > 0, (qo + qf * mag + 2) >> 2, 0)
                dq = np.where(b0 < 0, -dq, dq).astype(np.int64)
                bands[0] = dc_predict_integrate(dq).astype(np.int32)
            comps.append(bands)
        return comps, qi_bands, wide

    def _upload(self, blob: np.ndarray):
        """One copy of the blob to the device: from pinned host memory and
        not blocking on the card.  Returns (device tensor, host tensor);
        the host tensor must live until the copy has run."""
        host = torch.from_numpy(blob)
        if self.device.type != "cuda":
            return host.to(self.device), host
        host = host.pin_memory()
        return host.to(self.device, non_blocking=True), host

    def _decode_fast(self, code: int, payload: bytes):
        """Parse + host entropy decode (quantised) + one packed upload +
        the picture's device work, queued.  Returns (picture_number,
        device planes, pinned blob).  Raises _Fallback for pictures
        outside the packed path's envelope."""
        if self.telemetry or self.vf.bit_depth > 8:
            raise _Fallback
        (r, p, picture_number, ref_nums, retired, is_ref,
         zero_residual, mv) = self._parse_picture(code, payload)
        if p.is_lowdelay or p.is_noarith \
                or (p.num_refs and p.have_global_motion):
            raise _Fallback
        if p.num_refs:
            bound = obmc.MV_BOUND_PEL << p.mv_precision
            if any(np.abs(mv[k]).max(initial=0) > bound
                   for k in ("dx1", "dy1", "dx2", "dy2")):
                raise _Fallback

        nb = subband_count(p.transform_depth)
        shapes3 = [di._band_shapes(p, c) for c in range(3)]
        if zero_residual:
            comps = [[np.zeros((h, w), np.int32) for (h, w) in shapes]
                     for shapes in shapes3]
            qi_bands = np.zeros(3 * nb, np.int32)
            wide = False
        else:
            comps, qi_bands, wide = self._decode_bands_raw(r, payload, p)

        # one packed uint8 blob: mv fields + per-band quant indices +
        # int16 coarse bands + int8 (int16 when wide) fine bands
        parts = []
        if p.num_refs:
            parts.append(np.stack(
                [mv[k].astype(np.int16) for k in _MV_FIELD_ORDER])
                .view(np.uint8).ravel())
        parts.append(qi_bands.astype(np.int16).view(np.uint8))
        for bands in comps:
            parts.append(np.concatenate(
                [np.asarray(b, np.int16).ravel()
                 for b in bands[:_N_COARSE]]).view(np.uint8))
        ft = np.int16 if wide else np.int8
        for bands in comps:
            if len(bands) > _N_COARSE:
                parts.append(np.concatenate(
                    [np.asarray(b, ft).ravel()
                     for b in bands[_N_COARSE:]]).view(np.uint8))
        blob = np.concatenate(parts)

        ups = []
        if p.num_refs:
            for rn in ref_nums:
                if rn not in self.refs:
                    raise BrokenPicture(
                        "missing_reference",
                        f"reference picture {rn} not in buffer for "
                        f"{picture_number}")
                ups.append(tuple(self.refs[rn].get_upsampled()))
        step = _get_dec_step(p, wide, self.device)
        dev_blob, host_blob = self._upload(blob)
        planes = step(dev_blob, *ups)

        if is_ref:
            self.refs[picture_number] = RefFrame(planes)
            if retired is not None and retired != picture_number:
                self.refs.pop(retired, None)
        return picture_number, planes, host_blob

    def decode_stream(self, stream: bytes, presentation_order: bool = True):
        out = []
        # (num, device planes, md5, pinned blob kept alive until fetched)
        pend = deque()

        def drain_one():
            num, planes, md5, _ = pend.popleft()
            host = tuple(pl.cpu().numpy() for pl in planes)
            if md5 is not None:
                with record_function("frame_md5"):
                    if _native.frame_md5(host) != md5:
                        self.md5_failures.append(num)
            out.append((num, host))

        for code, payload in bs.split_units(stream):
            if code == bs.SEQUENCE_HEADER:
                self.vf = bs.read_sequence_header(
                    BitReader(payload)).video_format
            elif code == bs.AUXILIARY_DATA:
                if len(payload) >= 17 and payload[0] == 3:  # MD5 checksum
                    self._pending_md5 = payload[1:17]
            elif bs.is_picture(code):
                try:
                    try:
                        num, planes, blob = self._decode_fast(code, payload)
                    except _Fallback:
                        num, planes = self.decode_picture_unit(code, payload)
                        blob = None
                except BrokenPicture as e:
                    self.errors.append({"code": code, "error": repr(e),
                                        "kind": e.kind})
                    self._pending_md5 = None
                    continue
                except (ValueError, KeyError, IndexError) as e:
                    self.errors.append({"code": code, "error": repr(e),
                                        "kind": "parse"})
                    self._pending_md5 = None
                    continue
                pend.append((num, planes, self._pending_md5, blob))
                self._pending_md5 = None
                while len(pend) > self.pipeline_depth:
                    drain_one()
        while pend:
            drain_one()
        if presentation_order:
            out.sort(key=lambda t: t[0])
        return [planes for _, planes in out]
