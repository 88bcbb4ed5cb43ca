"""Dirac stream decoder: intra + inter (long-GOP) pictures, in PyTorch.

Port of `schroedinger_tpu/decoder/core.py`.  Per picture: parse and MV
entropy decode (host, native C++) -> residual decode (host, native C++)
-> inverse wavelet (device) -> OBMC render from one or two references
(device: the patch render, or the per-pixel gather render for global
motion, |mv| > MV_BOUND_PEL and overlap beyond twice the separation) ->
combine -> reference bookkeeping in decode order
(a reference picture enters the buffer, then retires the picture its
header names).  Reference pictures stay on the device as u8 tensors with
their half-pel planes; decoded frames come back to the host as numpy u8
planes (u16 when deep), sorted into presentation order (B pictures are
coded after the reference that follows them).

VC-2 low-delay pictures go to `decoder/lowdelay.py`, intra pictures to
`decoder/intra.py`, both 8-bit or deep (uint16 planes out), arith or
no-arith.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from schroedinger_tpu_torch import bitstream as bs
from schroedinger_tpu_torch.coding import native as _native
from schroedinger_tpu_torch.coding.bitio import BitReader
from schroedinger_tpu_torch.params import Params
from schroedinger_tpu_torch.video_format import VideoFormat
from schroedinger_tpu_torch.wavelets import Wavelet
from schroedinger_tpu_torch.decoder import intra as di
from schroedinger_tpu_torch.decoder import lowdelay as lod
from schroedinger_tpu_torch.decoder.overlay import overlay_motion
from schroedinger_tpu_torch.devices import resolve_device
from schroedinger_tpu_torch.ops import obmc

_MV_FIELDS = ("dx1", "dy1", "dx2", "dy2", "pred_mode", "dc0", "dc1", "dc2",
              "using_global")


class BrokenPicture(Exception):
    """Data-dependent picture decode failure with a classified kind
    (schrounpack.h:16-22, schrodecoder.c:1402-1415).

    kind: "missing_reference" | "parse" | "payload"."""

    def __init__(self, kind: str, msg: str):
        super().__init__(msg)
        self.kind = kind


def upsample(plane):
    """u8 plane tensor -> interleaved (2h, 2w) half-pel plane."""
    return obmc.make_halfpel(obmc.upsample_plane(plane))


@dataclasses.dataclass
class RefFrame:
    planes: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]  # u8 planes
    upsampled: Optional[list] = None  # cached interleaved half-pel planes

    def get_upsampled(self):
        if self.upsampled is None:
            self.upsampled = [upsample(p) for p in self.planes]
        return self.upsampled


def _combine(residual, pred, clip_shape):
    h, w = clip_shape
    out = residual[:h, :w].to(torch.int32) + pred + 128
    return out.clamp(0, 255).to(torch.uint8)


def read_picture_prediction_parameters(r: BitReader, p: Params) -> None:
    """schrodecoder.c:2405-2517."""
    index = r.read_uint()
    if index == 0:
        p.xblen_luma = r.read_uint()
        p.yblen_luma = r.read_uint()
        p.xbsep_luma = r.read_uint()
        p.ybsep_luma = r.read_uint()
    else:
        blocks = [(0, 0, 0, 0), (8, 8, 4, 4), (12, 12, 8, 8),
                  (16, 16, 12, 12), (24, 24, 16, 16)]
        (p.xblen_luma, p.yblen_luma, p.xbsep_luma,
         p.ybsep_luma) = blocks[index]
    p.mv_precision = r.read_uint()
    p.have_global_motion = bool(r.read_bit())
    if p.have_global_motion:
        for i in range(p.num_refs):
            gm = p.global_motion[i]
            if r.read_bit():
                gm.b0 = r.read_sint()
                gm.b1 = r.read_sint()
            else:
                gm.b0 = gm.b1 = 0
            if r.read_bit():
                gm.a_exp = r.read_uint()
                gm.a00 = r.read_sint()
                gm.a01 = r.read_sint()
                gm.a10 = r.read_sint()
                gm.a11 = r.read_sint()
            else:
                gm.a_exp, gm.a00, gm.a01, gm.a10, gm.a11 = 0, 1, 0, 0, 1
            if r.read_bit():
                gm.c_exp = r.read_uint()
                gm.c0 = r.read_sint()
                gm.c1 = r.read_sint()
            else:
                gm.c_exp = gm.c0 = gm.c1 = 0
    p.picture_pred_mode = r.read_uint()
    p.picture_weight_bits = 1
    p.picture_weight_1 = 1
    p.picture_weight_2 = 1
    if r.read_bit():
        p.picture_weight_bits = r.read_uint()
        p.picture_weight_1 = r.read_sint()
        if p.num_refs > 1:
            p.picture_weight_2 = r.read_sint()


def read_block_data_buffers(r: BitReader, payload: bytes, num_refs: int):
    """schro_decoder_parse_block_data: 9 length-prefixed buffers."""
    bufs: List[Optional[bytes]] = []
    for i in range(9):
        if num_refs < 2 and i in (4, 5):
            bufs.append(None)
            continue
        length = r.read_uint()
        r.sync()
        start = r.bits_read // 8
        bufs.append(payload[start:start + length])
        r.skip_bits(length * 8)
    return bufs


def decode_residual(payload_reader: BitReader, payload: bytes, p: Params,
                    device=None):
    """Decode transform data -> list of 3 s16 iwt-sized residual tensors
    (host entropy decode, inverse wavelet on `device`; None: the card)."""
    device = resolve_device(device)
    return [di.bands_to_plane(bands, p, device)
            for bands in di.decode_bands(payload_reader, payload, p)]


class StreamDecoder:
    """Decodes a full Dirac stream; returns frames in presentation order
    as (y, u, v) numpy u8 planes (u16 when deep).  All tensor work runs
    on `device`: the card when None (an error where there is none), the
    CPU on request.

    `telemetry` (None: read SCHRO_TPU_TELEMETRY) draws each inter
    picture's motion field onto its output luma (`decoder/overlay.py`,
    on the host); the MD5 is checked on the clean picture first, and the
    reference planes stay clean."""

    def __init__(self, telemetry=None, device=None):
        if telemetry is None:
            telemetry = os.environ.get("SCHRO_TPU_TELEMETRY", "") not in \
                ("", "0")
        self.telemetry = bool(telemetry)
        self.device = resolve_device(device)
        self.vf: Optional[VideoFormat] = None
        self.refs: Dict[int, RefFrame] = {}
        self._pending_md5: Optional[bytes] = None
        self.md5_failures: List[int] = []
        self.errors: List[dict] = []

    def _render_inter(self, p: Params, mv, ref1: RefFrame,
                      ref2: Optional[RefFrame], residual_planes):
        # vectors beyond the patch render's margin take the per-pixel
        # gather render; global motion and wide overlaps take it by the
        # render's own dispatch
        bound = obmc.MV_BOUND_PEL << p.mv_precision
        in_bound = all(np.abs(mv[k]).max(initial=0) <= bound
                       for k in ("dx1", "dy1", "dx2", "dy2"))
        mvt = {k: torch.as_tensor(np.asarray(mv[k], np.int32),
                                  device=self.device)
               for k in _MV_FIELDS if k in mv}
        render = obmc.make_render_body(p, 2 if ref2 is not None else 1,
                                       use_patches=None if in_bound
                                       else False)
        preds = render(mvt, tuple(ref1.get_upsampled()),
                       tuple(ref2.get_upsampled())
                       if ref2 is not None else None)
        vfmt = p.video_format
        pic_sizes = [vfmt.picture_luma_size(), vfmt.picture_chroma_size(),
                     vfmt.picture_chroma_size()]
        return tuple(_combine(residual_planes[k], preds[k],
                              (pic_sizes[k][1], pic_sizes[k][0]))
                     for k in range(3))

    def _parse_picture(self, code: int, payload: bytes):
        """Parse picture header + prediction/transform parameters + MV
        entropy decode.  Returns (r, p, picture_number, ref_nums, retired,
        is_ref, zero_residual, mv) with the BitReader positioned at the
        residual data."""
        r = BitReader(payload)
        picture_number = r.read_bits(32)
        num_refs = bs.num_refs(code)
        is_ref = bs.is_reference(code)
        ref_nums = []
        for _ in range(num_refs):
            ref_nums.append((picture_number + r.read_sint()) & 0xFFFFFFFF)
        retired = None
        if is_ref:
            delta = r.read_sint()
            retired = (picture_number + delta) & 0xFFFFFFFF

        p = Params(video_format=self.vf, num_refs=num_refs,
                   is_lowdelay=bs.is_lowdelay(code),
                   is_noarith=not bs.using_ac(code))

        mv = None
        if num_refs > 0:
            r.sync()
            read_picture_prediction_parameters(r, p)
            r.sync()
            bufs = read_block_data_buffers(r, payload, num_refs)
            with record_function("motion_decode"):
                mv = _native.motion_decode(bufs, p.x_num_blocks,
                                           p.y_num_blocks, num_refs,
                                           p.have_global_motion,
                                           p.is_noarith)

        r.sync()
        zero_residual = False
        if num_refs > 0:
            zero_residual = bool(r.read_bit())
        if not zero_residual:
            p.wavelet_filter_index = Wavelet(r.read_uint())
            p.transform_depth = r.read_uint()
            if p.is_lowdelay:
                p.n_horiz_slices = r.read_uint()
                p.n_vert_slices = r.read_uint()
                p.slice_bytes_num = r.read_uint()
                p.slice_bytes_denom = r.read_uint()
                if r.read_bit():
                    p.quant_matrix[0] = r.read_uint()
                    for i in range(p.transform_depth):
                        p.quant_matrix[1 + 3 * i] = r.read_uint()
                        p.quant_matrix[2 + 3 * i] = r.read_uint()
                        p.quant_matrix[3 + 3 * i] = r.read_uint()
                else:
                    p.set_default_quant_matrix()
            elif r.read_bit():
                for i in range(p.transform_depth + 1):
                    p.horiz_codeblocks[i] = r.read_uint()
                    p.vert_codeblocks[i] = r.read_uint()
                p.codeblock_mode_index = r.read_uint()
            else:
                for i in range(p.transform_depth + 1):
                    p.horiz_codeblocks[i] = 1
                    p.vert_codeblocks[i] = 1
                p.codeblock_mode_index = 0
            r.sync()
        return (r, p, picture_number, ref_nums, retired, is_ref,
                zero_residual, mv)

    def decode_picture_unit(self, code: int, payload: bytes):
        """Decode one picture unit -> (picture_number, plane tensors: u8,
        u16 when deep)."""
        (r, p, picture_number, ref_nums, retired, is_ref,
         zero_residual, mv) = self._parse_picture(code, payload)

        num_refs = p.num_refs
        if p.is_lowdelay:
            planes = lod.decode_picture(payload[r.bits_read // 8:], p,
                                        device=self.device)
        elif num_refs == 0:
            planes = di.decode_picture(payload[r.bits_read // 8:], p,
                                       device=self.device)
        else:
            if zero_residual:
                res = [torch.zeros(shape, dtype=torch.int16,
                                   device=self.device)
                       for shape in ((p.iwt_luma_height, p.iwt_luma_width),
                                     (p.iwt_chroma_height,
                                      p.iwt_chroma_width),
                                     (p.iwt_chroma_height,
                                      p.iwt_chroma_width))]
            else:
                res = decode_residual(r, payload, p, device=self.device)
            for rn in ref_nums:
                if rn not in self.refs:
                    raise BrokenPicture("missing_reference",
                                        f"reference picture {rn} not in "
                                        f"buffer for {picture_number}")
            ref1 = self.refs[ref_nums[0]]
            ref2 = self.refs[ref_nums[1]] if num_refs > 1 else None
            planes = self._render_inter(p, mv, ref1, ref2, res)

        if is_ref:
            self.refs[picture_number] = RefFrame(planes)
            if retired is not None and retired != picture_number:
                self.refs.pop(retired, None)
        if self.telemetry and mv is not None:
            planes = self._overlay(picture_number, planes, mv, p)
        return picture_number, planes

    def _overlay(self, picture_number, planes, mv, p):
        """The telemetry overlay on the output copy only (schrodecoder.c:
        107); the reference planes kept above stay clean.  The in-stream
        MD5 is checked against the clean picture first."""
        with record_function("telemetry_overlay"):
            host = tuple(pl.cpu().numpy() for pl in planes)
            if self._pending_md5 is not None:
                if _native.frame_md5(host) != self._pending_md5:
                    self.md5_failures.append(picture_number)
                self._pending_md5 = None
            y = torch.from_numpy(overlay_motion(host[0], mv, p))
            return (y.to(self.device),) + tuple(planes[1:])

    def decode_stream(self, stream: bytes, presentation_order: bool = True):
        out = []
        for code, payload in bs.split_units(stream):
            if code == bs.SEQUENCE_HEADER:
                self.vf = bs.read_sequence_header(
                    BitReader(payload)).video_format
            elif code == bs.AUXILIARY_DATA:
                if len(payload) >= 17 and payload[0] == 3:  # MD5 checksum
                    self._pending_md5 = payload[1:17]
            elif bs.is_picture(code):
                try:
                    num, planes = self.decode_picture_unit(code, payload)
                except BrokenPicture as e:
                    # data-dependent decode failure: record the picture
                    # error and continue (schrodecoder.c:1402-1415)
                    self.errors.append({"code": code, "error": repr(e),
                                        "kind": e.kind})
                    self._pending_md5 = None
                    continue
                except (ValueError, KeyError, IndexError) as e:
                    # malformed fields from a corrupted payload
                    self.errors.append({"code": code, "error": repr(e),
                                        "kind": "parse"})
                    self._pending_md5 = None
                    continue
                planes = tuple(pl.cpu().numpy() for pl in planes)
                if self._pending_md5 is not None:
                    with record_function("frame_md5"):
                        md5 = _native.frame_md5(planes)
                    if md5 != self._pending_md5:
                        self.md5_failures.append(num)
                    self._pending_md5 = None
                out.append((num, planes))
        if presentation_order:
            out.sort(key=lambda t: t[0])
        return [planes for _, planes in out]
