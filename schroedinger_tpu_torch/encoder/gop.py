"""Long-GOP encoder: IPPP (backref) GOP at fixed quantisers.

Port of `schroedinger_tpu/encoder/gop.py` `GopEncoder` for the backref
GOP structure with constant quant indices: intra pictures every
`gop_length` (and on scene changes), P pictures predicted from the
previous reference, MD5 auxiliary units on request.  In `encode_stream`
the device work of picture N+1 is queued before the host entropy coding
of picture N runs, PIPELINE_DEPTH pictures deep.

Not ported yet (the constructor raises NotImplementedError for them):
the biref / BBBP engine, CBR and the quantiser engines, interlaced
(field) coding and deep (>8-bit) video.  The JAX encoder's other options
(block and codeblock sizes, multiquant, pyramid depth, magic constants,
phase correlation, prefilters, no-arith coding, the estimation switches,
PSNR/SSIM postanalysis) are not taken: the port runs their defaults,
which the parity tests hold to the JAX package.
"""
from __future__ import annotations

from collections import deque
from typing import Optional

import numpy as np
import torch
from torch.profiler import record_function

from schroedinger_tpu import bitstream as bs
from schroedinger_tpu.coding import native as _native
from schroedinger_tpu.params import Params, subband_count
from schroedinger_tpu.utils.telemetry import FrameStats
from schroedinger_tpu.video_format import VideoFormat
from schroedinger_tpu.wavelets import MAX_DEPTH_S16, Wavelet
from schroedinger_tpu_torch.decoder.core import RefFrame
from schroedinger_tpu_torch.encoder import inter as ei_inter
from schroedinger_tpu_torch.encoder import intra as ei_intra
from schroedinger_tpu_torch.encoder.ratecontrol import ArithCorrection

# the JAX GopEncoder's defaults for the options the port does not take
SCENE_CHANGE_THRESHOLD = 3.0
PIPELINE_DEPTH = 3
ME_LEVELS = 5              # downsample_levels
ME_BAILOUT_LIMIT = 0.33    # magic["me_bailout_limit"]
SCAN_DISTANCE = 4.0        # magic["scan_distance"]


class GopEncoder:
    def __init__(self, video_format: VideoFormat,
                 intra_wavelet: Wavelet = Wavelet.DESLAURIERS_DUBUC_9_7,
                 inter_wavelet: Wavelet = Wavelet.LE_GALL_5_3,
                 transform_depth: int = 3,
                 gop_length: int = 24,
                 base_qi_intra: int = 16,
                 base_qi_inter: int = 20,
                 bitrate: int = 0,
                 enable_md5: bool = False,
                 mv_precision: int = 0,
                 enable_scene_change: bool = True,
                 quantiser_engine=None,
                 gop_structure: str = "backref",
                 device="cpu"):
        unsupported = {
            "gop_structure='biref'": gop_structure != "backref",
            "bitrate (CBR)": bool(bitrate),
            "quantiser_engine": quantiser_engine is not None,
            "interlaced coding": video_format.interlaced_coding,
            "bit depth > 8": video_format.bit_depth != 8,
        }
        missing = [k for k, v in unsupported.items() if v]
        if missing:
            raise NotImplementedError(
                "not ported to schroedinger_tpu_torch yet: "
                + ", ".join(missing))
        self.device = torch.device(device)
        self.vf = video_format
        self.intra_wavelet = intra_wavelet
        self.inter_wavelet = inter_wavelet
        self.depth = min(transform_depth,
                         MAX_DEPTH_S16[intra_wavelet],
                         MAX_DEPTH_S16[inter_wavelet])
        self.gop_length = gop_length
        self.base_qi_intra = base_qi_intra
        self.base_qi_inter = base_qi_inter
        self.frame_number = 0
        self.last_ref: Optional[int] = None
        self.prev_ref: Optional[int] = None
        self.ref_frames = {}
        self._chain = bs.OffsetChain()
        self.enable_md5 = enable_md5
        self.mv_precision = mv_precision
        self.enable_scene_change = enable_scene_change
        self._prev_input = None
        self._prev_mad = None
        self.stats = FrameStats()
        self._sent_stream_aux = False
        # per-(component, band) arith-correction tables; the fixed
        # quantisers never read them (the CBR port will)
        self.acorr = ArithCorrection(3 * subband_count(self.depth))

    def _params(self, num_refs: int) -> Params:
        p = Params(video_format=self.vf, num_refs=num_refs,
                   transform_depth=self.depth,
                   wavelet_filter_index=(self.inter_wavelet if num_refs
                                         else self.intra_wavelet))
        p.set_default_codeblocks()
        p.set_default_quant_matrix()
        p.mv_precision = self.mv_precision if num_refs else 0

        # automatic motion block size, partial overlap (blen = 3/2 bsep)
        # (init_params, schroengine.c:410-455)
        area = self.vf.width * self.vf.height
        bsep = 16 if area >= 1920 * 1080 else 12 if area >= 960 * 540 else 8
        p.xbsep_luma = p.ybsep_luma = bsep
        p.xblen_luma = p.yblen_luma = (bsep * 3 // 2) & ~3
        # automatic codeblocks, one DC codeblock (reference decoder-compat
        # workaround, schroengine.c:508-511), no multiquant
        p.horiz_codeblocks[0] = 1
        p.vert_codeblocks[0] = 1
        p.codeblock_mode_index = 0
        return p

    def _scene_change_score(self, planes) -> float:
        """MAD vs previous input, downsampled 4x (schroencoder.c:1909
        calculate_sc_score analog): score = mad / running mad."""
        y = np.asarray(planes[0], np.int32)[::4, ::4]
        score = 0.0
        if self._prev_input is not None:
            mad = float(np.abs(y - self._prev_input).mean())
            base = self._prev_mad if self._prev_mad else max(mad, 1e-3)
            score = mad / max(base, 1e-3)
            self._prev_mad = (0.7 * (self._prev_mad or mad) + 0.3 * mad)
        self._prev_input = y
        return score

    def _is_intra(self, num, planes):
        """(intra?, scene-change score) for display-order picture num."""
        is_intra = (num % self.gop_length) == 0
        sc = (self._scene_change_score(planes)
              if self.enable_scene_change else 0.0)
        if (not is_intra and sc > SCENE_CHANGE_THRESHOLD
                and self.last_ref is not None):
            is_intra = True
        return is_intra, sc

    def encode_frame(self, planes) -> bytes:
        """Encode one frame without pipelining; returns its parse units."""
        num = self.frame_number
        is_intra, sc = self._is_intra(num, planes)
        return bytes(self._encode_ref(planes, num, is_intra, sc))

    def flush(self) -> bytes:
        """encode_frame holds nothing back in the backref GOP."""
        return b""

    def encode_stream(self, frames) -> bytes:
        """Encode a sequence with device/host pipelining: the P step of
        frame N+1 is queued on the device before the host entropy coding
        of frame N runs, so device compute and C++ arith coding overlap."""
        out = bytearray()
        pends = deque()  # (pending dict, (num, ref_num, retired, sc))
        for planes in frames:
            num = self.frame_number
            is_intra, sc = self._is_intra(num, planes)
            if is_intra or self.last_ref is None:
                while pends:
                    out += self._finish_pending(pends.popleft())
                out += self._encode_ref(planes, num, True, sc)
                continue

            meta = (num, self.last_ref, self.prev_ref, sc)
            pending = ei_inter.start_inter_picture(
                planes, self._params(1), self.ref_frames[self.last_ref],
                base_qi=self.base_qi_inter,
                me_levels=ME_LEVELS,
                scan_distance=SCAN_DISTANCE)
            # the new recon tensors become the reference at once; the
            # device stream orders the dependency
            if self.prev_ref is not None:
                self.ref_frames.pop(self.prev_ref, None)
            self.ref_frames[num] = RefFrame(tuple(pending["recon"]))
            self.prev_ref = self.last_ref
            self.last_ref = num
            self.frame_number += 1
            pends.append((pending, meta))
            if len(pends) > PIPELINE_DEPTH:
                out += self._finish_pending(pends.popleft())
        while pends:
            out += self._finish_pending(pends.popleft())
        out += self._chain.add([bs.make_eos_unit()], final_eos=True)
        return bytes(out)

    def _md5_unit(self, recon) -> bytes:
        planes = tuple(pl.cpu().numpy() for pl in recon)
        with record_function("frame_md5"):
            md5 = _native.frame_md5(planes)
        return bs.make_aux_unit(bs.AUX_MD5_CHECKSUM, md5)

    def _finish_pending(self, pend) -> bytes:
        pending, (num, ref_num, retired, sc) = pend
        unit = ei_inter.finish_inter_picture(pending, num, ref_num,
                                             is_ref=True, retired=retired)
        units = []
        if self.enable_md5:
            units.append(self._md5_unit(pending["recon"]))
        units.append(unit)
        self.stats.record(frame=num, intra=False, bits=len(unit) * 8,
                          sc_score=round(sc, 3),
                          dc_ratio=round(pending["dc_ratio"], 3))
        return self._chain.add(units)

    def _encode_ref(self, planes, num, is_intra, sc_score,
                    retired="auto") -> bytes:
        if retired == "auto":
            retired = self.prev_ref
        units = []
        if is_intra:
            units.append(bs.write_sequence_header(self.vf, profile=8,
                                                  level=0))
            if not self._sent_stream_aux:
                self._sent_stream_aux = True
                units.append(bs.make_aux_unit(
                    1, b"schroedinger-tpu 2.0"))      # ENCODER_STRING
            p = self._params(0)
            nb = subband_count(p.transform_depth)
            qm = np.asarray(p.quant_matrix[:nb], np.int32)
            qi_bands = np.tile(np.clip(self.base_qi_intra - qm, 0, 60), 3)
            qis = {}
            for comp in range(3):
                for i in range(nb):
                    hcb, vcb = ei_intra._codeblock_counts(p, i)
                    qis[(comp, i)] = np.full(
                        (vcb, hcb), int(qi_bands[comp * nb + i]), np.int32)
            unit, recon = ei_intra.encode_picture(
                planes, p, num, quant_indices=qis, is_ref=True,
                retired=retired, return_recon=True, device=self.device)
        else:
            unit, recon, dc_ratio = ei_inter.encode_inter_picture(
                planes, self._params(1), num, self.last_ref,
                self.ref_frames[self.last_ref],
                base_qi=self.base_qi_inter, is_ref=True, retired=retired,
                me_levels=ME_LEVELS,
                scan_distance=SCAN_DISTANCE)
            if dc_ratio > ME_BAILOUT_LIMIT:
                # intra bailout (schroencoder.c:2373-2384): motion
                # compensation failed for most blocks -> code this
                # picture as intra instead (same number/retire)
                return self._encode_ref(planes, num, True, sc_score,
                                        retired=retired)
        if self.enable_md5:
            units.append(self._md5_unit(recon))
        units.append(unit)

        if self.prev_ref is not None:
            self.ref_frames.pop(self.prev_ref, None)
        self.prev_ref = self.last_ref
        self.last_ref = num
        self.ref_frames[num] = RefFrame(tuple(recon))
        if num == self.frame_number:
            self.frame_number += 1
        self.stats.record(frame=num, intra=bool(is_intra),
                          bits=len(unit) * 8, sc_score=round(sc_score, 3))
        return self._chain.add(units)
