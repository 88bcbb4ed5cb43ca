"""Public push/pull codec API (SchroEncoder/SchroDecoder equivalents).

Port of `schroedinger_tpu/api.py`.  The encoder dispatches on
force_profile / rate_control exactly like schro_encoder_start
(schroencoder.c:670-745):

  vc2_low_delay -> VC-2 low-delay slices (fixed-byte, no arith), 8-bit
                   or deep
  vc2_simple    -> intra-only, VLC residuals (no arith)
  vc2_main      -> intra-only, arithmetic coding, 8-bit or deep
  main          -> long-GOP motion-compensated coding on the biref engine
                   (gop_structure adaptive, biref, chained_biref) or the
                   backref engine (backref, chained_backref), under every
                   rate control: constant_quality (the default),
                   constant_lambda, constant_bitrate (TM5 with
                   enable_rdo_cbr, else the allocation controller),
                   constant_error and constant_noise_threshold; lossless
                   on the backref engine at quant index 0 with Haar-0;
                   enable_multiquant / enable_dc_multiquant on any of them,
                   and every other long-GOP setting: motion block size and
                   overlap, codeblock size, the enable_*_estimation
                   switches (chroma ME needs deep estimation), phase
                   correlation, downsample_levels, the prefilters,
                   enable_psnr / enable_ssim and perceptual weighting

Interlaced coding (the `interlaced_coding` setting, or a format that has
it) codes each frame as two field pictures on the long-GOP engines, and
`Decoder` weaves the decoded field pairs back into frames.  The VC-2
profiles refuse it with a ValueError: only the long-GOP encoder splits
frames into fields (the JAX package fails there with a shape error,
ROADMAP.md Queue 3).  Deep long GOP raises NotImplementedError, refused
on purpose as the reference codes deep formats intra only.
Both classes run on the card unless the caller passes device="cpu"; a
failed device program raises, nothing falls back to another path.
"""
from __future__ import annotations

import concurrent.futures as cf
import math
import time
from typing import List, Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from schroedinger_tpu_torch import bitstream as bs
from schroedinger_tpu_torch.config import PROFILES, EncoderConfig
from schroedinger_tpu_torch.decoder.pipeline import PipelinedStreamDecoder
from schroedinger_tpu_torch.devices import resolve_device
from schroedinger_tpu_torch.encoder import intra as ei_intra
from schroedinger_tpu_torch.encoder import lowdelay as loe
from schroedinger_tpu_torch.encoder.gop import GopEncoder
from schroedinger_tpu_torch.encoder.ratecontrol import QuantiserEngine
from schroedinger_tpu_torch.frontends import weave_fields
from schroedinger_tpu_torch.params import Params, subband_count
from schroedinger_tpu_torch.pipeline import upload_picture
from schroedinger_tpu_torch.utils.telemetry import counters
from schroedinger_tpu_torch.video_format import VideoFormat
from schroedinger_tpu_torch.wavelets import MAX_DEPTH_S16, Wavelet


def _reduce_fraction(n: int, d: int) -> Tuple[int, int]:
    g = math.gcd(n, d)
    return n // g, d // g


def _quality_to_qi(quality: float) -> int:
    """Monotone quality (0..10) -> base quant index; 10 is lossless."""
    return int(np.clip(round((10.0 - quality) * 5.0), 0, 60))


class Encoder:
    """Dirac/VC-2 encoder with profile dispatch matching the reference."""

    def __init__(self, video_format: VideoFormat,
                 config: Optional[EncoderConfig] = None, device=None):
        self.vf = video_format
        self.cfg = config or EncoderConfig()
        self.profile = self._resolve_profile()
        interlaced = bool(self.cfg.get("interlaced_coding")
                          or video_format.interlaced_coding)
        if interlaced and self.profile != "main":
            raise ValueError(
                f"interlaced coding needs the long-GOP profile: the "
                f"{self.profile} profile codes whole frames, and only the "
                f"long-GOP encoder splits them into field pictures")
        if interlaced and not video_format.interlaced_coding:
            # the sequence header carries both flags (the JAX encoder
            # sets them on the caller's format too)
            video_format.interlaced = True
            video_format.interlaced_coding = True
        self.device = resolve_device(device)
        self.frame_number = 0
        self._out: List[bytes] = []
        self._chain = bs.OffsetChain()
        self._gop = None

        if self.profile == "vc2_low_delay":
            self._init_lowdelay()
        elif self.profile in ("vc2_simple", "vc2_main"):
            self._init_intra()
        else:
            self._init_gop()

    def _resolve_profile(self) -> str:
        fp = self.cfg.get("force_profile")
        if isinstance(fp, (int, float)):
            fp = PROFILES[int(fp)]
        if fp and fp != "auto":
            return fp
        rc = self.cfg.rate_control
        if rc == "low_delay":
            return "vc2_low_delay"
        if self.cfg.enable_noarith:
            return "vc2_simple"
        if self.cfg.gop_structure == "intra_only":
            return "vc2_main"
        return "main"

    # ---- profile setups -------------------------------------------------

    def _init_lowdelay(self) -> None:
        wavelet = Wavelet(self.cfg.enum_index("intra_wavelet"))
        depth = min(self.cfg.transform_depth, MAX_DEPTH_S16[wavelet])
        p = Params(video_format=self.vf, is_lowdelay=True, num_refs=0,
                   wavelet_filter_index=wavelet, transform_depth=depth)
        if self.cfg.horiz_slices and self.cfg.vert_slices:
            p.n_horiz_slices = self.cfg.horiz_slices
            p.n_vert_slices = self.cfg.vert_slices
        else:
            p.n_horiz_slices = p.iwt_chroma_width >> depth
            p.n_vert_slices = p.iwt_chroma_height >> depth
        p.set_default_quant_matrix()

        bitrate = self.cfg.bitrate
        if bitrate == 0:
            bitrate = (self.vf.width * self.vf.height
                       * self.vf.frame_rate_numerator
                       // self.vf.frame_rate_denominator) * 2
        num = bitrate * self.vf.frame_rate_denominator // (
            self.vf.frame_rate_numerator * 8)
        denom = p.n_horiz_slices * p.n_vert_slices
        p.slice_bytes_num, p.slice_bytes_denom = _reduce_fraction(num, denom)
        self.params = p

    def _init_intra(self) -> None:
        wavelet = Wavelet(self.cfg.enum_index("intra_wavelet"))
        depth = min(self.cfg.transform_depth, MAX_DEPTH_S16[wavelet])
        p = Params(video_format=self.vf, num_refs=0,
                   is_noarith=(self.profile == "vc2_simple"),
                   wavelet_filter_index=wavelet, transform_depth=depth)
        p.set_default_codeblocks()
        if p.is_noarith:
            # avoid the reference decoder's quant-offset compat ambiguity
            p.codeblock_mode_index = 0
        p.set_default_quant_matrix()
        self.params = p
        if self.cfg.rate_control == "lossless":
            self._base_qi = 0
        else:
            self._base_qi = _quality_to_qi(float(self.cfg.get("quality")))

    def _init_gop(self) -> None:
        cfg = self.cfg
        bitrate = cfg.bitrate if cfg.rate_control == "constant_bitrate" \
            else 0
        fps = self.vf.frame_rate_numerator / self.vf.frame_rate_denominator
        lossless = cfg.rate_control == "lossless"
        qi = 0 if lossless else _quality_to_qi(float(cfg.get("quality")))
        qengine = None
        if cfg.rate_control == "constant_lambda":
            # frame_lambda from quality, schroencoder.c:65
            lam = math.exp(0.921034 * float(cfg.get("quality")) - 13.825)
            qengine = QuantiserEngine("constant_lambda", lam=lam)
        elif cfg.rate_control == "constant_quality":
            # quality -> frame lambda + RDO pick, the reference's default
            # mode (schroencoder.c:83-99, magic_error_power 4 neutral)
            q = float(cfg.get("quality"))
            ep = float(cfg.get("magic_error_power"))
            q += -3.5 * (ep - 4)
            q *= 1.0 + (ep - 4) * 0.2
            if ep < 2.5:
                q += 2
            lam = math.exp(1.6447 * q - 16.2826)
            qengine = QuantiserEngine("constant_lambda", lam=lam)
        elif cfg.rate_control in ("constant_error",
                                  "constant_noise_threshold"):
            # lambda bisected per picture on the host so that the error of
            # the picks meets the noise threshold (schroquantiser.c:
            # 1099-1129), from the stat tables of an earlier picture
            qengine = QuantiserEngine(
                cfg.rate_control,
                noise_threshold=float(cfg.get("noise_threshold")),
                width=self.vf.width, height=self.vf.height)
        intra_w = Wavelet(cfg.enum_index("intra_wavelet"))
        inter_w = Wavelet(cfg.enum_index("inter_wavelet"))
        if lossless:
            # reference lossless long-GOP forces Haar-0 (schroengine.c:547)
            intra_w = inter_w = Wavelet.HAAR_0
        magic = {k: float(cfg.get("magic_" + k)) for k in (
            "subband0_lambda_scale", "diagonal_lambda_scale",
            "chroma_lambda_scale",
            "me_lambda_scale", "I_lambda_scale", "P_lambda_scale",
            "B_lambda_scale", "inter_cpd_scale", "keyframe_weight",
            "inter_p_weight", "inter_b_weight", "allocation_scale",
            "badblock_multiplier_nonref", "badblock_multiplier_ref",
            "block_search_threshold", "scan_distance",
            "me_bailout_limit", "error_power")}
        est = []
        if not cfg.get("enable_hierarchical_estimation"):
            est.append("no_hierarchical")
        if not cfg.get("enable_deep_estimation"):
            est.append("no_deep")
        if not cfg.get("enable_bigblock_estimation"):
            est.append("no_bigblock")
        if not (cfg.get("enable_zero_estimation")
                or cfg.get("enable_bigblock_estimation")):
            est.append("no_zero")
        if cfg.get("enable_chroma_me") and cfg.get("enable_deep_estimation"):
            # like the reference, chroma ME needs the deep estimator
            # (schroencoder.c:646-648)
            est.append("chroma_me")
        if cfg.get("enable_fullscan_estimation"):
            est.append("fullscan")
        self._gop = GopEncoder(
            self.vf,
            intra_wavelet=intra_w,
            inter_wavelet=inter_w,
            transform_depth=min(cfg.transform_depth, 3) if lossless
            else cfg.transform_depth,
            gop_length=min(cfg.au_distance, 24),
            base_qi_intra=qi,
            base_qi_inter=qi if lossless else min(60, qi + 4),
            bitrate=bitrate, fps=fps,
            enable_md5=cfg.enable_md5,
            mv_precision=cfg.mv_precision,
            # adaptive maps to the tworef engine like the reference
            # (schroencoder.c:599-604); lossless forces the backref
            # handler (schroengine.c:991-995)
            gop_structure=("biref" if not lossless
                           and cfg.gop_structure in
                           ("adaptive", "biref", "chained_biref")
                           else "backref"),
            subgroup_length=int(cfg.get("magic_subgroup_length")),
            enable_phasecorr=bool(cfg.get("enable_phasecorr_estimation")),
            quantiser_engine=qengine,
            enable_scene_change=bool(
                cfg.get("enable_scene_change_detection")),
            scene_change_threshold=float(
                cfg.get("magic_scene_change_threshold")),
            perceptual_weighting=cfg.get("perceptual_weighting"),
            perceptual_distance=float(cfg.get("perceptual_distance")),
            open_gop=bool(cfg.get("open_gop")),
            enable_psnr=bool(cfg.get("enable_psnr")),
            enable_ssim=bool(cfg.get("enable_ssim")),
            block_size=cfg.get("motion_block_size"),
            block_overlap=cfg.get("motion_block_overlap"),
            codeblock_size=cfg.get("codeblock_size"),
            enable_multiquant=bool(cfg.get("enable_multiquant")),
            enable_dc_multiquant=bool(cfg.get("enable_dc_multiquant")),
            filtering=cfg.get("filtering"),
            filter_value=float(cfg.get("filter_value")),
            rdo_cbr=bool(cfg.get("enable_rdo_cbr")),
            buffer_size=int(cfg.get("buffer_size")),
            buffer_level=int(cfg.get("buffer_level")),
            pipeline_depth=max(1, min(int(cfg.get("queue_depth")) - 1, 8)),
            downsample_levels=int(cfg.get("downsample_levels")),
            max_refs=int(cfg.get("max_refs")),
            estimation=tuple(est),
            magic=magic,
            device=self.device)

    # ---- push/pull ------------------------------------------------------

    def push_frame(self, planes) -> None:
        if self._gop is not None:
            self._out.append(self._gop.encode_frame(planes))
            self.frame_number += 1
            return
        p = self.params
        if self.profile == "vc2_low_delay":
            units = [bs.write_sequence_header(self.vf, profile=0, level=0),
                     loe.encode_picture(planes, p, self.frame_number,
                                        device=self.device)]
        else:
            nb = subband_count(p.transform_depth)
            qm = p.quant_matrix[:nb]
            qis = {}
            for comp in range(3):
                for i in range(nb):
                    hcb, vcb = ei_intra._codeblock_counts(p, i)
                    qi = int(np.clip(self._base_qi - qm[i], 0, 60))
                    qis[(comp, i)] = np.full((vcb, hcb), qi, np.int32)
            prof_num = 1 if self.profile == "vc2_simple" else 2
            units = [bs.write_sequence_header(self.vf, profile=prof_num,
                                              level=0),
                     ei_intra.encode_picture(planes, p, self.frame_number,
                                             quant_indices=qis,
                                             is_ref=False,
                                             device=self.device)]
        self._out.append(self._chain.add(units))
        self.frame_number += 1

    def pull(self) -> Optional[bytes]:
        if self._out:
            return self._out.pop(0)
        return None

    def end_of_stream(self) -> bytes:
        if self._gop is not None:
            tail = self._gop.flush()
            return tail + self._gop._chain.add([bs.make_eos_unit()],
                                               final_eos=True)
        return self._chain.add([bs.make_eos_unit()], final_eos=True)

    def encode_stream(self, frames) -> bytes:
        if self.profile == "vc2_low_delay":
            return self._encode_stream_lowdelay(frames)
        if self._gop is not None:
            out = self._gop.encode_stream(frames)   # includes flush + EOS
            self.frame_number = self._gop.frame_number
            return out
        out = bytearray()
        for f in frames:
            self.push_frame(f)
            out += self.pull()
        out += self.end_of_stream()
        return bytes(out)

    def _encode_stream_lowdelay(self, frames) -> bytes:
        """Pipelined low-delay encode: while the main thread queues the
        device analysis of frame N+1, a worker thread fetches frame N to
        the host and packs it in the native coder (which releases the
        GIL).  The JAX encoder packs on its main thread, where one jitted
        call queues the analysis; in eager torch queueing it is host work
        of its own, so the packing moves to the worker to overlap it.
        On the card the worker fetches on a stream of its own, so the
        copy of frame N runs beside the analysis of frame N+1.
        The counters `ld_fetch_ns` and `ld_pack_ns` sum the worker's
        fetch and packing time (a profiler that records only the thread
        that started it sees no span of the worker's).  Spans: `ld_analysis` (the upload
        and the queued analysis), `ld_fetch` (the worker's fetch),
        `ld_pack` (its packing) and `ld_wait` (the main thread waiting
        for a packed picture)."""
        analyze = loe._get_analyze_fn(self.params)
        side = (torch.cuda.Stream(self.device)
                if self.device.type == "cuda" else None)

        def host_half(dev, ready, fnum):
            t0 = time.perf_counter_ns()
            with record_function("ld_fetch"):
                host = loe.fetch_analysis(dev, side, ready)
            t1 = time.perf_counter_ns()
            unit = loe.encode_picture_from_analysis(host, self.params, fnum,
                                                    False)
            t2 = time.perf_counter_ns()
            counters.add("ld_fetch_ns", t1 - t0)
            counters.add("ld_pack_ns", t2 - t1)
            return unit

        out = bytearray()
        with cf.ThreadPoolExecutor(max_workers=1) as pool:
            pending = None
            for f in frames:
                with record_function("ld_analysis"):
                    dev = analyze(*upload_picture(
                        f, self.vf.bit_depth, self.device))
                    ready = None
                    if side is not None:
                        ready = torch.cuda.Event()
                        ready.record()
                fut = pool.submit(host_half, dev, ready, self.frame_number)
                self.frame_number += 1
                if pending is not None:
                    self._emit_lowdelay(pending, out)
                pending = fut
            if pending is not None:
                self._emit_lowdelay(pending, out)
        out += self.end_of_stream()
        return bytes(out)

    def _emit_lowdelay(self, fut, out: bytearray) -> None:
        with record_function("ld_wait"):
            unit = fut.result()
        out += self._chain.add(
            [bs.write_sequence_header(self.vf, profile=0, level=0), unit])


class Decoder:
    """Dirac/VC-2 decoder: the pipelined stream decoder (host entropy
    decode overlaps the device's render; falls back per picture where
    needed).  Field pictures come out woven into frames."""

    def __init__(self, device=None):
        self._core = PipelinedStreamDecoder(device=device)

    @property
    def md5_failures(self):
        return self._core.md5_failures

    @property
    def errors(self):
        return self._core.errors

    @property
    def vf(self):
        return self._core.vf

    def decode_stream(self, stream: bytes) -> List[Tuple[np.ndarray, ...]]:
        return weave_pictures(self._core.decode_stream(stream),
                              self._core.vf)


def weave_pictures(pictures, vf):
    """A decoder's pictures in presentation order as frames: under
    interlaced coding the pairs of field pictures woven in the format's
    field order (an unpaired last field is dropped, as in the JAX
    decoder), else the pictures themselves."""
    if vf is None or not vf.interlaced_coding:
        return pictures
    return [weave_fields(pictures[i], pictures[i + 1],
                         tff=vf.top_field_first)
            for i in range(0, len(pictures) - 1, 2)]
