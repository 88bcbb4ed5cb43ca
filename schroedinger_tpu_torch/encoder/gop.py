"""Long-GOP encoder: GOP structure, reference management, rate control.

Port of `schroedinger_tpu/encoder/gop.py` `GopEncoder` for two engines:

- "backref": I P P P.  In `encode_stream` the device work of picture N+1
  is queued before the host entropy coding of picture N runs,
  `pipeline_depth` pictures deep; `encode_frame` (the push API) codes
  each picture to its end before the next, which changes the lag of the
  rate decisions and so the stream.
- "biref": the tworef / BBBP engine.  Display-order frames buffer into
  subgroups of `subgroup_length`; the last picture of each subgroup is
  coded first as a P (two references once a long-term intra exists), then
  the earlier ones as non-reference two-reference B pictures, all of a
  full subgroup's B pictures as one batch (`enable_b_batch`, the JAX
  default) where the JAX encoder batches them.

Rate control, on both engines: with `bitrate` the TM5 controller
(`ratecontrol.CbrControllerTM5`) sets one lambda per picture kind, and a
`QuantiserEngine` in constant_lambda mode holds one lambda for the
stream; every picture then picks its quantisers on the device against
its own exact stat tables.  The constant_error and
constant_noise_threshold engines, and the allocation controller of
`rdo_cbr=False` (`ratecontrol.CbrController`), pick on the host from the
stat tables of an earlier picture (the lag is part of the stream).
Without either the pictures are coded at the fixed base indices.
`enable_multiquant` writes the per-codeblock quant syntax and, with the
RD pick, refines each band's index codeblock by codeblock.

The constructor takes the JAX encoder's whole signature with its
defaults, and `GopEncoder(vf, **kw)` gives the JAX encoder's stream for
every `kw`: the block geometry (`block_size`, `block_overlap`,
`codeblock_size`), phase-correlation candidates, the estimation switches
and `downsample_levels`, the prefilters (`filtering`, each picture
filtered once), PSNR / SSIM of the reconstructions into `stats`, and the
perceptual weighting.  Interlaced coding (`video_format.interlaced_coding`)
splits each frame into two field pictures (`frontends.split_fields`, in
the format's field order) coded back to back as pictures 2n and 2n+1;
the GOP length and the access-unit boundary count frames, the TM5
controller fields.  Deep (>8-bit) video raises NotImplementedError: the
reference codes deep formats intra only (ROADMAP.md Queue 3).
"""
from __future__ import annotations

from collections import deque
from typing import Optional

import numpy as np
from torch.profiler import record_function

from schroedinger_tpu_torch import bitstream as bs
from schroedinger_tpu_torch import tables
from schroedinger_tpu_torch.coding import native as _native
from schroedinger_tpu_torch.coding import slices as sl
from schroedinger_tpu_torch.decoder.core import RefFrame
from schroedinger_tpu_torch.devices import resolve_device
from schroedinger_tpu_torch.encoder import inter as ei_inter
from schroedinger_tpu_torch.encoder import intra as ei_intra
from schroedinger_tpu_torch.encoder.lowdelay import _forward
from schroedinger_tpu_torch.encoder.ratecontrol import (ArithCorrection,
                                                        CbrController,
                                                        CbrControllerTM5,
                                                        estimate_bits_at,
                                                        lambda_for_bits,
                                                        pick_bands_rdo,
                                                        qi_from_lambda,
                                                        stats_tables)
from schroedinger_tpu_torch.encoder.weights import (band_lambda_scales,
                                                    cycles_per_degree)
from schroedinger_tpu_torch.frontends import split_fields
from schroedinger_tpu_torch.ops.filters import apply_prefilter
from schroedinger_tpu_torch.ops.metrics import ssim_frame
from schroedinger_tpu_torch.params import Params, subband_count
from schroedinger_tpu_torch.pipeline import _prep, to_host, upload_picture
from schroedinger_tpu_torch.utils.telemetry import FrameStats
from schroedinger_tpu_torch.video_format import VideoFormat
from schroedinger_tpu_torch.wavelets import MAX_DEPTH_S16, Wavelet

# motion block separation by block_size (init_params,
# schroengine.c:410-455)
BLOCK_SEPARATIONS = {"small": 8, "medium": 12, "large": 16}

# magic_* tuning constants (schroencoder.c:4513-4535 defaults), the JAX
# encoder's whole set.  keyframe_weight, inter_p_weight, inter_b_weight,
# allocation_scale and the badblock multipliers are read only by the
# allocation controller (rdo_cbr=False)
MAGIC_DEFAULTS = dict(
    subband0_lambda_scale=10.0, diagonal_lambda_scale=1.0,
    chroma_lambda_scale=0.1, me_lambda_scale=1.0, I_lambda_scale=1.0,
    P_lambda_scale=0.25, B_lambda_scale=0.01, inter_cpd_scale=1.0,
    keyframe_weight=7.5, inter_p_weight=1.5, inter_b_weight=0.2,
    allocation_scale=1.1, me_bailout_limit=0.33,
    badblock_multiplier_ref=8.0, badblock_multiplier_nonref=4.0,
    block_search_threshold=15.0, scan_distance=4.0, error_power=4.0)


class GopEncoder:
    def __init__(self, video_format: VideoFormat,
                 intra_wavelet: Wavelet = Wavelet.DESLAURIERS_DUBUC_9_7,
                 inter_wavelet: Wavelet = Wavelet.LE_GALL_5_3,
                 transform_depth: int = 3,
                 gop_length: int = 24,
                 base_qi_intra: int = 16,
                 base_qi_inter: int = 20,
                 bitrate: int = 0,
                 fps: float = 25.0,
                 enable_md5: bool = False,
                 mv_precision: int = 0,
                 enable_scene_change: bool = True,
                 scene_change_threshold: float = 3.0,
                 enable_phasecorr: bool = False,
                 quantiser_engine=None,
                 stats=None,
                 pipeline_depth: int = 3,
                 gop_structure: str = "backref",
                 subgroup_length: int = 4,
                 base_qi_b: Optional[int] = None,
                 perceptual_weighting: str = "ccir959",
                 perceptual_distance: float = 4.0,
                 open_gop: bool = True,
                 enable_psnr: bool = False,
                 enable_ssim: bool = False,
                 block_size: str = "automatic",
                 block_overlap: str = "automatic",
                 codeblock_size: str = "automatic",
                 enable_multiquant: bool = False,
                 enable_dc_multiquant: bool = False,
                 filtering: str = "none",
                 filter_value: float = 5.0,
                 rdo_cbr: bool = True,
                 buffer_size: int = 0,
                 buffer_level: int = 0,
                 downsample_levels: int = 5,
                 enable_noarith: bool = False,
                 max_refs: int = 3,
                 estimation: tuple = (),
                 enable_b_batch: bool = True,
                 magic: Optional[dict] = None,
                 device=None):
        if gop_structure not in ("backref", "biref"):
            raise ValueError(f"gop_structure {gop_structure!r}")
        if max_refs < 2 and gop_structure == "biref":
            # a 1-deep reference buffer cannot host the tworef engine's
            # forward references: degrade to the backref (IPPP) engine
            gop_structure = "backref"
        if video_format.bit_depth != 8:
            raise NotImplementedError(
                "deep (>8-bit) long-GOP coding is refused: the reference "
                "codes deep formats intra only (ROADMAP.md Queue 3)")
        self.device = resolve_device(device)
        self.vf = video_format
        self.intra_wavelet = intra_wavelet
        self.inter_wavelet = inter_wavelet
        self.depth = min(transform_depth,
                         MAX_DEPTH_S16[intra_wavelet],
                         MAX_DEPTH_S16[inter_wavelet])
        self.gop_length = gop_length
        self.base_qi_intra = base_qi_intra
        self.base_qi_inter = base_qi_inter
        self.base_qi_b = (base_qi_b if base_qi_b is not None
                          else min(60, base_qi_inter + 4))
        self.frame_number = 0
        self.last_ref: Optional[int] = None
        self.prev_ref: Optional[int] = None
        self.ref_frames = {}
        self._chain = bs.OffsetChain()
        self.enable_md5 = enable_md5
        self.mv_precision = mv_precision
        self.enable_scene_change = enable_scene_change
        self.scene_change_threshold = scene_change_threshold
        self._prev_input = None
        self._prev_mad = None
        self.stats = stats if stats is not None else FrameStats()
        # field coding: two pictures per frame
        self.field_factor = 2 if video_format.interlaced_coding else 1
        self.perceptual_weighting = perceptual_weighting
        self.perceptual_distance = perceptual_distance
        self.downsample_levels = downsample_levels
        self.enable_phasecorr = enable_phasecorr
        self.enable_psnr = enable_psnr
        self.enable_ssim = enable_ssim
        self.block_size = block_size
        self.block_overlap = block_overlap
        self.codeblock_size = codeblock_size
        self.filtering = filtering
        self.filter_value = filter_value
        # estimation-stage switches (the enable_*_estimation settings):
        # tokens among no_hierarchical, no_deep, no_bigblock, no_zero,
        # chroma_me and fullscan, resolved by inter._estimation
        self.estimation = tuple(estimation)
        self.enable_b_batch = enable_b_batch
        self.enable_multiquant = enable_multiquant
        self.enable_dc_multiquant = enable_dc_multiquant
        # no-arith (VLC) residuals and MVs on the long-GOP path: the
        # reference's unit writers have the is_noarith branches
        # (schroencoder.c:4073+) although its settings dispatch selects
        # no-arith only for intra-only streams
        self.enable_noarith = enable_noarith
        self.qengine = quantiser_engine
        self.pipeline_depth = pipeline_depth
        self.gop_structure = gop_structure
        self.subgroup_length = subgroup_length
        self.open_gop = open_gop
        # decoder-visible reference-buffer budget (schroengine.c:127-245
        # manages up to 4; the max_refs setting caps it)
        self.max_refs = max(1, int(max_refs))
        unknown = sorted(set(magic or {}) - set(MAGIC_DEFAULTS))
        if unknown:
            raise ValueError(f"unknown magic constants: {unknown}")
        self.magic = dict(MAGIC_DEFAULTS, **(magic or {}))
        self._queue = []          # biref: display-order (num, planes, sc)
        self._pends2 = deque()    # biref: coded-order pending pictures
        self._refbuf = {}         # biref: picture number -> expired flag
        self._enc_last_ref = None  # mirrors encoder->last_ref
        self._au_frame = None     # picture number of the last AU intra
        self._last_max_qi = None  # newest finished ref's coarsest luma qi
        self._last_badblock = 0.0  # newest finished picture's badblock ratio
        self._last_stats = None   # backref: newest (bits61, err61) tables
        self._stats_by_kind = {}  # biref: newest stat tables per P / B
        self._sent_stream_aux = False
        # EMA of non-residual bits per picture (headers + MV data),
        # subtracted from the TM5 allocation to get the residual target
        # of the on-device lambda fit (the reference knows the exact
        # value because it packs headers first, schroencoder.c:2532)
        self._oh_inter = None
        self._oh_intra = None
        self.rc = None
        if bitrate and rdo_cbr:
            self.rc = CbrControllerTM5(
                bitrate, fps, gop_length,
                subgroup_length=(subgroup_length
                                 if gop_structure == "biref" else 4),
                buffer_size=buffer_size, buffer_level=buffer_level,
                interlaced=video_format.interlaced_coding,
                b_lambda_scale=self.magic["B_lambda_scale"],
                p_lambda_scale=self.magic["P_lambda_scale"],
                i_lambda_scale=self.magic["I_lambda_scale"])
        elif bitrate:
            # enable_rdo_cbr=FALSE: the reference's other CBR path
            # (rdo_bit_allocation + the get_alloc reservoir curve,
            # schroengine.c:552-637): per-picture bit targets from weighted
            # allocations, the lambda bisected on the host to fit each
            self.rc = CbrController(
                bitrate, fps, gop_length,
                buffer_size=buffer_size, buffer_level=buffer_level,
                interlaced=video_format.interlaced_coding,
                keyframe_weight=self.magic["keyframe_weight"],
                inter_p_weight=self.magic["inter_p_weight"],
                inter_b_weight=self.magic["inter_b_weight"],
                allocation_scale=self.magic["allocation_scale"])
        self._tm5 = isinstance(self.rc, CbrControllerTM5)
        if (self.qengine is not None
                and getattr(self.qengine, "band_scales", None) is None):
            self.qengine.band_scales = self._band_scales3(False)
        # per-(component, band) x {intra, inter} arith-vs-estimate bit
        # ratio tables (schroencoder.c:2548-2590): they scale the
        # per-band bit estimates inside every RD pick
        self.acorr = ArithCorrection(3 * subband_count(self.depth))

    def _params(self, num_refs: int) -> Params:
        p = Params(video_format=self.vf, num_refs=num_refs,
                   transform_depth=self.depth,
                   wavelet_filter_index=(self.inter_wavelet if num_refs
                                         else self.intra_wavelet))
        p.set_default_codeblocks()
        p.set_default_quant_matrix()
        p.mv_precision = self.mv_precision if num_refs else 0

        # motion block size and overlap (init_params,
        # schroengine.c:410-455); automatic size by picture area,
        # automatic overlap = partial (blen = 3/2 bsep)
        area = self.vf.width * self.vf.height
        bsep = BLOCK_SEPARATIONS.get(
            self.block_size,
            16 if area >= 1920 * 1080 else 12 if area >= 960 * 540 else 8)
        p.xbsep_luma = p.ybsep_luma = bsep
        if self.block_overlap == "none":
            blen = bsep
        elif self.block_overlap == "full":
            blen = 2 * bsep
        else:
            blen = (bsep * 3 // 2) & ~3
        p.xblen_luma = p.yblen_luma = blen
        # codeblock_size (schroengine.c:459-505): small / medium aim at
        # about 5x5 / 8x8 coefficient blocks, large keeps the defaults
        # set above, full is one block per subband
        if self.codeblock_size in ("small", "medium"):
            denom = 5 if self.codeblock_size == "small" else 8
            for i in range(self.depth + 1):
                shift = self.depth if i == 0 else self.depth + 1 - i
                p.horiz_codeblocks[i] = max(
                    1, (p.iwt_luma_width >> shift) // denom)
                p.vert_codeblocks[i] = max(
                    1, (p.iwt_luma_height >> shift) // denom)
        elif self.codeblock_size == "full":
            for i in range(self.depth + 1):
                p.horiz_codeblocks[i] = 1
                p.vert_codeblocks[i] = 1
        # one DC codeblock unless DC multiquant is on (reference
        # decoder-compat workaround, schroengine.c:508-511)
        if not self.enable_dc_multiquant:
            p.horiz_codeblocks[0] = 1
            p.vert_codeblocks[0] = 1
        # multiquant takes the per-codeblock quant-delta codeblock mode
        # (schroengine.c:517-521); no-arith keeps mode 0: the quant-offset
        # mode is ambiguous in no-arith streams (the vc2_simple intra
        # path's compat choice)
        p.codeblock_mode_index = 1 if self.enable_multiquant else 0
        p.is_noarith = self.enable_noarith
        if self.enable_noarith:
            p.codeblock_mode_index = 0
        return p

    def _step_kw(self) -> dict:
        return dict(
            use_phasecorr=self.enable_phasecorr,
            me_levels=self.downsample_levels,
            block_search_threshold=self.magic["block_search_threshold"],
            scan_distance=self.magic["scan_distance"],
            estimation=self.estimation,
            error_power=self.magic["error_power"], device=self.device)

    def _prefilter(self, planes):
        """The encoder's prefilter (schroencoder.c:2211-2234): host u8
        planes out, each input picture filtered once."""
        if self.filtering in ("none", 0, None):
            return planes
        with record_function("prefilter"):
            return apply_prefilter(planes, self.filtering,
                                   self.filter_value, self.device)

    def _want_metrics(self) -> bool:
        return self.enable_psnr or self.enable_ssim

    def _quality_metrics(self, recon, planes) -> dict:
        """The optional postanalysis (schroencoder.c:2729-2752): luma PSNR
        and SSIM of the coded reconstruction against the (prefiltered)
        input, on the host."""
        out = {}
        if recon is None or planes is None or not self._want_metrics():
            return out
        with record_function("quality_metrics"):
            rec = to_host(recon[0]).astype(np.float64)
            src = np.asarray(planes[0], np.float64)
            if self.enable_psnr:
                mse = np.mean((rec - src) ** 2)
                out["psnr"] = round(
                    99.0 if mse == 0
                    else float(10 * np.log10(255.0 ** 2 / mse)), 3)
            if self.enable_ssim:
                out["ssim"] = round(float(ssim_frame(src, rec)), 4)
        return out

    def _scene_change_score(self, planes) -> float:
        """MAD vs previous input, downsampled 4x (schroencoder.c:1909
        calculate_sc_score analog): score = mad / running mad."""
        with record_function("scene_change"):
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
        """backref: (intra?, scene-change score) for picture num."""
        is_intra = ((num // self.field_factor) % self.gop_length) == 0
        sc = (self._scene_change_score(planes)
              if self.enable_scene_change else 0.0)
        if (not is_intra and sc > self.scene_change_threshold
                and self.last_ref is not None):
            is_intra = True
        return is_intra, sc

    def _pictures(self, planes):
        """The pictures of one input frame: the frame itself, or its two
        fields in the format's field order under interlaced coding
        (schro_encoder_push_frame_full, schroencoder.c:1072-1110)."""
        if self.field_factor == 2:
            return split_fields(planes, tff=self.vf.top_field_first)
        return (planes,)

    def encode_frame(self, planes) -> bytes:
        """Display-order input; returns coded-order parse units (references
        before the B pictures that use them).  The biref engine may return
        b'' while it buffers a subgroup.  Under interlaced coding the
        frame's two fields are coded back to back; the second field
        predicts from the first."""
        with record_function("gop_drive"):
            planes = self._prefilter(planes)
            out = bytearray()
            for pic in self._pictures(planes):
                num = self.frame_number
                if self.gop_structure == "biref":
                    self.frame_number += 1
                    sc = (self._scene_change_score(pic)
                          if self.enable_scene_change else 0.0)
                    self._queue.append((num, pic, sc))
                    out += self._drain_subgroups(final=False)
                else:
                    is_intra, sc = self._is_intra(num, pic)
                    out += self._encode_ref(pic, num, is_intra, sc)
            return bytes(out)

    def flush(self) -> bytes:
        """Code what the biref engine still buffers and finish its pending
        pictures (the backref engine holds nothing back)."""
        with record_function("gop_drive"):
            out = bytearray()
            if self.gop_structure == "biref":
                out += self._drain_subgroups(final=True)
                while self._pends2:
                    out += self._finish_pending2(self._pends2.popleft())
            return bytes(out)

    def encode_stream(self, frames, progress=None) -> bytes:
        """Encode a sequence with device/host pipelining: the inter step of
        a later picture is queued on the device before the host entropy
        coding of an earlier one runs, so device compute and C++ arith
        coding overlap.  With TM5 CBR or constant_lambda the per-band pick
        runs on the device against each picture's own tables; only the
        lambda crosses pictures, `pipeline_depth` pictures late.  The host
        picks (constant_error, constant_noise_threshold, the allocation
        controller) read the stat tables of the newest finished picture;
        at stream start, with no tables yet, the oldest picture in flight
        is finished first so that the engine engages from the second P.

        progress(i, nbytes), where given, is called as the JAX encoder
        calls it: after every input frame of the biref engine, after every
        P picture of the backref engine, with the bytes out so far."""
        out = bytearray()
        if self.gop_structure == "biref":
            for i, planes in enumerate(frames):
                out += self.encode_frame(planes)
                if progress is not None:
                    progress(i, len(out))
            out += self.flush()
            out += self._chain.add([bs.make_eos_unit()], final_eos=True)
            return bytes(out)
        pends = deque()  # (pending, (num, ref_num, retired, sc, keep))
        pictures = (pic for planes in frames
                    for pic in self._pictures(self._prefilter(planes)))
        for planes in pictures:
            with record_function("gop_drive"):
                num = self.frame_number
                is_intra, sc = self._is_intra(num, planes)
                if is_intra or self.last_ref is None:
                    while pends:
                        out += self._finish_pending(pends.popleft())
                    out += self._encode_ref(planes, num, True, sc)
                    continue

                qargs = self._quant_args("P")
                if (qargs.get("want_stats")
                        and qargs.get("qi_bands_override") is None
                        and pends):
                    # a host-pick engine with no stat tables yet (stream
                    # start): finish the oldest picture in flight, whose
                    # tables the engine then picks from
                    out += self._finish_pending(pends.popleft())
                    qargs = self._quant_args("P")
                meta = (num, self.last_ref, self.prev_ref, sc,
                        planes if self._want_metrics() else None)
                with record_function("p_picture_step"):
                    pending = ei_inter.start_inter_picture(
                        planes, self._params(1),
                        self.ref_frames[self.last_ref],
                        base_qi=self.base_qi_inter, **self._step_kw(),
                        **qargs)
                # the new recon tensors become the reference at once; the
                # device stream orders the dependency
                if self.prev_ref is not None:
                    self.ref_frames.pop(self.prev_ref, None)
                self.ref_frames[num] = RefFrame(tuple(pending["recon"]))
                self.prev_ref = self.last_ref
                self.last_ref = num
                self.frame_number += 1
                pends.append((pending, meta))
                if len(pends) > self.pipeline_depth:
                    out += self._finish_pending(pends.popleft())
            if progress is not None:
                progress(num, len(out))
        with record_function("gop_drive"):
            while pends:
                out += self._finish_pending(pends.popleft())
        out += self._chain.add([bs.make_eos_unit()], final_eos=True)
        return bytes(out)

    # ---- rate control ---------------------------------------------------

    def _band_scales(self, intra: bool) -> np.ndarray:
        """Per-band lambda multipliers (perceptual weights + magic scales,
        schroquantiser.c:856-880)."""
        cpd_h, cpd_v = cycles_per_degree(
            self.vf.height, self.vf.aspect_ratio_numerator,
            self.vf.aspect_ratio_denominator, self.perceptual_distance,
            self.vf.interlaced_coding)
        return band_lambda_scales(
            self.intra_wavelet if intra else self.inter_wavelet,
            self.depth, self.perceptual_weighting, cpd_h, cpd_v,
            inter_cpd_scale=self.magic["inter_cpd_scale"], intra=intra,
            subband0_scale=self.magic["subband0_lambda_scale"],
            diagonal_scale=self.magic["diagonal_lambda_scale"])

    def _band_scales3(self, intra: bool) -> np.ndarray:
        """Per-(component, band) lambda multipliers, component-major
        (3*nb,): the luma scales plus magic_chroma_lambda_scale on the
        chroma components (schroquantiser.c:865-880)."""
        s = self._band_scales(intra)
        c = self.magic["chroma_lambda_scale"]
        return np.concatenate([s, s * c, s * c])

    def _device_pick(self) -> bool:
        """True when the inter pictures pick their quantisers on the device
        (the TM5 controller or the constant_lambda engine); False for the
        host picks and the fixed base indices."""
        return self._tm5 or (self.qengine is not None
                             and self.qengine.mode == "constant_lambda")

    def _quant_args(self, kind: str) -> dict:
        """kwargs for start_inter_picture's quant selection.  The on-device
        RD pick (lam_bands) for the lambda-driven engines: the
        constant_lambda engine's one lambda holds for every picture; the
        TM5 controller's lambda is fitted per frame so that the corrected
        bit estimate of the picks matches this picture's complexity-
        weighted allocation (the reference's entropy_to_lambda,
        schroquantiser.c:887-960).  A host pick (qi_bands_override, with
        want_stats so that the picture's own tables come back) for the
        constant_error / constant_noise_threshold engines and the
        allocation controller, against the newest tables the host has.
        Without either, nothing (fixed base indices)."""
        with record_function("rate_control"):
            # the on-device RD argmin computes bits + lam*err; scaling the bit
            # estimates by the arith-correction ratio c gives the reference's
            # corrected cost c*bits + lam*err (schroquantiser.c:706-725)
            corr = np.maximum(self.acorr.inter, 1e-3)
            if self.qengine is not None:
                if self.qengine.mode == "constant_lambda":
                    return {"lam_bands": (self.qengine.lam
                                          * self.qengine.band_scales),
                            "corr_bands": corr,
                            "me_lam": self._me_lam()}
                return {"qi_bands_override": self.qengine.pick(),
                        "want_stats": True}
            if self.rc is None:
                return {}
            if self._tm5:
                alloc = {"I": self.rc.I_frame_alloc,
                         "P": self.rc.P_frame_alloc,
                         "B": self.rc.B_frame_alloc}[kind]
                oh = self._oh_inter or 0.0
                # buffer-aware cap, not a hard per-frame budget: a full
                # reservoir lets pictures spend up to ~3x their complexity
                # allocation (quality rides the buffer, like the reference's
                # get_alloc curve, schroengine.c:552-637), a draining one
                # tightens toward 1x
                occ = max(self.rc.buffer_level / self.rc.buffer_size, 0.0)
                if occ > 0.7:
                    # reservoir healthy: the buffer is the CBR contract, so
                    # the TM5 stable-quality spend rides it
                    target = 0.0
                else:
                    cap = alloc * (1.0 + 2.0 * occ)
                    target = max(cap - oh, 0.25 * alloc)
                return {"lam_bands": (self.rc.frame_lambda(kind)
                                      * self._band_scales3(False)),
                        "corr_bands": corr,
                        "target_bits": target,
                        "me_lam": self._me_lam()}
            # the allocation controller: a host pick against the newest stat
            # tables, in the JAX encoder's order of preference
            stats = (self._last_stats or self._stats_by_kind.get(kind)
                     or self._stats_by_kind.get("P")
                     or self._stats_by_kind.get("B"))
            qi = None
            if stats is not None:
                # badblock-weighted allocation (schroengine.c:610-617; the
                # ratio is the newest finished picture's)
                mult = self.magic["badblock_multiplier_nonref" if kind == "B"
                                  else "badblock_multiplier_ref"]
                extra = self._last_badblock * mult
                qi = pick_bands_rdo(stats,
                                    self.rc.frame_target(kind=kind,
                                                         extra_weight=extra),
                                    band_scales=self._band_scales3(False),
                                    correction=corr)
            return {"qi_bands_override": qi, "want_stats": True}

    def _rc_update(self, kind: str, bits: int, num: int,
                   est: Optional[float] = None) -> bytes:
        """Updates the CBR model (the TM5 controller by picture kind, the
        allocation controller with the bit estimate of the picks, where
        there is one); returns a PADDING parse unit when the reservoir
        overran (schroencoder.c:2601-2611), else b''."""
        if self.rc is None:
            return b""
        if self._tm5:
            pad = self.rc.update(kind, bits, num, self.field_factor)
        else:
            pad = self.rc.update(bits, est)
        return bs.make_padding_unit(pad) if pad else b""

    def _acorr_update(self, pending, unit_bits: int = 0) -> None:
        """EMA the inter arith-correction tables from a finished inter
        picture's actual vs estimated per-band bits, and the non-residual
        overhead EMA that feeds the lambda-fit target."""
        est = pending.get("band_bits_est")
        if est is not None:
            self.acorr.update(False, pending["band_bits_actual"], est)
        if unit_bits:
            oh = max(unit_bits - float(
                np.sum(pending.get("band_bits_actual", 0.0))), 0.0)
            self._oh_inter = (oh if self._oh_inter is None
                              else 0.8 * self._oh_inter + 0.2 * oh)

    def _me_lam(self) -> float:
        """Mode-decision lambda (frame_me_lambda analog): tracks the
        newest finished reference's coarsest luma quant step (QF/8 SAD
        per bit)."""
        qi = self._last_max_qi
        if qi is None:
            qi = self.base_qi_inter
        return (float(tables.QUANT_FACTOR[min(int(qi), 60)]) / 8.0
                * self.magic["me_lambda_scale"])

    # ---- tworef / BBBP engine -------------------------------------------
    # Re-expression of the reference's tworef GOP machinery
    # (schroengine.c:685-796 handle_gop_tworef, :247-304 code_BBBP,
    # :127-245 pick_refs/pick_retire).  The decoder-visible reference
    # buffer is modelled explicitly: coding a P *expires* the previous P
    # (schroengine.c:276 expire_reference) but the retire lags one
    # subgroup (pick_retire returns the oldest EXPIRED ref), because the
    # reference decoder retires BEFORE binding refs (schrodecoder.c:1302).
    # The most recent AU's intra picture stays unexpired until the next
    # AU, so steady-state P pictures have two references (previous P +
    # long-term I), exactly as the reference's pick_refs yields.

    def _pick_refs(self, fn: int):
        """ref0 = most recent back ref (expiry ignored); ref1 = earliest
        forward unexpired ref, else newest older unexpired back ref."""
        back = [n for n in self._refbuf if n < fn]
        ref0 = max(back)
        fwd = [n for n, exp in self._refbuf.items() if n > fn and not exp]
        if fwd:
            return ref0, min(fwd)
        older = [n for n, exp in self._refbuf.items()
                 if n < ref0 and not exp]
        return ref0, (max(older) if older else None)

    def _pick_retire(self):
        """Oldest expired ref; forced oldest-overall when the buffer holds
        max_refs pictures (schroengine.c:186-205's forced retire)."""
        expired = [n for n, e in self._refbuf.items() if e]
        if expired:
            return min(expired)
        if len(self._refbuf) >= self.max_refs:
            return min(self._refbuf)
        return None

    def _retire_and_add(self, retire, fn: int):
        # pending pictures keep their own handles on the planes they read
        if retire is not None:
            self._refbuf.pop(retire, None)
            self.ref_frames.pop(retire, None)
        self._refbuf[fn] = False

    def _drain_subgroups(self, final: bool) -> bytes:
        """Cut completed subgroups off the display-order queue and encode
        them (handle_gop_tworef's boundary logic, schroengine.c:703-776):
        an AU boundary ends the subgroup *with* the AU frame as its intra
        last picture (open GOP: the preceding B's reference the new I
        forward); a scene cut at the head becomes an I, a cut mid-subgroup
        ends the subgroup just before the cut frame."""
        out = bytearray()
        while self._queue:
            sg = self.subgroup_length
            n = len(self._queue)
            take = None
            last_is_intra = False
            for j in range(min(sg, n)):
                num, _, sc = self._queue[j]
                is_au = (self._au_frame is None
                         or (num - self._au_frame)
                         >= self.gop_length * self.field_factor)
                cut = (self.enable_scene_change
                       and sc > self.scene_change_threshold
                       and self._refbuf)
                if is_au:
                    # open GOP: the AU frame ends the subgroup as its
                    # intra last picture; closed GOP cuts before it so no
                    # picture crosses the AU (schroengine.c:729-736)
                    if self.open_gop or j == 0:
                        take, last_is_intra = j + 1, True
                    else:
                        take, last_is_intra = j, False
                    break
                if cut:
                    if j == 0:
                        take, last_is_intra = 1, True
                    else:
                        take, last_is_intra = j, False
                    break
            if take is None:
                if n >= sg:
                    take = sg
                elif final:
                    take = n
                else:
                    break  # wait for more frames
            group = [self._queue.pop(0) for _ in range(take)]
            out += self._encode_subgroup(group, last_is_intra)
        return bytes(out)

    def _encode_subgroup(self, group, last_is_intra: bool) -> bytes:
        out = bytearray()
        num, planes, sc = group[-1]
        if last_is_intra or not self._refbuf:
            while self._pends2:
                out += self._finish_pending2(self._pends2.popleft())
            retire = self._pick_retire()
            out += self._encode_ref(planes, num, True, sc,
                                    retired=retire, manage_refs=False)
            self._retire_and_add(retire, num)
            intra_num = num
        else:
            out += self._start_ref_biref(planes, num, sc)
            intra_num = None
        bs_ = group[:-1]
        batched = (self._start_b_batch(bs_)
                   if len(bs_) >= 2 and self.enable_b_batch else None)
        if batched is not None:
            out += batched
        else:
            for (bnum, bplanes, bsc) in bs_:
                out += self._start_b_biref(bplanes, bnum, bsc)
        if intra_num is not None:
            # expire_refs_before (schroengine.c:294-296): pre-AU refs
            # become retire candidates for subsequent ref pictures
            for n in self._refbuf:
                if n < intra_num:
                    self._refbuf[n] = True
            self._au_frame = intra_num
        return bytes(out)

    def _start_ref_biref(self, planes, num, sc) -> bytes:
        """Code the subgroup-last P: ref0 = previous I/P, ref1 = long-term
        unexpired ref (the last AU's intra) when one exists; the retire
        lags by one subgroup (schroengine.c:267-277)."""
        retire = self._pick_retire()
        ref0, ref1 = self._pick_refs(num)
        refs = [ref0] if ref1 is None else [ref0, ref1]
        qargs = self._quant_args("P")
        with record_function("p_picture_step"):
            pending = ei_inter.start_inter_picture(
                planes, self._params(len(refs)), self.ref_frames[ref0],
                base_qi=self.base_qi_inter,
                ref2=(self.ref_frames[ref1] if ref1 is not None else None),
                want_recon=True, **self._step_kw(), **qargs)
        meta = (num, refs, retire, True, "P", sc,
                planes if self._want_metrics() else None)
        self.ref_frames[num] = RefFrame(tuple(pending["recon"]))
        self._retire_and_add(retire, num)
        # expire_reference(encoder->last_ref) after coding each P
        if self._enc_last_ref in self._refbuf:
            self._refbuf[self._enc_last_ref] = True
        self._enc_last_ref = num
        self._pends2.append((pending, meta))
        return self._drain_pends2()

    def _start_b_biref(self, planes, num, sc) -> bytes:
        ref0, ref1 = self._pick_refs(num)
        qargs = self._quant_args("B")
        with record_function("b_picture_step"):
            pending = ei_inter.start_inter_picture(
                planes, self._params(2), self.ref_frames[ref0],
                base_qi=self.base_qi_b, ref2=self.ref_frames[ref1],
                want_recon=self.enable_md5 or self._want_metrics(),
                **self._step_kw(), **qargs)
        meta = (num, [ref0, ref1], None, False, "B", sc,
                planes if self._want_metrics() else None)
        self._pends2.append((pending, meta))
        return self._drain_pends2()

    def _start_b_batch(self, bs_):
        """Queue a whole subgroup's B pictures as one batch
        (inter.start_inter_batch: each ME search one launch for all of
        them, and one copy of their coded data to the host).  Returns None
        to fall back to the per-picture path under exactly the JAX
        encoder's conditions, which decide the bytes, in its order: phase
        correlation (its candidates are per picture), a tail or cut
        subgroup, a reconstruction wanted (MD5, PSNR or SSIM), mixed
        references or max_refs < 2, or no on-device pick (fixed
        quantisers, or a host pick: the constant_error and
        constant_noise_threshold engines and the allocation controller
        code each B picture on its own, at 14 kernel launches a picture on
        the card instead of 14 a batch).

        Two things of the JAX encoder's version are left out on purpose.
        It takes the three pictures' quant args before its last check,
        that they hold lam_bands; the port makes that check first
        (`_device_pick`; the quant args have no side effects for a B
        picture, so the bytes are the same).  It prefilters the B frames a
        second time (ROADMAP.md Queue 3); the port filters every picture
        once, in encode_frame.  Its compile barrier (a fetch of the
        pending pictures without their commits, for the TPU runtime)
        changes no byte and has no counterpart here."""
        if self.enable_phasecorr:
            return None     # per-picture candidates: per picture
        if len(bs_) != self.subgroup_length - 1:
            return None     # tail/cut subgroups: per picture
        if self.enable_md5 or self._want_metrics():
            return None     # a reconstruction is wanted: per picture
        nums = [b[0] for b in bs_]
        refsl = [self._pick_refs(n) for n in nums]
        ref0, ref1 = refsl[0]
        if ref1 is None or any(r != refsl[0] for r in refsl[1:]):
            return None
        if self.max_refs < 2:
            return None
        if not self._device_pick():
            return None     # fixed quantisers or a host pick: per picture
        # all the pictures' quant args before any of them commits, as the
        # JAX encoder takes them: this is what makes the bytes of the
        # batched path differ from the per-picture path's
        qsels = [self._quant_args("B") for _ in bs_]
        with record_function("b_batch_step"):
            pendings = ei_inter.start_inter_batch(
                [b[1] for b in bs_], self._params(2), self.ref_frames[ref0],
                self.ref_frames[ref1], qsels, want_recon=False,
                me_levels=self.downsample_levels,
                block_search_threshold=self.magic["block_search_threshold"],
                scan_distance=self.magic["scan_distance"],
                estimation=self.estimation,
                error_power=self.magic["error_power"], device=self.device)
        for (num, _, sc), pending in zip(bs_, pendings):
            self._pends2.append(
                (pending, (num, [ref0, ref1], None, False, "B", sc, None)))
        return self._drain_pends2()

    def _drain_pends2(self) -> bytes:
        """Finish the oldest pending pictures beyond `pipeline_depth`.  A
        picture's rate-control, arith-correction and overhead updates are
        committed here, so the lambda of picture n rests on the pictures
        up to n - pipeline_depth - 1: the lag is part of the rate
        decision and of the stream.  A host-pick engine with no stat
        tables yet (stream start) first finishes the oldest picture, so
        that it engages as early as the JAX encoder's."""
        out = bytearray()
        if (self.qengine is not None
                and self.qengine.mode != "constant_lambda"
                and not self._stats_by_kind and self._pends2):
            out += self._finish_pending2(self._pends2.popleft())
        while len(self._pends2) > self.pipeline_depth:
            out += self._finish_pending2(self._pends2.popleft())
        return bytes(out)

    def _finish_pending2(self, pend) -> bytes:
        pending, (num, refs, retired, is_ref, kind, sc, keep) = pend
        with record_function("picture_finish"):
            unit, stats = ei_inter.finish_inter_picture(
                pending, num, refs[0], is_ref=is_ref, retired=retired,
                ref2_num=refs[1] if len(refs) > 1 else None)
            with record_function("rate_control"):
                if self.qengine is not None:
                    self.qengine.update(stats)
                if stats is not None:
                    self._stats_by_kind[kind] = stats
                self._acorr_update(pending, len(unit) * 8)
                self._last_badblock = pending["badblock_ratio"]
                if kind != "B":
                    self._last_max_qi = int(np.max(
                        pending["qi_bands"][:pending["nb"]]))
                pad_unit = self._rc_update(kind, len(unit) * 8, num,
                                           self._estimate(stats, pending))
            units = []
            if self.enable_md5 and pending["recon"] is not None:
                units.append(self._md5_unit(pending["recon"]))
            units.append(unit)
            self.stats.record(
                frame=num, intra=False, b_picture=(kind == "B"),
                bits=len(unit) * 8, sc_score=round(sc, 3),
                dc_ratio=round(pending["dc_ratio"], 3),
                badblock=round(pending["badblock_ratio"], 3),
                qi_bands=pending["qi_bands"].tolist(),
                target_bits=pending["target_bits"],
                lam_scale=pending["lam_scale"],
                buffer_level=(self.rc.buffer_level if self.rc else None),
                base_lambda=getattr(self.rc, "base_lambda", None),
                **self._quality_metrics(pending["recon"], keep))
            if pad_unit:
                units.append(pad_unit)
            return self._chain.add(units)

    @staticmethod
    def _estimate(stats, pending) -> Optional[float]:
        """The bit estimate of a finished picture's picks from its own
        tables, for the allocation controller (None without tables)."""
        if stats is None:
            return None
        return estimate_bits_at(stats[0], pending["qi_bands"])

    # ---- reference pictures ---------------------------------------------

    def _md5_unit(self, recon) -> bytes:
        planes = tuple(to_host(pl) for pl in recon)
        with record_function("frame_md5"):
            md5 = _native.frame_md5(planes)
        return bs.make_aux_unit(bs.AUX_MD5_CHECKSUM, md5)

    def _finish_pending(self, pend) -> bytes:
        """Finish a pipelined backref P picture: its unit, and the engine,
        stat-table, arith-correction, badblock, ME-lambda and rate-model
        updates the JAX encoder commits here."""
        pending, (num, ref_num, retired, sc, keep) = pend
        with record_function("picture_finish"):
            unit, stats = ei_inter.finish_inter_picture(
                pending, num, ref_num, is_ref=True, retired=retired)
            with record_function("rate_control"):
                if self.qengine is not None:
                    self.qengine.update(stats)
                if stats is not None:
                    self._last_stats = stats
                self._acorr_update(pending, len(unit) * 8)
                self._last_badblock = pending["badblock_ratio"]
                self._last_max_qi = int(np.max(
                    pending["qi_bands"][:pending["nb"]]))
                pad_unit = self._rc_update("P", len(unit) * 8, num,
                                           self._estimate(stats, pending))
            units = []
            if self.enable_md5:
                units.append(self._md5_unit(pending["recon"]))
            units.append(unit)
            self.stats.record(
                frame=num, intra=False, bits=len(unit) * 8,
                sc_score=round(sc, 3),
                dc_ratio=round(pending["dc_ratio"], 3),
                badblock=round(pending["badblock_ratio"], 3),
                qi_bands=pending["qi_bands"].tolist(),
                buffer_level=(self.rc.buffer_level if self.rc else None),
                **self._quality_metrics(pending["recon"], keep))
            if pad_unit:
                units.append(pad_unit)
            return self._chain.add(units)

    def _seed_rc_from_intra(self, planes, p) -> None:
        """Calibrate the TM5 base lambda against this content before the
        first picture is coded: transform the first frame, build its
        exact stat tables, and solve for the lambda whose RD pick costs
        the I-frame allocation (lambda_for_bits: the reference's
        entropy_to_lambda bisection, schroquantiser.c:887-960, applied
        once at stream start)."""
        with record_function("rc_seed"):
            stats = self._intra_stats(planes, p)
            corr_i = np.maximum(self.acorr.intra, 1e-3)
            bits_c = np.asarray(stats[0], np.float64) * corr_i
            # only seed when the allocation is binding: if even the finest
            # pick (row 0) costs less than the target, the content is
            # cheaper than the budget and the default quality-level lambda
            # is the right regime.  Reservoir-aware first-I target: the
            # intra may borrow deeply from the buffer (high-quality refs
            # are what make the cheap B's work), so fit to ~0.3 buffer
            # rather than the pro-rata allocation
            target = max(self.rc.I_frame_alloc, 0.3 * self.rc.buffer_size)
            max_bits = float(bits_c[0].sum())
            if target >= 0.9 * max_bits:
                return
            lam = lambda_for_bits(bits_c, stats[1], target,
                                  band_scales=self._band_scales3(True))
            if np.isfinite(lam) and lam > 0:
                # base_lambda is the I-level lambda; P/B derive via the
                # magic scales; never seed finer than the default quality
                # level
                self.rc.base_lambda = float(min(lam, self.rc.base_lambda))

    def _intra_stats(self, planes, p):
        """The exact (61, 3nb) intra stat tables of a frame: forward
        transform on the device, `ratecontrol.stats_tables`."""
        band_lists = []
        for plane, (oh, ow) in zip(
                upload_picture(planes, 8, self.device),
                ((p.iwt_luma_height, p.iwt_luma_width),
                 (p.iwt_chroma_height, p.iwt_chroma_width),
                 (p.iwt_chroma_height, p.iwt_chroma_width))):
            pyr = _forward(_prep(plane, oh, ow, 8), p.transform_depth,
                           p.wavelet_filter_index)
            band_lists.append(sl.subband_arrays(pyr, p.transform_depth))
        with record_function("stat_tables"):
            return stats_tables(band_lists, p, intra=True,
                                error_power=self.magic["error_power"])

    def _encode_intra_rd(self, planes, p, num, retired, intra_lambda):
        """The unfused rate-controlled intra picture (the path of the
        pictures the fused step does not code: no-arith, the per-codeblock
        quant syntax of multiquant, the allocation controller): transform
        and exact stat tables on the device, the per-band pick on the host
        with the intra arith-correction ratios scaling the bit estimates
        (schroquantiser.c:704-725) -- the RD pick at `intra_lambda`, or
        with intra_lambda None the allocation controller's pick that fits
        the intra allocation (choose_quantisers_rdo_cbr) -- the picture
        coded at the picks, and the correction tables updated from its
        coded band bits.  Returns (unit, recon, qi_bands)."""
        nb = subband_count(p.transform_depth)
        stats = self._intra_stats(planes, p)
        corr_i = np.maximum(self.acorr.intra, 1e-3)
        if intra_lambda is not None:
            qi_bands = qi_from_lambda(np.asarray(stats[0], np.float64)
                                      * corr_i, stats[1], intra_lambda,
                                      band_scales=self._band_scales3(True))
        else:
            qi_bands = pick_bands_rdo(stats, self.rc.frame_target(True),
                                      band_scales=self._band_scales3(True),
                                      correction=corr_i)
        est = np.asarray(stats[0], np.float64)[
            np.clip(qi_bands, 0, 60), np.arange(3 * nb)]
        qis = {}
        for comp in range(3):
            for i in range(nb):
                hcb, vcb = ei_intra._codeblock_counts(p, i)
                qis[(comp, i)] = np.full(
                    (vcb, hcb), int(qi_bands[comp * nb + i]), np.int32)
        bb_out = []
        unit, recon = ei_intra.encode_picture(
            planes, p, num, quant_indices=qis, is_ref=True, retired=retired,
            return_recon=True, band_bits_out=bb_out, device=self.device)
        self.acorr.update(True, bb_out[0], est)
        return unit, recon, qi_bands

    def _encode_ref(self, planes, num, is_intra, sc_score,
                    retired="auto", manage_refs=True) -> bytes:
        if retired == "auto":
            retired = self.prev_ref
        units = []
        pad_unit = b""
        if is_intra:
            units.append(bs.write_sequence_header(self.vf, profile=8,
                                                  level=0))
            if not self._sent_stream_aux:
                # codec-comment + CBR bitrate auxiliary data with the
                # first coded frame (schroencoder.c:1480-1507, :744)
                self._sent_stream_aux = True
                units.append(bs.make_aux_unit(
                    1, b"schroedinger-tpu 2.0"))      # ENCODER_STRING
                if self.rc is not None:
                    units.append(bs.make_aux_unit(
                        bs.AUX_BITRATE,
                        int(self.rc.bitrate).to_bytes(4, "big")))
            p = self._params(0)
            intra_lambda = None
            if (self.qengine is not None
                    and self.qengine.mode == "constant_lambda"):
                intra_lambda = self.qengine.lam * self.magic["I_lambda_scale"]
            elif self._tm5:
                if self.rc.intra_cbr_lambda is None:
                    # first intra: seed the TM5 base lambda by fitting
                    # this frame's exact stat tables to its allocation
                    self._seed_rc_from_intra(planes, p)
                with record_function("rate_control"):
                    intra_lambda = self.rc.frame_lambda("I")
            # the host-pick engines code the intra pictures at the base
            # index; the allocation controller picks them on the host
            if intra_lambda is not None or self.rc is not None:
                bb_act = None
                with record_function("i_picture"):
                    if (intra_lambda is None or self.enable_noarith
                            or p.codeblock_mode_index != 0):
                        # the fused step codes arith pictures of codeblock
                        # mode 0 at a lambda only
                        unit, recon, qi_bands = self._encode_intra_rd(
                            planes, p, num, retired, intra_lambda)
                    else:
                        # fused intra path: transform, stats, RD pick and
                        # quantisation on the device, host entropy coding
                        # and serial DC-predict band 0, device
                        # reconstruction
                        (unit, recon, qi_bands, _stats, bb_act,
                         bb_est) = ei_intra.encode_picture_fused(
                            planes, p, num,
                            intra_lambda * self._band_scales3(True),
                            is_ref=True, retired=retired,
                            corr=self.acorr.intra,
                            error_power=self.magic["error_power"],
                            device=self.device)
                with record_function("rate_control"):
                    if bb_act is not None:
                        self.acorr.update(True, bb_act, bb_est)
                        oh = max(len(unit) * 8 - float(np.sum(bb_act)), 0.0)
                        self._oh_intra = (
                            oh if self._oh_intra is None
                            else 0.8 * self._oh_intra + 0.2 * oh)
                    pad_unit = self._rc_update("I", len(unit) * 8, num)
            else:
                nb = subband_count(p.transform_depth)
                qm = np.asarray(p.quant_matrix[:nb], np.int32)
                qi_bands = np.tile(np.clip(self.base_qi_intra - qm, 0, 60),
                                   3)
                qis = {}
                for comp in range(3):
                    for i in range(nb):
                        hcb, vcb = ei_intra._codeblock_counts(p, i)
                        qis[(comp, i)] = np.full(
                            (vcb, hcb), int(qi_bands[comp * nb + i]),
                            np.int32)
                with record_function("i_picture"):
                    unit, recon = ei_intra.encode_picture(
                        planes, p, num, quant_indices=qis, is_ref=True,
                        retired=retired, return_recon=True,
                        device=self.device)
        else:
            qargs = self._quant_args("P")
            with record_function("p_picture_step"):
                ipend = ei_inter.start_inter_picture(
                    planes, self._params(1), self.ref_frames[self.last_ref],
                    base_qi=self.base_qi_inter, **self._step_kw(), **qargs)
            with record_function("picture_finish"):
                unit, stats = ei_inter.finish_inter_picture(
                    ipend, num, self.last_ref, is_ref=True, retired=retired)
            recon = ipend["recon"]
            if ipend["dc_ratio"] > self.magic["me_bailout_limit"]:
                # intra bailout (schroencoder.c:2373-2384): motion
                # compensation failed for most blocks -> code this
                # picture as intra instead (same number/retire)
                return self._encode_ref(planes, num, True, sc_score,
                                        retired=retired,
                                        manage_refs=manage_refs)
            # each picture finishes before the next starts: the engines
            # pick from the previous picture's tables, and the rate model
            # takes no bit estimate (the JAX encoder's _encode_ref; the
            # badblock ratio and the ME lambda stay where encode_stream
            # left them)
            with record_function("rate_control"):
                if self.qengine is not None:
                    self.qengine.update(stats)
                if stats is not None:
                    self._last_stats = stats
                self._acorr_update(ipend, len(unit) * 8)
                pad_unit = self._rc_update("P", len(unit) * 8, num)
        if self.enable_md5:
            units.append(self._md5_unit(recon))
        units.append(unit)
        if pad_unit:
            units.append(pad_unit)

        if manage_refs:
            if self.prev_ref is not None:
                self.ref_frames.pop(self.prev_ref, None)
            self.prev_ref = self.last_ref
            self.last_ref = num
        self.ref_frames[num] = RefFrame(tuple(recon))
        if num == self.frame_number:
            self.frame_number += 1
        self.stats.record(frame=num, intra=bool(is_intra),
                          bits=len(unit) * 8, sc_score=round(sc_score, 3),
                          qi_bands=(np.asarray(qi_bands).tolist()
                                    if is_intra else None),
                          buffer_level=(self.rc.buffer_level if self.rc
                                        else None),
                          base_lambda=getattr(self.rc, "base_lambda", None),
                          **self._quality_metrics(recon, planes))
        return self._chain.add(units)
