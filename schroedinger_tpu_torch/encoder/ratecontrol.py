"""Rate control: stat tables on the device, quantiser picks, CBR models.

Port of `schroedinger_tpu/encoder/ratecontrol.py`.  The 61-way
per-(component, band) (bits, error) tables and the RD pick with its lambda
fit are torch and run on the device of their input; `CbrControllerTM5`,
`CbrController` (the allocation controller of `rdo_cbr=False`),
`ArithCorrection`, the host picks and `QuantiserEngine` are numpy code
copied line for line, so that the same bit counts give the same float64
lambdas, targets and picks in both packages.

Which table entries are exact: the magnitude bits and the nonzero counts
are integers, summed here in int64, so they equal the JAX package's
float32 sums wherever those are exact (below 2^24 per band).  The error
table is a sum of float32 terms taken in float64 and rounded once, so it
is the same on the CPU and on the card up to that rounding, and agrees
with the JAX package's float32 running sums to about 1e-6 relative; the
flag-entropy term of the bits goes through float32 log2 and agrees to
the same order.
"""
from __future__ import annotations

import numpy as np
import torch

from schroedinger_tpu_torch import tables
from schroedinger_tpu_torch.params import Params, subband_count

# base indices per pass of the table loop: a pass holds a few int32 and
# float32 temporaries of (chunk, n) elements, so the chunk shrinks as the
# picture grows (1080p 4:2:0 has n = 3.1 M coefficients)
_TABLE_ELEMS = 1 << 26


def _sint_bits(v):
    """exp-Golomb sint size 2n - 1 + (m != 0), n = bit_length(|v| + 1),
    int32.  Exact for |v| + 1 < 2^24 (frexp of a float32)."""
    m = v.to(torch.int32).abs()
    n = torch.frexp((m + 1).to(torch.float32))[1]
    return 2 * n - 1 + (m != 0).to(torch.int32)


def error_metric(ad, error_power: float):
    """|orig - dequant| ** error_power (error_pow, schroquantiser.c:477-507;
    default power 4) as a square-and-multiply chain for integral powers,
    in the order the JAX package multiplies, so the float32 terms are the
    same bits."""
    ip = int(round(error_power))
    if abs(error_power - ip) < 1e-9 and 1 <= ip <= 16:
        out = None
        sq = ad
        n = ip
        while n:
            if n & 1:
                out = sq if out is None else out * sq
            n >>= 1
            if n:
                sq = sq * sq
        return out
    return ad ** error_power


def _quant_tables(device, intra: bool):
    qf = torch.as_tensor(tables.QUANT_FACTOR, dtype=torch.int32,
                         device=device)
    qo = torch.as_tensor(tables.QUANT_OFFSET_1_2 if intra
                         else tables.QUANT_OFFSET_3_8, dtype=torch.int32,
                         device=device)
    return qf, qo


def _quant_dequant(v, qf, qo):
    """Dead-zone quantise and dequantise (ops/quant.py semantics) in plain
    int32: exact while |v| < 2^27, which transform coefficients of 8-bit
    video and their first differences are by a wide margin."""
    x = v.abs() << 2
    mag = torch.where(x < qo, torch.zeros_like(x),
                      torch.div(x - (qo - (qf >> 1)), qf,
                                rounding_mode="floor"))
    dmag = torch.where(mag == 0, mag, (mag * qf + qo + 2) >> 2)
    neg = v < 0
    return torch.where(neg, -mag, mag), torch.where(neg, -dmag, dmag)


def bits_per_base(flat_coeffs, qmo, intra: bool):
    """Total sint-bit estimate of quantised coefficients for base 0..60.

    flat_coeffs: (N,) int tensor; qmo: (N,) per-coefficient quant-matrix
    offset.  Returns (61,) int64 (an exact integer sum)."""
    v = flat_coeffs.to(torch.int32)
    QF, QO = _quant_tables(v.device, intra)
    out = []
    for base in range(61):
        qi = (base - qmo).clamp(0, 60).long()
        qq, _ = _quant_dequant(v, QF[qi], QO[qi])
        out.append(_sint_bits(qq.abs()).sum(dtype=torch.int64))
    return torch.stack(out)


def band_counts(allflat, bounds, ncol: int, intra: bool,
                error_power: float = 4.0):
    """The three (61, ncol) sums behind the stat tables, per quant index
    (row) and column: magnitude bits of the nonzero coefficients (int64,
    exact), nonzero count (int64, exact) and error (float64 sum of the
    float32 terms |orig - dequant| ** error_power).

    allflat: flat int32 coefficient vector, or (N, n) for N pictures,
    which gives (N, 61, ncol) sums, each row summed as its picture alone
    would be; bounds: [(column, lo, hi)] static slices of it.  The pass
    over the quant indices holds about _TABLE_ELEMS elements per picture
    and temporary."""
    if allflat.ndim == 1:
        return tuple(t[0] for t in band_counts(allflat[None], bounds, ncol,
                                                 intra, error_power))
    dev = allflat.device
    N, n = allflat.shape
    QF, QO = _quant_tables(dev, intra)
    v = allflat.to(torch.int32)[:, None, :]
    chunk = max(1, min(61, _TABLE_ELEMS // max(n, 1)))
    mag = torch.zeros((N, 61, ncol), dtype=torch.int64, device=dev)
    nz = torch.zeros((N, 61, ncol), dtype=torch.int64, device=dev)
    err = torch.zeros((N, 61, ncol), dtype=torch.float64, device=dev)
    for b0 in range(0, 61, chunk):
        b1 = min(61, b0 + chunk)
        qq, dq = _quant_dequant(v, QF[b0:b1, None], QO[b0:b1, None])
        nzm = qq != 0
        b = torch.where(nzm, _sint_bits(qq) - 1, torch.zeros_like(qq))
        e = error_metric((v - dq).abs().to(torch.float32), error_power)
        for col, lo, hi in bounds:
            mag[:, b0:b1, col] += b[..., lo:hi].sum(-1, dtype=torch.int64)
            nz[:, b0:b1, col] += nzm[..., lo:hi].sum(-1, dtype=torch.int64)
            err[:, b0:b1, col] += e[..., lo:hi].sum(-1, dtype=torch.float64)
    return mag, nz, err


def band_tables(allflat, bounds, ncol: int, intra: bool,
                error_power: float = 4.0):
    """(bits, err) float32 (61, ncol) tables of one flat int32 coefficient
    vector: row q holds, per column, the estimated coded bits and the
    error of coding that column's coefficients at quant index q; (N, 61,
    ncol) for an (N, n) batch.

    The bit model is arith-aware (the analog of the reference's histogram
    arith-entropy estimate, schrohistogram.c:267-345): a nonzero
    coefficient costs its sint length minus the leading flag bit, and the
    zero/nonzero flags of the whole column cost their first-order binary
    entropy."""
    mag, nz, err = band_counts(allflat, bounds, ncol, intra, error_power)
    nvec = np.zeros(ncol, np.float32)
    for col, lo, hi in bounds:
        nvec[col] += hi - lo
    nvec = torch.as_tensor(nvec, device=allflat.device)
    nzf = nz.to(torch.float32)
    p1 = (nzf / nvec).clamp(1e-6, 1.0 - 1e-6)
    flag = -(nzf * torch.log2(p1) + (nvec - nzf) * torch.log2(1.0 - p1))
    return mag.to(torch.float32) + flag, err.to(torch.float32)


def stats_tables(band_lists, p: Params, intra: bool,
                 error_power: float = 4.0):
    """Exact (61, 3*nb) per-(component, band) (bits, error) tables for a
    transformed frame (schro_encoder_calc_estimates analog, which is also
    per component).  band_lists: per component, the subband tensors.
    Columns are component-major (ci*nb + band).  For intra, band 0 is
    estimated on horizontal first differences (the DC-predict histogram
    analog, schrohistogram.c:360).  Returns two numpy float32 arrays."""
    nb = subband_count(p.transform_depth)
    flats = []
    bounds = []
    off = 0
    for ci, bands in enumerate(band_lists):
        for i, b in enumerate(bands):
            arr = b.to(torch.int32)
            if i == 0 and intra:
                arr = torch.cat([arr[:, :1], arr[:, 1:] - arr[:, :-1]], 1)
            arr = arr.reshape(-1)
            flats.append(arr)
            bounds.append((ci * nb + i, off, off + arr.numel()))
            off += arr.numel()
    bits61, err61 = band_tables(torch.cat(flats), bounds,
                                len(band_lists) * nb, intra, error_power)
    return bits61.cpu().numpy(), err61.cpu().numpy()


def rd_pick(rc_bits, rc_err, lam_bands, corr_bands, target_bits=0.0,
            s_hi: float = 1.0):
    """Per-column RD argmin of the tables on their device, index 60
    excluded like the reference (schro_subband_pick_quant,
    schroquantiser.c:808-835), with the arith-correction ratios scaling
    the bit estimates (schroquantiser.c:706-725).

    rc_bits, rc_err: (61, ncol) float32; lam_bands, corr_bands: (ncol,)
    float32 tensors.  target_bits > 0 engages the lambda fit: a 22-step
    geometric bisection of a scale s in [1/16384, s_hi] on the lambdas so
    that the corrected bit estimate of the picks meets target_bits (the
    reference's entropy_to_lambda, schroquantiser.c:887-960); s_hi = 1
    scales down only.  Everything stays on the device: no value is read
    back.  Ties go to the lowest quant index, the row order of the cost
    array.  Returns (qi (ncol,) int32 at the fitted scale, the fitted
    scale as a float32 scalar tensor; 1 without a fit).

    A batch takes (N, 61, ncol) tables, (N, ncol) lambdas and corrections
    and N targets (a sequence of floats), and returns (N, ncol) picks and
    (N,) scales: each picture is picked as it would be alone, the fit
    running for those whose target is above 0."""
    f32 = torch.float32
    dev = rc_bits.device
    batched = rc_bits.ndim == 3
    if not batched:
        rc_bits, rc_err = rc_bits[None], rc_err[None]
        lam_bands, corr_bands = lam_bands[None], corr_bands[None]
        target_bits = [target_bits]
    targets = np.asarray([t or 0.0 for t in target_bits], np.float32)
    N = rc_bits.shape[0]
    bits_c = corr_bands[:, None, :] * rc_bits[:, :60]
    err = rc_err[:, :60]

    def pick_at(s):
        cost = bits_c + (s[:, None] * lam_bands)[:, None, :] * err
        qi = torch.argmin(cost, dim=1)
        return qi, torch.gather(bits_c, 1, qi[:, None, :])[:, 0].sum(
            -1, dtype=torch.float64).to(f32)

    s_fit = torch.ones(N, dtype=f32, device=dev)
    fit = targets > 0
    if fit.any():
        target = torch.as_tensor(targets, device=dev)
        lo = torch.full((N,), 1.0 / 16384.0, dtype=f32, device=dev)
        hi = torch.full((N,), s_hi, dtype=f32, device=dev)
        for _ in range(22):
            mid = torch.sqrt(lo * hi)
            _, b = pick_at(mid)
            # more lambda -> finer -> more bits
            under = b < target
            lo, hi = torch.where(under, mid, lo), torch.where(under, hi, mid)
        s_fit = torch.where(torch.as_tensor(fit, device=dev),
                            torch.sqrt(lo * hi), s_fit)
    qi, _ = pick_at(s_fit)
    qi = qi.to(torch.int32)
    if not batched:
        return qi[0], s_fit[0]
    return qi, s_fit


def pick_base_qi(band_lists, p: Params, target_bits: int,
                 intra: bool, correction: float = 1.0) -> int:
    """Choose the base quant index whose estimated frame bits fit the
    target.  band_lists: per-component list of subband tensors.
    correction: measured arith-vs-estimate ratio."""
    nb = subband_count(p.transform_depth)
    qm = np.asarray(p.quant_matrix[:nb], np.int32)
    flats = []
    qmos = []
    for bands in band_lists:
        for i, b in enumerate(bands):
            arr = b.reshape(-1)
            flats.append(arr)
            qmos.append(torch.full(arr.shape, int(qm[i]), dtype=torch.int32,
                                   device=arr.device))
    bits = bits_per_base(torch.cat(flats), torch.cat(qmos),
                         intra).cpu().numpy()
    bits = bits * correction
    # smallest base whose estimate fits; favor quality when everything fits
    fits = np.nonzero(bits <= target_bits)[0]
    if len(fits) == 0:
        return 60
    return int(fits[0])


def estimate_bits_at(bits61, qi_bands) -> float:
    """Frame-bit estimate of coding each band at qi_bands from the
    actual-qi-indexed stat table."""
    bits61 = np.asarray(bits61, np.float64)
    nb = bits61.shape[1]
    return float(bits61[np.asarray(qi_bands), np.arange(nb)].sum())


class ArithCorrection:
    """Per-(component, band) x {intra, inter} arith-vs-estimate bit-ratio
    tables (schroencoder.c:2548-2590 average_arith_context_ratios_{intra,
    inter}[component][band], init 1.0 at :572-573, EMA 0.9/0.1 guarded by
    est > 200).

    Our stat tables are exact sint-length sums, so the ratio measures how
    far the adaptive arithmetic coder compresses below the raw VLC length
    per band — near 1 for dense low bands, far below 1 for sparse high
    bands whose codeblocks collapse to zero flags.  Scaling the per-band
    bit estimates by these ratios before the RD pick re-balances spend
    toward the bands where bits are genuinely cheap (the reference applies
    its ratios at schroquantiser.c:706-725 before entropy_to_lambda).

    Unlike the reference we EMA against the RAW estimate, not the
    already-corrected one (the reference's update reads est_entropy that
    was pre-multiplied by the old ratio, so its fixed point is
    sqrt(actual/raw) — half-strength correction; ours converges to the
    true actual/raw ratio)."""

    def __init__(self, ncol: int):
        self.intra = np.ones(ncol, np.float64)
        self.inter = np.ones(ncol, np.float64)

    def get(self, intra: bool) -> np.ndarray:
        return self.intra if intra else self.inter

    def update(self, intra: bool, actual_bits, est_bits) -> None:
        """actual_bits/est_bits: (ncol,) per-(component, band) coded vs
        estimated bits at the picked quant indices.  Ratios are clamped
        to [0.5, 2]: the flag-entropy bit model keeps true ratios near 1,
        and an unclamped transient (a band that was all-zero last frame)
        would swing the RD pick's relative band costs wildly."""
        tab = self.get(intra)
        a = np.asarray(actual_bits, np.float64)
        e = np.asarray(est_bits, np.float64)
        ok = e > 200.0
        tab[ok] = np.clip(0.9 * tab[ok] + 0.1 * (a[ok] / e[ok]), 0.5, 2.0)


class CbrController:
    """Reference-grade CBR bit reservoir (schroencoder.c:183-545), the
    controller of enable_rdo_cbr=FALSE.

    Allocation follows schro_encoder_calculate_allocation / get_alloc
    (schroengine.c:552-637): per-picture requested bits = bits_per_picture
    * picture_weight * allocation_scale, passed through the buffer-aware
    exponential curve so the allocation never exceeds what the reservoir
    holds and must-spend bits (level about to overflow) are always spent.
    Level update mirrors schroencoder.c:2592-2615 (underrun clamps to 0;
    overrun pads the stream back to buffer_size).  Picture weights default
    to the reference's magic_keyframe_weight 7.5 / magic_inter_p_weight
    1.5 / magic_inter_b_weight 0.2 with magic_allocation_scale 1.1
    (schroencoder.c:4520-4525); buffer_size/buffer_level follow
    schro_encoder_init_rc_buffer (buffer_size 0 -> 3 s of bitrate, level
    0 -> start full).  The arith-vs-estimate correction is the
    reference's online EMA 0.9/0.1 (schroencoder.c:2548-2590)."""

    def __init__(self, bitrate: int, fps: float, gop_length: int,
                 buffer_size: int = 0, buffer_level: int = 0,
                 interlaced: bool = False,
                 keyframe_weight: float = 7.5,
                 inter_p_weight: float = 1.5,
                 inter_b_weight: float = 0.2,
                 allocation_scale: float = 1.1):
        self.bitrate = bitrate
        self.gop_length = gop_length
        self.buffer_size = buffer_size if buffer_size else 3 * bitrate
        self.buffer_level = buffer_level if buffer_level \
            else self.buffer_size
        self.bits_per_picture = bitrate / fps / (2 if interlaced else 1)
        self.weights = {"I": keyframe_weight, "P": inter_p_weight,
                        "B": inter_b_weight}
        self.allocation_scale = allocation_scale
        self.correction = 1.0

    def frame_target(self, is_intra: bool = False, kind: str | None = None,
                     extra_weight: float = 0.0) -> int:
        """Allocated bits for the next picture (get_alloc analog).

        kind: "I"/"P"/"B" (overrides is_intra); extra_weight: additive
        weight term (the reference's badblock_ratio * magic multipliers)."""
        if kind is None:
            kind = "I" if is_intra else "P"
        w = self.weights[kind] + extra_weight
        requested = self.bits_per_picture * w * self.allocation_scale
        must_use = max(
            0.0, self.buffer_level + self.bits_per_picture - self.buffer_size)
        denom = max(1.0, self.buffer_size - self.bits_per_picture)
        x = max(0.0, requested - must_use) / denom
        y = 1.0 - np.exp(-x)
        alloc = must_use + (self.buffer_level - must_use) * y
        return max(1000, int(alloc))

    def update(self, actual_bits: int,
               estimated_bits: float | None = None) -> int:
        """Returns the PADDING bytes the stream must insert to hold the
        reservoir at capacity (buffer overrun, schroencoder.c:2601-2611;
        0 when the level fits)."""
        self.buffer_level += self.bits_per_picture - actual_bits
        if self.buffer_level < 0:
            self.buffer_level = 0.0      # underrun (schroencoder.c:2599)
        pad = 0
        if self.buffer_level > self.buffer_size:
            pad = int(self.buffer_level - self.buffer_size + 7) // 8
            self.buffer_level -= pad * 8
        if estimated_bits and estimated_bits > 200:
            ratio = actual_bits / estimated_bits
            self.correction = 0.9 * self.correction + 0.1 * ratio
        return pad


class CbrControllerTM5:
    """The reference's actual CBR rate control (enable_rdo_cbr=TRUE,
    schroencoder.c:277-545): TM5-style per-kind complexity tracking, a
    smoothed quality factor `qf` re-derived per subgroup from the
    bits ~ 4*10^((qf-12)*2/5) model, and frame lambdas from qf
    (schro_encoder_set_frame_lambda, schroencoder.c:53-133:
    lambda = exp(0.921034*qf - 13.825), B x magic_B_lambda_scale 0.01,
    P x magic_P_lambda_scale 0.25, intra geometric-filtered against the
    previous intra lambda).  The quantiser then takes this lambda
    directly (choose_quantisers_rdo_cbr); unlike a fit-the-allocation
    pick, easy content undershoots the bitrate at stable quality."""

    def __init__(self, bitrate: int, fps: float, gop_length: int,
                 subgroup_length: int = 4,
                 buffer_size: int = 0, buffer_level: int = 0,
                 interlaced: bool = False,
                 b_lambda_scale: float = 0.01,
                 p_lambda_scale: float = 0.25,
                 i_lambda_scale: float = 1.0):
        self.bitrate = bitrate
        self.gop_length = max(gop_length, 1)
        self.sg_len = max(int(subgroup_length), 1)
        self.buffer_size = buffer_size if buffer_size else 3 * bitrate
        # "Set initial level at 100%" (schroencoder.c:193-196)
        self.buffer_level = float(buffer_level if buffer_level
                                  else self.buffer_size)
        self.bits_per_picture = bitrate / fps / (2 if interlaced else 1)
        self.gop_target = self.bits_per_picture * self.gop_length
        self._total_gop_bits = self.gop_target
        self.qf = 7.0                     # schroencoder.c:560
        self.scales = {"I": i_lambda_scale, "P": p_lambda_scale,
                       "B": b_lambda_scale}
        self.intra_cbr_lambda = None      # schroencoder.c:670 (-1)
        # multiplicative base-lambda controller: the reference trusts the
        # absolute qf->lambda calibration against ITS histogram estimate
        # scale and lets the heavily-damped qf filter track slow drift
        # (schroencoder.c:418-475); our exact power-p tables sit on a
        # different absolute scale, so the base lambda itself adapts from
        # measured subgroup spend (ratio^2, clamped 4x per update) while
        # the SHARED-lambda principle — one quality level, per-kind
        # scales, spend follows content complexity — stays exactly TM5's
        self.base_lambda = float(np.exp(0.921034 * self.qf - 13.825))
        self._sg_bits = 0.0
        self._sg_frames = 0
        # initial allocations (init_rc_buffer, schroencoder.c:211-237;
        # the reference's `2 ^ 24` is XOR = 26, kept as intended 1<<24
        # since only the I:P:B ratio 9:3:1 matters before normalisation)
        num_p = max(self.gop_length // self.sg_len - 1, 0)
        num_b = max(self.gop_length - num_p - 1, 0)
        i_a, p_a, b_a = 9.0, 3.0, 1.0
        total = i_a + num_p * p_a + num_b * b_a
        self.I_frame_alloc = i_a * self.gop_target / total
        self.P_frame_alloc = p_a * self.gop_target / total
        self.B_frame_alloc = b_a * self.gop_target / total
        self.I_complexity = self.I_frame_alloc
        self.P_complexity = self.P_frame_alloc
        self.B_complexity = self.B_frame_alloc
        self.B_complexity_sum = 0.0
        self.subgroup_position = 1
        self.correction = 1.0             # estimate EMA (unused by TM5)

    def frame_lambda(self, kind: str) -> float:
        lam = self.base_lambda
        if kind == "I":
            if self.intra_cbr_lambda is not None:
                lam = float(np.sqrt(lam * self.intra_cbr_lambda))
            self.intra_cbr_lambda = lam
            return lam
        return lam * self.scales[kind]

    def _allocate(self, fnum: int) -> None:
        """schro_encoder_cbr_allocate (schroencoder.c:279-349)."""
        num_i = 1
        num_p = max(self.gop_length // self.sg_len - 1, 0)
        num_b = self.gop_length - num_i - num_p
        occ = self.buffer_level / self.buffer_size
        # (the reference's `(fnum+1) % 4 * sg_len` binds as ((fnum+1)%4)
        # * sg_len -- kept as written)
        if occ < 0.9 and (fnum + 1) % 4 == 0:
            corr = min(0.25, 0.25 * (0.9 - occ) / 0.9)
            self.gop_target = self._total_gop_bits * (1.0 - corr)
        elif occ > 0.9 and (fnum + 1) % self.sg_len == 0:
            corr = min(0.5, 0.5 * (occ - 0.9) / 0.9)
            self.gop_target = self._total_gop_bits * (1.0 + corr)
        min_bits = self._total_gop_bits / (100 * self.gop_length)
        icty, pcty, bcty = (max(self.I_complexity, 1.0),
                            max(self.P_complexity, 1.0),
                            max(self.B_complexity, 1.0))
        self.I_frame_alloc = max(min_bits, self.gop_target /
                                 (num_i + num_p * pcty / icty
                                  + num_b * bcty / icty))
        self.P_frame_alloc = max(min_bits, self.gop_target /
                                 (num_p + num_i * icty / pcty
                                  + num_b * bcty / pcty)
                                 if num_p else min_bits)
        self.B_frame_alloc = max(min_bits, self.gop_target /
                                 (num_b + num_i * icty / bcty
                                  + num_p * pcty / bcty)
                                 if num_b else min_bits)

    def update(self, kind: str, num_bits: float, frame_number: int,
               field_factor: int = 1) -> int:
        """Buffer level + qf update after a picture is coded, in coded
        order (schro_encoder_cbr_update, schroencoder.c:356-497).
        Returns the stream PADDING bytes due on reservoir overrun
        (schroencoder.c:2601-2611)."""
        self.buffer_level += self.bits_per_picture - num_bits
        self.buffer_level = max(self.buffer_level, 0.0)
        pad = 0
        if self.buffer_level > self.buffer_size:
            pad = int(self.buffer_level - self.buffer_size + 7) // 8
            self.buffer_level -= pad * 8

        occ = self.buffer_level / self.buffer_size
        fnum = frame_number // field_factor
        if fnum <= 3 * self.sg_len:
            filter_tap = 1.0
        else:
            filter_tap = ((occ - 0.9) / 0.1 if occ > 0.9
                          else (0.9 - occ) / 0.9)
            filter_tap = min(max(filter_tap, 0.25), 1.0)

        emergency = False
        if kind == "I":
            self.I_complexity = num_bits
            target = self.I_frame_alloc
            if fnum == 0:
                self.subgroup_position = self.sg_len + 1
        elif kind == "B":
            self.B_complexity_sum += num_bits
            target = self.B_frame_alloc
        else:
            self.P_complexity = num_bits
            target = self.P_frame_alloc
        if num_bits < target / 2 or num_bits > 3 * target:
            emergency = True

        self._sg_bits += num_bits
        self._sg_frames += 1
        self.subgroup_position -= 1
        if self.subgroup_position == 0 or emergency:
            # lambda controller: subgroup spend vs its pro-rata share of
            # the (occupancy-adjusted) GOP target.  Measured locally
            # bits ~ lambda^1 in the power-4 regime, so the correction is
            # ratio^1, clamped to 2x per step (the pipeline applies new
            # lambdas with ~1 subgroup of lag; a hotter gain hunts)
            sg_target = (self.gop_target / self.gop_length
                         * max(self._sg_frames, 1))
            if self._sg_bits > 0 and sg_target > 0:
                r = sg_target / self._sg_bits
                # the reference's first-3-subgroups filter_tap=1.0
                # analog (schroencoder.c:409-416): full-strength
                # correction while the stream-start transient settles,
                # then the damped band to avoid hunting with the
                # pipeline's one-subgroup feedback lag
                n = getattr(self, "_n_lam_updates", 0)
                lim = (0.1, 4.0) if n < 3 else (0.6, 1.7)
                self._n_lam_updates = n + 1
                self.base_lambda *= float(np.clip(np.sqrt(r), *lim))
                self.base_lambda = float(np.clip(self.base_lambda,
                                                 1e-9, 1e4))
            self._sg_bits = 0.0
            self._sg_frames = 0
            if (self.sg_len > 1
                    and self.subgroup_position < self.sg_len - 1):
                done = self.sg_len - 1 - self.subgroup_position
                if done > 0 and self.B_complexity_sum > 0:
                    self.B_complexity = self.B_complexity_sum / done
            self._allocate(fnum)
            tbits = (self.P_frame_alloc
                     + (self.sg_len - 1) * self.B_frame_alloc)
            pbits = (self.P_complexity
                     + (self.sg_len - 1) * self.B_complexity)
            K = (pbits ** 2) * 10.0 ** (0.4 * (12 - self.qf)) / 16.0
            new_qf = 12 - 2.5 * np.log10(16 * K / max(tbits, 1.0) ** 2)
            if ((abs(self.qf - new_qf) >= 0.25 or new_qf <= 4.0)
                    and new_qf <= 8.0):
                new_qf = filter_tap * new_qf + (1 - filter_tap) * self.qf
            if new_qf <= 8.0:
                if pbits < 2 * tbits:
                    new_qf = max(new_qf, self.qf - 1.0)
                else:
                    new_qf = max(new_qf, self.qf - 2.0)
            new_qf = min(new_qf, 5 + 10 * occ)
            self.qf = float(new_qf)
            if self.subgroup_position <= 0:
                self.subgroup_position = self.sg_len
                self.B_complexity_sum = 0.0
        return pad


# ---- per-subband quantiser engines (schroquantiser.c:280-316 dispatch) ----

def qi_from_lambda(bits61, err61, lam: float,
                   band_scales=None) -> np.ndarray:
    """Per-subband quant indices minimising R + lambda*D (the reference's
    lambda weights distortion: larger lambda -> finer quantisation,
    schroquantiser.c entropy/error tradeoff).

    bits61/err61: (61, nb) per-base coded-bit / squared-error estimates
    (exact-stat analog of the reference's histogram estimate tables,
    schro_encoder_calc_estimates).  band_scales: (nb,) per-band lambda
    multipliers (perceptual weighting, weights.band_lambda_scales;
    schroquantiser.c:856-880).  Returns (nb,) int32.  Like the reference
    (schro_subband_pick_quant j<60), index 60 is never picked.
    """
    lamv = lam * (np.asarray(band_scales, np.float64)
                  if band_scales is not None else 1.0)
    cost = (np.asarray(bits61, np.float64)
            + lamv * np.asarray(err61, np.float64))
    return np.argmin(cost[:60], axis=0).astype(np.int32)


def lambda_for_bits(bits61, err61, target_bits: float,
                    band_scales=None, correction=1.0) -> float:
    """Frame lambda whose RDO pick costs ~target_bits
    (schro_encoder_entropy_to_lambda, schroquantiser.c:887-960: geometric
    bracketing by x100 then 7-step geometric bisection).  correction:
    scalar or per-band (ncol,) arith-vs-estimate ratios scaling the bit
    estimates (average_arith_context_ratios analog)."""
    bits61 = np.asarray(bits61, np.float64) * correction
    err61 = np.asarray(err61, np.float64)
    nb = bits61.shape[1]
    idx = np.arange(nb)

    def bits_at(lam):
        qi = qi_from_lambda(bits61, err61, lam, band_scales)
        return float(bits61[qi, idx].sum())

    lam_hi = 1.0
    bits_hi = bits_at(lam_hi)
    if bits_hi < target_bits:
        lam_lo, bits_lo = lam_hi, bits_hi
        for _ in range(5):
            lam_hi = lam_lo * 100.0
            bits_hi = bits_at(lam_hi)
            if bits_hi > target_bits:
                break
            lam_lo, bits_lo = lam_hi, bits_hi
    else:
        for _ in range(5):
            lam_lo = lam_hi * 0.01
            bits_lo = bits_at(lam_lo)
            if bits_lo < target_bits:
                break
            lam_hi, bits_hi = lam_lo, bits_lo
    if bits_lo == bits_hi:
        return float(np.sqrt(lam_lo * lam_hi))
    for _ in range(7):
        if bits_hi == bits_lo:
            break
        lam_mid = float(np.sqrt(lam_lo * lam_hi))
        bits_mid = bits_at(lam_mid)
        if bits_mid < target_bits:
            lam_lo, bits_lo = lam_mid, bits_mid
        else:
            lam_hi, bits_hi = lam_mid, bits_mid
    return float(np.sqrt(lam_lo * lam_hi))


def pick_bands_rdo(stats, target_bits: float, band_scales=None,
                   correction=1.0) -> np.ndarray:
    """CBR per-band pick: lambda from the bit allocation, then the RD
    argmin (choose_quantisers_rdo_cbr, schroquantiser.c:772-780). Unlike
    fit-smallest-base this degrades gracefully: a tiny allocation gives a
    coarse-but-balanced spend, a huge one stops at the RD knee instead of
    near-lossless bloat."""
    bits61, err61 = stats
    lam = lambda_for_bits(bits61, err61, target_bits, band_scales,
                          correction)
    return qi_from_lambda(np.asarray(bits61, np.float64) * correction,
                          err61, lam, band_scales)


def lambda_for_error(bits61, err61, target_error: float,
                     iters: int = 24, band_scales=None) -> float:
    """Bisect lambda so total squared error at the RDO choice hits the
    target (schro_encoder_error_to_lambda, schroquantiser.c:1040-1106)."""
    lo, hi = 1e-10, 1e6   # err_at is non-increasing in lambda

    def err_at(lam):
        qi = qi_from_lambda(bits61, err61, lam, band_scales)
        return float(np.asarray(err61, np.float64)[qi, np.arange(len(qi))]
                     .sum())

    if err_at(lo) <= target_error:
        return lo             # cheapest choice already clean enough
    if err_at(hi) >= target_error:
        return hi             # can't reach the target; use finest tradeoff
    for _ in range(iters):
        mid = np.sqrt(lo * hi)
        if err_at(mid) > target_error:
            lo = mid
        else:
            hi = mid
    return float(np.sqrt(lo * hi))


class QuantiserEngine:
    """Per-frame per-subband quant-index chooser from exact stat tables.

    Modes (schroencoder.c:726-760 rate-control dispatch):
      constant_lambda: fixed lambda RDO (ENGINE_RDO_LAMBDA)
      constant_error / constant_noise_threshold: lambda bisected each frame
        so the frame error matches the noise target
        (ENGINE_CONSTANT_ERROR, schroquantiser.c:1099-1129)

    Stats arrive with one frame of lag (the fused P-step emits them with
    the frame it encodes); pick() returns None until the first P frame's
    stats exist, letting the caller fall back to base_qi - quant_matrix.
    """

    def __init__(self, mode: str, lam: float = 1.0,
                 noise_threshold: float = 25.0, width: int = 0,
                 height: int = 0, band_scales=None):
        self.mode = mode
        self.lam = lam
        # reference-exact target (choose_quantisers_constant_error,
        # schroquantiser.c:1101-1113): 255 * 10^(-nt/20) * W * H, used
        # against the power-p error tables exactly as the reference does
        self.target_error = (255.0 * (0.1 ** (noise_threshold * 0.05))
                             * max(width * height, 1))
        self._stats = None
        self.band_scales = band_scales  # set by the GOP driver if None

    def update(self, stats) -> None:
        if stats is not None:
            self._stats = stats

    def pick(self):
        if self._stats is None:
            return None
        bits61, err61 = self._stats
        if self.mode == "constant_lambda":
            lam = self.lam
        else:
            lam = lambda_for_error(bits61, err61, self.target_error,
                                   band_scales=self.band_scales)
        return qi_from_lambda(bits61, err61, lam,
                              band_scales=self.band_scales)
