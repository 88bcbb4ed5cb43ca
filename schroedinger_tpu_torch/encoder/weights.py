"""Perceptual subband weighting (schroquantiser.c:35-288 analog).

The reference ships Monte-Carlo noise-power curves of each wavelet's 1-D
synthesis (schro_tables_wavelet_noise_curve, generated by
testsuite/tables2/wavelet_tables.c:30-99: inject white noise into one
subband, synthesize, average the FFT power spectrum over 100k trials).
We compute the same curves deterministically: synthesis is linear, so the
expected power spectrum of unit-variance noise in band S is
sum_{k in S} |FFT(synth(e_k))|^2 — a batch of basis impulse responses
through a float (rounding-free) model of the lifting, no transcribed
tables and no sampling noise.

Subband weights follow schro_encoder_calculate_subband_weights
(schroquantiser.c:152-288, the weighted_sum branch the reference actually
runs): weight[i] = 1 / (size * sqrt(sum_{f_h,f_v} h_i(f_h) v_i(f_v)
W(f_h,f_v))) with W the perceptual weight on the 2-D frequency grid in
cycles per degree and size = 2^n_transforms / CURVE_SIZE.

The quantiser scales its RD lambda by 1/weight^2 per band
(schroquantiser.c:875, lambda /= weight * weight).

Whole copy of `schroedinger_tpu/encoder/weights.py`: the port imports nothing of
the JAX package, and later slices find their entry points here.
"""
from __future__ import annotations

import math
from functools import lru_cache

import numpy as np

from schroedinger_tpu_torch.params import subband_position
from schroedinger_tpu_torch.wavelets import Wavelet

CURVE_SIZE = 128
_N = 256  # analysis length (testsuite/tables2/wavelet_tables.c:26-27)

# output scaling shifts per filter (wavelet_tables.c:20, filtershift[])
FILTER_SHIFT = {
    Wavelet.DESLAURIERS_DUBUC_9_7: 1,
    Wavelet.LE_GALL_5_3: 1,
    Wavelet.DESLAURIERS_DUBUC_13_7: 1,
    Wavelet.HAAR_0: 0,
    Wavelet.HAAR_1: 1,
    Wavelet.FIDELITY: 0,
    Wavelet.DAUBECHIES_9_7: 1,
}


def _edge(a: np.ndarray, k: int) -> np.ndarray:
    """Edge-extended view: columns -8..n+7 (testsuite/common.c extend)."""
    pad = 8
    return np.pad(a, ((0, 0), (pad, pad)), mode="edge")[:, pad + k:]


def _synth_1d(a: np.ndarray, filt: Wavelet) -> np.ndarray:
    """Float (rounding-free) 1-D synthesis lifting on interleaved rows,
    mirroring the scalar reference (testsuite/common.c:752-828) with the
    integer `(x + r) >> s` steps replaced by exact `x / 2^s`."""
    a = a.astype(np.float64).copy()
    n = a.shape[1]
    ev, od = slice(0, n, 2), slice(1, n, 2)

    def at(k):  # a[i + k] for i in the even grid
        return _edge(a, k)[:, 0:n:2]

    if filt in (Wavelet.DESLAURIERS_DUBUC_9_7,):
        a[:, ev] -= (at(-1) + at(1)) / 4.0
        a[:, od] += (-at(-2) + 9 * at(0) + 9 * at(2) - at(4)) / 16.0
    elif filt == Wavelet.LE_GALL_5_3:
        a[:, ev] -= (at(-1) + at(1)) / 4.0
        a[:, od] += (at(0) + at(2)) / 2.0
    elif filt == Wavelet.DESLAURIERS_DUBUC_13_7:
        a[:, ev] -= (-at(-3) + 9 * at(-1) + 9 * at(1) - at(3)) / 32.0
        a[:, od] += (-at(-2) + 9 * at(0) + 9 * at(2) - at(4)) / 16.0
    elif filt in (Wavelet.HAAR_0, Wavelet.HAAR_1):
        a[:, ev] -= at(1) / 2.0
        a[:, od] += at(0)
    elif filt == Wavelet.FIDELITY:
        a[:, od] += (-2 * at(-6) + 10 * at(-4) - 25 * at(-2) + 81 * at(0)
                     + 81 * at(2) - 25 * at(4) + 10 * at(6)
                     - 2 * at(8)) / 256.0
        a[:, ev] -= (-8 * at(-7) + 21 * at(-5) - 46 * at(-3) + 161 * at(-1)
                     + 161 * at(1) - 46 * at(3) + 21 * at(5)
                     - 8 * at(7)) / 256.0
    elif filt == Wavelet.DAUBECHIES_9_7:
        a[:, ev] -= (1817 * at(-1) + 1817 * at(1)) / 4096.0
        a[:, od] -= (3616 * at(0) + 3616 * at(2)) / 4096.0
        a[:, ev] += (217 * at(-1) + 217 * at(1)) / 4096.0
        a[:, od] += (6497 * at(0) + 6497 * at(2)) / 4096.0
    else:
        raise ValueError(filt)
    return a


def _interleave(a: np.ndarray) -> np.ndarray:
    """[low half | high half] rows -> even/odd interleaved rows."""
    n = a.shape[1]
    out = np.empty_like(a)
    out[:, 0::2] = a[:, :n // 2]
    out[:, 1::2] = a[:, n // 2:]
    return out


@lru_cache(maxsize=None)
def noise_curves(filt: Wavelet) -> np.ndarray:
    """(8, CURVE_SIZE) synthesis noise-power curves: row 2k = high band at
    n_levels k+1, row 2k+1 = low band (wavelet_tables.c:118-152 layout)."""
    out = np.zeros((8, CURVE_SIZE))
    fshift = FILTER_SHIFT[Wavelet(filt)]
    for row in range(8):
        n_levels = 1 + (row >> 1)
        lo_band = bool(row & 1)
        lo, hi = ((0, _N >> n_levels) if lo_band
                  else (_N >> n_levels, _N >> (n_levels - 1)))
        basis = np.zeros((hi - lo, _N))
        basis[np.arange(hi - lo), np.arange(lo, hi)] = 1.0
        for lev in range(n_levels - 1, -1, -1):
            m = _N >> lev
            basis[:, :m] = _synth_1d(_interleave(basis[:, :m]),
                                     Wavelet(filt))
        power = np.abs(np.fft.fft(basis, axis=1)) ** 2
        x = power.sum(axis=0) / _N  # FFT normalisation
        x /= 1 << (fshift * n_levels)
        out[row] = x[:CURVE_SIZE]
    return out


# ---- perceptual weight functions (schroquantiser.c:33-69) ---------------

def perceptual_weight_constant(cpd):
    return np.ones_like(np.asarray(cpd, np.float64))


def perceptual_weight_ccir959(cpd):
    cpd = np.asarray(cpd, np.float64)
    w = 0.255 * (1 + 0.2561 * cpd * cpd) ** -0.75
    return w / 0.255


def perceptual_weight_moo(cpd):
    cpd = np.asarray(cpd, np.float64)
    return np.where(cpd < 4, 1.0, 0.68 * cpd * np.exp(-0.25 * cpd))


def perceptual_weight_manos_sakrison(cpd):
    cpd = np.asarray(cpd, np.float64)
    w = 2.6 * (0.0192 + 0.114 * cpd) * np.exp(-(0.114 * cpd) ** 1.1)
    return np.where(cpd < 4, 1.0, w / 0.980779694777866)


PERCEPTUAL_WEIGHT_FNS = {
    "none": perceptual_weight_constant,
    "constant": perceptual_weight_constant,
    "ccir959": perceptual_weight_ccir959,
    "moo": perceptual_weight_moo,
    "manos_sakrison": perceptual_weight_manos_sakrison,
}


def cycles_per_degree(height: int, aspect_num: int, aspect_den: int,
                      perceptual_distance: float,
                      interlaced: bool) -> tuple:
    """(cpd_horiz, cpd_vert), schro_encoder_init_perceptual_weighting
    (schroencoder.c:855-869); distance in picture heights."""
    v = 0.5 * height / (2.0 * math.atan(0.5 / perceptual_distance)
                        * 180.0 / math.pi)
    h = v * aspect_den / max(aspect_num, 1)
    if interlaced:
        v *= 0.5
    return h, v


@lru_cache(maxsize=None)
def subband_weights(filt: Wavelet, depth: int,
                    weighting: str = "constant",
                    cpd_h: float = 0.0, cpd_v: float = 0.0,
                    inter_cpd_scale: float = 1.0,
                    intra: bool = True) -> np.ndarray:
    """(nb,) quantiser weights (schroquantiser.c:258-280 weighted_sum
    branch).  Larger weight => visually cheaper noise => coarser quant."""
    wfn = PERCEPTUAL_WEIGHT_FNS[weighting]
    scale = 1.0 if intra else inter_cpd_scale
    fh = np.arange(CURVE_SIZE) * cpd_h * scale / CURVE_SIZE
    fv = np.arange(CURVE_SIZE) * cpd_v * scale / CURVE_SIZE
    grid = wfn(np.sqrt(fv[:, None] ** 2 + fh[None, :] ** 2))

    curves = noise_curves(Wavelet(filt))
    nb = 3 * depth + 1
    out = np.zeros(nb)
    for i in range(nb):
        pos = subband_position(i)
        n_transforms = depth - (pos >> 2)
        hi = (n_transforms - 1) * 2 + (0 if (pos & 1) else 1)
        vi = (n_transforms - 1) * 2 + (0 if (pos & 2) else 1)
        h_curve, v_curve = curves[hi], curves[vi]
        size = (1.0 / CURVE_SIZE) * (1 << n_transforms)
        ws = float(v_curve @ grid @ h_curve)
        out[i] = 1.0 / (size * math.sqrt(max(ws, 1e-30)))
    return out


def band_lambda_scales(filt: Wavelet, depth: int,
                       weighting: str = "constant",
                       cpd_h: float = 0.0, cpd_v: float = 0.0,
                       inter_cpd_scale: float = 1.0,
                       intra: bool = True,
                       subband0_scale: float = 10.0,
                       diagonal_scale: float = 1.0) -> np.ndarray:
    """Per-band multipliers applied to the frame lambda before the RD
    argmin (schro_encoder_lambda_to_entropy, schroquantiser.c:856-880):
    lambda_i = frame_lambda * scales_i with scales_i =
    magic_subband0_lambda_scale^(i==0) * magic_diagonal_lambda_scale^(diag)
    / weight_i^2."""
    w = subband_weights(Wavelet(filt), depth, weighting, cpd_h, cpd_v,
                        inter_cpd_scale, intra)
    nb = 3 * depth + 1
    scales = 1.0 / np.square(w)
    for i in range(nb):
        pos = subband_position(i)
        if i == 0:
            scales[i] *= subband0_scale
        if (pos & 3) == 3:
            scales[i] *= diagonal_scale
    return scales
