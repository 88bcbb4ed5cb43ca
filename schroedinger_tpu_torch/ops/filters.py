"""Encoder prefilters (schrofilter.c equivalents; port of
`schroedinger_tpu/ops/filters.py`).

The dispatch follows the reference's `filtering` setting
(schroencoder.c:2211-2234): none, center_weighted_median (cwmN), gaussian
(the IIR3 recursive lowpass, schro_frame_filter_lowpass2), add_noise,
adaptive_gaussian (schro_frame_filter_adaptive_lowpass: the slope of a
wavelet histogram chooses sigma) and lowpass (the 3-tap luma smoother,
schro_frame_filter_lowpass).  The recursive Gaussian and the histogram
fit are host float64 numpy, as in the JAX package; the 3-tap smoother and
the median are integer tensor code on any device.

add_noise draws its normal noise from a `torch.Generator` seeded 0 at
each call, on the CPU, so every device adds the same noise; the JAX
package draws it from jax.random.normal(PRNGKey(0)) (threefry), so the
two packages add different noise of the same distribution.
"""
from __future__ import annotations

import numpy as np
import torch

from schroedinger_tpu_torch.ops import wavelet as wv
from schroedinger_tpu_torch.ops.metrics import _lowpass2
from schroedinger_tpu_torch.wavelets import Wavelet


def gaussian_lowpass(plane, sigma: float, chroma_shift: int = 0):
    """The reference's recursive Gaussian (schro_frame_filter_lowpass2,
    schrofilter.c:635-744) on a host u8 plane: forward + reverse IIR3 per
    row, then per column, u8 rounding at every write; chroma planes take
    sigma scaled down by the subsampling shift (schrofilter.c:785-800)."""
    s = float(sigma) / (1 << chroma_shift)
    plane = np.asarray(plane)
    if s <= 0.0:
        return plane

    def rnd_u8(v):
        return np.clip(np.rint(v), 0.0, 255.0)

    return np.asarray(_lowpass2(plane.astype(np.float64), s, rnd_u8),
                      np.uint8)


def lowpass3(plane, tap: int):
    """schro_frame_filter_lowpass (schrofilter.c:339-430): the separable
    3-tap [tap, 256 - 2 tap, tap] smoother with edge clamp and
    (x + 128) >> 8 rounding, on a u8 plane tensor."""
    x = plane.to(torch.int32)
    t1 = int(tap)
    t2 = 256 - 2 * t1

    def pass1(v, dim):
        n = v.shape[dim]
        idx = torch.arange(n, device=v.device)
        lo = v.index_select(dim, (idx - 1).clamp(0, n - 1))
        hi = v.index_select(dim, (idx + 1).clamp(0, n - 1))
        return (lo * t1 + v * t2 + hi * t1 + 128) >> 8

    return pass1(pass1(x, 1), 0).to(plane.dtype)


_HIST_SHIFT = 3                      # SCHRO_HISTOGRAM_SHIFT
_HIST_SIZE = (16 - _HIST_SHIFT) * (1 << _HIST_SHIFT)


def _ilogx(x):
    """Log-bin index (schrohistogram.c:11-22), vectorised."""
    x = np.abs(np.asarray(x, np.int64))
    i = np.zeros_like(x)
    big = 2 << _HIST_SHIFT
    while (x >= big).any():
        m = x >= big
        x = np.where(m, x >> 1, x)
        i = i + m
    return (x + (i << _HIST_SHIFT)).astype(np.int64)


def _iexpx(i):
    i = np.asarray(i, np.int64)
    small = i < (1 << _HIST_SHIFT)
    v = ((1 << _HIST_SHIFT) | (i & ((1 << _HIST_SHIFT) - 1))) << np.maximum(
        (i >> _HIST_SHIFT) - 1, 0)
    return np.where(small, i, v)


def _ilogx_size(i):
    i = np.asarray(i, np.int64)
    return np.where(i < (1 << _HIST_SHIFT), 1,
                    1 << np.maximum((i >> _HIST_SHIFT) - 1, 0))


def adaptive_lowpass_sigma(y_plane) -> float:
    """schro_frame_filter_adaptive_lowpass (schrofilter.c:946-988): one
    LeGall 5/3 level over the (u8 - 128) luma, a log-binned histogram of
    its LH and HH coefficients, the least-squares slope of log(count /
    binsize) against sqrt(value), sigma = -1 / slope (0 where the slope
    is not negative)."""
    y_plane = np.asarray(y_plane)
    h, w = y_plane.shape
    h2, w2 = h // 2 * 2, w // 2 * 2
    res = torch.as_tensor(y_plane[:h2, :w2].astype(np.int16) - 128)
    pyr = wv.forward(res, 1, Wavelet.LE_GALL_5_3)
    hi = np.concatenate([pyr["levels"][0][k].numpy().ravel()
                         for k in ("lh", "hh")])
    idx = _ilogx(hi)
    bins = np.bincount(idx, minlength=_HIST_SIZE).astype(np.float64)
    i = np.arange(_HIST_SIZE)
    mask = (i > 0) & (bins > 0)
    if mask.sum() < 2:
        return 0.0
    x = np.sqrt(_iexpx(i[mask]).astype(np.float64))
    yv = np.log(bins[mask] / _ilogx_size(i[mask]))
    n = mask.sum()
    slope = ((n * (x * yv).sum() - x.sum() * yv.sum())
             / (n * (x * x).sum() - x.sum() ** 2))
    if slope >= 0:
        return 0.0
    return float(-1.0 / slope)


def center_weighted_median(plane, weight: int = 5):
    """3x3 center-weighted median (cwmN, schrofilter.c) of a u8 plane
    tensor: the center sample counts `weight` times among its 8
    neighbours (edge-clamped); the median is picked by rank."""
    x = plane.to(torch.int32)
    h, w = x.shape
    dev = x.device
    taps = []
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            ys = (torch.arange(h, device=dev) + dy).clamp(0, h - 1)
            xs = (torch.arange(w, device=dev) + dx).clamp(0, w - 1)
            taps.append(x[ys[:, None], xs[None, :]])
    reps = [taps[i] for i in range(9) if i != 4] + [taps[4]] * weight
    srt = torch.sort(torch.stack(reps), dim=0).values
    return srt[(8 + weight) // 2].to(plane.dtype)


def add_noise(plane, amount: float, generator: torch.Generator):
    """plane + amount * N(0, 1) noise from `generator`, rounded half to
    even and clipped to 0..255; the noise is drawn on the CPU."""
    noise = torch.randn(tuple(plane.shape), generator=generator) * amount
    out = plane.cpu().to(torch.float32) + noise
    return torch.round(out).clamp(0, 255).to(plane.dtype).to(plane.device)


def apply_prefilter(planes, filtering: str, filter_value: float,
                    device=torch.device("cpu")):
    """Prefilter the (y, u, v) u8 planes (host arrays or tensors) by the
    setting's name (config.FILTERINGS; the reference's dispatch,
    schroencoder.c:2211-2234); the tensor filters run on `device`.
    Returns host u8 numpy planes."""
    planes = tuple(pl.cpu().numpy() if torch.is_tensor(pl)
                   else np.asarray(pl) for pl in planes)
    if filtering in ("none", 0, None):
        return planes
    if filtering in ("gaussian", "adaptive_gaussian"):
        sigma = filter_value
        if filtering == "adaptive_gaussian":
            # sigma from the luma's wavelet-coefficient slope; the filter
            # engages only when sigma > 1 (schrofilter.c:981-987)
            sigma = adaptive_lowpass_sigma(planes[0])
            if sigma <= 1.0:
                return planes
        return tuple(gaussian_lowpass(p, sigma, chroma_shift=int(i > 0))
                     for i, p in enumerate(planes))
    gen = torch.Generator().manual_seed(0)
    out = []
    for i, p in enumerate(planes):
        t = torch.as_tensor(p, device=device)
        if filtering == "lowpass":
            # luma only, like the reference (lowpass3_h_u8 copies chroma)
            t = lowpass3(t, int(filter_value)) if i == 0 else t
        elif filtering == "center_weighted_median":
            t = center_weighted_median(t, int(max(1, filter_value)))
        elif filtering == "add_noise":
            t = add_noise(t, filter_value, gen)
        out.append(t.cpu().numpy())
    return tuple(out)
