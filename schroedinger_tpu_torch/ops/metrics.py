"""Quality metrics: MSE, PSNR and MSSIM (port of
`schroedinger_tpu/ops/metrics.py`).

`ssim_frame` is the reference's schro_frame_ssim (schrossim.c:65-149)
operation for operation, on the host in float64 numpy as in the JAX
package: its IIR3 recursive Gaussian (`_lowpass2`, shared with the
Gaussian prefilter of `ops/filters.py`) runs a sequential recursion in
double, where float32 drifts across rounding boundaries.  `mse`, `psnr`
and the 8x8-box `ssim` are tensor functions on any device.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def mse(a, b):
    d = a.to(torch.float32) - b.to(torch.float32)
    return (d * d).mean()


def psnr(a, b, peak: float = 255.0):
    m = mse(a, b)
    return torch.where(m == 0, torch.full_like(m, math.inf),
                       10.0 * torch.log10(peak * peak / m))


def _iir3_coeff(sigma: float):
    """Young/van-Vliet-style recursive-Gaussian coefficients
    (generate_coeff, schrofilter.c:666-688)."""
    if sigma >= 2.5:
        q = 0.98711 * sigma - 0.96330
    else:
        q = 3.97156 - 4.41554 * math.sqrt(1 - 0.26891 * sigma)
    b0 = 1.57825 + 2.44413 * q + 1.4281 * q * q + 0.422205 * q ** 3
    b1 = 2.44413 * q + 2.85619 * q * q + 1.26661 * q ** 3
    b2 = -1.4281 * q * q - 1.26661 * q ** 3
    b3 = 0.422205 * q ** 3
    return (1.0 - (b1 + b2 + b3) / b0, b1 / b0, b2 / b0, b3 / b0)


def _iir3_rows(x, coeff, rnd):
    """One IIR3 pass along axis 1 of (rows, n), batched across rows:
    outputs rounded per sample (the in-place integer store), the filter
    state kept unrounded (schro_iir3_*_f64, schrofilter.c:566-631)."""
    B, c1, c2, c3 = coeff
    x = np.asarray(x, np.float64)
    out = np.empty_like(x)
    s0 = x[:, 0].copy()
    s1 = x[:, 0].copy()
    s2 = x[:, 0].copy()
    for i in range(x.shape[1]):
        v = B * x[:, i] + c1 * s0 + c2 * s1 + c3 * s2
        s2 = s1
        s1 = s0
        s0 = v
        out[:, i] = rnd(v)
    return out


def _lowpass2(img, sigma: float, rnd):
    """schro_frame_filter_lowpass2 (schrofilter.c:635-744): per-row
    forward + reverse IIR3, then per-column forward + reverse, every write
    rounded to the frame's integer type (rnd).  The reverse passes run on
    the forward-filtered data with state seeded from its last sample (the
    reference filters in place)."""
    coeff = _iir3_coeff(max(sigma, 1e-3))
    x = np.asarray(img, np.float64)
    x = _iir3_rows(x, coeff, rnd)                       # rows fwd
    x = _iir3_rows(x[:, ::-1], coeff, rnd)[:, ::-1]     # rows rev
    x = _iir3_rows(x.T, coeff, rnd).T                   # cols down
    x = _iir3_rows(x.T[:, ::-1], coeff, rnd)[:, ::-1].T  # cols up
    return x


def _clamp_s16(v):
    return np.clip(v, -32768.0, 32767.0)


def ssim_frame(a, b, c1: float = (0.01 * 255) ** 2,
               c2: float = (0.03 * 255) ** 2):
    """Per-pixel mean SSIM over a luma plane, the reference's multiply /
    lowpass formulation: mu = IIR3 lowpass (sigma = width / 256 * 1.5) of
    the u8 planes, hipass = plane - 128 - mu (the reference's u8 -> s16
    conversion subtracts 128, schrovirtframe.c:1741-1750, and the
    offset is kept for parity), variances and covariance = IIR3 lowpass
    of the s16-clamped hipass products, SSIM averaged over every
    pixel."""

    def rnd_u8(v):
        return np.clip(np.rint(v), 0.0, 255.0)

    rnd_s16 = np.rint

    x = np.asarray(a, np.float64)
    y = np.asarray(b, np.float64)
    sigma = (x.shape[1] / 256.0) * 1.5  # SSIM_SIGMA, schrossim.c:62
    mx = _lowpass2(x, sigma, rnd_u8)
    my = _lowpass2(y, sigma, rnd_u8)
    hx = x - 128.0 - mx
    hy = y - 128.0 - my
    vx = _lowpass2(_clamp_s16(hx * hx), sigma, rnd_s16)
    vy = _lowpass2(_clamp_s16(hy * hy), sigma, rnd_s16)
    cov = _lowpass2(_clamp_s16(hx * hy), sigma, rnd_s16)
    s = ((2 * mx * my + c1) * (2 * cov + c2)) / (
        (mx * mx + my * my + c1) * (vx + vy + c2))
    return float(np.mean(s))


def ssim(a, b, c1: float = (0.01 * 255) ** 2, c2: float = (0.03 * 255) ** 2):
    """Mean SSIM with an 8x8 box window (the fast form; ssim_frame is the
    schrossim.c analog that enable_ssim reports)."""
    x = a.to(torch.float32)
    y = b.to(torch.float32)

    def box(v):
        h, w = v.shape
        h8, w8 = h // 8 * 8, w // 8 * 8
        return v[:h8, :w8].reshape(h8 // 8, 8, w8 // 8, 8).mean(dim=(1, 3))

    mx = box(x)
    my = box(y)
    vx = box(x * x) - mx * mx
    vy = box(y * y) - my * my
    cov = box(x * y) - mx * my
    s = ((2 * mx * my + c1) * (2 * cov + c2)) / (
        (mx * mx + my * my + c1) * (vx + vy + c2))
    return s.mean()
