"""FFT phase-correlation motion estimation (port of
`schroedinger_tpu/encoder/phasecorr.py`).

The reference slides Gaussian-weighted windows (2^(5+i) x 2^(4+i), i =
level) over the 4x downsampled luma, phase-correlates each window of the
current frame against the co-sited reference window (normalised
cross-power spectrum, inverse FFT) and extracts the top-2 correlation
peaks with half-peak sub-sample refinement (schrophasecorrelation.c:
129-179, 339-401).  Here all windows of a level form one (n_windows, wh,
ww) batch through `torch.fft.fft2` / `ifft2`, in float32 as in the JAX
package, and `pick_candidates` distils the window vectors on the host
into the uniform candidates the ME's competition takes (`me.make_me_body`
n_extra).

The FFT is float: pocketfft on the CPU, cuFFT on the card and XLA's FFT
sum in different orders, so a near-tied peak or a sub-pel peak that
rounds at .5 may pick another vector on another device.
"""
from __future__ import annotations

import numpy as np
import torch

from schroedinger_tpu_torch.encoder.me import downsample2
from schroedinger_tpu_torch.utils.telemetry import dump, dump_enabled

PICTURE_SHIFT = 2  # the reference runs phase correlation 4x down (:489)


def _gauss_weight(wh: int, ww: int) -> np.ndarray:
    """Normalised Gaussian window (schrophasecorrelation.c:71-102)."""
    my, mx = 0.5 * (wh - 1), 0.5 * (ww - 1)
    y = (np.arange(wh) - my) / my
    x = (np.arange(ww) - mx) / mx
    d2 = y[:, None] ** 2 + x[None, :] ** 2
    w = np.exp(-2.0 * d2)
    return (w / w.sum()).astype(np.float32)


def _window_origins(dh: int, dw: int, wh: int, ww: int):
    """Static window grid: ~50% overlap, edges included (:319-324,354-357)."""
    num_x = (dw - ww) // (ww // 2) + 2
    num_y = (dh - wh) // (wh // 2) + 2
    xs = [((dw - ww) * ix) // (num_x - 1) for ix in range(num_x)]
    ys = [((dh - wh) * iy) // (num_y - 1) for iy in range(num_y)]
    return ys, xs


def _find_peaks(ccorr, wh: int, ww: int):
    """Top-2 peaks with half-peak sub-sample refinement, batched.

    ccorr: (N, wh, ww) float32 correlation surfaces (cyclic).  Returns
    (dy, dx), each (N, 2) float32, for the first and second peak (the
    first peak's 3x3 neighbourhood zeroed in between, :129-179)."""
    n = ccorr.shape[0]
    flat0 = ccorr.reshape(n, wh * ww)

    def at(flat, iy, ix):
        return torch.gather(flat, 1,
                            ((iy % wh) * ww + (ix % ww))[:, None])[:, 0]

    def one_peak(flat):
        i = torch.argmax(flat, dim=1)
        peak = torch.gather(flat, 1, i[:, None])[:, 0]
        ix = i % ww
        iy = torch.div(i, ww, rounding_mode="floor")
        sx = torch.where(ix >= ww // 2, ix - ww, ix)
        sy = torch.where(iy >= wh // 2, iy - wh, iy)
        safe = torch.where(peak != 0, peak, torch.ones_like(peak))
        a = at(flat, iy, ix + 1)
        b = at(flat, iy, ix - 1)
        dx = torch.where(a > b, sx + 0.5 * a / safe, sx - 0.5 * b / safe)
        a = at(flat, iy + 1, ix)
        b = at(flat, iy - 1, ix)
        dy = torch.where(a > b, sy + 0.5 * a / safe, sy - 0.5 * b / safe)
        dx = torch.where(peak != 0, dx, torch.zeros_like(dx))
        dy = torch.where(peak != 0, dy, torch.zeros_like(dy))
        # zero the 3x3 neighbourhood for the next peak (:170-178)
        o = torch.arange(-1, 2, device=flat.device)
        ny = (iy[:, None, None] + o[None, :, None]) % wh
        nx = (ix[:, None, None] + o[None, None, :]) % ww
        kill = (ny * ww + nx).reshape(n, 9)
        mask = torch.zeros_like(flat).scatter_(1, kill, 1.0)
        return dy, dx, flat * (1.0 - mask)

    dy1, dx1, flat1 = one_peak(flat0)
    dy2, dx2, _ = one_peak(flat1)
    return torch.stack([dy1, dy2], 1), torch.stack([dx1, dx2], 1)


def make_phasecorr_fn(H: int, W: int, levels=(0, 1)):
    """fn(cur_y u8 (H, W), ref_y u8) -> (n_total, 2, 2) int32 tensor on
    the planes' device: [k, p] = (dy, dx) of peak p of window k in
    full-resolution pels (rint(-d << picture_shift), :386-397), the
    windows of every level concatenated.  A level whose window exceeds
    the downsampled frame is skipped (:483-486); with none left the
    result is one zero window."""
    dh, dw = H >> PICTURE_SHIFT, W >> PICTURE_SHIFT
    plans = []
    for lev in levels:
        ww, wh = 1 << (5 + lev), 1 << (4 + lev)
        if dw < ww or dh < wh:
            continue
        ys, xs = _window_origins(dh, dw, wh, ww)
        oy = np.repeat(ys, len(xs)).astype(np.int64)
        ox = np.tile(xs, len(ys)).astype(np.int64)
        # win[k, j, i] = img[oy[k] + j, ox[k] + i]
        iy = oy[:, None, None] + np.arange(wh)[None, :, None]
        ix = ox[:, None, None] + np.arange(ww)[None, None, :]
        plans.append((wh, ww, iy, ix, _gauss_weight(wh, ww)))
    consts = {}

    def plan_on(dev):
        hit = consts.get(dev)
        if hit is None:
            hit = consts[dev] = [
                (wh, ww, torch.as_tensor(iy, device=dev),
                 torch.as_tensor(ix, device=dev),
                 torch.as_tensor(wt, device=dev))
                for wh, ww, iy, ix, wt in plans]
        return hit

    def run(cur, ref):
        dev = cur.device
        c = downsample2(downsample2(cur)).to(torch.float32)
        r = downsample2(downsample2(ref)).to(torch.float32)
        outs = []
        for wh, ww, iy, ix, wt in plan_on(dev):
            def prep(img):
                win = img[iy, ix] * wt           # (N, wh, ww)
                s = win.sum(dim=(1, 2), keepdim=True)
                win = win / torch.where(s != 0, s, torch.ones_like(s))
                return torch.fft.fft2(win)
            f1 = prep(c)
            f2 = prep(r)
            cross = f1 * torch.conj(f2)          # complex_mult of conj (:369)
            mag = cross.abs()
            cross = cross / torch.where(mag > 0, mag, torch.ones_like(mag))
            ccorr = torch.fft.ifft2(cross).real * (wh * ww)
            dy, dx = _find_peaks(ccorr, wh, ww)
            v = torch.stack([dy, dx], dim=-1)    # (N, 2, 2)
            outs.append(torch.round(-v * (1 << PICTURE_SHIFT)).to(
                torch.int32))
        if not outs:
            return torch.zeros((1, 2, 2), dtype=torch.int32, device=dev)
        return torch.cat(outs, dim=0)

    return run


def pick_candidates(vecs, n: int = 8, vmax: int = 240) -> np.ndarray:
    """Distil window vectors into the n most common distinct (dy, dx), on
    the host; zero-padded to exactly n rows (the zero vector is harmless
    as an extra SAD candidate).  With the `phase_corr` dump topic on, one
    line of the picks and their counts goes to the telemetry dump."""
    v = np.asarray(vecs).reshape(-1, 2)
    v = v[(np.abs(v) <= vmax).all(axis=1)]
    if len(v) == 0:
        return np.zeros((n, 2), np.int32)
    uniq, counts = np.unique(v, axis=0, return_counts=True)
    order = np.argsort(-counts)
    out = np.zeros((n, 2), np.int32)
    take = min(n, len(uniq))
    out[:take] = uniq[order[:take]]
    if dump_enabled("phase_corr"):
        dump("phase_corr", " ".join("%d,%d:%d" % (dy, dx, c) for (dy, dx), c
                                    in zip(uniq[order[:take]],
                                           counts[order[:take]])))
    return out
