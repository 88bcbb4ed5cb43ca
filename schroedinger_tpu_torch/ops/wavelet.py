"""Integer lifting wavelet transforms (forward + inverse) in PyTorch.

Port of `schroedinger_tpu/ops/wavelet.py`: the 7 Dirac/VC-2 wavelets in
the Mallat (separated-subband) layout, bit-exact with the reference's Orc
kernels (schrowaveletorc.c, schroorc.orc):

- s16 path: 16-bit adds wrap (addw/subw); multiplies widen to 32-bit
  (mulswl); results truncate back to 16 bits (convlw).
- s32 path: all ops wrap at 32 bits (addl/mulll).
- avgsw/avgsl ((a+b+1)>>1) via the overflow-free (a|b) - ((a^b)>>1).
- Edge handling: taps clamp to the first/last sample of the half-rate array.

Torch keeps the dtype of an integer tensor combined with a Python int, so
int16 adds wrap as in the JAX version; the widening steps cast to int32
explicitly.
"""
from __future__ import annotations

import torch

from schroedinger_tpu_torch.wavelets import HAS_SHIFT, Wavelet


def _shift_edge(x, off: int, axis: int):
    """x[clamp(i+off)] along `axis` — tap with edge clamping: the body
    shifted by `off` and the edge sample repeated, one concatenation."""
    if off == 0:
        return x
    ax = axis % x.ndim
    n = x.shape[ax]
    k = min(abs(off), n)
    reps = [k if d == ax else -1 for d in range(x.ndim)]
    if off > 0:
        return torch.cat([x.narrow(ax, k, n - k),
                          x.narrow(ax, n - 1, 1).expand(reps)], ax)
    return torch.cat([x.narrow(ax, 0, 1).expand(reps),
                      x.narrow(ax, 0, n - k)], ax)


def _avg_ceil(a, b):
    """(a+b+1)>>1 without intermediate overflow (Orc avgsw/avgsl)."""
    return (a | b) - ((a ^ b) >> 1)


def _add22(a, b):
    """((a+b)+2)>>2 with wrapping narrow adds (orc_add2_rshift_add_s16_22)."""
    return ((a + b) + 2) >> 2


def _mas2(s0, s1, w, off, sh, dtype):
    """(w*(s0+s1) + off) >> sh; narrow wrapping add, 32-bit multiply."""
    t = (s0 + s1).to(torch.int32)
    return ((t * w + off) >> sh).to(dtype)


def _mas4_1991(sm1, s0, s1, s2, off, sh, dtype):
    """(9*(s0+s1) - (sm1+s2) + off) >> sh; narrow wrapping pair adds."""
    t1 = (s0 + s1).to(torch.int32)
    t2 = (sm1 + s2).to(torch.int32)
    return ((t1 * 9 - t2 + off) >> sh).to(dtype)


def _mas8(taps, weights, off, sh, dtype):
    """(sum_k w[k]*taps[k] + off) >> sh with 32-bit accumulation."""
    acc = None
    for t, w in zip(taps, weights):
        term = t.to(torch.int32) * w
        acc = term + off if acc is None else acc + term
    return (acc >> sh).to(dtype)


_FID_W1 = (-8, 21, -46, 161, 161, -46, 21, -8)  # update on even, offset 128
_FID_W2 = (2, -10, 25, -81, -81, 25, -10, 2)    # predict on odd, offset 127


def _steps(wavelet: Wavelet, tap=None):
    """Lifting steps as (target, sign, fn(e, o, axis, dtype)) tuples.

    target 'o' modifies the odd (high-pass-to-be) half, 'e' the even half.
    Forward applies in order; inverse applies reversed with flipped signs.
    `tap(x, off, axis)` supplies neighbour samples; the default clamps to
    the array's edge, the row-sharded path (`parallel/tiles.py`) fills the
    rows past a tile's edge from its neighbours.
    """
    t = tap if tap is not None else _shift_edge

    if wavelet in (Wavelet.DESLAURIERS_DUBUC_9_7,
                   Wavelet.DESLAURIERS_DUBUC_13_7):
        def predict(e, o, ax, dt):
            return _mas4_1991(t(e, -1, ax), e, t(e, 1, ax), t(e, 2, ax),
                              8, 4, dt)
        if wavelet == Wavelet.DESLAURIERS_DUBUC_9_7:
            def update(e, o, ax, dt):
                return _add22(t(o, -1, ax), o)
        else:
            def update(e, o, ax, dt):
                return _mas4_1991(t(o, -2, ax), t(o, -1, ax), o,
                                  t(o, 1, ax), 16, 5, dt)
        return (("o", -1, predict), ("e", +1, update))

    if wavelet == Wavelet.LE_GALL_5_3:
        def predict(e, o, ax, dt):
            return _avg_ceil(e, t(e, 1, ax))

        def update(e, o, ax, dt):
            return _add22(t(o, -1, ax), o)
        return (("o", -1, predict), ("e", +1, update))

    if wavelet in (Wavelet.HAAR_0, Wavelet.HAAR_1):
        def predict(e, o, ax, dt):
            return e

        def update(e, o, ax, dt):
            return _avg_ceil(o, torch.zeros_like(o))
        return (("o", -1, predict), ("e", +1, update))

    if wavelet == Wavelet.FIDELITY:
        def update(e, o, ax, dt):
            return _mas8([t(o, k, ax) for k in range(-4, 4)], _FID_W1,
                         128, 8, dt)

        def predict(e, o, ax, dt):
            return _mas8([t(e, k, ax) for k in range(-3, 5)], _FID_W2,
                         127, 8, dt)
        # Fidelity is update-first, and both steps *add* (weights carry signs).
        return (("e", +1, update), ("o", +1, predict))

    if wavelet == Wavelet.DAUBECHIES_9_7:
        def p1(e, o, ax, dt):
            return _mas2(e, t(e, 1, ax), 6497, 2048, 12, dt)

        def u1(e, o, ax, dt):
            return _mas2(t(o, -1, ax), o, 217, 2048, 12, dt)

        def p2(e, o, ax, dt):
            return _mas2(e, t(e, 1, ax), 3616, 2048, 12, dt)

        def u2(e, o, ax, dt):
            return _mas2(t(o, -1, ax), o, 1817, 2048, 12, dt)
        return (("o", -1, p1), ("e", -1, u1), ("o", +1, p2), ("e", +1, u2))

    raise ValueError(f"unknown wavelet {wavelet}")


def _lift_fwd(e, o, wavelet, axis, tap=None):
    dt = e.dtype
    for target, sign, fn in _steps(wavelet, tap):
        v = fn(e, o, axis, dt)
        if target == "o":
            o = o + v if sign > 0 else o - v
        else:
            e = e + v if sign > 0 else e - v
    return e, o


def _lift_inv(e, o, wavelet, axis, tap=None):
    dt = e.dtype
    for target, sign, fn in reversed(_steps(wavelet, tap)):
        v = fn(e, o, axis, dt)
        if target == "o":
            o = o - v if sign > 0 else o + v
        else:
            e = e - v if sign > 0 else e + v
    return e, o


def _split(x, axis):
    ax = axis % x.ndim
    idx_e = [slice(None)] * x.ndim
    idx_o = [slice(None)] * x.ndim
    idx_e[ax] = slice(0, None, 2)
    idx_o[ax] = slice(1, None, 2)
    return x[tuple(idx_e)], x[tuple(idx_o)]


def _interleave(e, o, axis):
    ax = axis % e.ndim
    stacked = torch.stack([e, o], dim=ax + 1)
    shape = list(e.shape)
    shape[ax] = e.shape[ax] * 2
    return stacked.reshape(shape)


def fwd_level(x, wavelet: Wavelet):
    """One 2-D analysis level. x: (..., H, W) int16/int32, H and W even.

    Returns (LL, HL, LH, HH), each (..., H/2, W/2)."""
    wavelet = Wavelet(wavelet)
    if HAS_SHIFT[wavelet]:
        x = x + x  # <<1 with narrow wrap (orc x2 shlw)
    e, o = _split(x, -1)
    lo, hi = _lift_fwd(e, o, wavelet, -1)
    out = []
    for half in (lo, hi):
        ev, od = _split(half, -2)
        out.append(_lift_fwd(ev, od, wavelet, -2))
    (ll, lh), (hl, hh) = out
    return ll, hl, lh, hh


def inv_level(ll, hl, lh, hh, wavelet: Wavelet):
    """One 2-D synthesis level; inverse of fwd_level (bit-exact round trip)."""
    wavelet = Wavelet(wavelet)
    halves = []
    for ev, od in ((ll, lh), (hl, hh)):
        ev, od = _lift_inv(ev, od, wavelet, -2)
        halves.append(_interleave(ev, od, -2))
    lo, hi = halves
    e, o = _lift_inv(lo, hi, wavelet, -1)
    x = _interleave(e, o, -1)
    if HAS_SHIFT[wavelet]:
        x = (x + 1) >> 1  # rounded de-shift (orc_interleave2_rrshift1)
    return x


def forward(x, depth: int, wavelet: Wavelet):
    """Full `depth`-level forward IWT -> {'ll': ..., 'levels': [...]};
    levels[0] is the first level applied (finest, H/2)."""
    levels = []
    cur = x
    for _ in range(depth):
        ll, hl, lh, hh = fwd_level(cur, wavelet)
        levels.append({"hl": hl, "lh": lh, "hh": hh})
        cur = ll
    return {"ll": cur, "levels": levels}


def inverse(pyr, wavelet: Wavelet):
    """Inverse of `forward`."""
    cur = pyr["ll"]
    for lev in reversed(pyr["levels"]):
        cur = inv_level(cur, lev["hl"], lev["lh"], lev["hh"], wavelet)
    return cur
