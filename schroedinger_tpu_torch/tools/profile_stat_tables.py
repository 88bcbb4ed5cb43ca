"""Check and timing of the stat tables CUDA kernel, on one NVIDIA GPU.

    python -m schroedinger_tpu_torch.tools.profile_stat_tables

At the main path's launch shapes (SHAPES: a 1080p 4:2:0 inter picture at
depth 3, alone and as a batch of three B pictures; its intra picture,
band 0 as first differences; a batch of three 1080i field pictures; a
2160p picture, alone and three), on coefficients made from a numpy seed
(`make_coeffs`), it holds the kernel (`ops/stat_tables.py`, through
`ratecontrol.band_counts`) to the plain version
(`ratecontrol.band_counts_plain`) on the card: magnitude bits and
nonzero counts equal, the error sums within 1e-12 relative, and two
launches the same bits.  Then it times the kernel on the device alone
(20 launches captured in one CUDA graph and replayed) and from Python as
the encoder launches it, and the plain version from Python, beside the
least time the card could take (`bound_ms`), and prints one line per
shape with the card's name and power limit.

It needs the card and raises without one.
"""
from __future__ import annotations

import numpy as np
import torch

from schroedinger_tpu_torch.encoder import ratecontrol as rc
from schroedinger_tpu_torch.ops import stat_tables as st
from schroedinger_tpu_torch.tools.profile_patch_refine import (
    ALU_OPS_PER_S, HBM_BYTES_PER_S, gpu_line, graph_ms, time_ms)

# (component planes (h, w) as the steps transform them, depth, pictures,
# dtype, intra)
SHAPES = {
    "1080p inter N=1": (((1088, 1920), (544, 960), (544, 960)), 3, 1,
                        torch.int16, False),
    "1080p inter N=3": (((1088, 1920), (544, 960), (544, 960)), 3, 3,
                        torch.int16, False),
    "1080p intra": (((1080, 1920), (544, 960), (544, 960)), 3, 1,
                    torch.int32, True),
    "1080i field N=3": (((544, 1920), (272, 960), (272, 960)), 3, 3,
                        torch.int16, False),
    "2160p inter N=1": (((2160, 3840), (1088, 1920), (1088, 1920)), 3, 1,
                        torch.int16, False),
    "2160p inter N=3": (((2160, 3840), (1088, 1920), (1088, 1920)), 3, 3,
                        torch.int16, False),
}
MAIN_SHAPES = ("1080p inter N=1", "1080p inter N=3", "1080p intra")
# operations of one (coefficient, quant index) evaluation at power 4, one
# each: the numerator's add, the magic multiply and shift, the dead-zone
# compare and select; the dequantisation's multiply, add and shift, its
# compare and select; the difference, abs and conversion to float32; two
# multiplies of the error term, its conversion to float64 and its add;
# the sint length's add, clz, multiply and subtract; the packed count's
# shift, add, select and add
OPS_PER_EVAL = 24
ERR_RTOL = 1e-12


def band_bounds(planes, depth):
    """(bounds, n, ncol) of the flat coefficients of three components'
    pyramids laid out as the encoder's steps lay them: per component,
    band 0 then the 3 * depth bands from the coarsest level up; column
    ci * nb + band."""
    nb = 3 * depth + 1
    bounds, off = [], 0
    for ci, (h, w) in enumerate(planes):
        for bi in range(nb):
            lev = depth if bi == 0 else depth - (bi - 1) // 3
            size = (h >> lev) * (w >> lev)
            bounds.append((ci * nb + bi, off, off + size))
            off += size
    return bounds, off, len(planes) * nb


def make_coeffs(bounds, depth, n, N, seed, dtype, intra, peak=None):
    """(N, n) coefficients from numpy default_rng(seed), on the CPU: each
    band Laplacian with a scale that halves from the coarsest level to
    the finest; band 0 of an intra picture a smooth DC plane's
    horizontal first differences (the first column raw), of an inter
    picture a residual.  `peak`: a few coefficients of every band at
    +-peak."""
    rng = np.random.default_rng(seed)
    out = np.zeros((N, n), np.int64)
    for col, lo, hi in bounds:
        bi = col % (3 * depth + 1)
        size = hi - lo
        if bi == 0 and intra:
            dc = np.cumsum(rng.normal(0, 30, (N, size)), axis=1) + 2048
            diff = np.concatenate([dc[:, :1], np.diff(dc, axis=1)], 1)
            out[:, lo:hi] = np.round(diff)
        else:
            level = 0 if bi == 0 else (bi - 1) // 3
            scale = (80.0 if intra else 16.0) / (1 << level)
            out[:, lo:hi] = np.round(rng.laplace(0, scale, (N, size)))
        if peak is not None:
            out[:, lo:lo + 4] = [peak, -peak, peak - 1, 1 - peak]
    return torch.as_tensor(out).to(dtype)


def bound_ms(N, n, elem_bytes, ncol):
    """The least time the card could take for one call: N * n * 61
    evaluations of OPS_PER_EVAL operations over the ALU rate, against the
    coefficients read once and the three (N, 61, ncol) eight-byte tables
    written once over the memory rate.  Returns (ms, "operations" or
    "bytes")."""
    ops = N * n * st.N_QUANT * OPS_PER_EVAL / ALU_OPS_PER_S
    nbytes = (N * n * elem_bytes + 3 * N * st.N_QUANT * ncol * 8) \
        / HBM_BYTES_PER_S
    return max(ops, nbytes) * 1e3, "operations" if ops >= nbytes else "bytes"


def check(flat, bounds, ncol, intra, error_power=4.0, rtol=ERR_RTOL):
    """The kernel against the plain version on the card: (mag, nz) equal,
    err within rtol, a second launch the same bits, one launch counted
    per call.  Returns (the kernel's sums, err's largest relative
    difference)."""
    before = st.launches()
    got = rc.band_counts(flat, bounds, ncol, intra, error_power)
    again = rc.band_counts(flat, bounds, ncol, intra, error_power)
    want = rc.band_counts_plain(flat if flat.ndim == 2 else flat[None],
                                bounds, ncol, intra, error_power)
    torch.cuda.synchronize()
    if st.launches() != before + 2:
        raise AssertionError(f"stat tables: {st.launches() - before} "
                             "launches for 2 calls")
    if flat.ndim == 1:
        want = tuple(t[0] for t in want)
    for g, a in zip(got, again):
        if not torch.equal(g, a):
            raise AssertionError("stat tables: two launches differ")
    for name, g, w in zip(("mag", "nz"), got[:2], want[:2]):
        if g.dtype != torch.int64 or not torch.equal(g, w):
            raise AssertionError(f"stat tables: {name} differs from the "
                                 "plain sums")
    rel = ((got[2] - want[2]).abs()
           / want[2].abs().clamp_min(1e-300)).max().item()
    if got[2].dtype != torch.float64 or rel > rtol:
        raise AssertionError(f"stat tables: err differs by {rel:.3e} "
                             f"relative (limit {rtol:.0e})")
    return got, rel


def profile_shape(name, dev, card, seed=0):
    """Check and time one of SHAPES; prints its line and returns {"device_ms",
    "python_ms", "plain_ms", "bound_ms", "rel"}."""
    planes, depth, N, dtype, intra = SHAPES[name]
    bounds, n, ncol = band_bounds(planes, depth)
    flat = make_coeffs(bounds, depth, n, N, seed, dtype, intra).to(dev)
    _, rel = check(flat, bounds, ncol, intra)
    args = (flat, bounds, ncol, intra)
    device = graph_ms(rc.band_counts, args)
    python = time_ms(rc.band_counts, args)
    plain = time_ms(rc.band_counts_plain, args, iters=3, warmups=1)
    bound, by = bound_ms(N, n, flat.element_size(), ncol)
    print(f"stat_tables {name} ({N} x {n} {str(dtype)[6:]}, {ncol} "
          f"columns): kernel == plain (err within {rel:.2e}); device "
          f"{device:.4f} ms, from Python {python:.4f} ms, plain from Python "
          f"{plain:.3f} ms, bound {bound:.4f} ms by {by} "
          f"({bound / device:.1%} of it) [{card}]", flush=True)
    return {"device_ms": device, "python_ms": python, "plain_ms": plain,
            "bound_ms": bound, "rel": rel}


def main() -> int:
    card = gpu_line()
    if not torch.cuda.is_available():
        raise RuntimeError("needs an NVIDIA GPU: the stat tables kernel has "
                           "no CPU mode")
    dev = torch.device("cuda")
    for name in SHAPES:
        profile_shape(name, dev, card)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
