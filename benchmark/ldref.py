"""A plain reference of the VC-2 low-delay encoder's analysis of one
picture, in plain PyTorch integer tensors, written from SMPTE ST 2042-1
(VC-2) and the reference encoder's quantiser:

- the prepared plane: 2^(bit depth - 1) off every sample (128 at 8 bits),
  edge-extended to the padded size (each component's size rounded up to
  a multiple of 2^depth);
- the LeGall 5,3 forward transform: at each level the inverse of the
  standard's synthesis (vertical lifting, then horizontal, then the
  rounded shift right by one), so the sample shifted left by one, then
  horizontal analysis, then vertical; each lifting step the inverse of
  the standard's, with its edge positions clamped as the standard clamps
  them;
- the slices of each component in the standard's slice-band order: per
  slice (row sy, column sx of the grid), level 0's LL, then the HL, LH
  and HH bands of levels 1 (coarsest) to depth, each band's rectangle
  [h sy / ny, h (sy + 1) / ny) x [w sx / nx, w (sx + 1) / nx) in raster
  order;
- for each of the 61 base indices, each slice's signed interleaved
  exp-Golomb bit sum and the last nonzero position of its non-DC
  coefficients (every band but LL), under the dead-zone quantiser at the
  band's index max(base - quant matrix offset, 0): a magnitude m codes
  as 0 where 4 m is below the quant offset, else as (4 m - offset +
  factor / 2) // factor.

`analyse` returns what the port's `pipeline.make_lowdelay_analyze`
returns, as int64 tensors on the planes' device: the slices (ny, nx, S)
of Y, U and V, and per component (bits, last nonzero) (61, ny, nx),
the last -1 where a slice has no nonzero coefficient.

It imports nothing of the program, no kernel and no JAX; it evaluates
one base at a time over every slice of a component, with no chunking,
batching or cache.  Where it departs from the standard's text:

- the standard defines only the decoder; the prepared plane's edge
  extension, the dead-zone quantiser (its rounding, 4 m against the
  offset) and the bit count of each base are the reference encoder's
  (libschroedinger), not the text's;
- the slice grid is the deployment's: one slice per 2^depth x 2^depth
  block of the padded colour-difference picture, which the standard
  leaves to the encoder;
- only LeGall 5,3 (wavelet index 1) with its default quantisation
  matrices (depths 1 to 4), and slice grids that divide every band;
- everything is computed in int64, where the program computes 8-bit
  planes in int16 and deep ones in int32: the two agree wherever the
  program does not wrap.
"""
from __future__ import annotations

import numpy as np
import torch

# default LeGall 5,3 quantisation matrices by depth: level 0's LL, then
# (HL, LH, HH) of each level from 1 (the coarsest)
LEGALL_MATRICES = {
    1: [(4,), (2, 2, 0)],
    2: [(4,), (2, 2, 0), (4, 4, 2)],
    3: [(4,), (2, 2, 0), (4, 4, 2), (5, 5, 3)],
    4: [(4,), (2, 2, 0), (4, 4, 2), (5, 5, 3), (7, 7, 5)]}
BASES = 61
# vertical, horizontal chroma subsampling shifts
CHROMA_SHIFTS = {"444": (0, 0), "422": (0, 1), "420": (1, 1)}


def quant_factor(q):
    base = 1 << (q // 4)
    return (4 * base, (503829 * base + 52958) // 105917,
            (665857 * base + 58854) // 117708,
            (440253 * base + 32722) // 65444)[q % 4]


def quant_offset(q):
    """The intra (and low-delay) quantisation offset."""
    return 1 if q == 0 else 2 if q == 1 else (quant_factor(q) + 1) // 2


def padded(n, depth):
    return -(-n // (1 << depth)) << depth


def prepare(plane, bit_depth, height, width):
    """The plane less 2^(bit_depth - 1), edge-extended to (height,
    width)."""
    x = plane.to(torch.int64) - (1 << (bit_depth - 1))
    h, w = x.shape
    rows = torch.arange(height, device=x.device).clamp(max=h - 1)
    cols = torch.arange(width, device=x.device).clamp(max=w - 1)
    return x[rows][:, cols]


def analysis_1d(a):
    """One LeGall 5,3 analysis step along the last axis: (low, high), the
    inverse of the standard's synthesis (even samples lose (odd[n - 1] +
    odd[n] + 2) >> 2, then odd samples gain (even[n] + even[n + 1] + 1)
    >> 1; odd[-1] is odd[0], even[N] is even[N - 1])."""
    even, odd = a[..., 0::2], a[..., 1::2]
    nxt = torch.cat([even[..., 1:], even[..., -1:]], -1)
    odd = odd - ((even + nxt + 1) >> 1)
    prv = torch.cat([odd[..., :1], odd[..., :-1]], -1)
    even = even + ((prv + odd + 2) >> 2)
    return even, odd


def analysis_level(x):
    """One level: (LL, HL, LH, HH) of x, its sides even."""
    low, high = analysis_1d(x << 1)
    ll, lh = (t.T for t in analysis_1d(low.T))
    hl, hh = (t.T for t in analysis_1d(high.T))
    return ll, hl, lh, hh


def bands(x, depth):
    """The bands of a padded plane in the standard's order: LL, then
    (HL, LH, HH) of levels 1 (coarsest) to depth."""
    levels = []
    for _ in range(depth):
        x, hl, lh, hh = analysis_level(x)
        levels.append((hl, lh, hh))
    return [x] + [b for lev in reversed(levels) for b in lev]


def slices(band_list, ny, nx):
    """(ny, nx, S): every slice's coefficients in slice-band order (each
    band cut into its ny x nx rectangles, which divide it evenly)."""
    parts = []
    for b in band_list:
        h, w = b.shape
        parts.append(b.reshape(ny, h // ny, nx, w // nx).permute(0, 2, 1, 3)
                     .reshape(ny, nx, -1))
    return torch.cat(parts, -1)


def offsets(band_list, ny, nx, depth):
    """The quant matrix offset of each position of a slice."""
    matrix = [m for level in LEGALL_MATRICES[depth] for m in level]
    return torch.cat([torch.full((b.numel() // (ny * nx),), m,
                                 dtype=torch.int64)
                      for b, m in zip(band_list, matrix)])


def bit_length(v):
    """floor(log2(v)) + 1 of every element of a tensor of positive
    integers."""
    n = torch.zeros_like(v)
    while bool((v > 0).any()):
        n += (v > 0).to(torch.int64)
        v = v >> 1
    return n


def tables(sliced, offs, dcs):
    """(bits, last nonzero), each (61, ny, nx), of the non-DC positions
    (from `dcs` on) of one component's slices."""
    dev = sliced.device
    x = 4 * sliced[..., dcs:].abs()
    offs = offs[dcs:].to(dev)
    factor = torch.tensor([quant_factor(q) for q in range(BASES)],
                          device=dev)
    offset = torch.tensor([quant_offset(q) for q in range(BASES)],
                          device=dev)
    pos = torch.arange(x.shape[-1], device=dev)
    bits, last = [], []
    for base in range(BASES):
        qi = (base - offs).clamp(min=0)
        qf, qo = factor[qi], offset[qi]
        mag = torch.where(x < qo, 0, (x - qo + qf // 2) // qf)
        nz = mag != 0
        bits.append((2 * bit_length(mag + 1) - 1 + nz.to(torch.int64))
                    .sum(-1))
        last.append(torch.where(nz, pos, -1).amax(-1))
    return torch.stack(bits), torch.stack(last)


def analyse(planes, bit_depth, chroma, depth, device=None):
    """The analysis of one picture's (y, u, v) planes (tensors, or NumPy
    arrays of unsigned samples) at `bit_depth`, `chroma` ("444", "422"
    or "420") and LeGall 5,3 at `depth`, on `device` (None: the planes'
    own): (y_slices, u_slices, v_slices, (y_bits, y_last), (u_bits,
    u_last), (v_bits, v_last))."""
    planes = [(p if torch.is_tensor(p)
               else torch.from_numpy(np.asarray(p, np.int64))).to(device)
              for p in planes]
    vs, hs = CHROMA_SHIFTS[chroma]
    h, w = planes[0].shape
    ch, cw = h >> vs, w >> hs
    ny, nx = padded(ch, depth) >> depth, padded(cw, depth) >> depth
    out, agg = [], []
    for k, p in enumerate(planes):
        ph, pw = (h, w) if k == 0 else (ch, cw)
        bl = bands(prepare(p, bit_depth, padded(ph, depth),
                           padded(pw, depth)), depth)
        sliced = slices(bl, ny, nx)
        out.append(sliced)
        agg.append(tables(sliced, offsets(bl, ny, nx, depth),
                          bl[0].numel() // (ny * nx)))
    return tuple(out) + tuple(agg)
