"""The 61-way stat-table sums on the card.

`band_counts` launches the hand-written kernel `csrc/stat_tables.cu`
(built and bound by `ops/cuda_build.py`) on CUDA tensors.  It computes
what `encoder/ratecontrol.band_counts_plain`, the plain PyTorch version
and the reference of the CPU tests, computes: per picture, quant index
and column, the magnitude bits and the nonzero count of the quantised
coefficients (int64, exact) and the float64 sum of the float32 error
terms.  `encoder/ratecontrol.band_counts` takes the kernel for every
CUDA tensor and the plain version for any other; this wrapper
launches or raises.

Nothing is uploaded per call: the per-index constants (`quant_constants`)
and each bounds list's tile layout (`layout`) and column sizes
(`column_sizes`) are made on the host once and kept on their device.
The counter `stat_table_launches` (`utils.telemetry.counters`) counts
the calls that launched the kernel (its partial sums and their reduce),
and nothing else.
"""
from __future__ import annotations

import numpy as np
import torch

from schroedinger_tpu_torch import tables
from schroedinger_tpu_torch.ops import cuda_build
from schroedinger_tpu_torch.utils.telemetry import counters

N_QUANT = 61
# coefficients of one block of the kernel's first pass (128 threads x 16)
TILE = 2048
# the numerators 4|v| - qo + qf/2 the division constants are exact for:
# every |v| < 2^24
NUMERATOR_BITS = 27
# pow_mode of the kernel: the compiled power (the default error power),
# any integral power 1-16 at run time, powf
_COMPILED_POWER = 4
_POW_RUNTIME = 0
_POW_FLOAT = -1

# (device, ...) -> constants on that device; filled once per key (a race
# between threads uploads the same values twice, which is harmless)
_CONSTS = {}


def magic_divisor(d: int):
    """(m, s) with floor(x / d) == (x * m) >> (32 + s) for every x <
    2^NUMERATOR_BITS: m = ceil(2^k / d) at k = max(32, NUMERATOR_BITS +
    ceil(log2 d)), so m * d - 2^k < d and x (m d - 2^k) < 2^k, and m <
    2^31.  The kernel takes it as __umulhi(x, m) >> s."""
    k = max(32, NUMERATOR_BITS + (d - 1).bit_length())
    return -(-(1 << k) // d), k - 32


def quant_constants(intra: bool) -> np.ndarray:
    """(61, 4) int32: each quant index's factor, its intra or inter
    offset, and the magic multiplier and shift of the division by the
    factor."""
    qo = tables.QUANT_OFFSET_1_2 if intra else tables.QUANT_OFFSET_3_8
    out = np.zeros((N_QUANT, 4), np.int64)
    for q in range(N_QUANT):
        qf = int(tables.QUANT_FACTOR[q])
        out[q] = (qf, int(qo[q]), *magic_divisor(qf))
    return out.astype(np.int32)


def layout(bounds, ncol: int, n: int, vec: int):
    """The kernel's work of a bounds list [(column, lo, hi)] over pictures
    of n coefficients read `vec` at a time (16 bytes).  Each slice takes
    ceil((hi - lo + vec - 1) / TILE) tiles, since its first window starts
    at the 16-byte boundary at or before lo, up to vec - 1 coefficients
    early.  Returns (tiles (ntiles, 3) int32 of (lo, hi, tile number in
    its slice), col_ptr (ncol + 1,) int32, col_segs (slices, 2) int32 of
    (first tile, end tile)): the tiles of column c are the col_segs rows
    col_ptr[c]:col_ptr[c + 1], slices in bounds order.  Raises on a slice
    outside the picture or a column outside 0..ncol-1."""
    tiles = []
    segs = [[] for _ in range(ncol)]
    for col, lo, hi in bounds:
        if not (0 <= col < ncol and 0 <= lo <= hi <= n):
            raise ValueError(f"stat tables: slice {(col, lo, hi)} outside "
                             f"{ncol} columns of {n} coefficients")
        count = -(-(hi - lo + vec - 1) // TILE) if hi > lo else 0
        segs[col].append((len(tiles), len(tiles) + count))
        tiles += [(lo, hi, k) for k in range(count)]
    col_ptr = np.cumsum([0] + [len(s) for s in segs])
    col_segs = [s for per_col in segs for s in per_col]
    return (np.asarray(tiles, np.int32).reshape(-1, 3),
            col_ptr.astype(np.int32),
            np.asarray(col_segs, np.int32).reshape(-1, 2))


def column_sizes(bounds, ncol: int, device) -> torch.Tensor:
    """(ncol,) float32 on `device`: the coefficients of each column, over
    all its slices; made once per device and bounds list."""
    key = ("nvec", device, tuple(bounds), ncol)
    hit = _CONSTS.get(key)
    if hit is None:
        nvec = np.zeros(ncol, np.float32)
        for col, lo, hi in bounds:
            nvec[col] += hi - lo
        hit = _CONSTS[key] = torch.as_tensor(nvec, device=device)
    return hit


def _device_consts(device, intra, bounds, ncol, n, vec):
    qkey = ("quant", device, intra)
    qtab = _CONSTS.get(qkey)
    if qtab is None:
        qtab = _CONSTS[qkey] = torch.as_tensor(quant_constants(intra),
                                               device=device)
    lkey = ("layout", device, tuple(bounds), ncol, n, vec)
    lay = _CONSTS.get(lkey)
    if lay is None:
        tiles, col_ptr, col_segs = layout(bounds, ncol, n, vec)
        flat = torch.as_tensor(np.concatenate(
            [tiles.reshape(-1), col_ptr, col_segs.reshape(-1)]),
            device=device)
        a, b = tiles.size, tiles.size + col_ptr.size
        lay = _CONSTS[lkey] = (len(tiles), flat[:a], flat[a:b], flat[b:])
    return qtab, lay


def _pow_mode(ip):
    """The kernel's pow_mode for error_metric's decision `ip` (the
    integral power 1-16, or None for a power it raises with `**`)."""
    if ip is None:
        return _POW_FLOAT
    return ip if ip == _COMPILED_POWER else _POW_RUNTIME


def band_counts(allflat, bounds, ncol: int, intra: bool, error_power: float,
                ip):
    """The kernel's (mag, nz, err), each (N, 61, ncol), of an (N, n)
    int16 or int32 CUDA tensor (contiguous, 16-byte aligned); bounds and
    the sums as ratecontrol.band_counts_plain.  `ip` is error_metric's
    integral power (1-16) or None.  Exact for every |v| < 2^24."""
    dev = allflat.device
    if dev.type != "cuda":
        raise ValueError(f"stat tables kernel: tensor on {dev}, expected "
                         "cuda")
    if allflat.dtype not in (torch.int16, torch.int32):
        raise TypeError(f"stat tables kernel: {allflat.dtype}, expected "
                        "int16 or int32")
    if allflat.ndim != 2:
        raise ValueError(f"stat tables kernel: shape {tuple(allflat.shape)},"
                         " expected (N, n)")
    if not allflat.is_contiguous():
        raise ValueError("stat tables kernel: input is not contiguous")
    if allflat.data_ptr() % 16:
        raise ValueError("stat tables kernel: input is not 16-byte aligned")
    N, n = allflat.shape
    if not 0 < N <= 65535 or n >= 2 ** 31 or ncol <= 0:
        raise ValueError(f"stat tables kernel: {N} pictures of {n} "
                         f"coefficients, {ncol} columns")
    es = allflat.element_size()
    qtab, (ntiles, tiles, col_ptr, col_segs) = _device_consts(
        dev, bool(intra), bounds, ncol, n, 16 // es)
    part_bits = torch.empty(N * ntiles * N_QUANT * 2, dtype=torch.int32,
                            device=dev)
    part_err = torch.empty(N * ntiles * N_QUANT, dtype=torch.float64,
                           device=dev)
    counts = torch.empty((2, N, N_QUANT, ncol), dtype=torch.int64,
                         device=dev)
    err = torch.empty((N, N_QUANT, ncol), dtype=torch.float64, device=dev)
    rc = cuda_build.load().stat_tables_launch(
        es, _pow_mode(ip), ip or 0, float(error_power), N, n,
        allflat.data_ptr(), qtab.data_ptr(), tiles.data_ptr(), ntiles,
        col_ptr.data_ptr(), col_segs.data_ptr(), ncol, part_bits.data_ptr(),
        part_err.data_ptr(), counts[0].data_ptr(), counts[1].data_ptr(),
        err.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"stat tables kernel launch failed: error {rc}")
    counters.add("stat_table_launches")
    return counts[0], counts[1], err


def launches() -> int:
    """The stat tables kernel's launches so far in this process (the
    counter `stat_table_launches`)."""
    return counters.snapshot().get("stat_table_launches", 0)
