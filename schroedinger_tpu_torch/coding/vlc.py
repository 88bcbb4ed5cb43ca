"""Vectorized Dirac VLC (interleaved exp-Golomb) engine — numpy host path.

Encodes/decodes many independent coefficient streams (VC-2 slices, no-arith
codeblocks) without per-symbol Python loops:

- encode: per-value codeword + bit length computed with Morton bit-spreading,
  then one ragged scatter into the output bit array (O(total_bits) numpy).
- decode: lockstep across streams — every step decodes one symbol in every
  stream by fetching a 64-bit window at each stream's bit cursor.

Bit/codeword semantics match coding/bitio.py (reference: schropack.c,
schrounpack.c), including guard-bit behavior (reads past a limit return 1s,
which decode as zero).

Whole copy of `schroedinger_tpu/coding/vlc.py`: the port imports nothing of
the JAX package, and later slices find their entry points here.
"""
from __future__ import annotations

import numpy as np

_U64 = np.uint64


def _spread_even(x):
    """Morton spread: bit j of x -> bit 2j of result (uint64 in/out)."""
    x = x.astype(_U64)
    x = (x | (x << _U64(16))) & _U64(0x0000FFFF0000FFFF)
    x = (x | (x << _U64(8))) & _U64(0x00FF00FF00FF00FF)
    x = (x | (x << _U64(4))) & _U64(0x0F0F0F0F0F0F0F0F)
    x = (x | (x << _U64(2))) & _U64(0x3333333333333333)
    x = (x | (x << _U64(1))) & _U64(0x5555555555555555)
    return x


def _compress_even(x):
    """Inverse of _spread_even: bit 2j -> bit j."""
    x = x & _U64(0x5555555555555555)
    x = (x | (x >> _U64(1))) & _U64(0x3333333333333333)
    x = (x | (x >> _U64(2))) & _U64(0x0F0F0F0F0F0F0F0F)
    x = (x | (x >> _U64(4))) & _U64(0x00FF00FF00FF00FF)
    x = (x | (x >> _U64(8))) & _U64(0x0000FFFF0000FFFF)
    x = (x | (x >> _U64(16))) & _U64(0x00000000FFFFFFFF)
    return x


def _bitlen(x):
    """Exact bit length of uint64 values (x < 2^53 guaranteed by callers)."""
    x = np.asarray(x, dtype=np.uint64)
    out = np.zeros(x.shape, dtype=np.int64)
    nz = x > 0
    out[nz] = np.floor(np.log2(x[nz].astype(np.float64))).astype(np.int64) + 1
    return out


def sint_bits(q):
    """Per-value encoded bit length of sint VLC (schro_pack_estimate_sint)."""
    m = np.abs(q.astype(np.int64))
    n = _bitlen(m + 1)
    return 2 * n - 1 + (m != 0)


def sint_codes(q):
    """(codeword uint64, bit length) per value. MSB of the codeword stream is
    at bit position (length-1); i.e. codeword is right-aligned."""
    m = np.abs(q.astype(np.int64)).astype(np.uint64)
    t = m + _U64(1)
    n = _bitlen(t)                       # bit length of t
    rest = t ^ (_U64(1) << (n - 1).astype(_U64))  # strip top bit
    code = (_spread_even(rest) << _U64(1)) | _U64(1)
    length = 2 * n - 1
    sign = (np.asarray(q) < 0).astype(_U64)
    has_sign = m != 0
    code = np.where(has_sign, (code << _U64(1)) | sign, code)
    length = length + has_sign
    return code, length.astype(np.int64)


def pack_streams(codes, lengths, stream_starts, capacities_bits):
    """Pack variable-length codes into back-to-back fixed-capacity streams.

    codes/lengths: flat arrays of codewords; stream s owns the slice
    [stream_starts[s], stream_starts[s+1]).  Each stream occupies exactly
    capacities_bits[s] bits in the output; unused bits are filled with 1s
    (decodes as zeros).  Total capacity must be a multiple of 8.

    Returns the packed bytes.
    """
    codes = np.asarray(codes, dtype=_U64)
    lengths = np.asarray(lengths, dtype=np.int64)
    stream_starts = np.asarray(stream_starts, dtype=np.int64)
    capacities = np.asarray(capacities_bits, dtype=np.int64)
    n_streams = len(capacities)

    stream_base = np.concatenate([[0], np.cumsum(capacities)])
    total_bits = int(stream_base[-1])
    assert total_bits % 8 == 0

    # bit offset of each value: stream base + within-stream cumsum
    cum = np.concatenate([[0], np.cumsum(lengths)])
    # cum at the start of each stream
    stream_cum0 = cum[stream_starts[:-1]] if len(stream_starts) > 1 else cum[:1]
    owner = np.repeat(np.arange(n_streams),
                      np.diff(stream_starts))
    offsets = stream_base[owner] + (cum[:-1] - stream_cum0[owner])

    used = cum[stream_starts[1:]] - cum[stream_starts[:-1]]
    if np.any(used > capacities):
        bad = int(np.argmax(used > capacities))
        raise ValueError(f"stream {bad} overflows: {used[bad]} > {capacities[bad]} bits")

    out_bits = np.ones(total_bits, dtype=np.uint8)
    total_code_bits = int(lengths.sum())
    if total_code_bits:
        owners_per_bit = np.repeat(np.arange(len(codes)), lengths)
        starts_per_bit = np.repeat(offsets, lengths)
        lens_per_bit = np.repeat(lengths, lengths)
        idx_within = np.arange(total_code_bits) - np.repeat(
            np.concatenate([[0], np.cumsum(lengths)])[:-1], lengths)
        shift = (lens_per_bit - 1 - idx_within).astype(np.uint64)
        bitvals = ((codes[owners_per_bit] >> shift) & _U64(1)).astype(np.uint8)
        out_bits[starts_per_bit + idx_within] = bitvals
    return np.packbits(out_bits).tobytes()


def _popcount64(x):
    x = x.astype(_U64)
    x = x - ((x >> _U64(1)) & _U64(0x5555555555555555))
    x = (x & _U64(0x3333333333333333)) + ((x >> _U64(2)) & _U64(0x3333333333333333))
    x = (x + (x >> _U64(4))) & _U64(0x0F0F0F0F0F0F0F0F)
    return (x * _U64(0x0101010101010101)) >> _U64(56)


def _clz64(x):
    """Exact count of leading zeros (returns 64 for x == 0)."""
    x = x.astype(_U64)
    y = x.copy()
    for s in (1, 2, 4, 8, 16, 32):
        y |= y >> _U64(s)
    return (64 - _popcount64(y)).astype(np.int64)


class LockstepDecoder:
    """Decode sint symbols from many independent bitstreams in lockstep.

    data: the packed byte buffer.
    offsets: per-stream current bit positions (absolute, int64).
    limits: per-stream absolute bit limits; reads at/past the limit see 1s
            (the guard pattern), decoding as zeros.
    """

    def __init__(self, data: bytes, offsets, limits):
        pad = np.full(9, 0xFF, dtype=np.uint8)
        self._bytes = np.concatenate([np.frombuffer(data, dtype=np.uint8), pad])
        self._nbits = len(data) * 8
        self.offsets = np.asarray(offsets, dtype=np.int64).copy()
        self.limits = np.asarray(limits, dtype=np.int64).copy()

    def _window(self):
        """64-bit MSB-aligned window at each stream's cursor, guard-masked."""
        o = self.offsets
        byte0 = np.minimum(o >> 3, self._nbits // 8)  # clamped into padded buf
        idx = byte0[:, None] + np.arange(9)
        idx = np.minimum(idx, len(self._bytes) - 1)
        chunk = self._bytes[idx].astype(_U64)  # (n, 9)
        hi = np.zeros(len(o), dtype=_U64)
        for k in range(8):
            hi = (hi << _U64(8)) | chunk[:, k]
        sh = (o & 7).astype(_U64)
        w = np.where(sh > 0,
                     (hi << sh) | (chunk[:, 8] >> (_U64(8) - sh)),
                     hi)
        # guard: positions >= limit read as 1
        rem = np.clip(self.limits - o, 0, 64).astype(_U64)
        guard_mask = np.where(rem >= _U64(64), _U64(0),
                              (~_U64(0)) >> np.minimum(rem, _U64(63)))
        # rem==64 -> no guard; rem<64 -> low (64-rem) bits forced 1
        w = w | guard_mask
        return w

    def read_sints(self, active=None):
        """Decode one sint per stream; returns int64 values (0 where inactive)."""
        w = self._window()
        stop = w & _U64(0xAAAAAAAAAAAAAAAA)
        p = _clz64(stop)             # position of terminator bit (even index)
        npairs = p >> 1
        # prefix of p bits (the (0,b) pairs); data bits at even bits of prefix
        pre = np.where(p > 0, w >> (_U64(64) - p.astype(_U64)), _U64(0))
        data = _compress_even(pre)
        t = (np.int64(1) << npairs) | data.astype(np.int64)
        mag = t - 1
        consumed = p + 1
        # sign bit (only when magnitude != 0) at position p+1
        sign = ((w >> (_U64(62) - p.astype(_U64))) & _U64(1)).astype(np.int64)
        has_sign = mag != 0
        vals = np.where(has_sign & (sign == 1), -mag, mag)
        consumed = consumed + has_sign
        if active is not None:
            vals = np.where(active, vals, 0)
            consumed = np.where(active, consumed, 0)
        self.offsets = self.offsets + consumed
        return vals
