"""Host-side bit-level I/O: Dirac VLC (interleaved exp-Golomb) pack/unpack.

Semantics match the reference packer/unpacker:
- bits are written MSB-first within bytes (schropack.c schro_pack_encode_bit)
- uint coding is interleaved exp-Golomb: for value v, t = v+1 with n bits;
  emit (0, data-bit) pairs for the n-1 low bits of t (MSB first), then 1
  (schropack.c:149-161)
- sint appends a sign bit (1 = negative) when magnitude != 0
- the reader supports a guard bit: reads past the end return the guard bit
  pattern (schrounpack.h:10-28), which makes trailing-zero elision work.

A frozen copy of the port's `coding/bitio.py`.
"""
from __future__ import annotations


class BitReader:
    def __init__(self, data: bytes, guard_bit: int = 1):
        self._data = data
        self._pos = 0          # bit position
        self._limit = len(data) * 8
        self._guard = guard_bit & 1

    def copy(self) -> "BitReader":
        r = BitReader(self._data, self._guard)
        r._pos = self._pos
        r._limit = self._limit
        return r

    @property
    def bits_read(self) -> int:
        return self._pos

    def bits_remaining(self) -> int:
        return max(0, self._limit - self._pos)

    def limit_bits(self, n: int) -> None:
        self._limit = min(self._limit, self._pos + n)

    def skip_bits(self, n: int) -> None:
        self._pos += n

    def read_bit(self) -> int:
        if self._pos >= self._limit:
            self._pos += 1
            return self._guard
        b = (self._data[self._pos >> 3] >> (7 - (self._pos & 7))) & 1
        self._pos += 1
        return b

    def read_bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.read_bit()
        return v

    def read_uint(self) -> int:
        v = 1
        while self.read_bit() == 0:
            v = (v << 1) | self.read_bit()
        return v - 1

    def read_sint(self) -> int:
        m = self.read_uint()
        if m and self.read_bit():
            return -m
        return m

    def sync(self) -> None:
        """Advance to the next byte boundary."""
        self._pos = (self._pos + 7) & ~7
