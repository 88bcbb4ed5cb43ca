"""Host-side bit-level I/O: Dirac VLC (interleaved exp-Golomb) pack/unpack.

Semantics match the reference packer/unpacker:
- bits are written MSB-first within bytes (schropack.c schro_pack_encode_bit)
- uint coding is interleaved exp-Golomb: for value v, t = v+1 with n bits;
  emit (0, data-bit) pairs for the n-1 low bits of t (MSB first), then 1
  (schropack.c:149-161)
- sint appends a sign bit (1 = negative) when magnitude != 0
- the reader supports a guard bit: reads past the end return the guard bit
  pattern (schrounpack.h:10-28), which makes trailing-zero elision work.

Used for headers and as the scalar reference for the vectorized VLC engine.

Whole copy of `schroedinger_tpu/coding/bitio.py`: the port imports nothing of
the JAX package, and later slices find their entry points here.
"""
from __future__ import annotations


class BitWriter:
    def __init__(self):
        self._bytes = bytearray()
        self._cur = 0
        self._nbits = 0  # bits used in _cur (from MSB)

    def write_bit(self, b: int) -> None:
        self._cur |= (b & 1) << (7 - self._nbits)
        self._nbits += 1
        if self._nbits == 8:
            self._bytes.append(self._cur)
            self._cur = 0
            self._nbits = 0

    def write_bits(self, n: int, v: int) -> None:
        for i in range(n - 1, -1, -1):
            self.write_bit((v >> i) & 1)

    def write_uint(self, v: int) -> None:
        t = v + 1
        n = t.bit_length()
        for i in range(n - 2, -1, -1):
            self.write_bit(0)
            self.write_bit((t >> i) & 1)
        self.write_bit(1)

    def write_sint(self, v: int) -> None:
        m = -v if v < 0 else v
        self.write_uint(m)
        if m:
            self.write_bit(1 if v < 0 else 0)

    def write_bytes(self, data: bytes) -> None:
        """Bulk byte append (payload copy after sync; schro_pack_append)."""
        if self._nbits == 0:
            self._bytes += data
        else:
            for byte in data:
                self.write_bits(8, byte)

    def sync(self) -> None:
        """Byte-align (pad with zero bits) — schro_pack_sync."""
        if self._nbits:
            self._bytes.append(self._cur)
            self._cur = 0
            self._nbits = 0

    @property
    def bit_position(self) -> int:
        return len(self._bytes) * 8 + self._nbits

    def get_bytes(self) -> bytes:
        assert self._nbits == 0, "unsynced bitstream"
        return bytes(self._bytes)


def uint_bits(v: int) -> int:
    return 2 * (v + 1).bit_length() - 1


def sint_bits(v: int) -> int:
    m = -v if v < 0 else v
    return uint_bits(m) + (1 if m else 0)


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
