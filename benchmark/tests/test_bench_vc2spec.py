"""The spec-level VC-2 low-delay decoder (`vc2spec.py`) on its own: its
inverse transform undoes a LeGall 5,3 analysis written here, its bounded
slice reads give back what a writer written here packed, and, as a
witness, the program's eight-bit low-delay stream decodes in it sample
for sample as in the program's own decoder."""
import numpy as np
import pytest

import vc2spec
import vc2_conformance


def _analysis_1d(a, axis):
    """LeGall 5,3 analysis along `axis`, in place: the synthesis's steps
    undone in the reverse order."""
    v = np.moveaxis(a, axis, 0)
    e, o = v[0::2], v[1::2]
    o -= (e + np.concatenate([e[1:], e[-1:]]) + 1) >> 1
    e += (np.concatenate([o[:1], o[:-1]]) + o + 2) >> 2


def _forward(x, depth):
    bands, ll = {}, x.astype(np.int64)
    for lev in range(depth, 0, -1):
        a = ll << 1
        _analysis_1d(a, 1)
        _analysis_1d(a, 0)
        bands[(lev, 0)] = a[0::2, 1::2]
        bands[(lev, 1)] = a[1::2, 0::2]
        bands[(lev, 2)] = a[1::2, 1::2]
        ll = a[0::2, 0::2]
    bands[(0, 0)] = ll
    return bands


@pytest.mark.parametrize("shape,depth", [((64, 128), 3), ((32, 96), 4),
                                         ((16, 16), 1)])
def test_inverse_undoes_the_analysis(shape, depth):
    x = np.random.default_rng(7).integers(-512, 512, shape)
    assert np.array_equal(vc2spec.inverse_legall(_forward(x, depth), depth),
                          x)


def _sint_bits(v):
    """Signed interleaved exp-Golomb code of v, as bits."""
    t = abs(v) + 1
    bits = []
    for i in range(t.bit_length() - 2, -1, -1):
        bits += [0, (t >> i) & 1]
    bits.append(1)
    if v:
        bits.append(1 if v < 0 else 0)
    return bits


def test_bounded_reads_give_back_the_values():
    rng = np.random.default_rng(3)
    blocks = [rng.integers(-300, 300, 40) * (rng.random(40) < 0.6)
              for _ in range(5)]
    blocks[2][-7:] = 0                   # trailing zeros, left unwritten
    blocks[4][:] = 0                     # an empty block
    bits, starts, ends = [], [], []
    for vals in blocks:
        last = max([i for i, v in enumerate(vals) if v] or [-1])
        starts.append(len(bits))
        for v in vals[:last + 1]:
            bits += _sint_bits(int(v))
        ends.append(len(bits))
        bits += [0, 1, 0, 0, 1]          # what lies between two blocks
    lanes = vc2spec._Lanes(np.array(bits, dtype=np.uint8))
    got = lanes.read(np.array(starts), np.array(ends), 40)
    assert np.array_equal(got.T, np.array(blocks))


def test_the_programs_eight_bit_stream_decodes_alike():
    out = vc2_conformance.compare(2**31 + 21, 8, 2, "cpu", size=(128, 64))
    assert out["differing"] == [0, 0, 0], out
