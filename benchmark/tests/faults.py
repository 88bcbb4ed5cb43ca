"""Faults planted in the program's outputs where they are produced, for
the tests that see `correct` come out false and for the readings of the
numbers they move (`read_limits.py`, `read_lowdelay.py`): a token altered
("token"), a step that returns its state unchanged ("stale": each pass
gives the previous pass's stream again) and half of a batch left out
("half": every other B picture dropped).  In a low-delay stream: a byte of
the middle slice of every picture altered ("slice"), the middle picture
dropped ("drop"), 16 bytes more after the middle picture's slices ("pad",
past the budget), the encoder at a transform depth of 3 ("depth3") and
every source sample the encoder receives raised by a quarter of the
range, 2^(bit depth - 2), clipped at the top ("offset": the check still
compares against the clip as made).  `plant` wraps the harness's factory
of the program's encoders."""
import copy

import numpy as np

import vc2spec
from harness import codec as hc


def _picture_units(stream):
    """(offset, length, parse code) of each picture unit of a stream."""
    from refcodec import bitstream as rbs
    out, pos = [], 0
    while pos + 13 <= len(stream) and stream[pos:pos + 4] == b"BBCD":
        code = stream[pos + 4]
        nxt = int.from_bytes(stream[pos + 5:pos + 9], "big")
        size = nxt or len(stream) - pos
        if rbs.is_picture(code):
            out.append((pos, size, code))
        if nxt == 0:
            break
        pos += nxt
    return out


def _flip(stream):
    """The stream with one byte of its largest picture's data altered."""
    pos, size, _ = max(_picture_units(stream), key=lambda u: u[1])
    b = bytearray(stream)
    b[pos + size * 3 // 4] ^= 0x5A
    return bytes(b)


def _drop_b_half(stream):
    """The stream without every other non-reference (B) picture."""
    from refcodec import bitstream as rbs
    units = [u for u in _picture_units(stream)
             if not rbs.is_reference(u[2])]
    b = bytearray(stream)
    for pos, size, _ in reversed(units[::2]):
        # an unparseable unit in place: its picture is gone
        b[pos + 13:pos + size] = bytes(size - 13)
    return bytes(b)


def _flip_slices(stream):
    """The low-delay stream with a byte of each picture's middle slice
    altered (the fourth, after the slice's quantiser and length)."""
    b = bytearray(stream)
    for pos, size, _ in _picture_units(stream):
        _, tp, off = vc2spec.picture_parameters(stream[pos + 13:pos + size])
        nb = vc2spec.slice_bytes(tp)
        b[pos + 13 + off + int(nb[:len(nb) // 2].sum()) + 3] ^= 0x5A
    return bytes(b)


def _middle_picture(stream):
    units = _picture_units(stream)
    return units[len(units) // 2][:2]


def _drop_picture(stream):
    """The low-delay stream without its middle picture; the unit before
    it, a sequence header, then leads to the one after it."""
    pos, size = _middle_picture(stream)
    return stream[:pos] + stream[pos + size:]


def _pad_picture(stream, extra=16):
    """The low-delay stream with `extra` bytes after the middle picture's
    slices, its parse info's offsets moved to match."""
    pos, size = _middle_picture(stream)
    b = bytearray(stream[:pos + size] + bytes(extra) + stream[pos + size:])
    b[pos + 5:pos + 9] = (size + extra).to_bytes(4, "big")
    nxt = pos + size + extra
    b[nxt + 9:nxt + 13] = (size + extra).to_bytes(4, "big")
    return bytes(b)


def _raise_samples(frames, bit_depth):
    """The frames with every sample raised by 2^(bit_depth - 2), clipped
    at the top of the range."""
    up, top = 1 << (bit_depth - 2), (1 << bit_depth) - 1
    return [tuple(np.minimum(p.astype(np.int32) + up, top).astype(p.dtype)
                  for p in f) for f in frames]


class _Encoder:
    def __init__(self, enc, fault, state, bit_depth):
        self._enc, self._fault, self._state = enc, fault, state
        self._bit_depth = bit_depth

    def encode_stream(self, frames):
        if self._fault == "offset":
            frames = _raise_samples(frames, self._bit_depth)
        s = self._enc.encode_stream(frames)
        if self._fault == "token":
            return _flip(s)
        if self._fault == "half":
            return _drop_b_half(s)
        if self._fault == "slice":
            return _flip_slices(s)
        if self._fault == "drop":
            return _drop_picture(s)
        if self._fault == "pad":
            return _pad_picture(s)
        if self._fault == "stale":
            last, self._state["last"] = self._state.get("last"), s
            return last or s
        return s


FAULTS = {"dirac-longgop-1080p25-cbr8m.encode-pan": (
    "token", "half", "stale"),
    "vc2-lowdelay-1080p25-422p10.encode-file": (
    "slice", "stale", "drop", "pad", "depth3", "offset")}


def plant(fault, cell, setattr_=setattr):
    """Wrap the factory so that every encoder made from now on has the
    fault."""
    assert fault in FAULTS[cell], (fault, cell)
    make = hc.Codec.new_encoder
    state = {}
    if fault == "depth3":
        def at_depth3(codec):
            codec = copy.copy(codec)
            codec.settings = dict(codec.settings, transform_depth=3)
            return codec
        setattr_(hc.Codec, "new_encoder", lambda self: make(at_depth3(self)))
        return
    setattr_(hc.Codec, "new_encoder",
             lambda self: _Encoder(make(self), fault, state,
                                   self.bit_depth))
