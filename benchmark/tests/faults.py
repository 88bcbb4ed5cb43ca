"""Faults planted in the program's outputs where they are produced, for
the tests that see `correct` come out false and for the readings of the
numbers they move (`read_limits.py`): a token altered ("token"), a step
that returns its state unchanged ("stale": each pass gives the previous
pass's stream again) and half of a batch left out ("half": every other B
picture dropped).  `plant` wraps the harness's factory of the program's
encoders."""
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


class _Encoder:
    def __init__(self, enc, fault, state):
        self._enc, self._fault, self._state = enc, fault, state

    def encode_stream(self, frames):
        s = self._enc.encode_stream(frames)
        if self._fault == "token":
            return _flip(s)
        if self._fault == "half":
            return _drop_b_half(s)
        if self._fault == "stale":
            last, self._state["last"] = self._state.get("last"), s
            return last or s
        return s


FAULTS = {"dirac-longgop-1080p25-cbr8m.encode-pan": (
    "token", "half", "stale")}


def plant(fault, cell, setattr_=setattr):
    """Wrap the factory so that every encoder made from now on has the
    fault."""
    assert fault in FAULTS[cell], (fault, cell)
    make = hc.Codec.new_encoder
    state = {}
    setattr_(hc.Codec, "new_encoder",
             lambda self: _Encoder(make(self), fault, state))
