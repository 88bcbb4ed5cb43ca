"""A plain NumPy decoder of VC-2 low-delay streams, written from the
decoding process of SMPTE ST 2042-1 (parse info, sequence header, the
low-delay picture's transform parameters and slices, dequantisation, DC
prediction, the LeGall 5,3 inverse transform, offsetting and clipping).

It imports nothing of the program and shares no code with it: it is the
independent side against which the program's low-delay streams and
pictures are held.  It covers what the low-delay configurations code:
frames (not fields), the LeGall 5,3 wavelet (index 1) at any depth with
its default or a custom quantisation matrix, and slice grids that divide
every subband evenly.

One reading is not the standard's text: the width of a slice's
`slice_y_length` field.  It is read as floor(log2(8 * slice_bytes)) + 1
bits, as libschroedinger and FFmpeg's Dirac decoder read it; where a
slice's size is a power of two that is one bit more than
intlog2(8 * slice_bytes - 7).

The slices of a picture decode side by side: one lane per slice, one
step per coefficient, each step a few array operations over all lanes.
"""
from __future__ import annotations

import numpy as np

PARSE_INFO_BYTES = 13
SEQUENCE_HEADER = 0x00
END_OF_SEQUENCE = 0x10

# base video formats: (width, height, colour difference format, frame
# rate (numerator, denominator), signal range (luma offset, luma
# excursion, colour difference offset and excursion)); format codes
# 0 = 4:4:4, 1 = 4:2:2, 2 = 4:2:0
_R8F, _R10V, _R12V = (0, 255, 128, 255), (64, 876, 512, 896), \
    (256, 3504, 2048, 3584)
BASE_FORMATS = [
    (640, 480, 2, (24000, 1001), _R8F), (176, 120, 2, (15000, 1001), _R8F),
    (176, 144, 2, (25, 2), _R8F), (352, 240, 2, (15000, 1001), _R8F),
    (352, 288, 2, (25, 2), _R8F), (704, 480, 2, (15000, 1001), _R8F),
    (704, 576, 2, (25, 2), _R8F), (720, 480, 1, (30000, 1001), _R10V),
    (720, 576, 1, (25, 1), _R10V), (1280, 720, 1, (60000, 1001), _R10V),
    (1280, 720, 1, (50, 1), _R10V), (1920, 1080, 1, (30000, 1001), _R10V),
    (1920, 1080, 1, (25, 1), _R10V), (1920, 1080, 1, (60000, 1001), _R10V),
    (1920, 1080, 1, (50, 1), _R10V), (2048, 1080, 0, (24, 1), _R12V),
    (4096, 2160, 0, (24, 1), _R12V), (3840, 2160, 1, (60000, 1001), _R10V),
    (3840, 2160, 1, (50, 1), _R10V), (7680, 4320, 1, (60000, 1001), _R10V),
    (7680, 4320, 1, (50, 1), _R10V)]
FRAME_RATES = {1: (24000, 1001), 2: (24, 1), 3: (25, 1), 4: (30000, 1001),
               5: (30, 1), 6: (50, 1), 7: (60000, 1001), 8: (60, 1),
               9: (15000, 1001), 10: (25, 2), 11: (48, 1)}
SIGNAL_RANGES = {1: _R8F, 2: (16, 219, 128, 224), 3: _R10V, 4: _R12V}
# default quantisation matrices of LeGall 5,3 by depth: level 0's LL,
# then (HL, LH, HH) of each level from 1
LEGALL_MATRICES = {
    1: [(4,), (2, 2, 0)],
    2: [(4,), (2, 2, 0), (4, 4, 2)],
    3: [(4,), (2, 2, 0), (4, 4, 2), (5, 5, 3)],
    4: [(4,), (2, 2, 0), (4, 4, 2), (5, 5, 3), (7, 7, 5)]}
LEGALL = 1


def is_ld_picture(code):
    """Low-delay picture parse codes: a picture (0x08) with the low-delay
    bit (0x80) and no references; VC-2 names 0xC8, Dirac also 0x88, and
    0x8C / 0xCC for an intra picture kept for reference."""
    return code & 0x8B == 0x88


def intlog2(n):
    """ceil(log2(n)) for n >= 1."""
    return (int(n) - 1).bit_length()


def quant_factor(q):
    base = 1 << (q // 4)
    return (4 * base, (503829 * base + 52958) // 105917,
            (665857 * base + 58854) // 117708,
            (440253 * base + 32722) // 65444)[q % 4]


def quant_offset(q):
    return 1 if q == 0 else 2 if q == 1 else (quant_factor(q) + 1) // 2


QF = np.array([quant_factor(q) for q in range(128)], dtype=np.int64)
QO = np.array([quant_offset(q) for q in range(128)], dtype=np.int64)


class Bits:
    """MSB-first reader of header fields."""

    def __init__(self, data):
        self.d, self.p = data, 0

    def bit(self):
        b = (self.d[self.p >> 3] >> (7 - (self.p & 7))) & 1
        self.p += 1
        return b

    def nbits(self, n):
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bit()
        return v

    def uint(self):
        """Interleaved exp-Golomb: a 0 says a data bit follows."""
        v = 1
        while not self.bit():
            v = (v << 1) | self.bit()
        return v - 1

    def align(self):
        self.p = (self.p + 7) & ~7


def parse_units(stream):
    """[(parse code, unit bytes after the parse info)], following each
    parse info's next offset; raises where a prefix is not 'BBCD'."""
    out, pos = [], 0
    while pos < len(stream):
        if stream[pos:pos + 4] != b"BBCD":
            raise ValueError(f"no parse info prefix at byte {pos}")
        code = stream[pos + 4]
        nxt = int.from_bytes(stream[pos + 5:pos + 9], "big")
        end = pos + nxt if nxt else len(stream)
        if code == END_OF_SEQUENCE:
            end = pos + PARSE_INFO_BYTES
        out.append((code, stream[pos + PARSE_INFO_BYTES:end]))
        if code == END_OF_SEQUENCE or nxt == 0:
            break
        pos = end
    return out


def sequence_header(data):
    """The fields of a sequence header that decoding needs, as a dict."""
    r = Bits(data)
    version = (r.uint(), r.uint())
    profile, level = r.uint(), r.uint()
    base = r.uint()
    w, h, chroma, rate, sig = BASE_FORMATS[base]
    if r.bit():
        w, h = r.uint(), r.uint()
    if r.bit():
        chroma = r.uint()
    if r.bit():
        r.uint()                    # source sampling
    if r.bit():
        i = r.uint()
        rate = FRAME_RATES[i] if i else (r.uint(), r.uint())
    if r.bit():
        if r.uint() == 0:           # pixel aspect ratio
            r.uint(), r.uint()
    if r.bit():
        for _ in range(4):          # clean area
            r.uint()
    if r.bit():
        i = r.uint()
        sig = SIGNAL_RANGES[i] if i else tuple(r.uint() for _ in range(4))
    if r.bit():
        if r.uint() == 0:           # colour spec: primaries, matrix,
            for _ in range(3):      # transfer function
                if r.bit():
                    r.uint()
    coding_mode = r.uint()
    return {"version": version, "profile": profile, "level": level,
            "base_format": base, "width": w, "height": h, "chroma": chroma,
            "frame_rate": rate, "luma_offset": sig[0],
            "luma_excursion": sig[1], "chroma_offset": sig[2],
            "chroma_excursion": sig[3], "fields": coding_mode == 1,
            "luma_depth": intlog2(sig[1] + 1),
            "chroma_depth": intlog2(sig[3] + 1)}


def picture_parameters(data):
    """(picture number, transform parameters, byte offset of the slices)
    of a low-delay picture unit."""
    r = Bits(data)
    number = r.nbits(32)
    r.align()
    wavelet, depth = r.uint(), r.uint()
    tp = {"wavelet": wavelet, "depth": depth,
          "slices_x": r.uint(), "slices_y": r.uint(),
          "bytes_num": r.uint(), "bytes_den": r.uint()}
    if r.bit():
        m = [(r.uint(),)] + [(r.uint(), r.uint(), r.uint())
                             for _ in range(depth)]
    else:
        if wavelet != LEGALL or depth not in LEGALL_MATRICES:
            raise ValueError(f"no default matrix for wavelet {wavelet} "
                             f"at depth {depth}")
        m = LEGALL_MATRICES[depth]
    tp["matrix"] = m
    r.align()
    return number, tp, r.p // 8


def slice_bytes(tp):
    """Bytes of each slice, in raster order."""
    i = np.arange(tp["slices_x"] * tp["slices_y"], dtype=np.int64)
    num, den = tp["bytes_num"], tp["bytes_den"]
    return (i + 1) * num // den - i * num // den


def length_bits(nbytes):
    """Width of each slice's slice_y_length field (see the module's
    docstring)."""
    return np.array([int(8 * b).bit_length() for b in nbytes])


def component_dims(seq):
    """(height, width) of the three components."""
    w, h = seq["width"], seq["height"]
    cw = w if seq["chroma"] == 0 else w // 2
    ch = h // 2 if seq["chroma"] == 2 else h
    return [(h, w), (ch, cw), (ch, cw)]


def band_layout(dims, tp):
    """[(level, orientation, band height, band width, slice rows, slice
    columns)] of a component in slice order, from its padded size."""
    depth, ny, nx = tp["depth"], tp["slices_y"], tp["slices_x"]
    ph = -(-dims[0] >> depth) << depth
    pw = -(-dims[1] >> depth) << depth
    out = [(0, 0, ph >> depth, pw >> depth)]
    for lev in range(1, depth + 1):
        s = depth - lev + 1
        out += [(lev, o, ph >> s, pw >> s) for o in range(3)]
    layout = []
    for lev, o, bh, bw in out:
        if bh % ny or bw % nx:
            raise ValueError("slices that do not divide every subband "
                             "evenly are not covered")
        layout.append((lev, o, bh, bw, bh // ny, bw // nx))
    return layout, (ph, pw)


class _Lanes:
    """Bounded reads of signed interleaved exp-Golomb values, one lane per
    block: a read past a block's end gives a 1 bit."""

    def __init__(self, bits):
        self.b = bits
        m = bits.size
        self.nxt = np.empty(m + 2, dtype=np.int64)
        self.nxt[m:] = m + 2
        idx = np.arange(m, dtype=np.int64)
        for par in (0, 1):
            cand = np.where(bits[par::2] == 1, idx[par::2], 1 << 60)
            self.nxt[par:m:2] = np.minimum.accumulate(cand[::-1])[::-1]

    def bit(self, q, end):
        ok = q < end
        return np.where(ok, self.b[np.where(ok, q, 0)], 1)

    def read(self, start, end, count):
        """`count` values from each lane's block [start, end)."""
        pos = start.copy()
        starts = np.empty((count, pos.size), dtype=np.int64)
        terms = np.empty_like(starts)
        m = self.b.size
        for k in range(count):
            inb = pos < end
            t = np.minimum(self.nxt[np.minimum(pos, m)],
                           end + ((end - pos) & 1))
            t = np.where(inb, t, pos)
            starts[k], terms[k] = pos, t
            pos = t + 1 + (t > pos)
        n = (terms - starts) // 2               # data bits of each value
        ends = np.broadcast_to(end, starts.shape)
        val = np.ones(starts.shape, dtype=np.int64)
        for j in range(int(n.max()) if n.size else 0):
            sel = n > j
            val[sel] = (val[sel] << 1) | self.bit(starts[sel] + 1 + 2 * j,
                                                  ends[sel])
        val -= 1
        neg = (val > 0) & (self.bit(terms + 1, ends) == 1)
        return np.where(neg, -val, val)


def _dequantise(q, qi):
    mag = (np.abs(q) * QF[qi] + QO[qi] + 2) >> 2
    return np.where(q == 0, 0, np.where(q < 0, -mag, mag))


def _dc_predict(band):
    """Adds each DC value's prediction from its decoded neighbours, in
    raster order (a wavefront over the anti-diagonals)."""
    h, w = band.shape
    for d in range(h + w - 1):
        ys = np.arange(max(0, d - w + 1), min(h, d + 1))
        xs = d - ys
        left = band[ys, np.maximum(xs - 1, 0)]
        up = band[np.maximum(ys - 1, 0), xs]
        diag = band[np.maximum(ys - 1, 0), np.maximum(xs - 1, 0)]
        pred = np.where((xs > 0) & (ys > 0), (left + up + diag + 1) // 3,
                        np.where(xs > 0, left, np.where(ys > 0, up, 0)))
        band[ys, xs] += pred


def _synth_1d(a, axis):
    """LeGall 5,3 synthesis along `axis`, in place."""
    v = np.moveaxis(a, axis, 0)
    e, o = v[0::2], v[1::2]
    e -= (np.concatenate([o[:1], o[:-1]]) + o + 2) >> 2
    o += (e + np.concatenate([e[1:], e[-1:]]) + 1) >> 1


def inverse_legall(bands, depth):
    """The padded component from its subbands ({(level, orientation):
    array}): per level, interleave, vertical then horizontal synthesis,
    then the filter's bit shift of 1 with rounding."""
    ll = bands[(0, 0)]
    for lev in range(1, depth + 1):
        h, w = ll.shape
        a = np.empty((2 * h, 2 * w), dtype=np.int64)
        a[0::2, 0::2] = ll
        a[0::2, 1::2] = bands[(lev, 0)]
        a[1::2, 0::2] = bands[(lev, 1)]
        a[1::2, 1::2] = bands[(lev, 2)]
        _synth_1d(a, 0)
        _synth_1d(a, 1)
        ll = (a + 1) >> 1
    return ll


def decode_coefficients(data, offset, seq, tp):
    """Each component's quantisation indices and dequantised subbands:
    ([qindex per slice (ny, nx)], [{(level, orientation): band}])."""
    if tp["wavelet"] != LEGALL:
        raise ValueError(f"wavelet {tp['wavelet']} is not covered")
    ny, nx = tp["slices_y"], tp["slices_x"]
    nb = slice_bytes(tp)
    total = int(nb.sum())
    if offset + total > len(data):
        raise ValueError(f"{len(data) - offset} bytes of slices, the "
                         f"parameters say {total}")
    bits = np.unpackbits(np.frombuffer(data, np.uint8, total, offset))
    lanes = _Lanes(bits)
    first = np.concatenate([[0], np.cumsum(nb)[:-1]]) * 8
    lb = length_bits(nb)
    w7 = 1 << np.arange(6, -1, -1)
    qindex = (bits[first[:, None] + np.arange(7)] * w7).sum(1)
    top = lb.max()
    pos = first[:, None] + 7 + np.arange(top)
    shifts = np.maximum(lb[:, None] - 1 - np.arange(top), -1)
    ylen = np.where(shifts >= 0, bits[np.minimum(pos, bits.size - 1)]
                    << np.maximum(shifts, 0), 0).sum(1)
    y0 = first + 7 + lb
    y1 = y0 + ylen
    s_end = first + 8 * nb
    y1 = np.minimum(y1, s_end)
    dims = component_dims(seq)
    out_bands, out_q = [], []
    layouts = [band_layout(d, tp)[0] for d in dims]
    counts = [sum(rh * rw for *_, rh, rw in lay) for lay in layouts]
    yv = lanes.read(y0, y1, counts[0])
    cv = lanes.read(y1, s_end, 2 * counts[1])
    for comp, vals in enumerate((yv, cv[0::2], cv[1::2])):
        k = 0
        bands = {}
        for lev, o, bh, bw, rh, rw in layouts[comp]:
            m = tp["matrix"][lev][o]
            qi = np.maximum(qindex - m, 0)
            blk = _dequantise(vals[k:k + rh * rw], qi[None, :])
            k += rh * rw
            bands[(lev, o)] = blk.reshape(rh, rw, ny, nx).transpose(
                2, 0, 3, 1).reshape(bh, bw)
        _dc_predict(bands[(0, 0)])
        out_bands.append(bands)
        out_q.append(qindex.reshape(ny, nx))
    return out_q, out_bands


def decode_picture(data, seq):
    """(picture number, (Y, C1, C2)) of one low-delay picture unit: the
    decoded samples, offset by half their range and clipped, as uint16
    (uint8 at 8 bits)."""
    number, tp, off = picture_parameters(data)
    _, bands = decode_coefficients(data, off, seq, tp)
    planes = []
    for comp, (h, w) in enumerate(component_dims(seq)):
        depth = seq["luma_depth"] if comp == 0 else seq["chroma_depth"]
        x = inverse_legall(bands[comp], tp["depth"])[:h, :w]
        x = np.clip(x + (1 << (depth - 1)), 0, (1 << depth) - 1)
        planes.append(x.astype(np.uint8 if depth <= 8 else np.uint16))
    return number, tuple(planes)


def decode_stream(stream):
    """[(picture number, planes)] of every low-delay picture of a stream,
    in stream order, with the sequence header in force."""
    seq, out = None, []
    for code, data in parse_units(stream):
        if code == SEQUENCE_HEADER:
            seq = sequence_header(data)
        elif is_ld_picture(code):
            if seq is None:
                raise ValueError("a picture before any sequence header")
            out.append(decode_picture(data, seq))
    return out
