"""Device programs of the VC-2 low-delay encoder.

Port of `schroedinger_tpu/pipeline.py`.  `make_lowdelay_analyze(p)` builds
the per-frame device work of a low-delay encode: plane preparation (the
standard's offset 2^(bit depth - 1) taken off: u8 - 128 as int16 at 8
bits, int32 when deep),
edge extension, the multi-level forward wavelet, the slice reorder, the
dead-zone quantisation at all 61 base indices and, per slice and base,
the sint-VLC bit sum and the last nonzero position of the non-DC
coefficients.  The host then runs only the per-slice quant-index search,
the DC chains and the packing (native C++) on those aggregates.  On the
card the analysis is replayed from a CUDA graph (`_Graphed`): its eager
launches, about 750 a 1080p 4:2:2 picture, would otherwise cost more host
time than the card takes to run them.

The JAX version maps the 61 bases one at a time; eager torch would then
pay about 1,500 launches per frame, so the bases go through in chunks
under an element budget (`PASS_ELEMS`).  The sums and maxima are
integers, so any chunking is bit-exact.
"""
from __future__ import annotations

import threading

import numpy as np
import torch
from torch.profiler import record_function

from schroedinger_tpu_torch import tables
from schroedinger_tpu_torch.coding import slices as sl
from schroedinger_tpu_torch.ops import wavelet as wv
from schroedinger_tpu_torch.ops.pad import pad_edge
from schroedinger_tpu_torch.ops.quant import wrap32
from schroedinger_tpu_torch.params import Params, subband_count
from schroedinger_tpu_torch.utils.telemetry import counters

# elements of one (bases, slices, positions) temporary per pass of the
# 61-base loop: 1080p 4:2:2 luma goes in 4 passes, each chroma plane in 2
PASS_ELEMS = 1 << 25


def _bit_length(t):
    """Exact bit length of a tensor of positive integers below 2^62: the
    float32 exponent, less one where rounding carried the value up to the
    next power of two."""
    n = (t.to(torch.float32).view(torch.int32) >> 23).to(t.dtype) - 126
    return n - ((torch.ones_like(t) << (n - 1)) > t).to(t.dtype)


def _sint_bits(v):
    """Encoded sint VLC bit length, exact for every int32 v: the JAX
    version's 2n - 1 + (m != 0) with n = 32 - clz(|v| + 1) in int32,
    where |v| >= 2^31 - 1 wraps and gives n = 32 (int32 result)."""
    m = v.to(torch.int64).abs()
    return (2 * _bit_length(m + 1) - 1 + (m != 0)).to(torch.int32)


def planes_to_device(planes, bit_depth: int, device):
    """Source planes (numpy u8/u16 or tensors) -> tensors on `device`: u8
    at 8 bits, int32 when deep (uploaded as 16-bit and widened on the
    device)."""
    out = []
    for pl in planes:
        if torch.is_tensor(pl):
            t = pl.to(device)
            out.append(t if bit_depth <= 8 else t.to(torch.int32))
        elif bit_depth <= 8:
            out.append(torch.tensor(np.asarray(pl, np.uint8), device=device))
        else:
            h16 = np.ascontiguousarray(pl, np.uint16).view(np.int16)
            out.append(torch.tensor(h16, device=device).to(torch.int32)
                       & 0xFFFF)
    return tuple(out)


def upload_picture(planes, bit_depth: int, device):
    """An encoder's copy of a source picture to `device`
    (`planes_to_device`), in the span `picture_upload`; the bytes copied
    count in `upload_bytes`."""
    with record_function("picture_upload"):
        out = planes_to_device(planes, bit_depth, device)
    moved = 0
    for pl, t in zip(planes, out):
        if not torch.is_tensor(pl):
            moved += np.asarray(pl).size * (1 if bit_depth <= 8 else 2)
        elif pl.device != t.device:
            moved += pl.numel() * pl.element_size()
    counters.add("upload_bytes", moved)
    return out


def to_host(t) -> np.ndarray:
    """An encoder's fetch of a tensor to a host array; the bytes count
    in `fetch_bytes`."""
    out = t.cpu().numpy()
    counters.add("fetch_bytes", out.nbytes)
    return out


def _prep(plane, oh: int, ow: int, bit_depth: int):
    """A source plane centred as ST 2042-1 takes it, 2^(bit depth - 1)
    off every sample (int16 at 8 bits, int32 when deep: the s32 path,
    schrolowdelay.c:110-763), and edge-extended to (oh, ow); the low-delay
    and the intra encoders' one preparation.  The JAX package widens deep
    samples without the offset, as the reference encoder does
    (orc_convert_s32_s16), which the standard's decoder reads 2^(bit
    depth - 1) too high."""
    if bit_depth > 8:
        x = plane.to(torch.int32) - (1 << (bit_depth - 1))
    else:
        x = plane.to(torch.int16) - 128
    h, w = x.shape
    return pad_edge(x, 0, oh - h, 0, ow - w)


def _iwt_dims(p: Params):
    return [(p.iwt_luma_height, p.iwt_luma_width),
            (p.iwt_chroma_height, p.iwt_chroma_width),
            (p.iwt_chroma_height, p.iwt_chroma_width)]


def _slice_plane(plane, oh, ow, p: Params):
    """Prepare, transform and slice one plane -> ((ny, nx, S), band index
    per position)."""
    pyr = wv.forward(_prep(plane, oh, ow, p.video_format.bit_depth),
                     p.transform_depth, p.wavelet_filter_index)
    # int16 on the wire at 8 bits, int32 when deep
    return sl.to_slices(sl.subband_arrays(pyr, p.transform_depth),
                        p.n_vert_slices, p.n_horiz_slices)


def _passes(n_elems: int):
    """(chunks, bases a chunk) of the 61-base loop over n_elems non-DC
    coefficients."""
    chunk = max(1, min(61, PASS_ELEMS // max(1, n_elems)))
    return -(-61 // chunk), chunk


def _tables(qmo_nd, dev):
    """The aggregates' device constants: the non-DC positions' quant
    matrix offsets, the quant factors and the offsets."""
    return (torch.as_tensor(np.asarray(qmo_nd, np.int64), device=dev),
            torch.as_tensor(tables.QUANT_FACTOR, dtype=torch.int32,
                            device=dev),
            torch.as_tensor(tables.QUANT_OFFSET_1_2, dtype=torch.int32,
                            device=dev))


def aggregates(sliced, qmo, dcs: int, consts=None):
    """Per base (61): the sint bit sum and the last nonzero position of
    the non-DC segment of every slice -> (bits, lastnz), each (61, ny, nx)
    int32; lastnz is -1 where a slice has no nonzero coefficient.
    `consts`: `_tables(qmo[dcs:], device)`, made here where None.

    The quantiser is the JAX one (int32 `|v| << 2` wrapping) with the
    sign dropped: the bits and the nonzero test need only the magnitude.
    Where the wrapped `|v| << 2` is negative it lies below every quant
    offset and quantises to 0, so it is clamped to 0 first, and then no
    int32 step can overflow."""
    dev = sliced.device
    ny, nx = sliced.shape[:2]
    nd = sliced[..., dcs:].reshape(ny * nx, -1)
    n_pos = nd.shape[-1]
    x = wrap32(nd.to(torch.int64).abs() << 2).clamp(min=0)
    qmo_nd, qf_t, qo_t = consts or _tables(qmo[dcs:], dev)
    pos = torch.arange(n_pos, dtype=torch.int32, device=dev)
    chunk = _passes(x.numel())[1]
    bits, last = [], []
    for b0 in range(0, 61, chunk):
        base = torch.arange(b0, min(61, b0 + chunk), device=dev)
        qi = (base[:, None] - qmo_nd[None, :]).clamp(0, 60)
        qf = qf_t[qi][:, None, :]
        qo = qo_t[qi][:, None, :]
        mag = torch.where(x < qo, 0, (x - (qo - qf // 2)) // qf)
        nz = mag != 0
        b = 2 * _bit_length(mag + 1) - 1 + nz.to(torch.int32)
        bits.append(b.sum(-1, dtype=torch.int32))
        last.append(torch.where(nz, pos, -1).amax(-1).to(torch.int32))
    return (torch.cat(bits).reshape(61, ny, nx),
            torch.cat(last).reshape(61, ny, nx))


def _clone(out):
    return (tuple(_clone(t) for t in out) if isinstance(out, tuple)
            else out.clone())


class _Graphed:
    """fn(*planes) on CUDA tensors, replayed from one CUDA graph.

    The first call (and a call with other shapes) runs fn once on a side
    stream to warm it up, then captures it on the graph's own inputs.
    Each call copies the planes into those inputs, replays the graph and
    returns clones of its outputs, so a caller may hold one picture's
    outputs while the next is analysed.  Callers on several threads take
    turns under a lock, and a call's stream waits for the previous call's
    clones before the inputs are overwritten."""

    def __init__(self, fn):
        self.fn = fn
        self.lock = threading.Lock()
        self.key = None

    def _capture(self, planes):
        self.inputs = [t.clone() for t in planes]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            self.fn(*self.inputs)
        torch.cuda.current_stream().wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        # another thread's copies may run during the capture
        with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
            self.outputs = self.fn(*self.inputs)
        self.done = None
        self.key = [(t.shape, t.dtype, t.device) for t in planes]

    def __call__(self, *planes):
        with self.lock:
            if self.key != [(t.shape, t.dtype, t.device) for t in planes]:
                self._capture(planes)
            stream = torch.cuda.current_stream()
            if self.done is not None:
                stream.wait_event(self.done)
            for dst, src in zip(self.inputs, planes):
                dst.copy_(src)
            self.graph.replay()
            out = _clone(self.outputs)
            self.done = torch.cuda.Event()
            self.done.record(stream)
        return out


def make_lowdelay_analyze(p: Params):
    """fn(y, u, v) -> (y_slices, u_slices, v_slices, (y_bits, y_lastnz),
    (u_bits, u_lastnz), (v_bits, v_lastnz)) on the planes' device; planes
    as `planes_to_device` makes them.  Replayed from a CUDA graph on the
    card.  Each call counts its chunks of the 61-base loop in
    `ld_analysis_passes`."""
    nb = subband_count(p.transform_depth)
    qm = np.asarray(p.quant_matrix[:nb], dtype=np.int32)
    dims = _iwt_dims(p)
    depth = p.transform_depth
    passes = sum(_passes(h * w - (h >> depth) * (w >> depth))[0]
                 for h, w in dims)
    consts = {}     # (device, luma or chroma) -> `_tables`, made once

    def run(y, u, v):
        (ys, ybi), (us, ubi), (vs, _) = (
            _slice_plane(pl, oh, ow, p) for pl, (oh, ow) in zip((y, u, v),
                                                               dims))
        dcs_y = int(np.sum(ybi == 0))
        dcs_uv = int(np.sum(ubi == 0))
        for key, bi, dcs in (((ys.device, 0), ybi, dcs_y),
                             ((us.device, 1), ubi, dcs_uv)):
            if key not in consts:
                consts[key] = _tables(qm[bi][dcs:], key[0])
        cy, cuv = consts[(ys.device, 0)], consts[(us.device, 1)]
        return (ys, us, vs, aggregates(ys, qm[ybi], dcs_y, cy),
                aggregates(us, qm[ubi], dcs_uv, cuv),
                aggregates(vs, qm[ubi], dcs_uv, cuv))

    graphed = _Graphed(run)

    def analyze(y, u, v):
        out = graphed(y, u, v) if y.is_cuda else run(y, u, v)
        counters.add("ld_analysis_passes", passes)
        return out

    return analyze
