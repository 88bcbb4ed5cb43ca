"""Device programs of the VC-2 low-delay encoder.

Port of `schroedinger_tpu/pipeline.py`.  `make_lowdelay_analyze(p)` builds
the per-frame device work of a low-delay encode: plane preparation (8
bits: u8 - 128 as int16; deep: a plain widen to int32, no recentring),
edge extension, the multi-level forward wavelet, the slice reorder, the
dead-zone quantisation at all 61 base indices and, per slice and base,
the sint-VLC bit sum and the last nonzero position of the non-DC
coefficients.  The host then runs only the per-slice quant-index search,
the DC chains and the packing (native C++) on those aggregates.

The JAX version maps the 61 bases one at a time; eager torch would then
pay about 1,500 launches per frame, so the bases go through in chunks
under an element budget (`PASS_ELEMS`).  The sums and maxima are
integers, so any chunking is bit-exact.
"""
from __future__ import annotations

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
    """The long-GOP encoder's copy of a source picture to `device`
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
    """The long-GOP encoder's fetch of a tensor to a host array; the
    bytes count in `fetch_bytes`."""
    out = t.cpu().numpy()
    counters.add("fetch_bytes", out.nbytes)
    return out


def _prep(plane, oh: int, ow: int, bit_depth: int):
    """Deep (10/16-bit) sources use the s32 path (schrolowdelay.c:110-763)
    with a PLAIN widen: only the 8-bit path recentres by 128
    (orc_convert_s32_s16 vs orc_offsetconvert_s16_u8)."""
    if bit_depth > 8:
        x = plane.to(torch.int32)
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


def aggregates(sliced, qmo, dcs: int):
    """Per base (61): the sint bit sum and the last nonzero position of
    the non-DC segment of every slice -> (bits, lastnz), each (61, ny, nx)
    int32; lastnz is -1 where a slice has no nonzero coefficient.

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
    qmo_nd = torch.as_tensor(np.asarray(qmo[dcs:], np.int64), device=dev)
    qf_t = torch.as_tensor(tables.QUANT_FACTOR, dtype=torch.int32,
                           device=dev)
    qo_t = torch.as_tensor(tables.QUANT_OFFSET_1_2, dtype=torch.int32,
                           device=dev)
    pos = torch.arange(n_pos, dtype=torch.int32, device=dev)
    chunk = max(1, min(61, PASS_ELEMS // max(1, x.numel())))
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


def make_lowdelay_analyze(p: Params):
    """fn(y, u, v) -> (y_slices, u_slices, v_slices, (y_bits, y_lastnz),
    (u_bits, u_lastnz), (v_bits, v_lastnz)) on the planes' device; planes
    as `planes_to_device` makes them."""
    nb = subband_count(p.transform_depth)
    qm = np.asarray(p.quant_matrix[:nb], dtype=np.int32)
    dims = _iwt_dims(p)

    def analyze(y, u, v):
        (ys, ybi), (us, ubi), (vs, _) = (
            _slice_plane(pl, oh, ow, p) for pl, (oh, ow) in zip((y, u, v),
                                                               dims))
        dcs_y = int(np.sum(ybi == 0))
        dcs_uv = int(np.sum(ubi == 0))
        return (ys, us, vs, aggregates(ys, qm[ybi], dcs_y),
                aggregates(us, qm[ubi], dcs_uv),
                aggregates(vs, qm[ubi], dcs_uv))

    return analyze
