"""The traced run's reduction: from `torch.profiler` over the window to
device busy time, per-span host and kernel time, the top device
operations and the device's idle gaps by what the host was doing.

Frozen copy of `schroedinger_tpu_torch/profile_slice.py`'s arithmetic
(`_device_busy_us`, `_events_under` and the span rows of `_report`): a
span's host time is its time on the host clock; for a host span (entropy
coding, packing, the native slice decode) that is real work, for a stage
span it is only the enqueue, and the stage's work is the device time of
the kernels launched under it.  The profiler's raw events are reduced in
memory, without building its per-event Python objects; no timeline is
written.
"""
from __future__ import annotations

import contextlib
import time

import torch
from torch.profiler import ProfilerActivity, profile

_CUDA = torch.autograd.DeviceType.CUDA
TOP = 10        # entries of each breakdown list
NAME = 160      # characters kept of a kernel's name
# the port's record_function spans (profile_slice.HOST_SPANS and
# STAGE_SPANS): host entropy coding and packing, then the encoder's and
# decoders' device stages
SPANS = ("encode_subband_arith", "decode_subband_arith",
         "encode_subband_noarith", "decode_subband_noarith",
         "motion_encode", "motion_decode", "frame_md5", "ld_pack",
         "ld_decode",
         "me_pass", "phasecorr", "rd_split", "render", "stat_tables",
         "rd_pick", "multiquant", "quantise_recon", "p_transfer",
         "b_batch_step", "b_picture_step", "prefilter",
         "quality_metrics", "ld_analysis", "ld_inverse")


@contextlib.contextmanager
def window_profile(enabled):
    """Profile the block with CPU and CUDA activity when `enabled`; yields
    a holder whose `prof` is the profiler (None when off) and whose
    `window_s` is the block's length on the host clock."""
    class Holder:
        prof = None
        window_s = 0.0
    h = Holder()
    if not enabled:
        t0 = time.perf_counter()
        yield h
        h.window_s = time.perf_counter() - t0
        return
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=False, profile_memory=False,
                 with_stack=False) as prof:
        t0 = time.perf_counter()
        yield h
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        h.window_s = time.perf_counter() - t0
    h.prof = prof


def _union(intervals):
    """Sorted disjoint union of (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def _overlap(a, b):
    """Length of the intersection of two sorted disjoint interval lists."""
    i = j = 0
    total = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def _innermost_segments(spans):
    """[(start, end, name)] pieces of the host timeline, each labelled
    with the innermost of the given spans open over it (the span opened
    last among those still open)."""
    bounds = sorted({t for s, e, _ in spans for t in (s, e)})
    opens = sorted(spans)
    segs, active, k = [], [], 0
    for a, b in zip(bounds, bounds[1:]):
        while k < len(opens) and opens[k][0] <= a:
            active.append(opens[k])
            k += 1
        active = [sp for sp in active if sp[1] > a]
        if active:
            segs.append((a, b, max(active, key=lambda sp: sp[0])[2]))
    return segs


def _gaps_by_span(busy, t0, t1, spans):
    """[name, seconds] of device idle time in [t0, t1] (nanoseconds), by
    the innermost host span open at the time, the largest first."""
    gaps, cur = [], t0
    for s, e in busy:
        if s > cur:
            gaps.append((cur, min(s, t1)))
        cur = max(cur, e)
    if cur < t1:
        gaps.append((cur, t1))
    segs = _innermost_segments(spans)
    by = {}
    j = 0
    for gs, ge in gaps:
        covered = 0
        while j < len(segs) and segs[j][1] <= gs:
            j += 1
        k = j
        while k < len(segs) and segs[k][0] < ge:
            ov = min(ge, segs[k][1]) - max(gs, segs[k][0])
            if ov > 0:
                by[segs[k][2]] = by.get(segs[k][2], 0) + ov
                covered += ov
            k += 1
        if ge - gs > covered:
            by["(no span)"] = by.get("(no span)", 0) + (ge - gs - covered)
    return sorted(([n, v / 1e9] for n, v in by.items()),
                  key=lambda r: -r[1])[:TOP]


def reduce(prof, window_s, span_names):
    """{busy_s, window_s, device_events, spans: {name: {count, host_s,
    device_s}}, device_ops, idle_gaps} of one profiled window, read from
    the profiler's raw events.

    Busy time is the union of the device's kernel and copy intervals.  A
    span's host time is the union of its occurrences on the host clock;
    its device time is the busy time inside its device-side mirrors (the
    first to the last kernel launched under it, on the one stream), which
    is the time of the kernels launched under it."""
    dev, ops, host, mirror = [], {}, {}, {}
    for e in prof.profiler.kineto_results.events():
        cuda = e.device_type() == _CUDA
        if e.is_user_annotation():
            name = e.name()
            if name in span_names:
                s = e.start_ns()
                (mirror if cuda else host).setdefault(name, []).append(
                    (s, s + e.duration_ns()))
        elif cuda:
            s, d = e.start_ns(), e.duration_ns()
            dev.append((s, s + d))
            name = e.name()
            ops[name] = ops.get(name, 0) + d
    busy = _union(dev)
    rows = {}
    for name, occ in host.items():
        rows[name] = {"count": len(occ),
                      "host_s": sum(e - s for s, e in _union(occ)) / 1e9,
                      "device_s": _overlap(busy, _union(mirror.get(name, [])))
                      / 1e9}
    spans = [(s, e, n) for n, occ in host.items() for s, e in occ]
    t0 = min((s for s, _, _ in spans), default=0)
    t1 = max((e for _, e, _ in spans), default=0)
    return {"busy_s": sum(e - s for s, e in busy) / 1e9,
            "window_s": window_s, "device_events": len(dev), "spans": rows,
            "device_ops": sorted(([n[:NAME], v / 1e9]
                                  for n, v in ops.items()),
                                 key=lambda r: -r[1])[:TOP],
            "idle_gaps": _gaps_by_span(busy, t0, t1, spans)}
