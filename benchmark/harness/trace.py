"""The traced run's reduction: from `torch.profiler` over the window to
device busy time, a row for every `record_function` span (the program's
and the harness's `bench.*`), the top device operations by the span they
ran under, and the device's idle time by what the host was doing.

Frozen copy of `schroedinger_tpu_torch/profile_slice.py`'s arithmetic
(`_device_busy_us`, `_events_under`, `_idle_by_span` and the span rows of
`_report`): a span's host time is its time on the host clock; for a host
span (entropy coding, packing, the native slice decode, the GOP driver)
that is real work, for a stage span it is only the enqueue, and the
stage's work is the device time of the kernels launched under it.  A
span's self time is its host time outside the spans opened inside it on
the same thread.  The profiler's raw events are reduced in memory,
without building its per-event Python objects; no timeline is written.
"""
from __future__ import annotations

import bisect
import contextlib
import time

import torch
from torch.profiler import ProfilerActivity, profile

_CUDA = torch.autograd.DeviceType.CUDA
TOP = 10        # entries of each breakdown list
NAME = 160      # characters kept of a kernel's name
NO_SPAN = "(no span)"


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
    """[(start, end, name)] pieces of a timeline (the host's, or the
    device's for the spans' mirrors), each labelled with the innermost of
    the given spans open over it (the span opened last among those still
    open)."""
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


def _innermost_at(segs, t):
    """The name of the segment of `_innermost_segments` that holds time
    `t`, or NO_SPAN."""
    k = bisect.bisect_right(segs, (t, float("inf"))) - 1
    return segs[k][2] if k >= 0 and segs[k][1] > t else NO_SPAN


def _gaps_by_span(busy, t0, t1, spans):
    """[name, seconds] of device idle time in [t0, t1] (nanoseconds), by
    the innermost host span open at the time (NO_SPAN where none is),
    the largest first."""
    gaps, cur = [], t0
    for s, e in busy:
        if s >= t1:
            break
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
            by[NO_SPAN] = by.get(NO_SPAN, 0) + (ge - gs - covered)
    return sorted(([n, v / 1e9] for n, v in by.items()),
                  key=lambda r: -r[1])


def _self_ns(occurrences):
    """{name: nanoseconds} of each span's host time outside the spans
    opened inside it on its own thread, summed over its occurrences
    (thread, start, end, name)."""
    # the spans open on the thread, innermost last: [thread, start, end,
    # name, time inside them]
    out, stack = {}, []

    def close():
        _, s, e, name, inner = stack.pop()
        out[name] = out.get(name, 0) + (e - s) - inner
    for tid, s, e, name in sorted(occurrences,
                                  key=lambda o: (o[0], o[1], -o[2])):
        while stack and (stack[-1][0] != tid or stack[-1][2] <= s):
            close()
        if stack:
            stack[-1][4] += min(e, stack[-1][2]) - s
        stack.append([tid, s, e, name, 0])
    while stack:
        close()
    return out


def host_union_s(trace, names):
    """Seconds of host time in which any of the spans `names` is open, on
    any thread."""
    return sum(e - s for s, e in _union(
        iv for n in names for iv in trace["host_intervals"].get(n, ()))) / 1e9


def reduce(prof, window_s):
    """{busy_s, window_s, device_events, spans: {name: {count, host_s,
    self_s, device_s}}, host_intervals, device_ops, idle_gaps,
    idle_by_span} of one profiled window, read from the profiler's raw
    events; every `record_function` span in the window has a row.

    Busy time is the union of the device's kernel and copy intervals.  A
    span's host time is the union of its occurrences on the host clock
    (`host_intervals`, nanoseconds); its self time is the sum over its
    occurrences of the time outside the spans opened inside it on the
    same thread; its device time is the busy time inside its device-side
    mirrors (the first to the last kernel launched under it, on the one
    stream), which is the time of the kernels launched under it.  A
    device operation is named with the innermost span whose mirror it
    started under.  The idle time, between the first span's start and
    the last one's end, goes to the innermost span open on the host
    (`idle_by_span`, whole; `idle_gaps`, its top entries)."""
    dev, occ, mirror = [], [], []
    for e in prof.profiler.kineto_results.events():
        cuda = e.device_type() == _CUDA
        s = e.start_ns()
        if e.is_user_annotation():
            if cuda:
                mirror.append((s, s + e.duration_ns(), e.name()))
            else:
                occ.append((e.start_thread_id(), s, s + e.duration_ns(),
                            e.name()))
        elif cuda:
            dev.append((s, s + e.duration_ns(), e.name()))
    busy = _union((s, e) for s, e, _ in dev)
    host, mirrors = {}, {}
    for _, s, e, n in occ:
        host.setdefault(n, []).append((s, e))
    for s, e, n in mirror:
        mirrors.setdefault(n, []).append((s, e))
    selfs = _self_ns(occ)
    intervals = {n: _union(o) for n, o in host.items()}
    rows = {n: {"count": len(host[n]),
                "host_s": sum(e - s for s, e in iv) / 1e9,
                "self_s": selfs[n] / 1e9,
                "device_s": _overlap(busy, _union(mirrors.get(n, []))) / 1e9}
            for n, iv in intervals.items()}
    segs = _innermost_segments(mirror)
    ops = {}
    for s, e, n in dev:
        key = f"{_innermost_at(segs, s)}: {n[:NAME]}"
        ops[key] = ops.get(key, 0) + (e - s)
    spans = [(s, e, n) for _, s, e, n in occ]
    t0 = min((s for s, _, _ in spans), default=0)
    t1 = max((e for _, e, _ in spans), default=0)
    idle = _gaps_by_span(busy, t0, t1, spans)
    return {"busy_s": sum(e - s for s, e in busy) / 1e9,
            "window_s": window_s, "device_events": len(dev), "spans": rows,
            "host_intervals": intervals,
            "device_ops": sorted(([n, v / 1e9] for n, v in ops.items()),
                                 key=lambda r: -r[1])[:TOP],
            "idle_gaps": idle[:TOP], "idle_by_span": idle}
