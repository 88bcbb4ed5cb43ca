"""The traced run's reduction (`harness/trace.py`) on a hand-made list of
the profiler's raw events, and the counters the readers get: every span
has a row, a span's self time leaves out the spans opened inside it on
its own thread, the idle split covers all the idle, the readers of the
metrics that were there before the reduction took every span read what
they read before, and `info["counters"]` is the change over the window.
"""
import types

import pytest
import torch

import run
from harness import trace as tr
from harness.codec import Codec

_CUDA = torch.autograd.DeviceType.CUDA
_CPU = torch.autograd.DeviceType.CPU
MS = 1_000_000


class _Event:
    """One raw profiler event, with the methods `trace.reduce` calls."""

    def __init__(self, name, start_ms, end_ms, cuda=False, span=True,
                 thread=1):
        self._name, self._cuda, self._span = name, cuda, span
        self._start, self._end = int(start_ms * MS), int(end_ms * MS)
        self._thread = thread

    def name(self):
        return self._name

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._end - self._start

    def device_type(self):
        return _CUDA if self._cuda else _CPU

    def is_user_annotation(self):
        return self._span

    def start_thread_id(self):
        return self._thread


def _host(name, s, e, thread=1):
    return _Event(name, s, e, thread=thread)


def _mirror(name, s, e):
    return _Event(name, s, e, cuda=True)


def _kernel(name, s, e):
    return _Event(name, s, e, cuda=True, span=False)


# a 100 ms pass of the harness: two GOP driver calls with their stages and
# copies on the main thread, an arith coder with a nested rate control on a
# second thread, the device-side mirrors of the spans that launched work,
# and seven device operations (15.5 ms busy)
EVENTS = [
    _host("bench.encode_stream", 0, 100),
    _host("gop_drive", 5, 60), _host("encode_subband_arith", 10, 20),
    _host("me_pass", 20, 30), _host("stat_tables", 22, 25),
    _host("rate_control", 35, 40), _host("picture_upload", 40, 45),
    _host("gop_drive", 65, 90), _host("p_transfer", 70, 80),
    _host("picture_upload", 72, 74), _host("i_transfer", 82, 85),
    _host("encode_subband_arith", 50, 70, thread=2),
    _host("rate_control", 55, 58, thread=2),
    _Event("aten::add", 11, 12, span=False),
    _mirror("bench.encode_stream", 1, 99), _mirror("gop_drive", 6, 59),
    _mirror("me_pass", 21, 31), _mirror("stat_tables", 23, 26),
    _kernel("elementwise_kernel", 21, 24),
    _kernel("elementwise_kernel", 23.5, 25),
    _kernel("me_rows_kernel", 26, 30), _kernel("Memcpy HtoD", 41, 43),
    _kernel("elementwise_kernel", 2, 3),
    _kernel("stat_tables_partials", 91, 95),
    _kernel("elementwise_kernel", 99.5, 100),
]
FRAMES = 4
# the reduction before it took every span (its fixed span list and the
# harness's), read on this list: the rows it had and what the five
# metrics that were there then read from them
BEFORE_ROWS = {
    "bench.encode_stream": {"count": 1, "host_s": 0.1, "device_s": 0.015},
    "encode_subband_arith": {"count": 2, "host_s": 0.03, "device_s": 0.0},
    "me_pass": {"count": 1, "host_s": 0.01, "device_s": 0.008},
    "stat_tables": {"count": 1, "host_s": 0.003, "device_s": 0.002},
    "p_transfer": {"count": 1, "host_s": 0.01, "device_s": 0.0}}
BEFORE_READINGS = {"device_idle.encode": 0.876, "stat_tables_device_ms": 0.5,
                   "me_pass_device_ms": 2.0,
                   "me_pass_roofline": 0.2168809253731343,
                   "arith_encode_host_ms": 7.5}


def _reduced():
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: iter(EVENTS))))
    return tr.reduce(prof, 0.125)


def _info(**extra):
    return dict(_reduced(), frames=FRAMES, direction="encode", refs_used=3,
                **extra)


def test_every_span_has_a_row():
    rows = _reduced()["spans"]
    assert set(rows) == {e.name() for e in EVENTS
                         if e.is_user_annotation() and not e._cuda}
    assert rows["gop_drive"]["count"] == 2
    assert rows["rate_control"]["host_s"] == pytest.approx(0.008)


def test_self_time_leaves_out_the_spans_inside_on_its_thread():
    rows = _reduced()["spans"]
    # 55 ms less four stages of 30, and 25 less two copies of 13; the
    # second thread's coder overlaps the first call but is not inside it
    assert rows["gop_drive"]["self_s"] == pytest.approx(0.037)
    assert rows["bench.encode_stream"]["self_s"] == pytest.approx(0.020)
    # 10 ms on the main thread, and 20 less its nested rate control
    assert rows["encode_subband_arith"]["self_s"] == pytest.approx(0.027)
    assert rows["p_transfer"]["self_s"] == pytest.approx(0.008)
    assert rows["stat_tables"]["self_s"] == rows["stat_tables"]["host_s"]


def test_idle_by_span_is_all_the_idle():
    r = _reduced()
    idle = dict(r["idle_by_span"])
    assert sum(idle.values()) == pytest.approx(0.100 - r["busy_s"])
    assert r["busy_s"] == pytest.approx(0.0155)
    # the idle goes to the innermost span, `gop_drive` included
    assert idle["gop_drive"] == pytest.approx(0.027)
    assert idle["bench.encode_stream"] == pytest.approx(0.0095)
    assert r["idle_gaps"] == r["idle_by_span"][:tr.TOP]


def test_earlier_rows_and_readings_are_unchanged():
    rows = _reduced()["spans"]
    for name, row in BEFORE_ROWS.items():
        assert {k: rows[name][k] for k in row} == pytest.approx(row), name
    info = _info()
    for name, want in BEFORE_READINGS.items():
        assert run.load_reader(name)(info) == pytest.approx(want, rel=1e-12)


def test_device_ops_carry_their_innermost_span():
    ops = dict(_reduced()["device_ops"])
    assert ops == pytest.approx({
        "me_pass: me_rows_kernel": 0.004,
        "bench.encode_stream: stat_tables_partials": 0.004,
        "me_pass: elementwise_kernel": 0.003,
        "gop_drive: Memcpy HtoD": 0.002,
        "stat_tables: elementwise_kernel": 0.0015,
        "bench.encode_stream: elementwise_kernel": 0.001,
        f"{tr.NO_SPAN}: elementwise_kernel": 0.0005})


def test_span_and_counter_readers():
    info = _info(counters={"upload_bytes": 3_000_000,
                           "fetch_bytes": 6_000_000,
                           "me_search_launches": 5})
    want = {"gop_drive_self_ms": 37 / FRAMES,
            "rate_control_host_ms": 8 / FRAMES,
            # the upload inside the inter picture's copy counts once
            "transfer_host_ms": 18 / FRAMES,
            "transfer_mb_per_frame": 9 / FRAMES,
            "unspanned_idle_share": 9.5 / 84.5}
    for name, v in want.items():
        assert run.load_reader(name)(info) == pytest.approx(v), name


def test_span_readers_read_nothing_without_their_spans():
    empty = {"spans": {}, "host_intervals": {}, "frames": FRAMES,
             "counters": {}, "idle_by_span": []}
    for name in ("gop_drive_self_ms", "rate_control_host_ms",
                 "transfer_host_ms", "transfer_mb_per_frame",
                 "unspanned_idle_share"):
        assert run.load_reader(name)(empty) is None, name


def test_counters_are_the_change_over_the_window(monkeypatch):
    snaps, infos = [], []
    real_counters, real_reader = Codec.counters, run.load_reader

    def counters(self):
        snaps.append(real_counters(self))
        return snaps[-1]

    def reader(name):
        read = real_reader(name)

        def spy(info):
            infos.append(info)
            return read(info)
        return spy
    monkeypatch.setattr(Codec, "counters", counters)
    monkeypatch.setattr(run, "load_reader", reader)
    result, _ = run.run("dirac-longgop-1080p25-cbr8m.encode-pan", 2**31 + 5,
                        0.0, True, "cpu", size=(128, 64), frames=4)
    assert len(snaps) == 2 and infos
    before, after = snaps
    counted = infos[0]["counters"]
    assert counted == {k: v - before.get(k, 0) for k, v in after.items()}
    # set-up's warm-up pass uploaded too: the process total is larger
    assert 0 < counted["upload_bytes"] < after["upload_bytes"]
    assert result["metrics"]["transfer_mb_per_frame"]["value"] == (
        pytest.approx((counted["upload_bytes"] + counted["fetch_bytes"])
                      / 1e6 / infos[0]["frames"]))
