"""The port's tracing on the CPU: the long-GOP encoder's record_function
spans (the GOP driver, scene change, rate control, the picture steps,
the copies to and from the device, an inter picture's host half) and the
event counters of `utils.telemetry`.

One 128x64 biref TM5 CBR clip goes through `api.Encoder` with the
profiler off and on: the two streams are equal, every span is there, the
picture steps match the stream's parse codes, the uploads count each
picture's planes, and the program's spans cover the encode.
`profile_slice`'s split of the device's idle time by span is checked on
a hand-made timeline.  The native arith coder's batch: where its
counters say each band was coded, and callers on many threads at once.
A 3-picture 10-bit 4:2:2 VC-2 low-delay clip: its spans once a picture,
and the counts of its pictures, slices, analysis passes and copies.
"""
import sys
import threading
import time
from types import SimpleNamespace

import pytest
from torch._C._profiler import _ExperimentalConfig
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

from schroedinger_tpu_torch import api, pipeline, profile_slice
from schroedinger_tpu_torch import bitstream as bs
from schroedinger_tpu_torch.coding import native
from schroedinger_tpu_torch.config import EncoderConfig
from schroedinger_tpu_torch.slice_config import make_frames, video_format
from schroedinger_tpu_torch.tools.profile_arith_pool import make_bands
from schroedinger_tpu_torch.utils.telemetry import Counters, counters
from schroedinger_tpu_torch.video_format import ChromaFormat

W, H, N = 128, 64, 11
# the benchmark cell's settings at an area-scaled rate, with an access
# unit every 8 frames: I, a batch of three B, P, a batch, the AU's I,
# then a tail subgroup of one B picture and a P
SETTINGS = dict(rate_control="constant_bitrate",
                bitrate=8_000_000 * W * H // (1920 * 1080),
                gop_structure="biref", au_distance=8, mv_precision=2,
                inter_wavelet=1, quality=6.8, queue_depth=4)
NEW_SPANS = ("gop_drive", "scene_change", "rate_control", "rc_seed",
             "p_picture_step", "i_picture", "picture_upload", "i_transfer",
             "picture_finish")


def _union_ns(intervals):
    total, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


@pytest.fixture(scope="module")
def clip():
    """The clip encoded with the profiler off, then on: both streams,
    the host spans {name: [(start, end)]}, the driver's encode_frame
    calls and the counters' change over the traced encode."""
    frames = make_frames(N, W, H)
    vf = video_format(W, H)
    plain = api.Encoder(vf, EncoderConfig(**SETTINGS),
                        device="cpu").encode_stream(frames)
    enc = api.Encoder(vf, EncoderConfig(**SETTINGS), device="cpu")
    calls = []
    driver_frame = enc._gop.encode_frame

    def encode_frame(planes):
        calls.append(1)
        return driver_frame(planes)
    enc._gop.encode_frame = encode_frame
    before = counters.snapshot()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("test.encode_stream"):
            stream = enc.encode_stream(frames)
    after = counters.snapshot()
    spans = {}
    for e in prof.profiler.kineto_results.events():
        if e.is_user_annotation():
            s = e.start_ns()
            spans.setdefault(e.name(), []).append((s, s + e.duration_ns()))
    codes = [code for code, _ in bs.split_units(stream)
             if bs.is_picture(code)]
    return {"plain": plain, "stream": stream, "spans": spans,
            "calls": len(calls), "frames": frames, "codes": codes,
            "counted": {k: after[k] - before.get(k, 0) for k in after}}


def test_stream_is_the_same_under_the_profiler(clip):
    assert clip["stream"] == clip["plain"]


def test_every_new_span_is_recorded(clip):
    missing = [n for n in NEW_SPANS if n not in clip["spans"]]
    assert not missing


def test_gop_drive_once_per_driver_call(clip):
    # one for each encode_frame call and one for the flush
    assert clip["calls"] == N
    assert len(clip["spans"]["gop_drive"]) == clip["calls"] + 1
    assert len(clip["spans"]["scene_change"]) == N


def test_picture_steps_match_the_parse_codes(clip):
    codes, spans = clip["codes"], clip["spans"]
    n_i = sum(1 for c in codes if bs.num_refs(c) == 0)
    n_p = sum(1 for c in codes if bs.num_refs(c) and bs.is_reference(c))
    n_b = sum(1 for c in codes if bs.num_refs(c) and not bs.is_reference(c))
    assert (n_i, n_p, n_b) == (2, 2, 7)
    assert len(spans["i_picture"]) == n_i
    assert len(spans["p_picture_step"]) == n_p
    assert (len(spans["b_picture_step"]) + 3 * len(spans["b_batch_step"])
            == n_b)
    assert len(spans["picture_finish"]) == n_p + n_b
    # the rate controller's calibration runs once, at the first intra
    assert len(spans["rc_seed"]) == 1


def test_uploads_and_fetches_are_counted(clip):
    counted = clip["counted"]
    plane_bytes = sum(pl.nbytes for pl in clip["frames"][0])
    # each picture once, and the first picture again for TM5's calibration
    uploads = len(clip["codes"]) + len(clip["spans"]["rc_seed"])
    assert counted["upload_bytes"] == uploads * plane_bytes
    assert len(clip["spans"]["picture_upload"]) == uploads
    # every coefficient comes back as an int16 at least once a picture
    assert counted["fetch_bytes"] > 2 * len(clip["codes"]) * plane_bytes
    assert counted.get("me_search_launches", 0) == 0   # the CPU's plain ME


def test_final_stage_launches_nothing_on_the_cpu(clip):
    """The ME's final stage runs its plain version on the CPU: kernel
    #4's counter stays 0, as kernel #1's does, and no competition counts
    as left in PyTorch on the card."""
    counted = clip["counted"]
    assert counted.get("me_final_launches", 0) == 0
    assert counted.get("me_search_launches", 0) == 0
    assert counted.get("me_compete_plain", 0) == 0


def test_arith_span_once_a_picture_and_inline_at_128x64(clip):
    # one batch a picture, every band of it on the calling thread: a
    # 128x64 picture is below the pool's threshold
    assert len(clip["spans"]["encode_subband_arith"]) == len(clip["codes"])
    assert clip["counted"]["arith_inline_bands"] >= len(clip["codes"])
    assert clip["counted"]["arith_pool_bands"] == 0


def test_program_spans_cover_the_encode(clip):
    spans = clip["spans"]
    (outer,) = spans["test.encode_stream"]
    inner = [(max(s, outer[0]), min(e, outer[1]))
             for name, occ in spans.items() if name != "test.encode_stream"
             for s, e in occ if e > outer[0] and s < outer[1]]
    assert _union_ns(inner) >= 0.95 * (outer[1] - outer[0])


LD_SPANS = ("ld_analysis", "ld_fetch", "ld_pack", "ld_wait",
            "picture_upload")


@pytest.fixture(scope="module")
def lowdelay_clip():
    """Three 10-bit 4:2:2 pictures through api.Encoder's low-delay
    encode_stream under the profiler, every thread profiled (the fetch
    and the packing run on a worker thread): the host spans {name:
    count}, the encoder's parameters and the counters' change."""
    frames = make_frames(3, W, H, chroma_format=ChromaFormat.C422,
                         bit_depth=10)
    enc = api.Encoder(video_format(W, H, ChromaFormat.C422, 10),
                      EncoderConfig(rate_control="low_delay",
                                    transform_depth=4, intra_wavelet=1),
                      device="cpu")
    before = counters.snapshot()
    with profile(activities=[ProfilerActivity.CPU],
                 experimental_config=_ExperimentalConfig(
                     profile_all_threads=True)) as prof:
        t0 = time.perf_counter_ns()
        enc.encode_stream(frames)
        wall_ns = time.perf_counter_ns() - t0
    after = counters.snapshot()
    spans = {}
    for e in prof.profiler.kineto_results.events():
        if e.is_user_annotation():
            spans[e.name()] = spans.get(e.name(), 0) + 1
    return {"spans": spans, "params": enc.params, "frames": frames,
            "counted": {k: after[k] - before.get(k, 0) for k in after},
            "wall_ns": wall_ns}


def test_lowdelay_spans_once_a_picture(lowdelay_clip):
    spans = lowdelay_clip["spans"]
    assert {n: spans.get(n, 0) for n in LD_SPANS} == dict.fromkeys(LD_SPANS,
                                                                   3)


def test_lowdelay_counts_pictures_slices_passes_and_copies(lowdelay_clip):
    p, counted = lowdelay_clip["params"], lowdelay_clip["counted"]
    slices = p.n_vert_slices * p.n_horiz_slices
    assert counted["ld_pictures"] == 3
    assert counted["ld_slices"] == 3 * slices
    # one pass of the 61 bases a plane at 128x64 (PASS_ELEMS), each
    # plane's non-DC positions under the budget
    passes = 0
    for ih, iw in ((p.iwt_luma_height, p.iwt_luma_width),
                   (p.iwt_chroma_height, p.iwt_chroma_width),
                   (p.iwt_chroma_height, p.iwt_chroma_width)):
        non_dc = ih * iw - (ih >> 4) * (iw >> 4)
        chunk = max(1, min(61, pipeline.PASS_ELEMS // non_dc))
        passes += -(-61 // chunk)
    assert passes == 3
    assert counted["ld_analysis_passes"] == 3 * passes
    # the 10-bit source up as 16-bit samples; down, the int32 slices and
    # each plane's 61-base bit and last-nonzero tables, in one copy
    source = sum(pl.size * 2 for pl in lowdelay_clip["frames"][0])
    coeffs = p.iwt_luma_height * p.iwt_luma_width \
        + 2 * p.iwt_chroma_height * p.iwt_chroma_width
    assert counted["upload_bytes"] == 3 * source
    assert counted["fetch_bytes"] == 3 * (4 * coeffs + 3 * 2 * 61 * slices
                                          * 4)


def test_lowdelay_counts_the_workers_time(lowdelay_clip):
    """The worker thread's fetch and packing time, which a profiler of
    the main thread alone cannot see, sums in `ld_fetch_ns` and
    `ld_pack_ns`: each positive, together within the encode's time (the
    worker runs one picture at a time)."""
    counted = lowdelay_clip["counted"]
    fetch, pack = counted["ld_fetch_ns"], counted["ld_pack_ns"]
    assert fetch > 0 and pack > 0
    assert fetch + pack < lowdelay_clip["wall_ns"]


class _Event:
    def __init__(self, name, start, end, device):
        self.name = name
        self.time_range = SimpleNamespace(start=start, end=end)
        self.device_type = (DeviceType.CUDA if device
                            else DeviceType.CPU)
        self.is_user_annotation = not device


def test_profile_slice_puts_device_idle_down_to_the_innermost_span():
    """profile_slice's idle split on a hand-made timeline (us): device
    busy 10-20 and 50-60 inside the encode span 0-100; host spans
    `gop_drive` 5-95 holding `rate_control` 30-40 and `picture_upload`
    55-70."""
    events = [_Event(profile_slice.ENCODE_SPAN, 0, 100, False),
              _Event("gop_drive", 5, 95, False),
              _Event("rate_control", 30, 40, False),
              _Event("picture_upload", 55, 70, False),
              _Event("not_a_port_span", 70, 80, False),
              _Event("kernel", 10, 20, True),
              _Event("kernel", 50, 60, True),
              _Event("kernel", 120, 130, True)]
    prof = SimpleNamespace(events=lambda: events)
    got = dict(profile_slice._idle_by_span(prof, profile_slice.ENCODE_SPAN))
    assert got == {profile_slice.ENCODE_SPAN: 10, "gop_drive": 50,
                   "rate_control": 10, "picture_upload": 10}


def test_counters_lose_no_update_across_threads():
    reg = Counters()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(2000):
                reg.add("events")
                reg.add("bytes", 3)
        threads = [threading.Thread(target=work) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert reg.snapshot() == {"events": 16 * 2000, "bytes": 3 * 16 * 2000}
    snap = reg.snapshot()
    snap["events"] = 0
    assert reg.snapshot()["events"] == 16 * 2000


def _arith_counts(bands):
    before = counters.snapshot()
    coded = native.encode_subbands_arith(bands)
    after = counters.snapshot()
    return coded, {k: after[k] - before.get(k, 0)
                   for k in ("arith_pool_bands", "arith_inline_bands")}


@pytest.mark.parametrize("case", ["large", "small", "one_band"])
def test_arith_counters_say_where_bands_were_coded(case):
    """A picture above POOL_MIN_COEFFS is shared with the pool (when the
    process may use more than one CPU); a 128x64 picture, or one
    non-empty band however large, stays on the calling thread."""
    bands = {"large": make_bands(1024, 576),
             "small": make_bands(128, 64),
             "one_band": [max(make_bands(1024, 576),
                              key=lambda b: b[0].size)]}[case]
    coeffs = sum(b[0].size for b in bands)
    assert (coeffs >= native.POOL_MIN_COEFFS) == (case != "small")
    pooled = case == "large" and native.arith_pool_cpus() > 1
    # a worker may still be waking when the caller has coded every band:
    # a few tries, each counting every band once
    for _ in range(5):
        _, counted = _arith_counts(bands)
        assert sum(counted.values()) == len(bands)
        if not pooled or counted["arith_pool_bands"]:
            break
    assert (counted["arith_pool_bands"] > 0) == pooled


def test_arith_batches_from_many_threads_keep_their_bytes():
    """More callers than CPUs code their own pictures at once, each three
    times: every result is the bytes its picture gives alone."""
    callers = native.arith_pool_cpus() + 4
    pictures = [make_bands(320, 256, seed=k) for k in range(callers)]
    alone = [native.encode_subbands_arith(b) for b in pictures]
    assert len({tuple(p for p, _ in a) for a in alone}) == callers
    results = [[] for _ in range(callers)]
    start = threading.Barrier(callers)

    def work(k):
        start.wait(timeout=60)
        for _ in range(3):
            results[k].append(native.encode_subbands_arith(pictures[k]))
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(k,))
                   for k in range(callers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert results == [[a] * 3 for a in alone]
