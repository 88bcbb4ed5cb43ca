"""The measured windows: one general loop for each way a traffic mix drives
the encoder, chosen by the mix's `api` (`LOOPS`; "stream": whole clips
through `encode_stream`, a new encoder for each).  `encode_live`, one
frame at a time through `push_frame` / `pull`, drives the low-delay
conformance check (`tests/vc2_conformance.py`); it joins `LOOPS` with the
low-delay cells and their check.  Every loop is closed, with one item in
flight, and runs until `seconds` have passed and `min_items` items are
done (set-up warms up with one clip's worth and no time); a whole-clip
loop does at least one clip and ends with the clip in flight, so its
window is whole clips.

Each call into the codec is wrapped in a `bench.*` span, so a traced run
can tell the harness's own time from the codec's.  A loop returns
(items done, window seconds, the seconds of each call or pass, outputs);
the outputs are judged only after the window has closed.
"""
from __future__ import annotations

import time

import torch
from torch.profiler import record_function


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def encode_stream(codec, clips, seconds, device, min_items=0, first=0):
    """Whole clips, each a new sequence from a new encoder: pass i codes
    clips[(first + i) % len(clips)].  Outputs are (clip index, stream)
    pairs."""
    streams, lat = [], []
    t0 = time.perf_counter()
    while True:
        k = (first + len(streams)) % len(clips)
        ts = time.perf_counter()
        with record_function("bench.encode_stream"):
            streams.append((k, codec.new_encoder().encode_stream(clips[k])))
        lat.append(time.perf_counter() - ts)
        if (time.perf_counter() - t0 >= seconds
                and len(streams) * len(clips[0]) >= min_items):
            break
    _sync(device)
    return (len(streams) * len(clips[0]), time.perf_counter() - t0, lat,
            streams)


def encode_live(codec, clips, seconds, device, min_items=0, first=0):
    # `first` is there for the loops' common call; one clip is looped
    """One continuing sequence of the first clip's frames: frame i of the
    window is clip[i % n], pushed, then its coded unit pulled; outputs
    are the units."""
    clip = clips[0]
    enc = codec.new_encoder()
    units, lat = [], []
    t0 = time.perf_counter()
    while (len(units) < min_items
           or time.perf_counter() - t0 < seconds):
        ts = time.perf_counter()
        with record_function("bench.push_frame"):
            enc.push_frame(clip[len(units) % len(clip)])
        with record_function("bench.pull"):
            units.append(enc.pull())
        lat.append(time.perf_counter() - ts)
    _sync(device)
    return len(units), time.perf_counter() - t0, lat, units


LOOPS = {"stream": encode_stream}
