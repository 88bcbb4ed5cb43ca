"""Where the time of the 1080p slice goes, on one NVIDIA GPU.

    python -m schroedinger_tpu_torch.profile_slice [--frames 6] [--out DIR]

Encodes pan + noise 1080p25 4:2:0 frames with the port's GopEncoder
(backref, fixed quantisers, quarter-pel MVs, MD5) under torch.profiler
after a 2-frame warm-up, then decodes the stream the same way.  Prints,
per run: wall time, the device's busy time (union of kernel intervals)
and idle share, the host time in the entropy-coding calls, and the top
kernels (not aten ops) by device time.  Writes a Chrome trace of the encode to DIR.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import time

import torch
from torch.profiler import ProfilerActivity, profile

from schroedinger_tpu_torch.decoder.core import StreamDecoder
from schroedinger_tpu_torch.encoder.gop import GopEncoder
from schroedinger_tpu_torch.slice_config import (CONFIG, make_frames,
                                                 video_format)


def _device_busy_us(prof):
    """Union of the device kernel/memcpy intervals, in microseconds."""
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy, len(spans)


def _report(tag, prof, wall_s, n_frames):
    busy_us, n_dev = _device_busy_us(prof)
    print(f"{tag}: {n_frames} frames in {wall_s:.3f} s "
          f"({n_frames / wall_s:.3f} frames/s); device busy "
          f"{busy_us / 1e3:.1f} ms, idle share "
          f"{1 - busy_us / 1e6 / wall_s:.3f}; {n_dev} device events "
          f"({n_dev / n_frames:.0f} per frame)", flush=True)
    avg = prof.key_averages()
    host = {k.key: k.cpu_time_total for k in avg}
    for name in ("encode_subband_arith", "decode_subband_arith",
                 "motion_encode", "motion_decode", "frame_md5"):
        if name in host:
            print(f"{tag}: host {name} {host[name] / 1e3:.1f} ms", flush=True)
    rows = sorted((k for k in avg if k.device_time_total > 0
                   and not k.key.startswith("aten::")),
                  key=lambda k: -k.device_time_total)[:12]
    for k in rows:
        print(f"{tag}: device {k.device_time_total / 1e3:8.2f} ms "
              f"{k.count:6d}x {k.key[:90]}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=6)
    ap.add_argument("--out", default=os.path.join("build", "traces"))
    a = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("needs an NVIDIA GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    vf = video_format(1920, 1080)
    frames = make_frames(a.frames, 1920, 1080)
    GopEncoder(vf, device="cuda", **CONFIG).encode_stream(frames[:2])
    torch.cuda.synchronize()

    enc = GopEncoder(vf, device="cuda", **CONFIG)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        stream = enc.encode_stream(frames)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    _report("encode", prof, wall, len(frames))
    os.makedirs(a.out, exist_ok=True)
    prof.export_chrome_trace(os.path.join(a.out, "encode_trace.json"))

    dec = StreamDecoder(device="cuda")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = dec.decode_stream(stream)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    _report("decode", prof, wall, len(out))
    if dec.md5_failures or dec.errors:
        raise RuntimeError(f"md5_failures={dec.md5_failures} "
                           f"errors={dec.errors}")
    print(f"card: {card}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
