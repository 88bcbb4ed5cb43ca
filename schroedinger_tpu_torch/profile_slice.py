"""Where the time of the 1080p slice goes, on one NVIDIA GPU.

    python -m schroedinger_tpu_torch.profile_slice
        [--config backref|flagship|draining|bench|lowdelay|
                  backref-quality|constant-error|multiquant|
                  phasecorr-chroma|prefilter-metrics|interlaced-cbr]
        [--frames N] [--out DIR]

Encodes pan + noise 1080p25 4:2:0 frames with the port's GopEncoder under
torch.profiler after a warm-up, then decodes the stream the same way.
`--config backref` (6 frames, 2 of warm-up) is the fixed-quantiser
I P P P slice; `--config flagship` (13 frames, 6 of warm-up) the biref
TM5 CBR encode with the on-device RD pick; `--config draining` (9 frames,
6 of warm-up) the flagship at 1 Mbit/s with a half-empty reservoir, where
the RD pick runs its 22-step lambda fit; `--config bench` (13 frames, 6
of warm-up) bench.py's headline encoder, the flagship with MD5 off and
each subgroup's B pictures batched, decoded by the pipelined decoder.
`--config lowdelay` (13 frames, 2 of warm-up) is what `schro_tpu encode`
does by default, VC-2 low delay through api.Encoder, on 10-bit 4:2:2
frames, decoded as `schro_tpu decode` does; its spans are the device
analysis, the native slice decode and the inverse wavelet, and the
encoder's worker thread reports its fetch and native packing time.
`--config backref-quality`, `constant-error` and `multiquant` (13
frames, 6 of warm-up) run api.Encoder under EncoderConfig(
gop_structure="backref"), (rate_control="constant_error") and
(enable_multiquant=True): chip_smoke's phases 15, 17 and 18;
`phasecorr-chroma` (phase correlation with chroma ME, B pictures one at a
time) and `prefilter-metrics` (the Gaussian prefilter with PSNR and SSIM)
run the estimation and prefilter settings of phases 20 and 22;
`interlaced-cbr` phase 23's 1080i25 field coding (TM5 CBR at 8 Mbit/s,
quarter-pel, bottom field first: the format's default), whose decode
counts field pictures.
Prints, per run: wall time,
the device's busy time (union of kernel intervals) and idle share, the
host time in the entropy-coding calls and in the encoder's stage spans
(each ME pass, the RD split, the render, the stat tables, the RD pick,
quantise + reconstruction, the fetch; and around them the step of a
batch of B pictures or of one B picture) with the device events each
launched, and the top kernels (not aten ops) by device time.  Writes a Chrome trace of the encode to DIR.
"""
from __future__ import annotations

import argparse
import bisect
import os
import subprocess
import time

import torch
from torch.profiler import ProfilerActivity, profile

from schroedinger_tpu_torch import api
from schroedinger_tpu_torch.config import EncoderConfig
from schroedinger_tpu_torch.decoder.core import StreamDecoder
from schroedinger_tpu_torch.decoder.pipeline import PipelinedStreamDecoder
from schroedinger_tpu_torch.encoder.gop import GopEncoder
from schroedinger_tpu_torch.slice_config import (CONFIG, CONFIG_BENCH,
                                                 CONFIG_FLAGSHIP,
                                                 CONFIG_FLAGSHIP_DRAINING,
                                                 make_frames, video_format)
from schroedinger_tpu_torch.tools.schro_tpu import encoder_config
from schroedinger_tpu_torch.video_format import ChromaFormat

# name -> (encoder options, frames, warm-up frames); "lowdelay" runs
# api.Encoder with the CLI's default configuration instead of GopEncoder
CONFIGS = {"backref": (CONFIG, 6, 2), "flagship": (CONFIG_FLAGSHIP, 13, 6),
           "draining": (CONFIG_FLAGSHIP_DRAINING, 9, 6),
           "bench": (CONFIG_BENCH, 13, 6), "lowdelay": (None, 13, 2)}
# name -> EncoderConfig keywords of an api.Encoder run (13 frames, 6 of
# warm-up): the long-GOP rate controls
API_CONFIGS = {"backref-quality": dict(gop_structure="backref"),
               "constant-error": dict(rate_control="constant_error"),
               "multiquant": dict(enable_multiquant=True),
               "phasecorr-chroma": dict(enable_phasecorr_estimation=1,
                                        enable_chroma_me=1),
               "prefilter-metrics": dict(filtering="gaussian",
                                         enable_psnr=1, enable_ssim=1),
               "interlaced-cbr": dict(rate_control="constant_bitrate",
                                      bitrate=8_000_000, interlaced_coding=1,
                                      mv_precision=2)}
# record_function spans of the port: host entropy coding, then the inter
# and intra steps' stages (host time of a stage = its enqueue, not the
# device's work)
HOST_SPANS = ("encode_subband_arith", "decode_subband_arith",
              "encode_subband_noarith", "decode_subband_noarith",
              "motion_encode", "motion_decode", "frame_md5", "ld_pack",
              "ld_decode")
STAGE_SPANS = ("me_pass", "phasecorr", "rd_split", "render", "stat_tables",
               "rd_pick", "multiquant", "quantise_recon", "p_transfer",
               "b_batch_step", "b_picture_step", "prefilter",
               "quality_metrics", "ld_analysis", "ld_inverse")


_CUDA = torch.autograd.DeviceType.CUDA
# the port's own kernels (csrc/patch_refine.cu)
OWN_KERNELS = ("me_rows_kernel", "me_cands_kernel")


def _device_busy_us(prof):
    """Union of the device kernel/memcpy intervals, in microseconds (the
    device-side mirrors of record_function spans are no work and are left
    out)."""
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == _CUDA and not e.is_user_annotation)
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


def _events_under(prof, names):
    """{span name: device events (kernels and copies) inside the span's
    device-side mirrors}: on the one stream, the work that span
    launched."""
    starts = sorted(e.time_range.start for e in prof.events()
                    if e.device_type == _CUDA and not e.is_user_annotation)
    counts = {}
    for e in prof.events():
        if (e.device_type == _CUDA and e.is_user_annotation
                and e.name in names):
            counts[e.name] = (counts.get(e.name, 0)
                              + bisect.bisect_right(starts, e.time_range.end)
                              - bisect.bisect_left(starts,
                                                   e.time_range.start))
    return counts


def _report(tag, prof, wall_s, n_frames):
    busy_us, n_dev = _device_busy_us(prof)
    print(f"{tag}: {n_frames} frames in {wall_s:.3f} s "
          f"({n_frames / wall_s:.3f} frames/s); device busy "
          f"{busy_us / 1e3:.1f} ms, idle share "
          f"{1 - busy_us / 1e6 / wall_s:.3f}; {n_dev} device events "
          f"({n_dev / n_frames:.0f} per frame)", flush=True)
    avg = prof.key_averages()
    # a record_function span has a host row (its time on the host clock
    # and the time of the kernels launched under it) and a device-side
    # mirror (first to last of those kernels on the device's timeline)
    host = {k.key: k for k in avg if k.device_type != _CUDA}
    mirror = {k.key: k for k in avg
              if k.device_type == _CUDA and k.is_user_annotation}
    events = _events_under(prof, STAGE_SPANS)
    for name in HOST_SPANS + STAGE_SPANS:
        if name in host:
            k = host[name]
            line = (f"{tag}: span {name} x{k.count}: host "
                    f"{k.cpu_time_total / 1e3:.1f} ms, kernels under it "
                    f"{k.device_time_total / 1e3:.1f} ms")
            if name in mirror:
                line += (f", on the device's timeline "
                         f"{mirror[name].device_time_total / 1e3:.1f} ms, "
                         f"{events.get(name, 0)} device events")
            print(line, flush=True)
    rows = sorted((k for k in avg if k.device_time_total > 0
                   and k.device_type == _CUDA and not k.is_user_annotation),
                  key=lambda k: -k.device_time_total)[:12]
    # the port's own kernels always, then the top rows
    own = [k for k in avg if k.device_type == _CUDA
           and any(n in k.key for n in OWN_KERNELS) and k not in rows]
    for k in own + rows:
        print(f"{tag}: device {k.device_time_total / 1e3:8.2f} ms "
              f"{k.count:6d}x {k.key[:90]}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", choices=sorted(CONFIGS) + sorted(API_CONFIGS),
                    default="backref")
    ap.add_argument("--frames", type=int, default=None)
    ap.add_argument("--out", default=os.path.join("build", "traces"))
    a = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("needs an NVIDIA GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    config, n_frames, n_warm = CONFIGS.get(a.config, (None, 13, 6))
    if a.config in API_CONFIGS:
        vf = video_format(1920, 1080)
        frames = make_frames(a.frames or n_frames, 1920, 1080)

        def new_encoder():
            return api.Encoder(vf, EncoderConfig(**API_CONFIGS[a.config]),
                               device="cuda")
    elif config is None:
        vf = video_format(1920, 1080, ChromaFormat.C422, 10)
        frames = make_frames(a.frames or n_frames, 1920, 1080,
                             chroma_format=ChromaFormat.C422, bit_depth=10)

        def new_encoder():
            return api.Encoder(vf, encoder_config("lowdelay"),
                               device="cuda")
    else:
        vf = video_format(1920, 1080)
        frames = make_frames(a.frames or n_frames, 1920, 1080)

        def new_encoder():
            return GopEncoder(vf, device="cuda", **config)
    new_encoder().encode_stream(frames[:n_warm])
    torch.cuda.synchronize()

    enc = new_encoder()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        stream = enc.encode_stream(frames)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    _report("encode", prof, wall, len(frames))
    if a.config == "lowdelay":
        # the fetch and the packing run on the encoder's worker thread,
        # whose spans the profiler does not record
        print(f"encode: worker thread: fetch "
              f"{enc.ld_seconds['fetch'] * 1e3:.1f} ms, native packing "
              f"{enc.ld_seconds['pack'] * 1e3:.1f} ms", flush=True)
    else:
        fitted = [f for f in getattr(enc, "_gop", enc).stats.frames
                  if (f.get("target_bits") or 0) > 0]
        print(f"encode: the lambda fit ran on {len(fitted)} pictures and "
              f"bound (scale < 0.99) on "
              f"{sum(1 for f in fitted if f['lam_scale'] < 0.99)}",
              flush=True)
    os.makedirs(a.out, exist_ok=True)
    prof.export_chrome_trace(
        os.path.join(a.out, f"encode_trace_{a.config}.json"))

    dec = (PipelinedStreamDecoder
           if a.config in ("bench", "lowdelay") or a.config in API_CONFIGS
           else StreamDecoder)(device="cuda")
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
