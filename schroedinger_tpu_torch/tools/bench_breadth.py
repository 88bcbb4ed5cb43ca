"""Breadth legs on the card: the port's `tools/bench_breadth.py`.

    python -m schroedinger_tpu_torch.tools.bench_breadth
        [--legs 576i25,720p10-422-intra] [--device cpu] [--frames 24]
        [--sd-size 720x576] [--hd-size 1280x720] [--work DIR] [--out PATH]

  576i25            720x576i25 4:2:0 field coding through api.Encoder
                    (TM5 CBR at 4 Mbit/s, quarter-pel MVs; each frame two
                    field pictures), `--frames` frames after a 2-frame
                    warm-up; the gates of `schroedinger_tpu_torch.bench` on
                    the woven frames (api.Decoder) and the fields
                    (StreamDecoder)
  720p10-422-intra  1280x720 10-bit 4:2:2 main-profile intra pictures
                    (Deslauriers-Dubuc 9,7 at depth 3, every codeblock at
                    quant index 12), max(frames / 2, 8) frames after a
                    one-picture warm-up; the pipelined and per-picture decoders equal,
                    every frame out, luma PSNR >= 30 dB at peak 1023

The port's own decoders take the place of the JAX tool's oracle decode.
Each leg runs in its own process and prints its JSON line; the runner
prints a merged line last.
"""
from __future__ import annotations

import sys
import time

import numpy as np

from schroedinger_tpu_torch import api
from schroedinger_tpu_torch import bench
from schroedinger_tpu_torch import bitstream as bs
from schroedinger_tpu_torch.config import EncoderConfig
from schroedinger_tpu_torch.devices import resolve_device
from schroedinger_tpu_torch.encoder import intra as ei
from schroedinger_tpu_torch.params import Params
from schroedinger_tpu_torch.slice_config import video_format
from schroedinger_tpu_torch.video_format import ChromaFormat
from schroedinger_tpu_torch.wavelets import Wavelet

SD = (720, 576)
HD = (1280, 720)
SD_BITRATE = 4_000_000
PEAK10 = 1023.0


def sd_frames(n, width=SD[0], height=SD[1]):
    """The JAX tool's SD content: a smooth luma pattern panned 2 px a frame
    plus N(0, 4) noise (seed 0), flat chroma."""
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:height, 0:width]
    base = 128 + 64 * np.sin(xx / 23.0) * np.cos(yy / 17.0)
    u = np.full((height // 2, width // 2), 120, np.uint8)
    v = np.full((height // 2, width // 2), 135, np.uint8)
    return [((np.roll(base, 2 * i, axis=1)
              + rng.normal(0, 4, (height, width))).clip(0, 255).astype(
                  np.uint8), u, v) for i in range(n)]


def deep_frames(n, width=HD[0], height=HD[1]):
    """The JAX tool's 10-bit 4:2:2 content: a pattern panned 1 px a frame
    plus N(0, 8) noise (seed 1), flat chroma at 512."""
    rng = np.random.default_rng(1)
    yy, xx = np.mgrid[0:height, 0:width]
    base = 512 + 256 * np.sin(xx / 19.0) * np.cos(yy / 13.0)
    u = np.full((height, width // 2), 512, np.uint16)
    v = np.full((height, width // 2), 512, np.uint16)
    return [((np.roll(base, i, axis=1) + rng.normal(0, 8, (height, width)))
             .clip(0, 1013).astype(np.uint16), u, v) for i in range(n)]


def leg_576i25(args):
    w, h = args.sd_size
    frames = sd_frames(args.frames, w, h)
    dev = resolve_device(args.device)

    def make():
        # api.Encoder marks the format it is given for field coding, so
        # each encoder takes a fresh one
        return api.Encoder(video_format(w, h), EncoderConfig(
            rate_control="constant_bitrate", bitrate=SD_BITRATE,
            interlaced_coding=True, mv_precision=2), device=dev)
    run = bench.timed_encode(make, frames, dev, warm=2, tag="576i25")
    rep = {"frames": len(frames), "fields": 2 * len(frames),
           "fps": round(run.fps, 3)}
    rep.update(bench.quality(run, frames, "576i25", SD_BITRATE))
    return rep


def deep_intra(n, size, device):
    """n frames of the 10-bit 4:2:2 content at `size` coded as main-profile
    intra pictures on `device`, decoded by both decoders; the gates; the
    report."""
    w, h = size
    frames = deep_frames(n, w, h)
    dev = resolve_device(device)
    vf = video_format(w, h, ChromaFormat.C422, bit_depth=10)
    p = Params(video_format=vf, num_refs=0, transform_depth=3,
               wavelet_filter_index=Wavelet.DESLAURIERS_DUBUC_9_7)
    p.set_default_codeblocks()
    p.set_default_quant_matrix()
    # every codeblock of every band at 12.  The JAX tool's (1, 1) map per
    # band does not match the default codeblock grid, and encode_picture
    # takes it unchecked: its pictures decode wrong, in both packages
    qis = 12
    ei.encode_picture(frames[0], p, 0, quant_indices=qis, is_ref=False,
                      device=dev)                                # warm-up
    bench.sync(dev)
    chain = bs.OffsetChain()
    units = []
    t0 = time.perf_counter()
    for i, f in enumerate(frames):
        units.append(chain.add(
            [bs.write_sequence_header(vf, profile=2, level=0),
             ei.encode_picture(f, p, i, quant_indices=qis, is_ref=False,
                               device=dev)]))
    bench.sync(dev)
    seconds = time.perf_counter() - t0
    stream = b"".join(units) + chain.add([bs.make_eos_unit()],
                                         final_eos=True)
    bench.log(f"[720p10-422-intra] {len(frames)} frames: "
              f"{len(frames) / seconds:.3f} frames/s, {len(stream)} bytes")
    runs = bench.decode_both(stream, dev)
    vals = bench.check_decodes(runs, frames, {}, "720p10-422-intra", PEAK10)
    out = runs["pipelined"][0][2]
    err = max(int(np.abs(o[0].astype(np.int64) - f[0].astype(np.int64))
                  .max()) for o, f in zip(out, frames))
    return {"frames": len(frames), "fps": round(len(frames) / seconds, 3),
            "bytes": len(stream), "psnr_db": round(np.mean(vals), 4),
            "psnr_min_db": round(min(vals), 4), "max_abs_err": err,
            "decode_fps_pipelined": round(
                len(frames) / runs["pipelined"][0][0], 3),
            "decode_fps_per_picture": round(
                len(frames) / runs["per-picture"][0][0], 3)}


def leg_deep_intra(args):
    return deep_intra(max(args.frames // 2, 8), args.hd_size, args.device)


LEGS = {"576i25": leg_576i25, "720p10-422-intra": leg_deep_intra}


def _arguments(ap):
    ap.add_argument("--frames", type=int, default=24)
    ap.add_argument("--sd-size", type=bench.size_arg, default=SD,
                    help="WxH of the field leg (default 720x576)")
    ap.add_argument("--hd-size", type=bench.size_arg, default=HD,
                    help="WxH of the 10-bit intra leg (default 1280x720)")


def main(argv=None) -> int:
    return bench.run("schroedinger_tpu_torch.tools.bench_breadth", LEGS,
                     argv, _arguments)


if __name__ == "__main__":
    sys.exit(main())
