#!/usr/bin/env python3
"""schro_tpu (PyTorch port) — encode/decode CLI of the Dirac/VC-2 codec.

The port's counterpart of `tools/schro_tpu.py`, with the same arguments
plus --device (default: the CUDA card; `--device cpu` runs everything
on the CPU):

  encode:  python -m schroedinger_tpu_torch.tools.schro_tpu encode \
               in.y4m out.drc [--profile lowdelay|longgop] [--bitrate N]
               [--frames N] [--set name=value]... [--device cpu]
  decode:  python -m schroedinger_tpu_torch.tools.schro_tpu decode \
               in.drc out.y4m [--device cpu]
  settings: python -m schroedinger_tpu_torch.tools.schro_tpu list-settings

Every encoder setting in the registry (config.SETTINGS — same 71 names
and defaults as the reference, schroencoder.c:4461-4535) is reachable
with a repeatable `--set name=value`.  Input/output video is YUV4MPEG2
(.y4m; 8-bit, or 10-bit as C420p10/C422p10/C444p10, which the JAX CLI
refuses), "-" for stdin/stdout pipes, or raw planar I420 (.yuv) with an
explicit --size WxH.  The default profile is VC-2 low delay, as in the
JAX CLI.  A y4m input's It / Ib flag marks the source interlaced; it is
coded as field pictures only with `--set interlaced_coding=1` (on the
long-GOP profile), and `decode` weaves a field stream's pictures back
into frames (the JAX CLI writes the fields).  `decode --telemetry` draws
each inter picture's motion field onto its luma (decoder/overlay.py).
"""
import argparse
import os
import sys

import numpy as np


def read_yuv(path, w, h, max_frames=None):
    fsize = w * h * 3 // 2
    data = open(path, "rb").read()
    n = len(data) // fsize
    if max_frames:
        n = min(n, max_frames)
    frames = []
    for i in range(n):
        buf = np.frombuffer(data, np.uint8, fsize, i * fsize)
        y = buf[:w * h].reshape(h, w)
        u = buf[w * h:w * h + w * h // 4].reshape(h // 2, w // 2)
        v = buf[w * h + w * h // 4:].reshape(h // 2, w // 2)
        frames.append((y, u, v))
    return frames


def write_yuv(path, frames):
    with open(path, "wb") as f:
        for (y, u, v) in frames:
            f.write(y.tobytes())
            f.write(u.tobytes())
            f.write(v.tobytes())


def _is_y4m(path, for_input):
    if path == "-":
        return True
    if path.endswith(".y4m"):
        return True
    if for_input and os.path.exists(path):
        with open(path, "rb") as f:
            return f.read(9) == b"YUV4MPEG2"
    return False


def _limit(frames, n):
    for i, f in enumerate(frames):
        if n is not None and i >= n:
            break
        yield f


def _parse_set_value(v: str):
    for conv in (int, float):
        try:
            return conv(v)
        except ValueError:
            pass
    if v.lower() in ("true", "false"):
        return v.lower() == "true"
    return v


def encoder_config(profile: str = "lowdelay", bitrate: int = 0,
                   gop: int = 24, qi: int = 16):
    """The EncoderConfig `encode` starts from, before any --set: VC-2 low
    delay (LeGall 5,3, depth 4, default slices and bitrate) or long GOP."""
    from schroedinger_tpu_torch.config import EncoderConfig
    if profile == "lowdelay":
        return EncoderConfig(rate_control="low_delay", bitrate=bitrate,
                             transform_depth=4, intra_wavelet=1)
    cfg = EncoderConfig(au_distance=gop, quality=max(0.0, 10.0 - qi / 5.0))
    if bitrate:
        cfg.set("rate_control", "constant_bitrate")
        cfg.set("bitrate", bitrate)
    return cfg


def list_settings() -> None:
    """Introspection (the reference's settings listing,
    schroencoder.c:4537-4550): one line per registry setting."""
    from schroedinger_tpu_torch import config as _cfg
    for s in _cfg.SETTINGS:
        extra = ""
        if s.type == "enum":
            extra = "  {" + ",".join(s.enum_list) + "}"
            dflt = s.enum_list[int(s.default)]
        elif s.type == "bool":
            dflt = bool(s.default)
        elif s.type == "int":
            dflt = int(s.default)
        else:
            dflt = s.default
        print(f"{s.name:40s} {s.type:6s} [{s.min:g}..{s.max:g}] "
              f"default={dflt}{extra}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("cmd", choices=["encode", "decode", "list-settings"])
    ap.add_argument("infile", nargs="?",
                    help="y4m/yuv/drc path, or - for a pipe")
    ap.add_argument("outfile", nargs="?",
                    help="drc/y4m/yuv path, or - for a pipe")
    ap.add_argument("--size", default=None, help="WxH (raw .yuv only)")
    ap.add_argument("--profile", default="lowdelay",
                    choices=["lowdelay", "longgop"])
    ap.add_argument("--bitrate", type=int, default=0)
    ap.add_argument("--qi", type=int, default=16, help="base quant (longgop)")
    ap.add_argument("--gop", type=int, default=24)
    ap.add_argument("--frames", type=int, default=None)
    ap.add_argument("--fps", type=int, default=25)
    ap.add_argument("--set", action="append", default=[], metavar="NAME=VAL",
                    dest="settings", help="any registry setting (repeatable; "
                    "see list-settings)")
    ap.add_argument("--telemetry", action="store_true",
                    help="decode: draw the MV/split overlay")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card, the default) or cpu")
    args = ap.parse_args(argv)
    # the card's rule: None asks for it and fails cleanly without one
    device = None if args.device == "cuda" else args.device

    if args.cmd == "list-settings":
        list_settings()
        return
    if not args.infile or not args.outfile:
        ap.error(f"{args.cmd} needs infile and outfile")

    from schroedinger_tpu_torch.video_format import ChromaFormat, VideoFormat

    if args.cmd == "encode":
        if _is_y4m(args.infile, True):
            from schroedinger_tpu_torch import y4m
            src = sys.stdin.buffer if args.infile == "-" else args.infile
            vf, frames, _depth = y4m.read_y4m(src)
            frames = _limit(frames, args.frames)
            if args.fps != 25:
                vf.frame_rate_numerator = args.fps
                vf.frame_rate_denominator = 1
        else:
            if not args.size:
                ap.error("raw .yuv input needs --size WxH")
            w, h = (int(t) for t in args.size.split("x"))
            vf = VideoFormat(width=w, height=h, clean_width=w, clean_height=h,
                             chroma_format=ChromaFormat.C420,
                             frame_rate_numerator=args.fps,
                             frame_rate_denominator=1)
            frames = read_yuv(args.infile, w, h, args.frames)
        from schroedinger_tpu_torch.api import Encoder
        cfg = encoder_config(args.profile, args.bitrate, args.gop, args.qi)
        for pair in args.settings:
            if "=" not in pair:
                ap.error(f"--set needs name=value, got {pair!r}")
            name, _, val = pair.partition("=")
            try:
                cfg.set(name.strip(), _parse_set_value(val.strip()))
            except KeyError:
                ap.error(f"unknown setting {name!r} (see list-settings)")
            except ValueError as e:
                ap.error(str(e))
        enc = Encoder(vf, cfg, device=device)
        stream = enc.encode_stream(list(frames))
        n = enc.frame_number
        out = sys.stdout.buffer if args.outfile == "-" \
            else open(args.outfile, "wb")
        out.write(stream)
        out.flush()
        print(f"encoded {n} frames -> {len(stream)} bytes", file=sys.stderr)
    else:
        from schroedinger_tpu_torch.decoder.pipeline import \
            PipelinedStreamDecoder
        data = (sys.stdin.buffer.read() if args.infile == "-"
                else open(args.infile, "rb").read())
        dec = PipelinedStreamDecoder(telemetry=args.telemetry or None,
                                     device=device)
        from schroedinger_tpu_torch.api import weave_pictures
        frames = weave_pictures(dec.decode_stream(data), dec.vf)
        if _is_y4m(args.outfile, False):
            from schroedinger_tpu_torch import y4m
            dst = sys.stdout.buffer if args.outfile == "-" else args.outfile
            wr = y4m.Y4MWriter(dst, dec.vf, dec.vf.bit_depth)
            wr.write_frames(frames)
            wr.close()
        else:
            write_yuv(args.outfile, frames)
        print(f"decoded {len(frames)} frames", file=sys.stderr)


if __name__ == "__main__":
    main()
