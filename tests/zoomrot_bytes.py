"""The zoomrot leg's bytes, picture by picture, in either package.

    python tests/zoomrot_bytes.py encode --package port --device cuda \
        --size 1920x1080 --out build/zoomrot/port-cuda.drc
    python tests/zoomrot_bytes.py encode --package jax --size 1280x720 \
        --out build/zoomrot/jax-cpu.drc
    python tests/zoomrot_bytes.py compare A.drc B.drc

`encode` codes bench.py's zoom and rotation content (`make_frames_zoomrot`
of the port's bench: the same seed and formula at any size) through the
bench's encoder (`GopEncoder` with `CONFIG_BENCH`, no warm-up) at a rate
scaled from the leg's 8 Mbit/s at 1080p by the picture area, writes the
stream and prints one JSON line: its bytes and each picture unit's
payload bytes in coded order.  `--package port` imports nothing of JAX
and runs on the card or the CPU; `--package jax` runs the JAX package's
`GopEncoder` on the CPU.  `compare` prints the first picture at which two
streams differ, or that they are equal byte for byte.
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from schroedinger_tpu_torch import bench  # noqa: E402
from schroedinger_tpu_torch import bitstream as bs  # noqa: E402
from schroedinger_tpu_torch.slice_config import CONFIG_BENCH  # noqa: E402

LEG_RATE = 8_000_000        # the leg's rate at 1920x1080


def payloads(stream):
    return [len(pl) for c, pl in bs.split_units(stream) if bs.is_picture(c)]


def encode(args):
    w, h = args.size
    frames = bench.make_frames_zoomrot(args.frames, width=w, height=h)
    rate = round(LEG_RATE * w * h / (1920 * 1080))
    t0 = time.perf_counter()
    if args.package == "port":
        import torch
        stream = bench.encode_leg(frames, torch.device(args.device), rate,
                                  warmup=False, tag="zoomrot").stream
    else:
        from schroedinger_tpu.encoder.gop import GopEncoder
        from schroedinger_tpu.video_format import ChromaFormat, VideoFormat
        vf = VideoFormat(width=w, height=h, clean_width=w, clean_height=h,
                         chroma_format=ChromaFormat.C420,
                         frame_rate_numerator=25, frame_rate_denominator=1)
        stream = GopEncoder(vf, **dict(CONFIG_BENCH, bitrate=rate)
                            ).encode_stream(frames)
    seconds = time.perf_counter() - t0
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "wb") as f:
        f.write(stream)
    print(json.dumps({"package": args.package, "device": args.device,
                      "size": [w, h], "frames": args.frames,
                      "bitrate": rate, "bytes": len(stream),
                      "seconds": round(seconds, 1),
                      "picture_payloads": payloads(stream)}), flush=True)


def compare(args):
    a, b = (open(p, "rb").read() for p in args.streams)
    pa, pb = payloads(a), payloads(b)
    diff = next((k for k, (x, y) in enumerate(zip(pa, pb)) if x != y), None)
    print(json.dumps({"equal": a == b, "bytes": [len(a), len(b)],
                      "pictures": [len(pa), len(pb)],
                      "first_differing_picture": diff}), flush=True)
    return 0 if a == b else 1


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python tests/zoomrot_bytes.py")
    sub = ap.add_subparsers(dest="cmd", required=True)
    enc = sub.add_parser("encode")
    enc.add_argument("--package", choices=("port", "jax"), default="port")
    enc.add_argument("--device", default="cpu")
    enc.add_argument("--size", type=bench.size_arg, default=(1920, 1080))
    enc.add_argument("--frames", type=int, default=32)
    enc.add_argument("--out", required=True)
    cmp_ = sub.add_parser("compare")
    cmp_.add_argument("streams", nargs=2)
    args = ap.parse_args(argv)
    if args.cmd == "compare":
        return compare(args)
    if args.package == "jax" and args.device != "cpu":
        ap.error("the JAX package runs on the CPU here")
    encode(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
