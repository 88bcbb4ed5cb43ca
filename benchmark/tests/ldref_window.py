"""The program's low-delay analysis of the window's own pictures held to
`ldref.py`, the plain reference, with torch.equal, at the configuration's
own size:

    python3 benchmark/tests/ldref_window.py --seeds 1,2 [--clips 0,7]
        [--device cuda] [--size WxH] [--frames N]

For each seed the clips of the low-delay cell (`lowdelay_cell.py`, which
finds the cell without `BENCHMARK.json`) are made as `run.run` makes them
(the configuration, the mix and `harness/content.py`), and each of `--clips`
is coded whole by a new encoder of the configuration
(`harness/codec.py`), as the window codes it.  The analysis the encoder
runs on each picture is kept as it comes from the device, then compared
with `ldref.analyse` of the same source picture.  The program is reached
only through the harness's adapter.  One JSON line per seed and clip:
the pictures compared, those equal, for each that differs the outputs
that differ (0-2 the Y, U, V slices, 3-8 the bits and last nonzero
positions of Y, U and V), and the change of the program's counters over
the clip's encode.
"""
import argparse
import json
import os
import sys
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import run  # noqa: E402  (puts the repository on the path)
import ldref  # noqa: E402
import lowdelay_cell  # noqa: E402
from harness import codec as hc  # noqa: E402
from harness import content  # noqa: E402


def capturing(kept):
    """The program's factory of analysis functions, wrapped so that each
    picture's analysis is appended to `kept`."""
    real = hc.api.loe._get_analyze_fn

    def get(params):
        fn = real(params)

        def analyse(*planes):
            out = fn(*planes)
            kept.append(out)
            return out
        return analyse
    return get


def flat(out):
    return list(out[:3]) + [a for agg in out[3:] for a in agg]


def compare(seed, clips, device, size=None, frames=None):
    _, cfg, traffic, _, _, _ = lowdelay_cell.load(10, {})
    fmt = dict(cfg["format"])
    if size:
        fmt["width"], fmt["height"] = size
        cfg = dict(cfg, format=fmt)
    if frames:
        traffic["frames"] = frames
    made = content.make_clips(traffic, fmt["width"], fmt["height"],
                              fmt["chroma"], fmt["bit_depth"], seed, device)
    codec = hc.Codec(cfg, device)
    depth = cfg["encoder"]["transform_depth"]
    lines = []
    for k in clips:
        kept = []
        real = hc.api.loe._get_analyze_fn
        hc.api.loe._get_analyze_fn = capturing(kept)
        before = codec.counters()
        try:
            t = time.perf_counter()
            codec.new_encoder().encode_stream(made[k])
            encode_s = time.perf_counter() - t
        finally:
            hc.api.loe._get_analyze_fn = real
        counted = {n: v - before.get(n, 0)
                   for n, v in codec.counters().items()
                   if v != before.get(n, 0)}
        t = time.perf_counter()
        differing = {}
        for i, (frame, got) in enumerate(zip(made[k], kept)):
            want = ldref.analyse(frame, fmt["bit_depth"], fmt["chroma"],
                                 depth, device=device)
            bad = [j for j, (g, w) in enumerate(zip(flat(got), flat(want)))
                   if not torch.equal(g.to(torch.int64), w)]
            if bad:
                differing[i] = bad
        lines.append({"seed": seed, "clip": k, "pictures": len(made[k]),
                      "compared": len(kept), "equal": len(kept) - len(
                          differing), "differing": differing,
                      "counters": counted, "encode_s": encode_s,
                      "reference_s": time.perf_counter() - t,
                      "device": (torch.cuda.get_device_name(0)
                                 if torch.device(device).type == "cuda"
                                 else "cpu")})
    return lines


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--clips", default="0,7")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--size", default=None)
    ap.add_argument("--frames", type=int, default=None)
    a = ap.parse_args()
    size = tuple(int(x) for x in a.size.split("x")) if a.size else None
    clips = [int(c) for c in a.clips.split(",")]
    ok = True
    for seed in a.seeds.split(","):
        for line in compare(int(seed), clips, a.device, size, a.frames):
            ok &= line["equal"] == line["pictures"] == line["compared"]
            print(json.dumps(line), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
