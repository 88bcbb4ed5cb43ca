"""Rate-distortion sweep on the card: the port's `tools/bench_rd.py`.

    python -m schroedinger_tpu_torch.tools.bench_rd
        [--bitrates 1000000,2000000,4000000,8000000] [--frames 32]
        [--size 1920x1080] [--device cpu] [--work DIR] [--out PATH]

One leg, `rd`: `bench.py`'s encoder in true CBR at each bitrate on the
low-noise zoom-and-rotation clip (`make_frames_zoomrot(n, noise=1)`:
pan + noise saturates at its noise floor at any rate), the first rate
after a 6-frame warm-up; each stream held to the gates of
`schroedinger_tpu_torch.bench` (both decoders, the reference pictures,
luma PSNR >= 30 dB, the bytes against the pro-rata share, the searches)
and reported as (bytes, mean luma PSNR, frames/s).  At PROFILE.md §6's
settings (`--frames 96 --bitrates 500000,1000000,2000000,4000000`, 1080p
zoomrot) it also reports the Bjontegaard delta-rate of the port's points
against the JAX package's rows of that table (negative: the port needs
fewer bytes for the same PSNR).  The oracle side of the JAX tool is left
out (see `bench`).
"""
from __future__ import annotations

import sys

import numpy as np

from schroedinger_tpu_torch import bench
from schroedinger_tpu_torch.devices import resolve_device

BITRATES = (1_000_000, 2_000_000, 4_000_000, 8_000_000)
# PROFILE.md §6, the JAX package's sweep of 96 frames of the 1080p zoomrot
# clip at noise 1: rate asked -> (bytes, mean luma PSNR dB); the table
# gives kB and MB to 3-4 digits, and the last PSNR as "~44.6"
PROFILE_RD_FRAMES = 96
PROFILE_RD = {500_000: (508_000, 41.96), 1_000_000: (849_000, 44.19),
              2_000_000: (1_135_000, 44.49), 4_000_000: (1_940_000, 44.6)}


def bd_rate(rate_ref, psnr_ref, rate_test, psnr_test):
    """Bjontegaard delta-rate (%): the mean log-rate gap over the
    overlapping PSNR interval, cubic polyfit in (psnr -> log rate)."""
    lr_ref = np.log(np.asarray(rate_ref, np.float64))
    lr_test = np.log(np.asarray(rate_test, np.float64))
    p_ref = np.asarray(psnr_ref, np.float64)
    p_test = np.asarray(psnr_test, np.float64)
    deg = min(3, len(p_ref) - 1)
    c_ref = np.polyfit(p_ref, lr_ref, deg)
    c_test = np.polyfit(p_test, lr_test, deg)
    lo = max(p_ref.min(), p_test.min())
    hi = min(p_ref.max(), p_test.max())
    if hi <= lo:
        return float("nan")
    xs = np.linspace(lo, hi, 200)
    avg = np.mean(np.polyval(c_test, xs) - np.polyval(c_ref, xs))
    return float((np.exp(avg) - 1.0) * 100.0)


def leg_rd(args):
    w, h = args.size
    frames = bench.make_frames_zoomrot(args.frames, noise=1.0, width=w,
                                       height=h)
    dev = resolve_device(args.device)
    points = []
    for k, rate in enumerate(args.bitrates):
        run = bench.encode_leg(frames, dev, rate, warmup=k == 0,
                               tag=f"rd@{rate}")
        rep = bench.quality(run, frames, f"rd@{rate}", rate)
        points.append({"bitrate": rate, "bytes": rep["bytes"],
                       "padding_bytes": rep["padding_bytes"],
                       "psnr_db": rep["psnr_db"], "fps": round(run.fps, 3),
                       "mix": rep["mix"], "searches": rep["searches"],
                       "launches": rep["launches"]})
        print(f"rd {rate} bit/s: {rep['bytes']} bytes, {rep['psnr_db']:.3f} "
              f"dB, {run.fps:.3f} frames/s", file=sys.stderr, flush=True)
    out = {"frames": len(frames), "points": points}
    if (args.size == (bench.W, bench.H) and args.frames == PROFILE_RD_FRAMES
            and tuple(args.bitrates) == tuple(PROFILE_RD)):
        ref = [PROFILE_RD[p["bitrate"]] for p in points]
        out["bd_rate_vs_jax_pct"] = round(bd_rate(
            [r[0] for r in ref], [r[1] for r in ref],
            [p["bytes"] for p in points], [p["psnr_db"] for p in points]), 3)
    return out


LEGS = {"rd": leg_rd}


def _arguments(ap):
    ap.add_argument("--size", type=bench.size_arg, default=(bench.W, bench.H),
                    help="WxH (default 1920x1080)")
    ap.add_argument("--frames", type=int, default=32)
    ap.add_argument("--bitrates", default=",".join(map(str, BITRATES)),
                    type=lambda s: [int(b) for b in s.split(",")])


def main(argv=None) -> int:
    return bench.run("schroedinger_tpu_torch.tools.bench_rd", LEGS, argv,
                     _arguments)


if __name__ == "__main__":
    sys.exit(main())
