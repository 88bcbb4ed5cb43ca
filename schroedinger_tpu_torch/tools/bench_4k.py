"""The 2160p25 long-GOP CBR encode and decode on the card: the port's
`tools/bench_4k.py`.

    python -m schroedinger_tpu_torch.tools.bench_4k [--legs 4k-backref,4k-biref]
        [--device cpu] [--size 3840x2160] [--frames 12] [--bitrate 24000000]
        [--work DIR] [--out PATH]

3840x2160 4:2:0 pan + noise (seed 0), 24 Mbit/s, GOP 24, quarter-pel MVs:
  4k-backref  the encoder's default engine (backref: I and one-reference
              P pictures), after a 2-frame warm-up, as the JAX tool runs it
  4k-biref    the flagship engine (biref: two-reference P and batches of
              B pictures), after a 6-frame warm-up
Each leg encodes, then decodes its stream with the pipelined decoder and
the per-picture one, with the gates of `schroedinger_tpu_torch.bench`
(both decoders equal, every reference picture equal to the encoder's
reconstruction, luma PSNR >= 30 dB, bytes within 0.1x-4x of the pro-rata
share, the searches the pictures imply).  Each leg runs in its own
process and prints its JSON line; the runner prints a merged line last.
The oracle side of the JAX tool is left out (see `bench`).
"""
from __future__ import annotations

import sys

import numpy as np

from schroedinger_tpu_torch import bench
from schroedinger_tpu_torch.devices import resolve_device
from schroedinger_tpu_torch.encoder.gop import GopEncoder
from schroedinger_tpu_torch.slice_config import video_format

W, H = 3840, 2160
BITRATE = 24_000_000


def make_frames(n, width=W, height=H):
    """The JAX tool's content: a smooth luma pattern panned 3 px a frame
    plus N(0, 4) noise (seed 0), smooth chroma."""
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:height, 0:width]
    base_y = 128 + 64 * np.sin(xx / 53.0) * np.cos(yy / 31.0)
    u = (128 + 24 * np.cos(xx[::2, ::2] / 41.0)).astype(np.uint8)
    v = (128 + 24 * np.sin(yy[::2, ::2] / 37.0)).astype(np.uint8)
    return [((np.roll(base_y, i * 3, axis=1)
              + rng.normal(0, 4, (height, width))).clip(0, 255).astype(
                  np.uint8), u, v) for i in range(n)]


def leg(engine, warm, args):
    """Encode the clip with `engine` (None: the default) after a warm-up
    of `warm` frames, then decode it; the gates; the report."""
    w, h = args.size
    frames = make_frames(args.frames, w, h)
    dev = resolve_device(args.device)
    vf = video_format(w, h)
    kw = dict(gop_length=24, mv_precision=2, bitrate=args.bitrate, fps=25)
    if engine:
        kw["gop_structure"] = engine
    run = bench.timed_encode(lambda: GopEncoder(vf, device=dev, **kw),
                             frames, dev, warm=warm, tag=args.leg,
                             per_frame=True)
    rep = {"frames": len(frames), "engine": run.enc.gop_structure,
           "fps": round(run.fps, 3)}
    rep.update(bench.quality(run, frames, args.leg, args.bitrate))
    return rep


LEGS = {"4k-backref": lambda args: leg(None, 2, args),
        "4k-biref": lambda args: leg("biref", 6, args)}


def _arguments(ap):
    ap.add_argument("--size", type=bench.size_arg, default=(W, H),
                    help="WxH (default 3840x2160)")
    ap.add_argument("--frames", type=int, default=12)
    ap.add_argument("--bitrate", type=int, default=BITRATE)


def main(argv=None) -> int:
    return bench.run("schroedinger_tpu_torch.tools.bench_4k", LEGS, argv,
                     _arguments)


if __name__ == "__main__":
    sys.exit(main())
