"""One rank of the multi-process GOP-sharding encode.

    python -m schroedinger_tpu_torch.tools.multihost_worker <addr> <n_proc> \\
        <rank> <out> [--device cpu] [--size 64x64|1080p]

Port of `tools/multihost_worker.py`.  The process joins the
torch.distributed world at <addr> (tcp://host:port) as <rank> of
<n_proc> (`parallel/group.init`: NCCL where every rank has a GPU of its
own, gloo otherwise), encodes its GOP-aligned chunk of a deterministic
clip with per-chunk rate control (exact=False), gathers every chunk's
payload and writes the merged stream to <out>; its last line of output
is a JSON object of its rank, device, merged bytes and the ME kernel's
launches (`ops/patch_refine.LAUNCHES`).  The stream is the same
on every rank and equals the single-process
`gops.encode_gops_sharded(make_frames(size), make_encoder, n_shards=n_proc,
sequential=True, exact=False)`.

--size 64x64 (the default) is the JAX worker's clip and encoder: 8
frames, biref GOPs of 4 with subgroups of 2, TM5 CBR at 400 kbit/s,
scene change off.  --size 1080p is 48 frames of bench.py's pan + noise
(`slice_config.make_frames`) through bench.py's encoder (`CONFIG_BENCH`:
biref GOPs of 24, TM5 CBR at 8 Mbit/s).  Without --device the ranks run
on the card.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch.distributed as dist

from schroedinger_tpu_torch import slice_config
from schroedinger_tpu_torch.encoder.gop import GopEncoder
from schroedinger_tpu_torch.ops import patch_refine as pr
from schroedinger_tpu_torch.parallel import gops, group
from schroedinger_tpu_torch.video_format import ChromaFormat, VideoFormat

SIZES = ("64x64", "1080p")
N_FRAMES_1080P = 48


def make_frames(size: str = "64x64"):
    """The clip of `size`: (y, u, v) u8 planes per frame."""
    if size == "1080p":
        return slice_config.make_frames(N_FRAMES_1080P, 1920, 1080)
    n, W, H = 8, 64, 64
    rng = np.random.default_rng(0)
    base = (128 + 60 * np.sin(np.arange(W) / 7.0)[None, :]
            * np.cos(np.arange(H) / 5.0)[:, None])
    out = []
    for i in range(n):
        y = (np.roll(base, 2 * i, axis=1)
             + rng.normal(0, 3, (H, W))).clip(0, 255).astype(np.uint8)
        u = np.full((H // 2, W // 2), 128, np.uint8)
        v = np.full((H // 2, W // 2), 128, np.uint8)
        out.append((y, u, v))
    return out


def make_encoder(size: str = "64x64", device=None):
    """A fresh encoder of the clip of `size` on `device`."""
    if size == "1080p":
        return GopEncoder(slice_config.video_format(1920, 1080),
                          device=device, **slice_config.CONFIG_BENCH)
    vf = VideoFormat(width=64, height=64, clean_width=64, clean_height=64,
                     chroma_format=ChromaFormat.C420,
                     frame_rate_numerator=25, frame_rate_denominator=1)
    return GopEncoder(vf, gop_length=4, gop_structure="biref",
                      subgroup_length=2, bitrate=400000, fps=25,
                      enable_scene_change=False, device=device)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("addr")
    ap.add_argument("n_proc", type=int)
    ap.add_argument("rank", type=int)
    ap.add_argument("out")
    ap.add_argument("--device", default=None)
    ap.add_argument("--size", choices=SIZES, default="64x64")
    args = ap.parse_args(argv)
    dev = group.init(args.rank, args.n_proc, args.addr, args.device)
    try:
        merged = gops.encode_gops_multihost(
            make_frames(args.size),
            lambda: make_encoder(args.size, device=dev), exact=False)
    finally:
        dist.destroy_process_group()
    with open(args.out, "wb") as f:
        f.write(merged)
    print(json.dumps({"rank": args.rank, "device": str(dev),
                      "bytes": len(merged), "launches": pr.LAUNCHES}),
          flush=True)


if __name__ == "__main__":
    main()
