"""Cost probe of the patch-refine CUDA kernel, on one NVIDIA GPU.

    python -m schroedinger_tpu_torch.tools.profile_patch_refine

The port of `tools/profile_pk_parts.py` (which split the TPU kernel's
time into its DMA, lane roll and SAD loop).  It builds the kernel's four
compile-time variants (`csrc/patch_refine.cu`: full, nostage, nosad,
onewindow), makes inputs from a numpy seed at the probe's geometry
(68x128 blocks of 16x16, radius 2, hints within +-120) and at the four
refine shapes of a 1080p picture, times each variant with CUDA events
(20 launches after 3 warm-ups, the variants in turns) and prints one line
per variant and shape with the card's name and power limit.  Each variant
is timed twice: launched from Python as the encoder launches it, where a
call costs what the host needs to enqueue it, and as 20 launches captured
in one CUDA graph and replayed, which leaves the device's own time per
launch.  Differences of the device times
against `full` split the kernel's time: full - nostage is the staging of
the reference window into shared memory, full - nosad is 24 of the 25
SAD loops, full - onewindow is what the window reads cost in device
memory misses; what `nosad` keeps is launch, staging, one SAD, the warp
min-reduction and the write-out.

It needs the card and raises without one.
"""
from __future__ import annotations

import subprocess

import numpy as np
import torch

from schroedinger_tpu_torch.encoder import me as me_mod
from schroedinger_tpu_torch.ops import patch_refine as pr

RAD = me_mod.REFINE_RADIUS
MARGIN = me_mod.ME_BOUND_PEL + 2 * 8 + 16   # make_me_body, coarse radius 8
# (name, nby, nbx, bs): the TPU probe's geometry, then the four refine
# launches of a 1080p inter picture per reference (5-level pyramid on the
# 1088x1920 block grid)
PROBE_SHAPE = ("probe", 68, 128, 16)
REFINE_SHAPES = [("level 3", 34, 60, 4), ("level 2", 68, 120, 4),
                 ("level 1", 68, 120, 8), ("level 0", 68, 120, 16)]
HINT_BOUND = 120
ITERS, WARMUPS = 20, 3


def gpu_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def make_inputs(nby, nbx, bs, dev, seed=0, flat=False,
                hint_bound=HINT_BOUND):
    """patch_refine's arguments from numpy default_rng(seed): random u8
    current and reference planes (two flat planes with `flat`: every
    candidate ties) and hints in +-hint_bound."""
    rng = np.random.default_rng(seed)
    h, w = nby * bs, nbx * bs
    if flat:
        cur = np.full((h, w), 77, np.uint8)
        ref = np.full((h, w), 90, np.uint8)
    else:
        cur = rng.integers(0, 256, (h, w)).astype(np.uint8)
        ref = rng.integers(0, 256, (h, w)).astype(np.uint8)
    mvy = rng.integers(-hint_bound, hint_bound + 1, (nby, nbx)).astype(
        np.int32)
    mvx = rng.integers(-hint_bound, hint_bound + 1, (nby, nbx)).astype(
        np.int32)
    cb = me_mod._to_blocks(torch.tensor(cur, device=dev).to(torch.int32),
                           nby, bs, nbx, bs).contiguous()
    P = me_mod._pad_ref(torch.tensor(ref, device=dev), MARGIN).contiguous()
    return (cb, P, torch.tensor(mvy, device=dev),
            torch.tensor(mvx, device=dev), nby, nbx, bs, bs, RAD, MARGIN)


def time_ms(fn, args, iters=ITERS, warmups=WARMUPS) -> float:
    """Mean milliseconds of one call: CUDA events around `iters` calls."""
    for _ in range(warmups):
        fn(*args)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn(*args)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, args, iters=ITERS, warmups=WARMUPS) -> float:
    """Mean device milliseconds of one call: `iters` calls captured in
    one CUDA graph, CUDA events around one replay (no host work between
    the launches)."""
    for _ in range(warmups):
        fn(*args)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn(*args)
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def probe(nby, nbx, bs, dev, rounds=2):
    """({variant: mean ms launched from Python}, {variant: mean device ms
    from a graph replay}) at one shape, the variants timed in turns
    (`rounds` passes over all four, averaged)."""
    args = make_inputs(nby, nbx, bs, dev)
    eager = dict.fromkeys(pr.PROBE_VARIANTS, 0.0)
    device = dict.fromkeys(pr.PROBE_VARIANTS, 0.0)
    for _ in range(rounds):
        for v in pr.PROBE_VARIANTS:
            def launch(*a, v=v):
                return pr.patch_refine_probe(v, *a)
            eager[v] += time_ms(launch, args) / rounds
            device[v] += graph_ms(launch, args) / rounds
    return eager, device


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("the patch-refine cost probe needs an NVIDIA GPU")
    card = gpu_line()
    dev = torch.device("cuda")
    pr.build()
    for name, nby, nbx, bs in [PROBE_SHAPE] + REFINE_SHAPES:
        eager, device = probe(nby, nbx, bs, dev)
        for v in pr.PROBE_VARIANTS:
            print(f"{name} ({nby}x{nbx} blocks of {bs}x{bs}, rad {RAD}) "
                  f"{v}: {eager[v]:.4f} ms launched from Python, "
                  f"{device[v]:.4f} ms on the device [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
