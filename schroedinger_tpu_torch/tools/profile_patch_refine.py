"""Cost probe of the ME search CUDA kernel, on one NVIDIA GPU.

    python -m schroedinger_tpu_torch.tools.profile_patch_refine

The port of `tools/profile_pk_parts.py` (which split the TPU kernel's
time into its DMA, lane roll and SAD loop).  It builds the kernel's four
compile-time variants (`csrc/patch_refine.cu`: full, nostage, nosad,
onewindow), makes inputs from a numpy seed at the probe's geometry
(68x128 blocks of 16x16, radius 2, hints within +-120) and at the seven
launch shapes of one reference of a 1080p picture (REFINE_SHAPES), times
each variant with CUDA events (20 launches after 3 warm-ups, the variants
in turns) and prints one line per variant and shape with the card's name
and power limit.  Each variant is timed twice: launched from Python as
the encoder launches it, where a call costs what the host needs to
enqueue it, and as 20 launches captured in one CUDA graph and replayed,
which leaves the device's own time per launch.  Differences of the device
times against `full` split the kernel's time: full - nostage is the
reference-window reads, full - nosad is the other candidates' SADs and
their reduction, full - onewindow is what the window reads cost in device
memory misses; what `nosad` keeps is launch, the reads, one SAD, the
minimum and the write-out.  Last, at each of the seven launch shapes,
the closest library route to the kernel's function (`unfold` of the
windows, `torch.cdist(p=1)`, `argmin`; `library_search`) is held equal to
the plain version and timed beside the kernel.

It needs the card and raises without one.
"""
from __future__ import annotations

import subprocess

import numpy as np
import torch

from schroedinger_tpu_torch.encoder import me as me_mod
from schroedinger_tpu_torch.ops import cuda_build
from schroedinger_tpu_torch.ops import patch_refine as pr

COARSE_RADIUS = 8                           # make_me_body's at 1080p
MARGIN = me_mod.ME_BOUND_PEL + 2 * COARSE_RADIUS + 16
# (name, nby, nbx, bs, rad, scale, field grid (hy, hx) or None): the TPU
# probe's geometry, then the seven launches of one reference of a 1080p
# inter picture (5-level pyramid on the 1088x1920 block grid): the coarse
# scan, four hint refines, the median and the zero SAD
PROBE_SHAPE = ("probe", 68, 128, 16, 2, 1, (68, 128))
REFINE_SHAPES = [
    ("level 4 coarse", 17, 30, 4, COARSE_RADIUS, 0, None),
    ("level 3", 34, 60, 4, 2, 2, (17, 30)),
    ("level 2", 68, 120, 4, 2, 2, (34, 60)),
    ("level 1", 68, 120, 8, 2, 2, (68, 120)),
    ("level 0", 68, 120, 16, 2, 2, (68, 120)),
    ("level 0 median", 68, 120, 16, 0, 1, (68, 120)),
    ("level 0 zero", 68, 120, 16, 0, 0, None)]
HINT_BOUND = 120
ITERS, WARMUPS = 20, 3
# the card's published peaks (NVIDIA H100 SXM data sheet): device memory
# rate, and the float32 rate outside the tensor cores, which stands in for
# the integer units' rate (the data sheet gives none; theirs is not higher)
HBM_BYTES_PER_S = 3.35e12
ALU_OPS_PER_S = 67e12


def gpu_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def make_inputs(shape, dev, seed=0, flat=False, hint_bound=HINT_BOUND,
                bound=me_mod.ME_BOUND_PEL):
    """me_search's arguments at one of the shapes above, from numpy
    default_rng(seed): random u8 current and reference planes (two flat
    planes with `flat`: every candidate ties) and a field whose hints,
    scaled, fall in +-hint_bound."""
    _, nby, nbx, bs, rad, scale, grid = shape
    rng = np.random.default_rng(seed)
    h, w = nby * bs, nbx * bs
    if flat:
        cur = np.full((h, w), 77, np.uint8)
        ref = np.full((h, w), 90, np.uint8)
    else:
        cur = rng.integers(0, 256, (h, w)).astype(np.uint8)
        ref = rng.integers(0, 256, (h, w)).astype(np.uint8)
    field = None
    if grid is not None:
        lim = hint_bound // max(scale, 1)
        field = torch.tensor(rng.integers(-lim, lim + 1, (*grid, 2)).astype(
            np.int32), device=dev)
    return (torch.tensor(cur, device=dev), torch.tensor(ref, device=dev),
            field, scale, bs, bs, rad, bound, MARGIN)


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


def probe(shape, dev, rounds=2):
    """({variant: mean ms launched from Python}, {variant: mean device ms
    from a graph replay}) at one shape, the variants timed in turns
    (`rounds` passes over all four, averaged)."""
    args = make_inputs(shape, dev)
    eager = dict.fromkeys(pr.PROBE_VARIANTS, 0.0)
    device = dict.fromkeys(pr.PROBE_VARIANTS, 0.0)
    for _ in range(rounds):
        for v in pr.PROBE_VARIANTS:
            def launch(*a, v=v):
                return pr.me_search_probe(v, *a)
            eager[v] += time_ms(launch, args) / rounds
            device[v] += graph_ms(launch, args) / rounds
    return eager, device


def library_search(cur, ref, field, scale, bs_y, bs_x, rad, bound, margin):
    """me_search's function (N = 1) by the closest library route: each
    block's (2 rad + 1)^2 candidate windows by `unfold` of its
    hint-displaced patch, their L1 distances to the block by
    `torch.cdist(p=1)` (float32: exact, a SAD is below 2^24) and the
    first minimum by `argmin`.  Returns (mv, sad) as me_search does."""
    h, w = cur.shape
    nby, nbx = h // bs_y, w // bs_x
    hint = pr.upsample_hint(field, nby, nbx, scale, bound, cur.device)
    pat = pr.extract_ref_patches(pr.pad_ref(ref, margin), hint[..., 0],
                                 hint[..., 1], nby, nbx, bs_y, bs_x, rad,
                                 margin)
    k = 2 * rad + 1
    win = pat[:, :bs_y + 2 * rad, :bs_x + 2 * rad].unfold(
        1, bs_y, 1).unfold(2, bs_x, 1).reshape(-1, k * k, bs_y * bs_x)
    blocks = pr.to_blocks(cur, nby, bs_y, nbx, bs_x).reshape(
        -1, 1, bs_y * bs_x)
    dist = torch.cdist(blocks.float(), win.float(), p=1)[:, 0]
    best = dist.argmin(1)
    mv = hint + torch.stack([torch.div(best, k, rounding_mode="floor") - rad,
                             best % k - rad], -1).reshape(nby, nbx, 2)
    sad = dist.gather(1, best[:, None]).reshape(nby, nbx)
    return mv.to(torch.int32), sad.to(torch.int32)


def library_line(shape, dev, card) -> str:
    """The library route at a launch shape against the plain version
    (torch.equal of mv and sad) and against the kernel, both timed in
    turns (kernel, library, library, kernel): the kernel on the device
    alone (graph replay) and from Python, the library route from
    Python."""
    args = make_inputs(shape, dev)
    mv, sad = library_search(*args)
    pm, ps = pr.me_search_plain(*args)
    equal = torch.equal(mv, pm) and torch.equal(sad, ps)
    kern = graph_ms(pr.me_search, args)
    lib = (time_ms(library_search, args) + time_ms(library_search, args)) / 2
    kern = (kern + graph_ms(pr.me_search, args)) / 2
    call = time_ms(pr.me_search, args)
    return (f"{describe(shape)} library route (unfold, cdist p=1, argmin): "
            f"{lib:.4f} ms from Python, == plain: {equal}; kernel "
            f"{kern:.4f} ms on the device, {call:.4f} ms from Python "
            f"[{card}]")


def describe(shape) -> str:
    name, nby, nbx, bs, rad, scale, _ = shape
    return f"{name} ({nby}x{nbx} blocks of {bs}x{bs}, rad {rad}, scale {scale})"


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("the ME search cost probe needs an NVIDIA GPU")
    card = gpu_line()
    dev = torch.device("cuda")
    cuda_build.build()
    for shape in [PROBE_SHAPE] + REFINE_SHAPES:
        eager, device = probe(shape, dev)
        for v in pr.PROBE_VARIANTS:
            print(f"{describe(shape)} {v}: {eager[v]:.4f} ms launched from "
                  f"Python, {device[v]:.4f} ms on the device [{card}]",
                  flush=True)
    for shape in REFINE_SHAPES:
        print(library_line(shape, dev, card), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
