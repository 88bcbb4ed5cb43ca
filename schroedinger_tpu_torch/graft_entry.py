"""The port's driver entry points: `entry()`, one step on one device, and
`dryrun_multichip`, the multi-device paths over a world of ranks, each
held bit for bit to its unsharded form.

    python -m schroedinger_tpu_torch.graft_entry [N] [--stages 1,2,3] \\
        [--device cpu]

runs entry() and the dry run over N ranks (4 by default; every stage
unless --stages names some; on the card unless --device cpu).

Port of `__graft_entry__.py`.  The stages:

  1. frames-within-GOP: each rank codes one B picture against the
     replicated references through the two-reference step with the
     on-device RD pick and the stat tables (`inter.start_inter_batch` at
     N = 1); every rank's fields, quantiser picks, quantised bands and
     stat tables equal rank 0's batched step of all the ranks' pictures
     (64x64, 12/8 blocks).
  2. tiles: the row-sharded wavelet (forward and back), the half-pel
     upsample with its halo, and the banded OBMC render, each equal to
     the unsharded op (`parallel/tiles.py`).
  3. GOP sharding: the threaded sharded encode equals the serial one, and
     the payload gather's padding and unpacking (`gops.gather_and_merge`
     on a stand-in allgather) give it too.
  4. two processes of `tools/multihost_worker.py` (64x64): their merged
     streams equal each other and the single-process sequential
     `encode_gops_sharded(..., exact=False)`, and decode.
  5, 6. stage 1 at 1080p and 2160p (LeGall 5,3, depth 3, 24/16 blocks):
     each rank's picture is bench.py's pan rolled by its rank, and its
     outputs equal rank 0's batched step.

Stages 1, 2, 5 and 6 run in one world of N ranks (`group.run_world`);
stages 3 and 4 run in this process and in two worker processes.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from functools import partial

import numpy as np
import torch
import torch.distributed as dist

from schroedinger_tpu_torch import slice_config
from schroedinger_tpu_torch.decoder.core import (RefFrame, StreamDecoder,
                                                 upsample)
from schroedinger_tpu_torch.devices import resolve_device
from schroedinger_tpu_torch.encoder import inter
from schroedinger_tpu_torch.encoder.gop import GopEncoder
from schroedinger_tpu_torch.ops import obmc
from schroedinger_tpu_torch.ops import patch_refine as pr
from schroedinger_tpu_torch.ops import wavelet as wv
from schroedinger_tpu_torch.parallel import gops, group, tiles
from schroedinger_tpu_torch.params import Params, subband_count
from schroedinger_tpu_torch.pipeline import (make_lowdelay_analyze,
                                             planes_to_device)
from schroedinger_tpu_torch.tools import multihost_worker as mw
from schroedinger_tpu_torch.video_format import ChromaFormat, VideoFormat
from schroedinger_tpu_torch.wavelets import Wavelet

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (width, height, block length, block separation) of stages 1, 5 and 6
FRAMES_IN_GOP = {1: (64, 64, 12, 8), 5: (1920, 1080, 24, 16),
                 6: (3840, 2160, 24, 16)}


def entry(device=None):
    """(fn, example_args): the low-delay analysis of a CIF frame (IWT,
    slicing and every quantiser's per-slice bit sums), fn =
    pipeline.make_lowdelay_analyze, its arguments u8 planes on `device`
    (the card unless the caller asks for the CPU)."""
    dev = resolve_device(device)
    vf = VideoFormat(width=352, height=288, clean_width=352,
                     clean_height=288, chroma_format=ChromaFormat.C420)
    p = Params(video_format=vf, is_lowdelay=True,
               wavelet_filter_index=Wavelet.LE_GALL_5_3, transform_depth=4)
    p.n_horiz_slices = p.iwt_chroma_width >> p.transform_depth
    p.n_vert_slices = p.iwt_chroma_height >> p.transform_depth
    p.set_default_quant_matrix()
    rng = np.random.default_rng(0)
    y = rng.integers(0, 255, (288, 352)).astype(np.uint8)
    u = rng.integers(0, 255, (144, 176)).astype(np.uint8)
    v = rng.integers(0, 255, (144, 176)).astype(np.uint8)
    return make_lowdelay_analyze(p), planes_to_device((y, u, v), 8, dev)


def inter_params(W: int, H: int, blen: int, bsep: int) -> Params:
    """The two-reference inter picture of the stages: 4:2:0, LeGall 5,3
    at depth 3, default codeblocks and quantiser matrix."""
    vf = VideoFormat(width=W, height=H, clean_width=W, clean_height=H,
                     chroma_format=ChromaFormat.C420)
    p = Params(video_format=vf, num_refs=2,
               wavelet_filter_index=Wavelet.LE_GALL_5_3, transform_depth=3)
    p.set_default_codeblocks()
    p.set_default_quant_matrix()
    p.xblen_luma = p.yblen_luma = blen
    p.xbsep_luma = p.ybsep_luma = bsep
    return p


def _device_ms(dev, fn):
    """(fn(), the ms between CUDA events around it) on the card; (fn(),
    None) on the CPU, which has no device time."""
    if dev.type != "cuda":
        return fn(), None
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize(dev)
    return out, start.elapsed_time(end)


def _wire_parts(pend):
    """[(name, length)] of the int16 wire and of the float32 wire of one
    picture of `inter._fetch_batch`, in their order."""
    nf, yb, xb = pend["fields"].shape
    nb = pend["nb"]
    parts = [("fields", nf * yb * xb), ("quantiser picks", 3 * nb)]
    parts += [(f"codeblock picks {ci}/{bi}", vcb * hcb)
              for ci, bi, vcb, hcb in pend["mq"]]
    parts += [(f"quantised bands of component {ci}", qf.numel())
              for ci, qf in enumerate(pend["qflats"])]
    fparts = [("bits tables", 61 * 3 * nb), ("error tables", 61 * 3 * nb),
              ("badblock ratio", 1), ("lambda fit scale", 1)]
    return parts, fparts


def _first_difference(got, want, parts):
    off = 0
    for name, n in parts:
        if not np.array_equal(got[off:off + n], want[off:off + n]):
            return name
        off += n
    return "length"


def frames_in_gop_step(stage, n, dev):
    """(frames, step) of stage 1, 5 or 6 with n B pictures on `dev`:
    frames[0] and frames[n + 1] (bench.py's pan, `make_frames`) are the
    references, frames[1..n] the B pictures between them; step(pictures)
    codes pictures as one batch against the references through
    inter.start_inter_batch (the RD pick on the device, the stat tables)
    and fetches it: (int16 wire, float32 wire, the first picture's
    pending dict), a row of each wire per picture."""
    W, H, blen, bsep = FRAMES_IN_GOP[stage]
    p = inter_params(W, H, blen, bsep)
    frames = slice_config.make_frames(n + 2, W, H)
    refs = [RefFrame(planes_to_device(frames[k], 8, dev))
            for k in (0, n + 1)]
    nb = subband_count(p.transform_depth)
    qsel = {"lam_bands": np.full(3 * nb, 2e-3, np.float32), "me_lam": 8.0,
            "target_bits": 0.0, "corr_bands": np.ones(3 * nb, np.float32)}

    def step(pics):
        pend = inter.start_inter_batch(pics, p, *refs, [qsel] * len(pics),
                                       want_stats=True, device=dev)
        shared = pend[0]["batch"][0]
        inter._fetch_batch(shared)
        return shared["wire"], shared["fwire"], pend[0]

    return frames, step


def frames_in_gop(rank, world, dev, stage):
    """Stage 1, 5 or 6 on this rank (see the module's head).  Returns
    {"launches": kernel #1's launches of each rank's N = 1 step, and on
    rank 0 "batch_launches", "batch_ms" and "single_ms": the device ms of
    its batched step and of an N = 1 step, each with its fetch, timed
    while the other ranks wait (None on the CPU)}."""
    W, H, blen, bsep = FRAMES_IN_GOP[stage]
    frames, step = frames_in_gop_step(stage, world, dev)
    pr.LAUNCHES = 0
    wire, fwire, pend = step([frames[rank + 1]])
    launches = group.allgather(np.asarray([pr.LAUNCHES], np.int64))
    got, got_f = group.allgather(wire[0]), group.allgather(fwire[0])
    report = {"launches": [int(n) for n in launches[:, 0]]}
    dist.barrier()
    if rank == 0:
        pr.LAUNCHES = 0
        want, want_f, _ = step(frames[1:world + 1])
        report["batch_launches"] = pr.LAUNCHES
        parts, fparts = _wire_parts(pend)
        for k in range(world):
            if not np.array_equal(got[k], want[k]):
                part = _first_difference(got[k], want[k], parts)
            elif not np.array_equal(got_f[k], want_f[k]):
                part = _first_difference(got_f[k], want_f[k], fparts)
            else:
                continue
            raise AssertionError(f"dryrun {stage}: rank {k}'s picture: "
                                 f"{part} differ from rank 0's batched step")
        _, report["batch_ms"] = _device_ms(
            dev, lambda: step(frames[1:world + 1]))
        _, report["single_ms"] = _device_ms(dev, lambda: step([frames[1]]))
        print(f"dryrun {stage} ok: the two-reference step with the on-device "
              f"RD pick at {W}x{H} ({blen}/{bsep} blocks), one B picture "
              f"per rank, equal to rank 0's batched step of {world} (fields, "
              f"quantiser picks, quantised bands, stat tables) on {dev}; "
              f"kernel #1 launches per rank {report['launches']}, batch "
              f"{report['batch_launches']}", flush=True)
    dist.barrier()
    return report


def _same_rows(got, whole, rank, world, what):
    band = whole.shape[-2] // world
    if not torch.equal(got, whole[..., rank * band:(rank + 1) * band, :]):
        raise AssertionError(f"{what}: rank {rank}'s rows differ from the "
                             "unsharded op's")


def _time_forms(rank, dev, sharded, whole, repeat):
    """(ms of the sharded op on every rank at once, ms of the unsharded op
    on rank 0 alone): host clock over `repeat` calls ending in a
    synchronize, between barriers."""
    def run(fn):
        t0 = time.perf_counter()
        for _ in range(repeat):
            fn()
        torch.cuda.synchronize(dev)
        return (time.perf_counter() - t0) * 1e3 / repeat

    dist.barrier()
    ms_sharded = run(sharded)
    dist.barrier()
    ms_whole = run(whole) if rank == 0 else None
    dist.barrier()
    return ms_sharded, ms_whole


def tiles_check(rank, world, dev, wave_hw, depth, wavelets, plane_hw,
                pic, repeat=0):
    """Stage 2 on this rank: the row-sharded forward and inverse wavelet of
    a random int16 (wave_hw) frame at `depth` for each of `wavelets`, the
    sharded upsample of a random u8 (plane_hw) plane and the banded
    two-reference luma render of a picture pic = (W, H, blen, bsep), each
    equal to the unsharded op on this rank's rows.  With repeat > 0 (on
    the card) each is timed, sharded and whole (`_time_forms`); returns
    {op: (sharded ms, whole ms)} (the whole ms on rank 0)."""
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.integers(-512, 512, wave_hw).astype(np.int16),
                     device=dev)
    tile = tiles.shard_rows(x, rank, world)
    times = {}
    for wavelet in wavelets:
        name = Wavelet(wavelet).name
        pyr = tiles.sharded_forward(tile, depth, wavelet)
        ref = wv.forward(x, depth, wavelet)
        _same_rows(pyr["ll"], ref["ll"], rank, world, f"{name} forward ll")
        for lev, lev_ref in zip(pyr["levels"], ref["levels"]):
            for k in ("hl", "lh", "hh"):
                _same_rows(lev[k], lev_ref[k], rank, world,
                           f"{name} forward {k}")
        if not torch.equal(tiles.sharded_inverse(pyr, wavelet), tile):
            raise AssertionError(f"{name}: the sharded round trip differs")
        if repeat:
            times[f"{name} forward"] = _time_forms(
                rank, dev, lambda: tiles.sharded_forward(tile, depth, wavelet),
                lambda: wv.forward(x, depth, wavelet), repeat)
            times[f"{name} inverse"] = _time_forms(
                rank, dev, lambda: tiles.sharded_inverse(pyr, wavelet),
                lambda: wv.inverse(ref, wavelet), repeat)

    plane = torch.tensor(rng.integers(0, 255, plane_hw).astype(np.uint8),
                         device=dev)
    ptile = tiles.shard_rows(plane, rank, world)
    _same_rows(tiles.sharded_upsample(ptile), upsample(plane), rank, world,
               "upsample")
    if repeat:
        times["upsample"] = _time_forms(
            rank, dev, lambda: tiles.sharded_upsample(ptile),
            lambda: upsample(plane), repeat)

    W, H, blen, bsep = pic
    p = inter_params(W, H, blen, bsep)
    yb, xb = p.y_num_blocks, p.x_num_blocks
    mv = {k: torch.tensor(rng.integers(lo, hi, (yb, xb)).astype(np.int32),
                          device=dev)
          for k, lo, hi in (("dx1", -8, 8), ("dy1", -8, 8), ("dx2", -8, 8),
                            ("dy2", -8, 8), ("pred_mode", 0, 4),
                            ("dc0", -50, 50))}
    ups = [upsample(torch.tensor(rng.integers(0, 255, (H, W)).astype(
        np.uint8), device=dev)) for _ in range(2)]

    def whole():
        return obmc.render_component(
            mv["dx1"], mv["dy1"], mv["dx2"], mv["dy2"], mv["pred_mode"],
            mv["dc0"], ups[0], ups[1], p.xblen_luma, p.yblen_luma,
            p.xbsep_luma, p.ybsep_luma, p.mv_precision, p.picture_weight_1,
            p.picture_weight_2, p.picture_weight_bits, H, W).to(torch.int16)

    if H % world == 0:
        _same_rows(tiles.sharded_render(mv, *ups, p, 2), whole(), rank,
                   world, "render")
        if repeat:
            times["render"] = _time_forms(
                rank, dev, lambda: tiles.sharded_render(mv, *ups, p, 2),
                whole, repeat)
    if rank == 0:
        render = f", banded render of {W}x{H}" if H % world == 0 else ""
        print(f"dryrun 2 ok: row-sharded wavelet "
              f"({', '.join(Wavelet(w).name for w in wavelets)}, "
              f"{wave_hw[0]}x{wave_hw[1]} at depth {depth}) forward and back, "
              f"upsample of {plane_hw[0]}x{plane_hw[1]} with its halo{render}"
              f" over {world} ranks equal to the unsharded ops on {dev}",
              flush=True)
    return times


def _world_stages(rank, world, dev, stages):
    out = {}
    for stage in stages:
        if stage == 2:
            out[2] = tiles_check(rank, world, dev, (16 * world, 64), 2,
                                 (Wavelet.LE_GALL_5_3,), (8 * world, 32),
                                 FRAMES_IN_GOP[1])
        else:
            out[stage] = frames_in_gop(rank, world, dev, stage)
    return out


def gop_sharding_check(dev) -> dict:
    """Stage 3 (see the module's head) on `dev`; returns {"bytes": the
    stream's length}."""
    frames = mw.make_frames("64x64")
    vf = slice_config.video_format(64, 64)

    def make():
        return GopEncoder(vf, base_qi_intra=12, base_qi_inter=16,
                          gop_length=4, enable_scene_change=False,
                          device=dev)

    serial = make().encode_stream(frames)
    if gops.encode_gops_sharded(frames, make, n_shards=2) != serial:
        raise AssertionError("dryrun 3: the GOP shard merge differs from "
                             "the serial encode")
    locals_ = []
    for start, stop in gops.chunk_ranges(len(frames), 4, 2):
        enc = make()
        gops._seed_shard_state(enc, start)
        locals_.append(enc.encode_stream(frames[start:stop]))

    def fake_allgather(arr):
        if arr.dtype == np.int64:
            return np.stack([np.asarray([len(s)], np.int64)
                             for s in locals_])
        out = np.zeros((2, arr.shape[0]), np.uint8)
        for i, s in enumerate(locals_):
            out[i, :len(s)] = np.frombuffer(s, np.uint8)
        return out

    for local in locals_:
        if gops.gather_and_merge(local, 2, fake_allgather) != serial:
            raise AssertionError("dryrun 3: the gathered merge differs from "
                                 "the serial encode")
    print(f"dryrun 3 ok: GOP sharding on two threads and the gathered merge "
          f"equal the serial encode ({len(serial)} bytes) on {dev}",
          flush=True)
    return {"bytes": len(serial)}


def multiprocess_encode(size: str, dev, n_proc: int = 2):
    """(streams, reports): the merged stream that each of n_proc processes
    of the worker (`tools/multihost_worker.py --size size`) writes, on
    `dev`'s kind of device, and each worker's report (its last line of
    output: rank, device, bytes, kernel #1's launches).  The workers'
    output is printed here; a worker that fails raises."""
    addr = f"tcp://127.0.0.1:{group.free_port()}"
    extra = ["--device", "cpu"] if dev.type == "cpu" else []
    env = dict(os.environ, PYTHONPATH=ROOT)
    with tempfile.TemporaryDirectory() as tmp:
        outs = [os.path.join(tmp, f"rank{i}.drc") for i in range(n_proc)]
        procs = [subprocess.Popen(
            [sys.executable, "-m", "schroedinger_tpu_torch.tools."
             "multihost_worker", addr, str(n_proc), str(i), outs[i],
             "--size", size, *extra], env=env, cwd=ROOT,
            stdout=subprocess.PIPE, text=True)
            for i in range(n_proc)]
        try:
            logs = [proc.communicate(timeout=900)[0] for proc in procs]
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        for log in logs:
            print(log, end="", flush=True)
        codes = [proc.returncode for proc in procs]
        if any(codes):
            raise RuntimeError(f"multihost workers exited with {codes}")
        streams = []
        for path in outs:
            with open(path, "rb") as f:
                streams.append(f.read())
    return streams, [json.loads(log.splitlines()[-1]) for log in logs]


def multiprocess_check(dev) -> dict:
    """Stage 4 (see the module's head) on `dev`; returns {"stream": the
    merged stream}."""
    streams, _ = multiprocess_encode("64x64", dev)
    if streams[0] != streams[1]:
        raise AssertionError("dryrun 4: the merged streams differ across "
                             "processes")
    expect = gops.encode_gops_sharded(
        mw.make_frames("64x64"), partial(mw.make_encoder, "64x64",
                                         device=dev),
        n_shards=2, sequential=True, exact=False)
    if streams[0] != expect:
        raise AssertionError("dryrun 4: the two-process merge differs from "
                             "the single-process sharded encode")
    decoded = StreamDecoder(device=dev).decode_stream(streams[0])
    if len(decoded) < 7:
        raise AssertionError(f"dryrun 4: {len(decoded)} pictures decoded")
    print(f"dryrun 4 ok: two worker processes encode the biref CBR clip, "
          f"gathered and merged into {len(streams[0])} bytes, equal across "
          f"processes and to the single-process sharded encode on {dev}",
          flush=True)
    return {"stream": streams[0]}


def dryrun_multichip(n_devices: int, stages=None, device=None) -> dict:
    """Run the multi-device paths (stages 1-6 of the module's head, or
    those named) over a world of n_devices ranks on `device` (the card
    unless the caller asks for the CPU), each held bit for bit to its
    unsharded form; a failure raises.  Returns {stage: its report}: rank
    0's for the stages of the world, stage 3's stream length, stage 4's
    merged stream."""
    stages = set(range(1, 7)) if stages is None else set(stages)
    dev = resolve_device(device)
    reports = {}
    in_world = sorted(stages & {1, 2, 5, 6})
    if in_world:
        reports = group.run_world(_world_stages, n_devices, in_world,
                                  device=device)[0]
    if 3 in stages:
        reports[3] = gop_sharding_check(dev)
    if 4 in stages:
        reports[4] = multiprocess_check(dev)
    return reports


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n", type=int, nargs="?", default=4)
    ap.add_argument("--stages", default=None,
                    help="comma-separated stage numbers (1-6); all if not "
                         "given")
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    fn, example = entry(args.device)
    outs = fn(*example)
    print(f"entry: low-delay analysis of a CIF frame on {example[0].device}:"
          f" slices {[tuple(o.shape) for o in outs[:3]]}", flush=True)
    stages = (None if args.stages is None
              else [int(s) for s in args.stages.split(",")])
    dryrun_multichip(args.n, stages=stages, device=args.device)


if __name__ == "__main__":
    main()
