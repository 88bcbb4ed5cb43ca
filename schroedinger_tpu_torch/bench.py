"""The port's bench: the legs of the repo's `bench.py`, on the card.

    python -m schroedinger_tpu_torch.bench [--legs headline,zoomrot,...]
        [--device cpu] [--size 1920x1080] [--frames 50] [--frames-extra 32]
        [--bitrate 8000000] [--work DIR] [--out PATH]

The encoder is `bench.py`'s (`GopEncoder(vf, **CONFIG_BENCH)`: biref,
TM5 CBR at 8 Mbit/s, GOP 24, quarter-pel MVs, MD5 off, a full subgroup's
B pictures as one batch) on 1080p25 4:2:0 content made from a seed:
  headline  pan + noise, `--frames` frames (50), two timed passes after a
            6-frame warm-up; reports both passes and the better one, and
            leaves its stream and its reference pictures' digests in the
            work directory for `decode`
  zoomrot   slow zoom and rotation, `--frames-extra` frames (32): a warm
            pass (the warm-up and one whole pass), then a timed pass
  scenecut  pan + noise with a hard cut every 11 frames, likewise
  decode    the headline stream through the pipelined decoder
            (`api.Decoder`) and the per-picture `StreamDecoder`, timed in
            turns (pipelined, per-picture, per-picture, pipelined) after
            one warm decode

Gates (correctness, not speed; any failure ends the leg with a non-zero
exit and no JSON line): every frame comes out, in order; the two decoders
give equal planes; every I and P picture decodes to the encoder's
reconstruction; luma PSNR >= 30 dB on every frame; the bytes within
0.1x-4x of the pro-rata share of the bitrate; the ME's full-pel searches
(kernel #1's launches on the card, each one a launch) as the picture mix
implies: one ME pass of `pyramid_levels` searches per reference of a
picture or of a batch of B pictures, and on the card one launch of the
ME's final stage (kernel #4) per pass.  At the record's settings each
long-GOP leg also prints its bytes and PSNR beside the JAX package's
record in `BENCH_partial.json` (reported, not gated).

Each leg runs in its own process (the allocator and the caches start
fresh), prints its JSON line when it ends, and the runner prints one
merged line last; a leg that fails stops the run with its exit code.
The runner writes only under the work directory (`build/bench` of the
checkout by default) and `--out`.  It runs on the card; `--device cpu`
runs it on the CPU (small: `--size 128x64 --frames 6 --frames-extra 6`),
and with neither a card nor that request it raises.

Left out against `bench.py`: the oracle (its `matched` leg and every
`*_ref` and `vs_baseline` key).  `oracle/Makefile` builds the reference C
library from a source tree the repo does not hold, and the card's machine
has no JAX.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

from schroedinger_tpu_torch import api
from schroedinger_tpu_torch import bitstream as bs
from schroedinger_tpu_torch.decoder.core import StreamDecoder
from schroedinger_tpu_torch.devices import resolve_device
from schroedinger_tpu_torch.encoder import me as me_mod
from schroedinger_tpu_torch.encoder.gop import GopEncoder
from schroedinger_tpu_torch.ops import me_final as mf
from schroedinger_tpu_torch.ops import patch_refine as pr
from schroedinger_tpu_torch.slice_config import (CONFIG_BENCH, make_frames
                                                 as pan_frames, video_format)

W, H = 1920, 1080
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORK = os.path.join(REPO, "build", "bench")
# the JAX package's bytes and mean luma PSNR at 1080p, 8 Mbit/s, 50
# frames (headline) and 32 (zoomrot, scenecut), from BENCH_partial.json
RECORD = {"headline": (2723037, 35.5), "zoomrot": (1360230, 37.82),
          "scenecut": (2060342, 35.38)}
# the parity bands of tests/test_biref_gop.py
BYTES_BAND, PSNR_BAND_DB = 0.15, 0.7


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def check(ok, msg):
    """A gate: raise AssertionError(msg) unless ok."""
    if not ok:
        raise AssertionError(msg)


# ---- content and quality (bench.py:55-123) ------------------------------

def _chroma(xx, yy):
    u = (128 + 24 * np.cos(xx[::2, ::2] / 31.0)).clip(0, 255).astype(np.uint8)
    v = (128 + 24 * np.sin(yy[::2, ::2] / 29.0)).clip(0, 255).astype(np.uint8)
    return u, v


def make_frames(n, width=W, height=H):
    """Horizontal pan (2 px a frame) + N(0, 4) noise, seed 0."""
    return pan_frames(n, width, height)


def make_frames_zoomrot(n, noise=3.0, width=W, height=H):
    """Slow zoom + rotation about the frame centre (seed 1): translational
    block ME cannot follow it globally, so the RD split and the mode
    choice do the quality work.  noise=1 gives a ~48 dB noise floor for
    the rate-distortion sweep."""
    rng = np.random.default_rng(1)
    yy, xx = np.mgrid[0:height, 0:width]
    u, v = _chroma(xx, yy)
    cy, cx = height / 2.0, width / 2.0
    frames = []
    for i in range(n):
        ang = 0.004 * i
        scale = 1.0 + 0.002 * i
        ca, sa = np.cos(ang) / scale, np.sin(ang) / scale
        sx = ca * (xx - cx) - sa * (yy - cy) + cx
        sy = sa * (xx - cx) + ca * (yy - cy) + cy
        y = (128 + 52 * np.sin(sx / 17.0) * np.cos(sy / 13.0)
             + 28 * np.sin((sx + 2 * sy) / 53.0)
             + rng.normal(0, noise, (height, width))).clip(0, 255).astype(
                 np.uint8)
        frames.append((y, u, v))
    return frames


def make_frames_scenecut(n, cut_every=11, width=W, height=H):
    """Pan content (3 px a frame) with a hard cut to another scene every
    `cut_every` frames, off the GOP grid (seed 2)."""
    rng = np.random.default_rng(2)
    yy, xx = np.mgrid[0:height, 0:width]
    u, v = _chroma(xx, yy)
    scenes = [128 + 64 * np.sin(xx / p) * np.cos(yy / q)
              for (p, q) in ((37.0, 23.0), (11.0, 47.0), (71.0, 13.0))]
    frames = []
    for i in range(n):
        base = scenes[(i // cut_every) % len(scenes)]
        y = (np.roll(base, i * 3, axis=1) + rng.normal(0, 4, (height, width))
             ).clip(0, 255).astype(np.uint8)
        frames.append((y, u, v))
    return frames


def psnr(a, b, peak=255.0):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return 99.0 if mse == 0 else float(10 * np.log10(peak ** 2 / mse))


def mean_psnr(decoded, frames, peak=255.0):
    """Mean luma PSNR (99 dB for an exact frame)."""
    return float(np.mean([psnr(g[0], o[0], peak)
                          for g, o in zip(decoded, frames)]))


# ---- what an encode did -------------------------------------------------

def record_refs(enc):
    """Keep every reference picture the encoder makes (its planes), by
    picture number, as the encoder stores it."""
    made = {}

    class Recording(dict):
        def __setitem__(self, k, v):
            made[k] = v
            super().__setitem__(k, v)
    enc.ref_frames = Recording(enc.ref_frames)
    return made


def record_batches(enc):
    """Per subgroup offered to the encoder's B batch: its B picture
    numbers, whether it went as one batch, and kernel #1's launches."""
    seen = []
    orig = enc._start_b_batch

    def wrapped(bs_):
        before = pr.launches()
        out = orig(bs_)
        seen.append(([b[0] for b in bs_], out is not None,
                     pr.launches() - before))
        return out
    enc._start_b_batch = wrapped
    return seen


class record_searches:
    """Within the block, count the ME's full-pel searches (the calls of
    `me.me_search`) by launch shape (cur's shape, block size, radius,
    scale), keep the arguments of each shape's first call, and count
    kernel #1's launches; the same for the ME's final stage (the calls of
    `me.me_final`, by cur's shape, block size, precision, competition
    and zero candidate: `final_first`, `final_count`) and kernel #4's
    launches (`final_launches`)."""

    def __init__(self):
        self.first, self.count = {}, {}
        self.final_first, self.final_count = {}, {}

    @property
    def calls(self):
        return sum(self.count.values())

    def __enter__(self):
        self.saved = me_mod.me_search
        self.saved_final = me_mod.me_final
        self.launches0 = pr.launches()
        self.final0 = mf.launches()

        def keep(first, count, key, args):
            if key not in first:
                first[key] = tuple(a.clone() if torch.is_tensor(a) else a
                                   for a in args)
            count[key] = count.get(key, 0) + 1

        def recording(*args):
            cur, _, _, scale, bs_y, bs_x, rad = args[:7]
            keep(self.first, self.count,
                 (tuple(cur.shape), bs_y, bs_x, rad, scale), args)
            return self.saved(*args)

        def recording_final(*args):
            c = args[0]
            bs_y, bs_x, prec, compete, zero_cand = args[5:10]
            keep(self.final_first, self.final_count,
                 (tuple(c.shape), bs_y, bs_x, prec, compete, zero_cand),
                 args)
            return self.saved_final(*args)
        me_mod.me_search = recording
        me_mod.me_final = recording_final
        return self

    def __exit__(self, *exc):
        me_mod.me_search = self.saved
        me_mod.me_final = self.saved_final
        self.launches = pr.launches() - self.launches0
        self.final_launches = mf.launches() - self.final0


def picture_kinds(stream):
    """[(picture number, number of references, is reference)] of the
    stream's picture units, in coded order."""
    return [(int.from_bytes(payload[:4], "big"), bs.num_refs(code),
             bs.is_reference(code))
            for code, payload in bs.split_units(stream)
            if bs.is_picture(code)]


def picture_mix(stream):
    """(I, P, B) counts: a P is an inter reference picture."""
    kinds = picture_kinds(stream)
    return (sum(1 for _, r, _ in kinds if r == 0),
            sum(1 for _, r, ref in kinds if r and ref),
            sum(1 for _, r, ref in kinds if r and not ref))


def searches_per_reference(gop):
    """Searches of one ME pass of the encoder's default estimation: the
    pyramid's levels (the competition's SADs at the median and at zero
    are the final stage's, one launch of kernel #4 a pass)."""
    p = gop._params(1)
    return me_mod.pyramid_levels(p.ybsep_luma * p.y_num_blocks,
                                 p.xbsep_luma * p.x_num_blocks,
                                 gop.downsample_levels)


def expected_searches(stream, seen, per_ref):
    """One ME pass per reference of every inter picture, but one per
    reference for a whole batch of B pictures."""
    batched = {n for nums, took, _ in seen if took for n in nums}
    refs = sum(r for n, r, _ in picture_kinds(stream) if n not in batched)
    return per_ref * (refs + 2 * sum(1 for _, took, _ in seen if took))


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timed_encode(make, frames, device, warm=6, tag="encode",
                 per_frame=False):
    """Encode `frames` with `make()` (a GopEncoder or an api.Encoder),
    after a warm-up encode of the first `warm` (none if 0), timed on the
    host up to a synchronise; a per-frame progress log to stderr."""
    if warm:
        t0 = time.perf_counter()
        make().encode_stream(frames[:warm])
        sync(device)
        log(f"[{tag}] warm-up of {warm} frames: "
            f"{time.perf_counter() - t0:.1f} s")
    enc = make()
    gop = getattr(enc, "_gop", enc)
    made, seen = record_refs(gop), record_batches(gop)
    tprev = [time.perf_counter()]

    def progress(i, nbytes):
        t = time.perf_counter()
        if per_frame:
            log(f"  [{tag}] frame {i}: {t - tprev[0]:.3f} s, {nbytes} bytes "
                "so far")
        tprev[0] = t

    with record_searches() as searches:
        t0 = time.perf_counter()
        if isinstance(enc, GopEncoder):
            stream = enc.encode_stream(frames, progress=progress)
        else:
            stream = enc.encode_stream(frames)
        sync(device)
        seconds = time.perf_counter() - t0
    log(f"[{tag}] {len(frames)} frames: {len(frames) / seconds:.3f} "
        f"frames/s, {len(stream)} bytes")
    return SimpleNamespace(stream=stream, seconds=seconds,
                           fps=len(frames) / seconds, enc=gop, made=made,
                           seen=seen, searches=searches.calls,
                           launches=searches.launches,
                           final_launches=searches.final_launches)


def encode_leg(frames, device, bitrate=8_000_000, warmup=True, tag="ours",
               per_frame=False):
    """`bench.py`'s `bench_ours`: GopEncoder(vf, **CONFIG_BENCH) at the
    frames' size, a 6-frame warm-up, the timed encode_stream."""
    h, w = frames[0][0].shape
    vf = video_format(w, h)
    cfg = dict(CONFIG_BENCH, bitrate=bitrate)
    return timed_encode(lambda: GopEncoder(vf, device=device, **cfg),
                        frames, device, warm=6 if warmup else 0, tag=tag,
                        per_frame=per_frame)


def check_searches(run, tag):
    """The searches (and on the card the launches of kernels #1 and #4)
    the picture mix implies.  Returns the mix's summary."""
    per_ref = searches_per_reference(run.enc)
    want = expected_searches(run.stream, run.seen, per_ref)
    check(run.searches == want,
          f"{tag}: {run.searches} ME searches, the pictures imply {want} "
          f"({per_ref} a reference, {2 * per_ref} a batch of B)")
    if run.enc.device.type == "cuda":
        check(run.launches == run.searches,
              f"{tag}: {run.launches} kernel launches for {run.searches} "
              "searches")
        passes = expected_searches(run.stream, run.seen, 1)
        check(run.final_launches == passes,
              f"{tag}: {run.final_launches} launches of the ME's final "
              f"stage for {passes} ME passes")
    n_i, n_p, n_b = picture_mix(run.stream)
    return {"mix": f"{n_i} I, {n_p} P, {n_b} B",
            "batches": sum(1 for _, took, _ in run.seen if took),
            "searches": run.searches, "launches": run.launches,
            "final_launches": run.final_launches,
            "searches_per_reference": per_ref}


def padding_bytes(stream):
    """The bytes of the stream's padding units (the CBR reservoir's
    filler: a stream padded up to its rate says nothing of its
    quality)."""
    return sum(bs.PARSE_HEADER_SIZE + len(payload)
               for code, payload in bs.split_units(stream)
               if code == bs.PADDING)


def check_rate(stream, n, bitrate, fps, tag):
    share = n * bitrate / fps / 8
    check(0.1 * share <= len(stream) <= 4 * share,
          f"{tag}: {len(stream)} bytes outside 0.1x-4x of the pro-rata "
          f"{share:.0f}")
    return round(len(stream) / share, 4)


def plane_digest(planes):
    h = hashlib.sha256()
    for pl in planes:
        h.update(np.ascontiguousarray(pl).tobytes())
    return h.hexdigest()


def decode_both(stream, device, order=("pipelined", "per-picture")):
    """Decode with api.Decoder (pipelined) and StreamDecoder in `order`,
    each timed up to a synchronise.  Returns {name: [(seconds, decoder,
    pictures)]}; api.Decoder's pictures are frames (woven fields),
    StreamDecoder's are pictures."""
    runs = {"pipelined": [], "per-picture": []}
    for name in order:
        dec = (api.Decoder(device=device) if name == "pipelined"
               else StreamDecoder(device=device))
        t0 = time.perf_counter()
        out = dec.decode_stream(stream)
        sync(device)
        runs[name].append((time.perf_counter() - t0, dec, out))
    return runs


def check_frames(out, frames, dec, tag, peak=255.0):
    """The gates on one decoder's frames: every frame out with the
    source's shape and type (u8, u16 when deep), no picture error or MD5
    failure, luma PSNR >= 30 dB at `peak` on every frame.  Returns the
    PSNRs."""
    check(len(out) == len(frames), f"{tag}: decoded {len(out)} frames, "
          f"expected {len(frames)}")
    check(not dec.md5_failures and not dec.errors,
          f"{tag}: md5_failures={dec.md5_failures} errors={dec.errors}")
    for k, (planes, src) in enumerate(zip(out, frames)):
        check(all(x.shape == s.shape and x.dtype == s.dtype
                  for x, s in zip(planes, src)),
              f"{tag}: frame {k} planes "
              f"{[(x.shape, x.dtype) for x in planes]}")
    vals = [psnr(o[0], f[0], peak) for o, f in zip(out, frames)]
    check(min(vals) >= 30.0, f"{tag}: luma PSNR {min(vals):.3f} dB < 30 "
          f"(frame {int(np.argmin(vals))})")
    return vals


def check_decodes(runs, frames, refs, tag, peak=255.0):
    """The gates on a decode by both decoders (`decode_both`): those of
    `check_frames` on api.Decoder's frames, no picture error or MD5
    failure in StreamDecoder, api.Decoder's frames equal to
    StreamDecoder's pictures (woven where they are fields), every
    reference picture equal to the encoder's reconstruction (`refs`:
    picture number -> planes digest).  Returns the PSNRs."""
    _, dec, out = runs["pipelined"][0]
    _, base, pics = runs["per-picture"][0]
    vals = check_frames(out, frames, dec, tag, peak)
    check(not base.md5_failures and not base.errors,
          f"{tag}: md5_failures={base.md5_failures} errors={base.errors}")
    woven = api.weave_pictures(pics, base.vf)
    check(len(woven) == len(out), f"{tag}: {len(woven)} frames from "
          f"StreamDecoder, {len(out)} from api.Decoder")
    for k, (a, b) in enumerate(zip(out, woven)):
        check(all(x.dtype == y.dtype and np.array_equal(x, y)
                  for x, y in zip(a, b)),
              f"{tag}: frame {k}: the pipelined and the per-picture "
              "decoder differ")
    for num, digest in refs.items():
        check(plane_digest(pics[num]) == digest,
              f"{tag}: reference picture {num} decodes to other planes "
              "than the encoder's reconstruction")
    return vals


def ref_digests(made):
    """Picture number -> planes digest of the reference pictures an
    encoder made (`record_refs`)."""
    return {num: plane_digest([p.cpu().numpy() for p in rf.planes])
            for num, rf in made.items()}


def quality(run, frames, tag, bitrate, fps=25, peak=255.0):
    """The gates on one encode (searches, rate, both decoders, the
    reference pictures, PSNR): returns its report."""
    rep = check_searches(run, tag)
    runs = decode_both(run.stream, run.enc.device)
    vals = check_decodes(runs, frames, ref_digests(run.made), tag, peak)
    rep.update({"bytes": len(run.stream),
                "padding_bytes": padding_bytes(run.stream), "psnr_db": round(np.mean(vals), 4),
                "psnr_min_db": round(min(vals), 4),
                "references_checked": len(run.made),
                "decode_fps_pipelined": round(
                    len(frames) / runs["pipelined"][0][0], 3),
                "decode_fps_per_picture": round(
                    len(frames) / runs["per-picture"][0][0], 3),
                "bytes_vs_pro_rata": check_rate(run.stream, len(frames),
                                                bitrate, fps, tag)})
    return rep


def against_record(name, rep, args, n_default):
    """The leg's bytes and PSNR beside the JAX package's record, at the
    record's settings only (reported, not gated)."""
    if (args.size != (W, H) or args.bitrate != 8_000_000
            or rep["frames"] != n_default):
        return
    r_bytes, r_psnr = RECORD[name]
    rep["record_bytes"], rep["record_psnr_db"] = r_bytes, r_psnr
    rep["bytes_vs_record"] = round(rep["bytes"] / r_bytes, 5)
    rep["psnr_vs_record_db"] = round(rep["psnr_db"] - r_psnr, 4)
    rep["within_parity_bands"] = bool(
        abs(rep["bytes"] / r_bytes - 1) <= BYTES_BAND
        and abs(rep["psnr_db"] - r_psnr) <= PSNR_BAND_DB)
    log(f"[{name}] {rep['bytes']} bytes, {rep['psnr_db']:.2f} dB; the JAX "
        f"record {r_bytes} bytes, {r_psnr} dB")


# ---- the legs -----------------------------------------------------------

def leg_headline(args):
    w, h = args.size
    frames = make_frames(args.frames, w, h)
    dev = resolve_device(args.device)
    p1 = encode_leg(frames, dev, args.bitrate, tag="headline",
                    per_frame=True)
    p2 = encode_leg(frames, dev, args.bitrate, warmup=False,
                    tag="headline-pass2")
    best = p2 if p2.fps > p1.fps else p1
    rep = {"frames": len(frames), "fps_pass1": round(p1.fps, 3),
           "fps_pass2": round(p2.fps, 3), "fps": round(best.fps, 3),
           "passes_equal": p1.stream == p2.stream}
    rep.update(quality(best, frames, "headline", args.bitrate))
    os.makedirs(args.work, exist_ok=True)
    with open(os.path.join(args.work, "headline.drc"), "wb") as f:
        f.write(best.stream)
    with open(os.path.join(args.work, "headline.refs.json"), "w") as f:
        json.dump({"frames": len(frames), "size": list(args.size),
                   "refs": ref_digests(best.made)}, f)
    against_record("headline", rep, args, 50)
    return rep


def content_leg(name, frames, args):
    """bench.py's content legs: a warm pass (the warm-up and a whole
    pass), then the timed pass."""
    dev = resolve_device(args.device)
    warm = encode_leg(frames, dev, args.bitrate, tag=f"{name}-warm")
    run = encode_leg(frames, dev, args.bitrate, warmup=False, tag=name,
                     per_frame=True)
    rep = {"frames": len(frames), "fps": round(run.fps, 3),
           "fps_warm_pass": round(warm.fps, 3),
           "passes_equal": warm.stream == run.stream}
    rep.update(quality(run, frames, name, args.bitrate))
    return rep, run


def leg_zoomrot(args):
    w, h = args.size
    rep, _ = content_leg("zoomrot", make_frames_zoomrot(
        args.frames_extra, width=w, height=h), args)
    against_record("zoomrot", rep, args, 32)
    return rep


def leg_scenecut(args):
    w, h = args.size
    cut_every = 11
    rep, run = content_leg("scenecut", make_frames_scenecut(
        args.frames_extra, cut_every, width=w, height=h), args)
    kind = {num: ("I" if r == 0 else "P" if ref else "B")
            for num, r, ref in picture_kinds(run.stream)}
    rep["cuts"] = {str(c): kind[c]
                   for c in range(cut_every, args.frames_extra, cut_every)}
    rep["per_picture_b"] = per_picture_b(run)
    log(f"[scenecut] mix {rep['mix']}; the cuts became {rep['cuts']}; B "
        f"pictures coded one at a time {rep['per_picture_b']}")
    against_record("scenecut", rep, args, 32)
    return rep


def per_picture_b(run):
    """The B pictures that were coded one at a time, not in a batch."""
    batched = {n for nums, took, _ in run.seen if took for n in nums}
    return sorted(n for n, r, ref in picture_kinds(run.stream)
                  if r and not ref and n not in batched)


def leg_decode(args):
    """The headline stream through both decoders in turns."""
    path = os.path.join(args.work, "headline.drc")
    with open(path, "rb") as f:
        stream = f.read()
    with open(os.path.join(args.work, "headline.refs.json")) as f:
        meta = json.load(f)
    w, h = meta["size"]
    frames = make_frames(meta["frames"], w, h)
    dev = resolve_device(args.device)
    api.Decoder(device=dev).decode_stream(stream)             # warm decode
    sync(dev)
    runs = decode_both(stream, dev, ("pipelined", "per-picture",
                                     "per-picture", "pipelined"))
    refs = {int(k): v for k, v in meta["refs"].items()}
    vals = check_decodes(runs, frames, refs, "decode")
    fps = {name: [round(len(frames) / r[0], 3) for r in v]
           for name, v in runs.items()}
    return {"frames": len(frames), "bytes": len(stream),
            "decode_fps_pipelined": round(np.mean(fps["pipelined"]), 3),
            "decode_fps_per_picture": round(np.mean(fps["per-picture"]), 3),
            "turns_pipelined": fps["pipelined"],
            "turns_per_picture": fps["per-picture"],
            "psnr_db": round(np.mean(vals), 4),
            "references_checked": len(refs)}


LEGS = {"headline": leg_headline, "zoomrot": leg_zoomrot,
        "scenecut": leg_scenecut, "decode": leg_decode}


# ---- the runner (shared with tools/bench_*.py) --------------------------

def size_arg(text):
    w, h = text.lower().split("x")
    return int(w), int(h)


def card_line(device):
    """The card's name and power limit (nvidia-smi), None on the CPU."""
    if resolve_device(device).type != "cuda":
        return None
    from schroedinger_tpu_torch.tools.profile_patch_refine import gpu_line
    return gpu_line()


def run(module, legs, argv=None, add_arguments=None, summary=None):
    """Parse the common arguments (and the tool's own); with `--leg NAME`
    run that leg here and print its JSON line; else run each leg of
    `--legs` in its own `python -m module` process, pass its output on,
    and print one merged line last.  Returns the exit code: the first
    failing leg's, which stops the run."""
    ap = argparse.ArgumentParser(prog=f"python -m {module}")
    ap.add_argument("--legs", default=",".join(legs),
                    help=f"comma-separated, of {', '.join(legs)}")
    ap.add_argument("--device", default=None,
                    help="cpu to run on the CPU (default: the card)")
    ap.add_argument("--work", default=WORK,
                    help="directory for the legs' streams")
    ap.add_argument("--out", default=None,
                    help="also write the merged JSON object here")
    ap.add_argument("--leg", default=None, help=argparse.SUPPRESS)
    if add_arguments:
        add_arguments(ap)
    argv = list(sys.argv[1:] if argv is None else argv)
    args = ap.parse_args(argv)
    if args.leg:
        t0 = time.perf_counter()
        rep = legs[args.leg](args)
        rep["wall_s"] = round(time.perf_counter() - t0, 3)
        print(json.dumps({"leg": args.leg, **rep}), flush=True)
        return 0
    names = [n for n in args.legs.split(",") if n]
    unknown = [n for n in names if n not in legs]
    if unknown:
        ap.error(f"unknown legs {unknown}")
    device = resolve_device(args.device)
    card = card_line(args.device)
    if card:
        log(f"card: {card}")
    merged = {"module": module, "device": str(device), "card": card,
              "legs": {}}
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    for name in names:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", module, *argv, "--leg", name], cwd=REPO,
            env=env, stdout=subprocess.PIPE, text=True)
        lines = proc.stdout.splitlines()
        for line in lines:
            print(line, flush=True)
        if proc.returncode != 0:
            log(f"leg {name} FAILED (exit {proc.returncode})")
            return proc.returncode
        rep = json.loads(lines[-1])
        rep.pop("leg")
        merged["legs"][name] = rep
        log(f"leg {name} ok ({time.perf_counter() - t0:.1f} s with its "
            "process)")
    if summary:
        merged.update(summary(merged["legs"], args))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(merged, f, indent=1)
    print(json.dumps(merged), flush=True)
    return 0


def _arguments(ap):
    ap.add_argument("--size", type=size_arg, default=(W, H),
                    help="WxH (default 1920x1080)")
    ap.add_argument("--frames", type=int, default=50,
                    help="frames of the headline (and of decode)")
    ap.add_argument("--frames-extra", type=int, default=32,
                    help="frames of zoomrot and scenecut")
    ap.add_argument("--bitrate", type=int, default=8_000_000)


def _summary(legs, args):
    if "headline" not in legs:
        return {}
    return {"metric": "longgop_1080p_cbr_encode",
            "value": legs["headline"]["fps"], "unit": "frames/s",
            "bitrate": args.bitrate, "n_frames": args.frames}


def main(argv=None) -> int:
    return run("schroedinger_tpu_torch.bench", LEGS, argv, _arguments,
               _summary)


if __name__ == "__main__":
    sys.exit(main())
