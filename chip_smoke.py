"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints lines; any failure ends the run with a non-zero exit
and no result line):
  0. the card's name and power limit (nvidia-smi); no CUDA -> fail
  1. build the ME search kernel (with its probe variants) from csrc/ with
     nvcc, and the C++ entropy coder with g++
  2. kernel == plain version (torch.equal) at the seven 1080p launch
     shapes of one reference (coarse scan, four hint refines, median and
     zero SAD), on random planes, on a flat all-tie plane, with hints at
     +-bound and with hints beyond the contract; each shape timed on the
     device alone (CUDA-graph replay) and as the encoder launches it from
     Python, the plain version from Python, beside the least time the
     card could take (the bytes the function needs over its memory rate,
     its operations over its rate); then one whole 1080p ME pyramid
     (make_me_body) on the card with the kernel and with the plain
     version: equal (dy, dx, sad), 7 launches, no call of the plain
     pieces on the kernel's run
  3. the backref path: a small stream encoded on the card must equal the
     CPU encode byte for byte; then 4 frames of 1080p25 4:2:0 pan + noise
     through GopEncoder(**CONFIG) (fixed quantisers, quarter-pel MVs, MD5)
     and StreamDecoder on the card: 7 kernel launches per P picture, all
     frames out, no MD5 failure, no picture error, luma PSNR >= 30 dB
  4. the cost probe (tools/profile_patch_refine.py) at its geometry and
     at the seven launch shapes: the `full` variant == plain, the four
     variants timed
  5. the flagship path: a 128x64 CBR stream on the card within the bands
     of the CPU encode (luma PSNR within 0.7 dB, bytes within 15 %; the
     count of differing per-band quantiser picks is printed); a 6-frame
     warm-up; 9 frames of 1080p through CONFIG_FLAGSHIP_DRAINING (1 Mbit/s,
     reservoir half empty), where the lambda fit must bind on at least
     one picture (target > 0, fitted scale < 0.99) and the stream must
     decode clean; then 13 frames of 1080p25 4:2:0 through
     GopEncoder(**CONFIG_FLAGSHIP) (biref, TM5 CBR at 8 Mbit/s, on-device
     RD pick, MD5) and StreamDecoder: 13 frames in presentation order, at
     least one two-reference P and six B pictures, 14 kernel launches per
     two-reference picture and 7 per one-reference picture, no MD5
     failure, no picture error, luma PSNR >= 30 dB on every frame, stream
     bytes within 0.1x-4x of the pro-rata 13 * 8e6 / 25 / 8
  6. the batched kernel: me_search at N = 3 (the B pictures of a
     subgroup against their shared reference) == its plain version
     (torch.equal) and == three N = 1 launches at the seven 1080p launch
     shapes, timed on the device (CUDA-graph replay) beside N = 1; and a
     batched 1080p ME pass of three pictures: 7 launches, equal to three
     single-picture passes
  7. 128x64 on the card against the CPU for bench.py's configuration and
     api.Encoder's default: the same stream (byte-equal is expected; the
     gate is 0.7 dB luma PSNR and 15 % bytes)
  8. smoke-1080p-bench-headline: bench.py's encoder (CONFIG_BENCH = the
     flagship with MD5 off, B pictures batched) on 50 frames of bench.py's
     pan + noise: every full subgroup's B pictures go as one batch of at
     most 14 kernel launches (the mix is printed: 3 I, 11 P, 36 B in 12
     batches unless a scene cut fires); api.Decoder (pipelined) and
     StreamDecoder give equal planes, every I and P picture decodes to the
     encoder's reconstruction (torch.equal), luma PSNR >= 30 dB on every
     frame, bytes within 0.1x-4x of the pro-rata 2,000,000; encode and
     both decoders' frames/s
  9. smoke-1080p-api-default: api.Encoder(vf, EncoderConfig()) (constant
     quality, pipeline depth 8, full-pel MVs, DD9,7 inter) on 13 frames,
     api.Decoder, with the checks of phase 8 but the byte range
 10. smoke-1080p-vc2-lowdelay-cli-422p10: what `schro_tpu encode` does by
     default (VC-2 low delay, LeGall 5,3, depth 4, 60 x 68 slices, 103.68
     Mbit/s) on 25 frames of 10-bit 4:2:2 1080p25 pan + noise: every
     picture unit is its headers plus its slice budgets, the "table" and
     "direct" host halves give the same bytes, the first 2 frames equal
     the CPU encode byte for byte, api.Decoder and StreamDecoder give
     equal uint16 planes, luma PSNR >= 30 dB at peak 1023 on every frame;
     encode and decode frames/s and the encode's shares of device
     analysis, fetch and native packing; then the CLI itself (encode,
     decode) on 3 frames of y4m, whose output equals api.Decoder's planes
 11. smoke-cif-vc2-lowdelay-lossless: 352x288 4:2:0 8-bit, LeGall 5,3, 10
     frames at a slice budget where every slice picks base 0: the decode
     equals the source (torch.equal on every plane)
 12. smoke-1080p-vc2-simple: api.Encoder(1080p25 4:2:0,
     EncoderConfig(enable_noarith=True)) on 8 frames, both decoders:
     sequence-header profile 1, PSNR >= 30 dB, card == CPU on frame 0
 13. smoke-1080p-vc2-main-422p10: EncoderConfig(gop_structure=
     "intra_only") on the 10-bit 4:2:2 source, 8 frames: card == CPU on
     frame 0, both decoders equal, PSNR >= 30 dB at peak 1023
 14. smoke-1080p-bench-noarith: GopEncoder(vf, **CONFIG_BENCH,
     enable_noarith=True) on 13 frames: every I and P picture decodes to
     the encoder's reconstruction, 7 kernel launches per reference (14 a
     batch of B pictures), PSNR >= 30 dB, bytes within 0.1x-4x of the
     pro-rata share
Phases 15-18, the long-GOP rate controls on 1080p25 4:2:0 pan + noise;
each checks that every frame comes out in order, no picture error, luma
PSNR >= 30 dB on every frame, api.Decoder (pipelined) == StreamDecoder,
every I and P picture decodes to the encoder's reconstruction
(torch.equal), and the kernel's launches the path implies; each prints
its encode and decode frames/s and bytes:
 15. smoke-1080p-backref-quality: api.Encoder(vf, EncoderConfig(
     gop_structure="backref")) (constant quality on the backref engine,
     RD pick on the device), 13 frames through encode_stream and 4 through
     push_frame, 7 launches per P picture; a 128x64 card encode within the
     bands of the CPU encode (0.7 dB, 15 %; byte equality printed)
 16. smoke-1080p-backref-cbr: GopEncoder(vf, **CONFIG_BENCH, gop_structure=
     "backref") (TM5 at 8 Mbit/s) on 13 frames, then the same with
     rdo_cbr=False (the allocation controller): bytes within 0.1x-4x of
     the pro-rata 13 * 8e6 / 25 / 8
 17. smoke-1080p-constant-error: EncoderConfig(rate_control=
     "constant_error") on the biref engine, 13 frames, then
     constant_noise_threshold on 9: from the second inter picture on the
     engine picks (an inter picture's indices differ from the base index
     less the quant matrix), every B picture goes on its own (14 launches
     each)
 18. smoke-1080p-multiquant: EncoderConfig(enable_multiquant=True), 13
     frames, B pictures batched: a band's codeblocks take different quant
     indices on at least one picture
Phases 19-22, the long-GOP encoder's remaining settings on 1080p25 4:2:0
pan + noise through api.Encoder on the card, with the checks of phases
15-18 (the launches per reference each setting implies); in 19 and 20
the kernel is held equal to its plain version (torch.equal) on the
recorded inputs of every launch shape the setting makes, each timed:
 19. smoke-1080p-block-geometry, 9 frames each: small blocks with full
     overlap (bsep 8, blen 16, 240 x 136 blocks), small codeblocks,
     medium blocks (bsep 12)
 20. smoke-1080p-estimation: phase correlation (13 frames, B pictures one
     at a time, 8 launches per reference); chroma ME (13 launches per
     reference), no hierarchical (3) and no deep estimation (5), 9 frames
     each; full scan (radius 32, 3 launches per reference, 3 frames)
 21. smoke-1080p-gather-decode: an I picture, then a P picture written as
     its prediction alone with global motion (a pan; an affine matrix)
     or with every vector near 200 pel: api.Decoder and StreamDecoder on
     the card equal the CPU decode bit for bit; the gather render's ms
     per picture
 22. smoke-1080p-prefilter-metrics, 5 frames each of the gaussian,
     adaptive_gaussian, lowpass and center_weighted_median prefilters
     with enable_psnr and enable_ssim: the prefilter on the card == the
     CPU's, each frame's PSNR equal to the CPU's recomputation to 3
     decimals and SSIM within 1e-4
Phases 23-26, interlaced (field) coding, the streaming decoder, the
telemetry overlay and the stream tools, on the card:
 23. smoke-1080i25-biref-cbr: api.Encoder(1080i25 4:2:0 top field first,
     EncoderConfig(rate_control="constant_bitrate", bitrate=8_000_000,
     interlaced_coding=1, mv_precision=2)) on 13 frames of pan + noise =
     26 field pictures (biref, MD5 off, every full subgroup's three B
     fields one batch): the kernel's launches the picture mix implies;
     bytes within 0.1x-4x of the pro-rata 520000; api.Decoder's woven
     frames equal to the weave of StreamDecoder's fields; the
     StreamingDecoder (the stream pushed in seeded pieces of 1-64 KiB)
     gives every field once, equal to StreamDecoder's; every I and P field
     equal to the encoder's reconstruction; luma PSNR >= 30 dB on every
     frame; encode and decode frames/s; the kernel == plain at every
     launch shape of the fields (1920x576 with the superblock padding,
     36 x 120 blocks at level 0), one picture and a batch of three, each
     timed beside its bound and the plain version
 24. smoke-576i25-sd-cbr: tools/bench_breadth.py's SD field cell (720x576
     4:2:0, TM5 CBR 4 Mbit/s, interlaced_coding, mv_precision=2, 25
     frames) with the checks of 23 (pro-rata 500000); then 4 frames
     bottom field first with MD5: md5_failures == [] in api.Decoder and
     the StreamingDecoder
 25. 128x64 field streams on the card equal to the CPU encode byte for
     byte: biref TM5 CBR top field first, backref constant quality bottom
     field first; a VC-2 low-delay config with interlaced_coding raises
     ValueError
 26. phase 23's stream decoded with StreamDecoder(telemetry=True) on the
     card equal to a CPU telemetry decode (every inter field's luma
     marked, chroma untouched), and by the CLI's `decode --telemetry`
     (its y4m == the woven telemetry fields); a telemetry decode of 24's
     MD5 stream without MD5 failures; dirac_inspect, dump_gop and drc_cut
     (the first 9 coded pictures) on the stream: the cut decodes to the
     full decode's fields; the StreamingDecoder's decode frames/s beside
     api.Decoder's, in turns
 27. frames-within-GOP on the card (graft_entry stages 1, 5 and 6) over a
     world of 4 ranks on cuda:0 (gloo, printed): each rank codes one B
     picture (bench.py's pan rolled by its rank) against the replicated
     references through the two-reference step with the RD pick and the
     stat tables at N = 1, at 64x64, 1080p and 2160p (24/16 blocks); its
     fields, quantiser picks, quantised bands and stat tables equal rank
     0's batched step of the 4 pictures; kernel #1 launches 14 times per
     rank and 14 for the batch at 1080p and 2160p; the device ms of rank
     0's batched step and of an N = 1 step; the kernel == plain at every
     launch shape of the 2160p step, timed beside its bound
 28. tiles at 1080p over 4 ranks: the row-sharded forward and inverse
     wavelet of a 1088x1920 int16 frame at depth 3 (LeGall 5,3,
     Deslauriers-Dubuc 9,7, Fidelity; halo rows through the host), the
     upsample of a 1080x1920 plane and the banded two-reference render of
     1080p luma, each equal to the unsharded op on the card; both forms
     timed
 29. smoke-1080p-gop-sharded: 48 frames of bench.py's pan + noise, two
     GOPs of 24, on two shard threads: CONFIG with scene change off equals
     the serial stream byte for byte; CONFIG_BENCH with per-chunk
     reservoirs (exact=False): threads == sequential, api.Decoder gives
     all 48 frames in order at luma PSNR >= 30 dB, each chunk's picture
     bytes within 0.1x-4x of its pro-rata share, kernel #1's launches as
     the pictures imply (7 per reference, 14 per batch of B pictures);
     serial and sharded frames/s in turns
 30. smoke-1080p-multiprocess: two processes of
     tools/multihost_worker.py on the one card (gloo), CONFIG_BENCH, 48
     frames: their merged streams equal each other and phase 29's
     sequential stream (else the first differing picture is named)
 31. graft_entry.entry(): the CIF low-delay analysis on the card equal to
     the CPU's
Phases 32-35, the bench entry points (schroedinger_tpu_torch.bench and
tools/bench_{4k,breadth,rd}.py) through their own functions at reduced
length; each holds its leg's gates (every frame out in order, api.Decoder
== StreamDecoder, every I and P picture == the encoder's reconstruction,
luma PSNR >= 30 dB, bytes within 0.1x-4x of the pro-rata share, kernel
#1's launches == the searches the picture mix implies):
 32. smoke-1080p-zoomrot (12 frames of bench.py's zoom and rotation) and
     smoke-1080p-scenecut (16 frames, the cut at frame 11, the third
     picture of its subgroup, must become an I picture), CONFIG_BENCH
 33. smoke-2160p-biref (6 frames of bench_4k's content, biref, 24 Mbit/s)
     and smoke-2160p-backref (4 frames, the default engine), each decoded
     by both decoders; the kernel == plain at every launch shape of the
     biref encode (a 2160p reference at N = 1, a batch of three B
     pictures at N = 3), each timed beside its bound
 34. smoke-720p10-422-intra: 4 frames of 1280x720 10-bit 4:2:2 main intra,
     both decoders, luma PSNR >= 30 dB at peak 1023
 35. smoke-1080p-rd: bench_rd's sweep of the low-noise zoomrot clip at
     0.5 and 1 Mbit/s over 96 frames (PROFILE.md §6's settings), on the
     slope of the curve; the higher rate codes more bytes less the
     padding units and a higher mean luma PSNR
The last two lines are the nvidia-smi line and
{"ok": true, "device": {...}}; the kernel summary JSON comes before them
(with the launches of phases 23, 24, 27-30 and 32-35 and the field and
2160p launch shapes).
"""
import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from schroedinger_tpu_torch import api
from schroedinger_tpu_torch import bench
from schroedinger_tpu_torch.bench import (check_frames, expected_searches,
                                          picture_kinds, picture_mix, psnr,
                                          record_batches, record_refs,
                                          record_searches)
from schroedinger_tpu_torch import bitstream as bs
from schroedinger_tpu_torch import graft_entry
from schroedinger_tpu_torch import y4m
from schroedinger_tpu_torch.coding import native as coder
from schroedinger_tpu_torch.coding.bitio import BitReader
from schroedinger_tpu_torch.config import EncoderConfig
from schroedinger_tpu_torch.decoder.core import StreamDecoder
from schroedinger_tpu_torch.decoder.streaming import StreamingDecoder
from schroedinger_tpu_torch.encoder import lowdelay as loe
from schroedinger_tpu_torch.encoder import gop as gop_mod
from schroedinger_tpu_torch.encoder import me as me_mod
from schroedinger_tpu_torch.encoder.gop import GopEncoder
from schroedinger_tpu_torch.frontends import weave_fields
from schroedinger_tpu_torch.ops import patch_refine as pr
from schroedinger_tpu_torch.parallel import gops, group
from schroedinger_tpu_torch.pipeline import planes_to_device
from schroedinger_tpu_torch.tools.schro_tpu import encoder_config
from schroedinger_tpu_torch.video_format import ChromaFormat
from schroedinger_tpu_torch.wavelets import Wavelet
from schroedinger_tpu_torch.slice_config import (CONFIG, CONFIG_BENCH,
                                                 CONFIG_FLAGSHIP,
                                                 CONFIG_FLAGSHIP_DRAINING,
                                                 make_frames, video_format)
from schroedinger_tpu_torch.tools import bench_4k, bench_breadth, bench_rd
from schroedinger_tpu_torch.tools import multihost_worker as mw
from schroedinger_tpu_torch.tools import profile_patch_refine as probe_tool
from schroedinger_tpu_torch.tools.profile_patch_refine import (gpu_line,
                                                               graph_ms,
                                                               time_ms)

# searches per reference of a 1080p inter picture: the coarse scan, four
# hint refines (5-level pyramid), the median and the zero SAD
LAUNCHES_PER_REF = 5 + 2
# the card's published peaks (NVIDIA H100 SXM data sheet): device memory
# rate, and the float32 rate outside the tensor cores, which stands in for
# the integer units' rate (the data sheet gives none; theirs is not higher)
HBM_BYTES_PER_S = 3.35e12
ALU_OPS_PER_S = 67e12


def refine_bound_ms(args):
    """The least time the card could take for one me_search call on these
    arguments.  Bytes: what the function needs, each read or written
    once: the current plane, of the reference plane the smaller of the
    whole plane and the sum of the blocks' (bs_y + 2rad) x (bs_x + 2rad)
    windows, the int32 hint field where it is read, and the int32 mv and
    sad out, over the memory rate.  Operations: nb * (2rad+1)^2 * bs_y *
    bs_x absolute differences of three operations (subtract, abs, add)
    over the ALU rate.  A batch of n current planes counts n of each but
    the one shared reference.  Returns (ms, "bytes" or "operations")."""
    cur, _, field, scale, bs_y, bs_x, rad, _, _ = args
    n = cur.shape[0] if cur.ndim == 3 else 1
    h, w = cur.shape[-2:]
    nb = (h // bs_y) * (w // bs_x)
    windows = n * nb * (bs_y + 2 * rad) * (bs_x + 2 * rad)
    nbytes = (n * h * w + min(h * w, windows) + 3 * n * nb * 4
              + (field.numel() * 4 if field is not None and scale else 0))
    ops = 3 * n * nb * (2 * rad + 1) ** 2 * bs_y * bs_x
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ALU_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def search_cases(shape, dev, seed):
    """(label, me_search arguments) at one launch shape: random planes and
    hints, the flat all-tie plane, hints at +-bound (the field's values
    times the scale land on the bound and past it), and hints beyond the
    contract (a bound past the margin, so the window clamp decides)."""
    bound = me_mod.ME_BOUND_PEL
    cases = [("random", probe_tool.make_inputs(shape, dev, seed=seed,
                                               hint_bound=bound)),
             ("flat", probe_tool.make_inputs(shape, dev, seed=seed,
                                             flat=True, hint_bound=bound))]
    if shape[5]:                         # the modes that read a field
        cases += [
            ("at the bound", probe_tool.make_inputs(
                shape, dev, seed=seed + 50, hint_bound=bound + 8)),
            ("beyond the contract", probe_tool.make_inputs(
                shape, dev, seed=seed + 90, hint_bound=probe_tool.MARGIN + 60,
                bound=probe_tool.MARGIN + 40))]
    return cases


def assert_equal_outputs(got, want, what):
    """torch.equal on (mv, sad); returns the largest |difference|."""
    worst = 0
    for g, w_, name in zip(got, want, ("mv", "sad")):
        err = int((g.to(torch.int64) - w_).abs().max())
        worst = max(worst, err)
        if not torch.equal(g, w_):
            raise AssertionError(f"{what}: kernel {name} differs from "
                                 f"plain (max |diff| {err})")
    return worst


class count_calls:
    """Within the block, count the calls of the named functions of a
    module (functions the kernel's path must not reach)."""

    def __init__(self, module, *names):
        self.module, self.names, self.calls = module, names, 0
        self.saved = {}

    def __enter__(self):
        for n in self.names:
            fn = self.saved[n] = getattr(self.module, n)

            def counted(*a, fn=fn, **k):
                self.calls += 1
                return fn(*a, **k)
            setattr(self.module, n, counted)
        return self

    def __exit__(self, *exc):
        for n, fn in self.saved.items():
            setattr(self.module, n, fn)


def phase_whole_me(card):
    """One 1080p ME pass (make_me_body, 5 levels) on the card with the
    kernel and with the plain version: equal (dy, dx, sad)."""
    dev = torch.device("cuda")
    W, H = 1920, 1080
    frames = make_frames(2, W, H)
    cur = torch.tensor(frames[1][0], device=dev)
    ref = torch.tensor(frames[0][0], device=dev)
    body = me_mod.make_me_body(H, W, 16, 16, 120, 68, levels=5,
                               coarse_radius=probe_tool.COARSE_RADIUS)
    body(cur, ref)                       # warm-up
    torch.cuda.synchronize()
    with count_calls(me_mod, "_dense_scan", "block_sads_at") as c_me, \
            count_calls(pr, "me_search_plain", "patch_refine_plain",
                        "extract_ref_patches") as c_pr:
        before = pr.LAUNCHES
        t0 = time.perf_counter()
        got = body(cur, ref)
        torch.cuda.synchronize()
        t_kernel = time.perf_counter() - t0
        launches = pr.LAUNCHES - before
    if c_me.calls or c_pr.calls:
        raise AssertionError(f"phase2 ME pass on the card called plain "
                             f"pieces {c_me.calls + c_pr.calls} times")
    if launches != LAUNCHES_PER_REF:
        raise AssertionError(f"phase2 ME pass: {launches} launches, "
                             f"expected {LAUNCHES_PER_REF}")
    kernel_search = me_mod.me_search
    me_mod.me_search = pr.me_search_plain
    try:
        t0 = time.perf_counter()
        want = body(cur, ref)
        torch.cuda.synchronize()
        t_plain = time.perf_counter() - t0
    finally:
        me_mod.me_search = kernel_search
    for g, w_, name in zip(got, want, ("dy", "dx", "sad")):
        if not torch.equal(g, w_):
            raise AssertionError(f"phase2 ME pass: {name} differs from the "
                                 f"plain run")
    moved = int((got[0] != 0).sum() + (got[1] != 0).sum())
    print(f"phase2 1080p ME pass (5 levels): kernel run == plain run on "
          f"(dy, dx, sad), {launches} launches, no plain piece called, "
          f"{moved} nonzero vector components; one pass {t_kernel * 1e3:.3f}"
          f" ms with the kernel, {t_plain * 1e3:.3f} ms plain (host clock) "
          f"[{card}]", flush=True)


def phase_kernel(card):
    """Kernel vs plain at the seven 1080p launch shapes, then a whole ME
    pass; returns the summary entry."""
    dev = torch.device("cuda")
    max_err = 0
    tot_dev = tot_call = tot_p = 0.0
    bound = {"bytes": 0.0, "operations": 0.0}   # ms bound by each
    shapes = []
    for seed, shape in enumerate(probe_tool.REFINE_SHAPES):
        labels = []
        for label, args in search_cases(shape, dev, seed):
            got = pr.me_search(*args)
            want = pr.me_search_plain(*args)
            torch.cuda.synchronize()
            max_err = max(max_err, assert_equal_outputs(
                got, want, f"me_search {shape[0]} {label}"))
            if label == "flat":
                hint = pr.upsample_hint(args[2], *got[1].shape, args[3],
                                        args[7], dev)
                assert torch.equal(got[0], hint - shape[4]), "tie order"
            labels.append(label)
        args = probe_tool.make_inputs(shape, dev, seed=seed)
        # turns: plain, kernel, kernel, plain.  Launched from Python a
        # call costs what the host needs to enqueue it; the graph replay
        # leaves the kernel's own time on the device, which is what the
        # bound speaks of
        p1 = time_ms(pr.me_search_plain, args)
        c1, d1 = time_ms(pr.me_search, args), graph_ms(pr.me_search, args)
        c2, d2 = time_ms(pr.me_search, args), graph_ms(pr.me_search, args)
        p2 = time_ms(pr.me_search_plain, args)
        dev_ms, call_ms, p_ms = (d1 + d2) / 2, (c1 + c2) / 2, (p1 + p2) / 2
        b_ms, by = refine_bound_ms(args)
        bound[by] += b_ms
        tot_dev += dev_ms
        tot_call += call_ms
        tot_p += p_ms
        shapes.append({"shape": shape[0], "ms": dev_ms, "call_ms": call_ms,
                       "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": by})
        print(f"phase2 me_search {probe_tool.describe(shape)}: kernel == "
              f"plain on {', '.join(labels)}; kernel {dev_ms:.4f} ms on the "
              f"device, {call_ms:.4f} ms launched from Python, plain "
              f"{p_ms:.4f} ms, bound {b_ms:.5f} ms by {by} [{card}]",
              flush=True)
    print(f"phase2 me_search, the seven launches of one reference: "
          f"{tot_dev:.4f} ms on the device, {tot_call:.4f} ms from Python, "
          f"plain {tot_p:.4f} ms, bound {sum(bound.values()):.5f} ms "
          f"[{card}]", flush=True)
    phase_whole_me(card)
    return {"name": "me_search", "route": "cuda",
            "source": "schroedinger_tpu_torch/csrc/patch_refine.cu",
            "replaces": "schroedinger_tpu/ops/pallas_me.py:71",
            "launches": None, "max_abs_err": max_err,
            # the seven launches of one reference of one inter picture:
            # device time, and the time of the calls as the encoder makes
            # them
            "ms": tot_dev, "call_ms": tot_call, "plain_ms": tot_p,
            "bound_ms": sum(bound.values()),
            "bound_by": max(bound, key=bound.get),
            # no single PyTorch call computes a gather of windows, the
            # candidates' SADs and a first-minimum argmin
            "library_ms": None, "shapes": shapes}


def phase_probe(card):
    """The cost probe's path at its own geometry and at the seven launch
    shapes; returns its entry."""
    dev = torch.device("cuda")
    shape = probe_tool.PROBE_SHAPE
    args = probe_tool.make_inputs(shape, dev)
    got = pr.me_search_probe("full", *args)
    want = pr.me_search_plain(*args)
    torch.cuda.synchronize()
    max_err = assert_equal_outputs(got, want, "probe variant full")
    plain_ms = time_ms(pr.me_search_plain, args)
    pr.PROBE_LAUNCHES = 0
    times, device_times = probe_tool.probe(shape, dev)
    launches = pr.PROBE_LAUNCHES
    if launches == 0:
        raise AssertionError("the probe launched no kernel")
    b_ms, by = refine_bound_ms(args)
    by_shape = {}
    for s in [shape] + probe_tool.REFINE_SHAPES:
        t, d = (times, device_times) if s is shape else probe_tool.probe(s,
                                                                         dev)
        by_shape[s[0]] = d
        print(f"phase4 probe {probe_tool.describe(s)}: launched from Python "
              f"(on the device alone): "
              + ", ".join(f"{v} {t[v]:.4f} ({d[v]:.4f}) ms" for v in t)
              + f" [{card}]", flush=True)
    print(f"phase4 probe: full == plain at {shape[0]}; plain {plain_ms:.4f} "
          f"ms, bound {b_ms:.5f} ms by {by}; {launches} launches at its own "
          f"geometry [{card}]", flush=True)
    return {"name": "me_search_probe", "route": "cuda",
            "source": "schroedinger_tpu_torch/csrc/patch_refine.cu",
            "replaces": "tools/profile_pk_parts.py:113",
            "launches": launches, "max_abs_err": max_err,
            "ms": device_times["full"], "call_ms": times["full"],
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": by,
            "library_ms": None, "variants_ms": device_times,
            "variants_call_ms": times, "variants_ms_by_shape": by_shape}


def run_on_card(vf, config, frames):
    """Encode and decode on the card, timed on the host around a
    synchronise.  Returns (encoder, stream, decoder, frames out,
    encode seconds, decode seconds)."""
    enc = GopEncoder(vf, device="cuda", **config)
    t0 = time.perf_counter()
    stream = enc.encode_stream(frames)
    torch.cuda.synchronize()
    t_enc = time.perf_counter() - t0
    dec = StreamDecoder(device="cuda")
    t0 = time.perf_counter()
    out = dec.decode_stream(stream)
    torch.cuda.synchronize()
    t_dec = time.perf_counter() - t0
    return enc, stream, dec, out, t_enc, t_dec


def phase_backref(card):
    """The backref encode + decode on the card; returns kernel launches."""
    # a small stream on the card equals the CPU encode (the CPU path is
    # the one the parity tests hold to the JAX package)
    small = make_frames(4, 128, 64)
    s_gpu = GopEncoder(video_format(128, 64), device="cuda",
                       **CONFIG).encode_stream(small)
    s_cpu = GopEncoder(video_format(128, 64), device="cpu",
                       **CONFIG).encode_stream(small)
    if s_gpu != s_cpu:
        raise AssertionError("128x64 stream on cuda differs from the CPU "
                             "encode")
    print(f"phase3 128x64 x4 stream on cuda == CPU encode "
          f"({len(s_gpu)} bytes)", flush=True)

    W, H, N = 1920, 1080, 4
    vf = video_format(W, H)
    frames = make_frames(N, W, H)
    # warm-up: one I + one P at full size (allocator, library init)
    GopEncoder(vf, device="cuda", **CONFIG).encode_stream(frames[:2])
    torch.cuda.synchronize()

    pr.LAUNCHES = 0
    enc, stream, dec, out, t_enc, t_dec = run_on_card(vf, CONFIG, frames)
    launches = pr.LAUNCHES

    n_p = sum(1 for f in enc.stats.frames if not f["intra"])
    print(f"phase3 coded {N - n_p} I + {n_p} P pictures "
          f"({'intra bailout/scene cut fired' if n_p != N - 1 else 'no intra bailout'}); "
          f"me_search launches {launches}", flush=True)
    if launches != LAUNCHES_PER_REF * n_p or n_p == 0:
        raise AssertionError(f"expected {LAUNCHES_PER_REF} launches per P "
                             f"picture ({LAUNCHES_PER_REF * n_p}), counted "
                             f"{launches}")
    vals = check_frames(out, frames, dec, "phase3")
    print(f"phase3 1080p25 4:2:0 x{N}: {len(stream)} bytes, luma PSNR "
          f"mean {np.mean(vals):.3f} min {min(vals):.3f} dB, "
          f"md5_failures=[] errors=[]; encode {N / t_enc:.3f} frames/s, "
          f"decode {N / t_dec:.3f} frames/s [{card}]", flush=True)
    return launches


def fit_summary(enc):
    """(pictures whose RD pick ran the lambda fit, those where it bound,
    the smallest fitted scale) from the encoder's picture records."""
    fitted = [f for f in enc.stats.frames if (f.get("target_bits") or 0) > 0]
    bound = [f for f in fitted if f["lam_scale"] < 0.99]
    return (len(fitted), len(bound),
            min((f["lam_scale"] for f in fitted), default=1.0))


def phase_draining(card, vf, frames):
    """The flagship with a draining reservoir at 1080p: the 22-step
    lambda fit must run and bind, and the stream must decode clean."""
    enc, stream, dec, out, t_enc, _ = run_on_card(
        vf, CONFIG_FLAGSHIP_DRAINING, frames)
    for f in enc.stats.frames:
        if not f["intra"]:
            print(f"phase5 draining picture {f['frame']:2d} "
                  f"{'B' if f['b_picture'] else 'P'}: {f['bits'] // 8} "
                  f"bytes, fit target {f['target_bits']:.0f} bits, fitted "
                  f"scale {f['lam_scale']:.6g}, reservoir "
                  f"{f['buffer_level']:.0f} bits", flush=True)
    n_fit, n_bound, s_min = fit_summary(enc)
    vals = check_frames(out, frames, dec, "phase5 draining")
    print(f"phase5 draining 1080p x{len(frames)} at "
          f"{CONFIG_FLAGSHIP_DRAINING['bitrate']} bit/s: {len(stream)} "
          f"bytes, luma PSNR mean {np.mean(vals):.3f} min {min(vals):.3f} "
          f"dB; the lambda fit ran on {n_fit} pictures and bound on "
          f"{n_bound} (smallest scale {s_min:.6g}); encode "
          f"{len(frames) / t_enc:.3f} frames/s [{card}]", flush=True)
    if n_bound < 1:
        raise AssertionError("phase5 draining: the lambda fit bound on no "
                             "picture")


def phase_flagship(card):
    """The flagship biref CBR encode + decode on the card; returns kernel
    launches of the 13-frame run."""
    # 128x64 on the card against the CPU: float sums differ between the
    # two, so the streams are held in bands, not bytes.  The bitrate is
    # cut to 500 kbit/s so that the controller binds at this size.
    small = make_frames(9, 128, 64)
    cfg = dict(CONFIG_FLAGSHIP, bitrate=500_000)
    vf_s = video_format(128, 64)
    e_cpu = GopEncoder(vf_s, device="cpu", **cfg)
    s_cpu = e_cpu.encode_stream(small)
    d_cpu = StreamDecoder(device="cpu")
    o_cpu = d_cpu.decode_stream(s_cpu)
    e_gpu, s_gpu, d_gpu, o_gpu, _, _ = run_on_card(vf_s, cfg, small)
    p_cpu = np.mean(check_frames(o_cpu, small, d_cpu, "phase5 128x64 cpu"))
    p_gpu = np.mean(check_frames(o_gpu, small, d_gpu, "phase5 128x64 cuda"))
    picks = differing = 0
    for a, b in zip(e_cpu.stats.frames, e_gpu.stats.frames):
        if a["frame"] != b["frame"]:
            raise AssertionError("phase5 128x64: coded order differs")
        picks += len(a["qi_bands"])
        differing += sum(x != y for x, y in zip(a["qi_bands"],
                                                b["qi_bands"]))
    print(f"phase5 128x64 x9 flagship at 500 kbit/s: cuda {len(s_gpu)} "
          f"bytes {p_gpu:.3f} dB, cpu {len(s_cpu)} bytes {p_cpu:.3f} dB; "
          f"{differing} of {picks} per-band picks differ; streams "
          f"{'equal' if s_gpu == s_cpu else 'differ'}; the lambda fit ran "
          f"on {fit_summary(e_gpu)[0]} pictures", flush=True)
    if abs(p_gpu - p_cpu) >= 0.7:
        raise AssertionError(f"phase5 128x64: PSNR {p_gpu:.3f} vs "
                             f"{p_cpu:.3f} dB")
    if abs(len(s_gpu) - len(s_cpu)) >= 0.15 * len(s_cpu):
        raise AssertionError(f"phase5 128x64: {len(s_gpu)} vs "
                             f"{len(s_cpu)} bytes")

    W, H, N = 1920, 1080, 13
    vf = video_format(W, H)
    frames = make_frames(N, W, H)
    # warm-up: I, P, 3 B and one more picture at full size
    GopEncoder(vf, device="cuda", **CONFIG_FLAGSHIP).encode_stream(
        frames[:6])
    torch.cuda.synchronize()
    phase_draining(card, vf, frames[:9])

    pr.LAUNCHES = 0
    enc, stream, dec, out, t_enc, t_dec = run_on_card(vf, CONFIG_FLAGSHIP,
                                                      frames)
    launches = pr.LAUNCHES

    for f in enc.stats.frames:
        kind = "I" if f["intra"] else "B" if f.get("b_picture") else "P"
        lam = f.get("base_lambda")
        print(f"phase5 picture {f['frame']:2d} {kind}: {f['bits'] // 8} "
              f"bytes, base lambda "
              f"{'n/a' if lam is None else format(lam, '.6g')}, reservoir "
              f"{f['buffer_level']:.0f} bits", flush=True)
    kinds = picture_kinds(stream)
    n1 = sum(1 for _, r, _ in kinds if r == 1)
    n2 = sum(1 for _, r, _ in kinds if r == 2)
    n_p2 = sum(1 for _, r, is_ref in kinds if r == 2 and is_ref)
    n_b = sum(1 for _, r, is_ref in kinds if r == 2 and not is_ref)
    print(f"phase5 coded {len(kinds) - n1 - n2} I, {n1} one-reference P, "
          f"{n_p2} two-reference P, {n_b} B; me_search launches "
          f"{launches}", flush=True)
    if n_p2 < 1 or n_b < 6:
        raise AssertionError(f"expected >= 1 two-reference P and >= 6 B "
                             f"pictures, got {n_p2} and {n_b}")
    expect = LAUNCHES_PER_REF * (2 * n2 + n1)
    if launches != expect:
        raise AssertionError(f"expected {2 * LAUNCHES_PER_REF} launches per "
                             f"two-reference and {LAUNCHES_PER_REF} per "
                             f"one-reference picture ({expect}), counted "
                             f"{launches}")
    vals = check_frames(out, frames, dec, "phase5")
    share = N * CONFIG_FLAGSHIP["bitrate"] / CONFIG_FLAGSHIP["fps"] / 8
    if not 0.1 * share <= len(stream) <= 4 * share:
        raise AssertionError(f"phase5: {len(stream)} bytes outside 0.1x-4x "
                             f"of the pro-rata {share:.0f}")
    print(f"phase5 1080p25 4:2:0 x{N} biref CBR: the lambda fit ran on "
          f"{fit_summary(enc)[0]} pictures (the reservoir stays full: the "
          f"draining run above drives it)", flush=True)
    print(f"phase5 1080p25 4:2:0 x{N} biref CBR: {len(stream)} bytes "
          f"({len(stream) / share:.3f} of the pro-rata {share:.0f}), luma "
          f"PSNR mean {np.mean(vals):.3f} min {min(vals):.3f} dB, "
          f"md5_failures=[] errors=[]; encode {N / t_enc:.3f} frames/s, "
          f"decode {N / t_dec:.3f} frames/s [{card}]", flush=True)
    return launches


def batch_args(shape, dev, seed, n=3):
    """me_search's arguments for a batch of n pictures at one launch
    shape: n current planes and fields from n seeds, the first seed's
    reference (the pictures share it)."""
    cases = [probe_tool.make_inputs(shape, dev, seed=seed + 7 * k)
             for k in range(n)]
    args = list(cases[0])
    args[0] = torch.stack([c[0] for c in cases])
    if args[2] is not None:
        args[2] = torch.stack([c[2] for c in cases])
    return tuple(args)


def picture_args(args, k):
    """Picture k of a batch's arguments, as a single-picture call."""
    one = list(args)
    one[0] = args[0][k].clone()
    one[2] = None if args[2] is None else args[2][k].clone()
    return tuple(one)


def phase_batch_kernel(card):
    """Kernel at N = 3 == plain and == three N = 1 launches at the seven
    1080p launch shapes; device time per launch at N = 3 beside N = 1;
    then a batched 1080p ME pass.  Returns the entry's batch keys."""
    dev = torch.device("cuda")
    max_err = 0
    t1 = t3 = b3 = 0.0
    shapes = []
    for seed, shape in enumerate(probe_tool.REFINE_SHAPES):
        args3 = batch_args(shape, dev, seed)
        before = pr.LAUNCHES
        got = pr.me_search(*args3)
        if pr.LAUNCHES != before + 1:
            raise AssertionError("phase6: a batch made more than one launch")
        want = pr.me_search_plain(*args3)
        torch.cuda.synchronize()
        max_err = max(max_err, assert_equal_outputs(
            got, want, f"phase6 me_search N=3 {shape[0]}"))
        for k in range(3):
            one = pr.me_search(*picture_args(args3, k))
            if not (torch.equal(got[0][k], one[0])
                    and torch.equal(got[1][k], one[1])):
                raise AssertionError(f"phase6 {shape[0]}: picture {k} of "
                                     "the batch differs from its own launch")
        args1 = picture_args(args3, 0)
        # turns: N = 1, N = 3, N = 3, N = 1, on the device alone
        d1a = graph_ms(pr.me_search, args1)
        d3a = graph_ms(pr.me_search, args3)
        d3b = graph_ms(pr.me_search, args3)
        d1b = graph_ms(pr.me_search, args1)
        d1, d3 = (d1a + d1b) / 2, (d3a + d3b) / 2
        bound3, by3 = refine_bound_ms(args3)
        t1, t3, b3 = t1 + d1, t3 + d3, b3 + bound3
        shapes.append({"shape": shape[0], "ms_n1": d1, "ms_n3": d3,
                       "bound_ms_n3": bound3, "bound_by_n3": by3})
        print(f"phase6 me_search N=3 {probe_tool.describe(shape)}: kernel "
              f"== plain == three N=1 launches; one launch {d3:.4f} ms on "
              f"the device at N=3, {d1:.4f} ms at N=1 ({d3 / d1:.2f}x for "
              f"3x the work); bound at N=3 {bound3:.5f} ms by {by3} "
              f"[{card}]", flush=True)
    print(f"phase6 me_search, the seven launches of one reference: "
          f"{t3:.4f} ms on the device for three pictures at N=3, "
          f"{t1:.4f} ms for one at N=1 (three single pictures: "
          f"{3 * t1:.4f} ms); bound at N=3 {b3:.5f} ms [{card}]",
          flush=True)

    W, H = 1920, 1080
    frames = make_frames(4, W, H)
    cur = torch.stack([torch.tensor(f[0], device=dev) for f in frames[1:]])
    ref = torch.tensor(frames[0][0], device=dev)
    body = me_mod.make_me_body(H, W, 16, 16, 120, 68, levels=5,
                               coarse_radius=probe_tool.COARSE_RADIUS)
    body(cur, ref)                       # warm-up
    torch.cuda.synchronize()
    before = pr.LAUNCHES
    got = body(cur, ref)
    torch.cuda.synchronize()
    launches = pr.LAUNCHES - before
    if launches != LAUNCHES_PER_REF:
        raise AssertionError(f"phase6 batched ME pass: {launches} launches,"
                             f" expected {LAUNCHES_PER_REF}")
    for k in range(3):
        one = body(cur[k].clone(), ref)
        for g, w_, name in zip(got, one, ("dy", "dx", "sad")):
            if not torch.equal(g[k], w_):
                raise AssertionError(f"phase6 batched ME pass: picture {k}"
                                     f" {name} differs from its own pass")
    print(f"phase6 1080p ME pass of a batch of 3 pictures: {launches} "
          f"launches, equal to three single-picture passes [{card}]",
          flush=True)
    return {"batch_max_abs_err": max_err, "ms_n3": t3, "ms_n1": t1,
            "bound_ms_n3": b3, "batch_shapes": shapes}


def check_two_decoders(stream, frames, made, card, what, peak=255.0):
    """api.Decoder (pipelined) and StreamDecoder on the card, timed in
    turns (pipelined, per-picture, per-picture, pipelined), held to the
    bench's gates (`bench.check_decodes`: equal planes for every frame,
    every reference picture equal to the encoder's reconstruction, luma
    PSNR >= 30 dB).  Returns (PSNRs, pipelined frames/s, per-picture
    frames/s), the rates the means of the two turns."""
    runs = bench.decode_both(stream, torch.device(CARD), (
        "pipelined", "per-picture", "per-picture", "pipelined"))
    vals = bench.check_decodes(runs, frames, bench.ref_digests(made), what,
                               peak)
    fps = {name: np.mean([len(frames) / r[0] for r in v])
           for name, v in runs.items()}
    return vals, fps["pipelined"], fps["per-picture"]


def phase_small_card_vs_cpu(card):
    """128x64: bench.py's configuration and api.Encoder's default on the
    card against the CPU."""
    small = make_frames(9, 128, 64)
    vf_s = video_format(128, 64)
    runs = {
        "bench (B batched)": lambda dev: GopEncoder(
            vf_s, device=dev, **dict(CONFIG_BENCH, bitrate=500_000)
        ).encode_stream(small),
        "api default": lambda dev: api.Encoder(
            vf_s, EncoderConfig(), device=dev).encode_stream(small),
        "bench noarith": lambda dev: GopEncoder(
            vf_s, device=dev, enable_noarith=True,
            **dict(CONFIG_BENCH, bitrate=500_000)).encode_stream(small)}
    for name, run in runs.items():
        psnrs = []
        streams = [run(None), run("cpu")]
        for stream, dev in zip(streams, (None, "cpu")):
            dec = api.Decoder(device=dev)
            psnrs.append(np.mean(check_frames(
                dec.decode_stream(stream), small, dec,
                f"phase7 {name} {dev or 'cuda'}")))
        (s_gpu, s_cpu), (p_gpu, p_cpu) = streams, psnrs
        print(f"phase7 128x64 x9 {name}: cuda {len(s_gpu)} bytes "
              f"{p_gpu:.3f} dB, cpu {len(s_cpu)} bytes {p_cpu:.3f} dB; "
              f"streams {'equal' if s_gpu == s_cpu else 'differ'} [{card}]",
              flush=True)
        if abs(p_gpu - p_cpu) >= 0.7 or \
                abs(len(s_gpu) - len(s_cpu)) >= 0.15 * len(s_cpu):
            raise AssertionError(f"phase7 {name}: card and CPU streams "
                                 "outside the bands")


def phase_bench_headline(card):
    """smoke-1080p-bench-headline; returns its launch counts."""
    W, H, N = 1920, 1080, 50
    vf = video_format(W, H)
    frames = make_frames(N, W, H)
    # warm-up: I, P, a batch of 3 B (allocator, library init)
    GopEncoder(vf, **CONFIG_BENCH).encode_stream(frames[:6])
    torch.cuda.synchronize()
    enc = GopEncoder(vf, **CONFIG_BENCH)
    seen = record_batches(enc)
    made = record_refs(enc)
    ticks = []
    pr.LAUNCHES = 0
    t0 = time.perf_counter()
    stream = enc.encode_stream(frames, progress=lambda i, n: ticks.append(
        (i, n)))
    torch.cuda.synchronize()
    t_enc = time.perf_counter() - t0
    launches = pr.LAUNCHES

    n_i, n_p, n_b = picture_mix(stream)
    batches = [s for s in seen if s[1]]
    per_pic = [s for s in seen if not s[1]]
    print(f"phase8 mix: {n_i} I, {n_p} P, {n_b} B; {len(batches)} batches "
          f"of B pictures ({sum(len(s[0]) for s in batches)} B), per-"
          f"picture subgroups offered {[s[0] for s in per_pic]}; launches "
          f"per batch {sorted(set(s[2] for s in batches))}; me_search "
          f"launches {launches}; progress called {len(ticks)} times",
          flush=True)
    if not batches or any(len(s[0]) == CONFIG_BENCH.get(
            "subgroup_length", 4) - 1 for s in per_pic):
        raise AssertionError(f"phase8: a full subgroup of B pictures went "
                             f"per picture: {per_pic}")
    if any(s[2] > 2 * LAUNCHES_PER_REF for s in batches):
        raise AssertionError("phase8: a batch made more than "
                             f"{2 * LAUNCHES_PER_REF} launches")
    if len(ticks) != N or ticks[-1][0] != N - 1:
        raise AssertionError(f"phase8: progress called {len(ticks)} times")
    vals, fps_pipe, fps_base = check_two_decoders(stream, frames, made, card,
                                                  "phase8")
    share = N * CONFIG_BENCH["bitrate"] / CONFIG_BENCH["fps"] / 8
    if not 0.1 * share <= len(stream) <= 4 * share:
        raise AssertionError(f"phase8: {len(stream)} bytes outside 0.1x-4x "
                             f"of the pro-rata {share:.0f}")
    print(f"phase8 smoke-1080p-bench-headline x{N}: {len(stream)} bytes "
          f"({len(stream) / share:.3f} of the pro-rata {share:.0f}), luma "
          f"PSNR mean {np.mean(vals):.3f} min {min(vals):.3f} dB, "
          f"{len(made)} reference pictures equal to the encoder's; encode "
          f"{N / t_enc:.3f} frames/s, decode {fps_pipe:.3f} frames/s "
          f"pipelined (api.Decoder), {fps_base:.3f} frames/s StreamDecoder "
          f"[{card}]", flush=True)
    return {"launches": launches,
            "batch_launches": sum(s[2] for s in batches),
            "batches": len(batches)}


def phase_api_default(card):
    """smoke-1080p-api-default; returns its launches."""
    W, H, N = 1920, 1080, 13
    vf = video_format(W, H)
    frames = make_frames(N, W, H)
    api.Encoder(vf, EncoderConfig()).encode_stream(frames[:6])   # warm-up
    torch.cuda.synchronize()
    enc = api.Encoder(vf, EncoderConfig())
    seen = record_batches(enc._gop)
    made = record_refs(enc._gop)
    pr.LAUNCHES = 0
    t0 = time.perf_counter()
    stream = enc.encode_stream(frames)
    torch.cuda.synchronize()
    t_enc = time.perf_counter() - t0
    launches = pr.LAUNCHES
    n_i, n_p, n_b = picture_mix(stream)
    vals, fps_pipe, fps_base = check_two_decoders(stream, frames, made, card,
                                                  "phase9")
    print(f"phase9 smoke-1080p-api-default x{N} (constant quality, "
          f"pipeline depth {enc._gop.pipeline_depth}, mv precision "
          f"{enc._gop.mv_precision}, inter wavelet "
          f"{int(enc._gop.inter_wavelet)}): {n_i} I, {n_p} P, {n_b} B, "
          f"{sum(1 for s in seen if s[1])} batches; {len(stream)} bytes, "
          f"luma PSNR mean {np.mean(vals):.3f} min {min(vals):.3f} dB; "
          f"me_search launches {launches}; encode {N / t_enc:.3f} frames/s,"
          f" decode {fps_pipe:.3f} frames/s pipelined, {fps_base:.3f} "
          f"frames/s StreamDecoder [{card}]", flush=True)
    return launches


# ---- the VC-2 profiles and no-arith long GOP (phases 10-14) -------------

C422 = ChromaFormat.C422
PEAK10 = 1023.0
FULL = (1920, 1080)      # the picture size of phases 10, 12, 13 and 14
CIF = (352, 288)


def picture_payloads(stream):
    """The picture units' payloads (after the 13-byte parse info)."""
    return [pl for c, pl in bs.split_units(stream) if bs.is_picture(c)]


def sequence_profile(stream):
    seq = [pl for c, pl in bs.split_units(stream)
           if c == bs.SEQUENCE_HEADER]
    return bs.read_sequence_header(BitReader(seq[0])).profile


def lowdelay_bases(stream, params):
    """Per picture, the base quant index every slice picked (native
    decode of its slices)."""
    hdr = len(loe._picture_headers(params, 0, False)) - 13
    y_qmo, uv_qmo, sbytes = loe._host_arrays(params)
    ny, nx = params.n_vert_slices, params.n_horiz_slices
    out = []
    for pl in picture_payloads(stream):
        out.append(coder.ld_decode(pl[hdr:], y_qmo, uv_qmo, ny, nx,
                                   y_qmo.size, uv_qmo.size, sbytes)[3])
    return out


def encode_timed(make, frames):
    """Encode on the card, timed on the host around a synchronise:
    (encoder, stream, seconds)."""
    enc = make()
    t0 = time.perf_counter()
    stream = enc.encode_stream(frames)
    torch.cuda.synchronize()
    return enc, stream, time.perf_counter() - t0


def lowdelay_stage_shares(enc, frames):
    """The encode's stages one after another on `frames` (no overlap):
    device analysis (upload and kernels, to a synchronise; and the
    kernels' own time from CUDA events), the fetch to the host and the
    native packing.  Returns ms per frame of each."""
    p = enc.params
    analyze = loe._get_analyze_fn(p)
    tot = {"analysis": 0.0, "analysis_device": 0.0, "fetch": 0.0,
           "pack": 0.0}
    for i, f in enumerate(frames):
        t0 = time.perf_counter()
        planes = planes_to_device(f, p.video_format.bit_depth, enc.device)
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        dev = analyze(*planes)
        e1.record()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        host = loe.fetch_analysis(dev)
        t2 = time.perf_counter()
        loe.encode_picture_from_analysis(host, p, i, False)
        t3 = time.perf_counter()
        tot["analysis"] += (t1 - t0) * 1e3
        tot["analysis_device"] += e0.elapsed_time(e1)
        tot["fetch"] += (t2 - t1) * 1e3
        tot["pack"] += (t3 - t2) * 1e3
    return {k: v / len(frames) for k, v in tot.items()}


def phase_lowdelay_cli(card):
    """smoke-1080p-vc2-lowdelay-cli-422p10."""
    (W, H), N = FULL, 25
    vf = video_format(W, H, C422, 10)
    frames = make_frames(N, W, H, chroma_format=C422, bit_depth=10)
    cfg = encoder_config("lowdelay")
    api.Encoder(vf, cfg).encode_stream(frames[:2])           # warm-up
    torch.cuda.synchronize()
    runs = {}
    for path in ("table", "direct", "direct", "table"):
        def make(path=path):
            enc = api.Encoder(vf, cfg)
            enc.ld_path = path
            return enc
        enc, stream, secs = encode_timed(make, frames)
        runs.setdefault(path, []).append((stream, secs, enc.ld_seconds))
    stream = runs["table"][0][0]
    if any(r[0] != stream for v in runs.values() for r in v):
        raise AssertionError("phase10: the table and direct paths (or two "
                             "runs of one) gave different bytes")
    p = enc.params
    budget = int(loe._host_arrays(p)[2].sum())
    head = len(loe._picture_headers(p, 0, False))
    sizes = {len(pl) + 13 for pl in picture_payloads(stream)}
    if sizes != {head + budget}:
        raise AssertionError(f"phase10: picture units of {sorted(sizes)} "
                             f"bytes, expected headers {head} + slice "
                             f"budgets {budget}")
    s_cpu = api.Encoder(vf, cfg, device="cpu").encode_stream(frames[:2])
    s_gpu = api.Encoder(vf, cfg).encode_stream(frames[:2])
    if s_cpu != s_gpu:
        raise AssertionError("phase10: the first 2 frames on the card "
                             "differ from the CPU encode")
    shares = lowdelay_stage_shares(enc, frames[:5])
    vals, fps_api, fps_sd = check_two_decoders(stream, frames, {}, card,
                                               "phase10", PEAK10)
    fps = {k: np.mean([N / r[1] for r in v]) for k, v in runs.items()}
    seq = shares["analysis"] + shares["fetch"] + shares["pack"]
    # the pipelined table runs: the worker's fetch and packing against
    # the wall (the main thread queues the analysis meanwhile)
    worker = {k: np.mean([r[2][k] / r[1] for r in runs["table"]])
              for k in ("fetch", "pack")}
    print(f"phase10 smoke-1080p-vc2-lowdelay-cli-422p10 x{N}: "
          f"{p.n_horiz_slices} x {p.n_vert_slices} slices of "
          f"{p.slice_bytes_num}/{p.slice_bytes_denom} bytes, units of "
          f"{head} + {budget} bytes, table == direct == CPU (2 frames); "
          f"luma PSNR mean {np.mean(vals):.3f} min {min(vals):.3f} dB at "
          f"peak 1023; encode {fps['table']:.3f} frames/s (table), "
          f"{fps['direct']:.3f} (direct); decode {fps_api:.3f} frames/s "
          f"api.Decoder, {fps_sd:.3f} StreamDecoder [{card}]", flush=True)
    print(f"phase10 encode stages one after another, ms per frame: device "
          f"analysis {shares['analysis']:.3f} (kernels "
          f"{shares['analysis_device']:.3f} by CUDA events), fetch "
          f"{shares['fetch']:.3f}, native packing {shares['pack']:.3f}; "
          f"shares {shares['analysis'] / seq:.3f} / "
          f"{shares['fetch'] / seq:.3f} / {shares['pack'] / seq:.3f}; the "
          f"pipelined encode takes {1e3 / fps['table']:.3f} ms a frame "
          f"against {seq:.3f} in turn, its worker thread busy "
          f"{worker['fetch']:.3f} of the wall fetching and "
          f"{worker['pack']:.3f} packing [{card}]", flush=True)
    phase_cli(card, vf, frames[:3])


def phase_cli(card, vf, frames):
    """The CLI itself, encode then decode, on a y4m of `frames`."""
    with tempfile.TemporaryDirectory() as tmp:
        src, drc, dst = (os.path.join(tmp, n) for n in ("in.y4m", "out.drc",
                                                        "out.y4m"))
        wr = y4m.Y4MWriter(src, vf, vf.bit_depth)
        wr.write_frames(frames)
        wr.close()
        env = dict(os.environ, PYTHONPATH=os.path.dirname(
            os.path.abspath(__file__)))
        t0 = time.perf_counter()
        for args in (["encode", src, drc], ["decode", drc, dst]):
            subprocess.run([sys.executable, "-m",
                            "schroedinger_tpu_torch.tools.schro_tpu", *args],
                           check=True, env=env, timeout=300)
        secs = time.perf_counter() - t0
        stream = open(drc, "rb").read()
        _, got, depth = y4m.read_y4m(dst)
        got = list(got)
        want = api.Decoder().decode_stream(stream)
    if depth != vf.bit_depth or len(got) != len(frames):
        raise AssertionError(f"phase10 CLI: {len(got)} frames at "
                             f"{depth} bits")
    for a3, b3 in zip(got, want):
        if not all(np.array_equal(a, b) for a, b in zip(a3, b3)):
            raise AssertionError("phase10 CLI: its y4m differs from "
                                 "api.Decoder's planes")
    print(f"phase10 CLI `schro_tpu encode` (default profile) + `decode` of "
          f"{len(frames)} frames of 10-bit 4:2:2 y4m: {len(stream)} bytes, "
          f"output y4m == api.Decoder's planes; {secs:.3f} s for both "
          f"processes [{card}]", flush=True)


def phase_lowdelay_lossless(card):
    """smoke-cif-vc2-lowdelay-lossless (BASELINE.json config 1)."""
    (W, H), N = CIF, 10
    vf = video_format(W, H)
    frames = make_frames(N, W, H)
    # 24 bits a luma sample: room for every slice at base 0
    cfg = encoder_config("lowdelay", bitrate=W * H * 25 * 24)
    enc, stream, secs = encode_timed(lambda: api.Encoder(vf, cfg), frames)
    bases = lowdelay_bases(stream, enc.params)
    if any(b.any() for b in bases):
        raise AssertionError("phase11: a slice picked a base above 0")
    dec = api.Decoder()
    out = dec.decode_stream(stream)
    if len(out) != N or not all(
            torch.equal(torch.from_numpy(o), torch.from_numpy(f))
            for o3, f3 in zip(out, frames) for o, f in zip(o3, f3)):
        raise AssertionError("phase11: the decode is not the source")
    print(f"phase11 smoke-cif-vc2-lowdelay-lossless x{N}: every slice of "
          f"every picture at base 0 ({bases[0].size} slices), decode == "
          f"source (torch.equal, every plane); {len(stream)} bytes, encode "
          f"{N / secs:.3f} frames/s [{card}]", flush=True)


def phase_intra_profile(card, tag, what, vf, cfg, frames, peak, profile):
    """An intra-only profile at 1080p: card == CPU on frame 0, the
    sequence header's profile, both decoders, PSNR >= 30 dB."""
    if api.Encoder(vf, cfg).encode_stream(frames[:1]) != api.Encoder(
            vf, cfg, device="cpu").encode_stream(frames[:1]):
        raise AssertionError(f"{tag}: frame 0 on the card differs from the "
                             "CPU encode")
    enc, stream, secs = encode_timed(lambda: api.Encoder(vf, cfg), frames)
    if enc.profile != what or sequence_profile(stream) != profile:
        raise AssertionError(f"{tag}: profile {enc.profile} "
                             f"{sequence_profile(stream)}")
    vals, fps_api, fps_sd = check_two_decoders(stream, frames, {}, card, tag,
                                               peak)
    print(f"{tag} smoke-1080p-{what.replace('_', '-')}"
          f"{'-422p10' if peak > 255 else ''} x{len(frames)}: profile "
          f"{profile}, frame 0 card == CPU, {len(stream)} bytes, luma PSNR "
          f"mean {np.mean(vals):.3f} min {min(vals):.3f} dB at peak "
          f"{peak:.0f}; encode {len(frames) / secs:.3f} frames/s, decode "
          f"{fps_api:.3f} frames/s api.Decoder, {fps_sd:.3f} StreamDecoder "
          f"[{card}]", flush=True)


def phase_bench_noarith(card):
    """smoke-1080p-bench-noarith; returns its launches."""
    (W, H), N = FULL, 13
    vf = video_format(W, H)
    frames = make_frames(N, W, H)
    cfg = dict(CONFIG_BENCH, enable_noarith=True)
    GopEncoder(vf, **cfg).encode_stream(frames[:2])          # warm-up
    torch.cuda.synchronize()
    enc = GopEncoder(vf, **cfg)
    seen = record_batches(enc)
    made = record_refs(enc)
    pr.LAUNCHES = 0
    t0 = time.perf_counter()
    stream = enc.encode_stream(frames)
    torch.cuda.synchronize()
    t_enc = time.perf_counter() - t0
    launches = pr.LAUNCHES
    kinds = picture_kinds(stream)
    batched = sum(len(s[0]) for s in seen if s[1])
    refs_p = sum(r for _, r, ref in kinds if r and ref)
    n_b = sum(1 for _, r, ref in kinds if r and not ref)
    expect = (LAUNCHES_PER_REF * (refs_p + 2 * (n_b - batched))
              + 2 * LAUNCHES_PER_REF * sum(1 for s in seen if s[1]))
    if launches != expect or any(s[2] != 2 * LAUNCHES_PER_REF
                                 for s in seen if s[1]):
        raise AssertionError(f"phase14: {launches} launches, expected "
                             f"{expect} (7 per reference, 14 a batch)")
    if any(bs.using_ac(c) for c, _ in bs.split_units(stream)
           if bs.is_picture(c)):
        raise AssertionError("phase14: a picture is arith coded")
    vals, fps_pipe, fps_base = check_two_decoders(stream, frames, made, card,
                                                  "phase14")
    share = N * CONFIG_BENCH["bitrate"] / CONFIG_BENCH["fps"] / 8
    if not 0.1 * share <= len(stream) <= 4 * share:
        raise AssertionError(f"phase14: {len(stream)} bytes outside 0.1x-4x "
                             f"of the pro-rata {share:.0f}")
    n_i, n_p, n_b = picture_mix(stream)
    print(f"phase14 smoke-1080p-bench-noarith x{N}: {n_i} I, {n_p} P, {n_b} "
          f"B ({batched} in batches), every picture no-arith; me_search "
          f"launches {launches}; {len(stream)} bytes "
          f"({len(stream) / share:.3f} of the pro-rata {share:.0f}), luma "
          f"PSNR mean {np.mean(vals):.3f} min {min(vals):.3f} dB, "
          f"{len(made)} reference pictures equal to the encoder's; encode "
          f"{N / t_enc:.3f} frames/s, decode {fps_pipe:.3f} frames/s "
          f"pipelined, {fps_base:.3f} StreamDecoder [{card}]", flush=True)
    return launches


# ---- the long-GOP rate controls (phases 15-18) ---------------------------

SMALL = (128, 64)        # the card-vs-CPU size of phase 15


def record_picks():
    """Keep, per inter picture an encoder finishes, its band and
    multiquant codeblock picks (wraps the inter module's finish, which
    the encoders call); returns (picks, a function that unwraps it)."""
    seen = {}
    inter = gop_mod.ei_inter
    orig = inter.finish_inter_picture

    def recording(pending, num, *a, **k):
        out = orig(pending, num, *a, **k)
        seen[num] = (pending["qi_bands"].copy(), dict(pending["qi_cb"]))
        return out
    inter.finish_inter_picture = recording
    return seen, lambda: setattr(inter, "finish_inter_picture", orig)


def run_rate_phase(card, tag, name, make, frames, encode=None,
                   per_ref=None, warm=6):
    """Encode `frames` with the encoder `make()` gives (after a warm-up of
    the first `warm`), counting the kernel's launches (per_ref a
    reference), and hold the stream to the phase checks.  Returns
    (stream, launches, encoder, batches)."""
    encode = encode or (lambda e: e.encode_stream(frames))
    make().encode_stream(frames[:warm])                      # warm-up
    torch.cuda.synchronize()
    enc = make()
    gop = getattr(enc, "_gop", enc)
    seen = record_batches(gop)
    made = record_refs(gop)
    pr.LAUNCHES = 0
    t0 = time.perf_counter()
    stream = encode(enc)
    torch.cuda.synchronize()
    t_enc = time.perf_counter() - t0
    launches = pr.LAUNCHES
    per_ref = per_ref or LAUNCHES_PER_REF
    expect = expected_searches(stream, seen, per_ref)
    if launches != expect:
        raise AssertionError(f"{tag}: {launches} launches, expected {expect}"
                             f" ({per_ref} per reference, {2 * per_ref} a "
                             "batch of B)")
    vals, fps_pipe, fps_base = check_two_decoders(stream, frames, made, card,
                                                  tag)
    n_i, n_p, n_b = picture_mix(stream)
    print(f"{tag} {name} x{len(frames)}: {n_i} I, {n_p} P, {n_b} B "
          f"({sum(len(s[0]) for s in seen if s[1])} in batches); me_search "
          f"launches {launches}; {len(stream)} bytes, luma PSNR mean "
          f"{np.mean(vals):.3f} min {min(vals):.3f} dB, {len(made)} "
          f"reference pictures equal to the encoder's; encode "
          f"{len(frames) / t_enc:.3f} frames/s, decode {fps_pipe:.3f} "
          f"frames/s pipelined, {fps_base:.3f} StreamDecoder [{card}]",
          flush=True)
    return stream, launches, gop, seen


def push_all(enc, frames):
    """push_frame / pull / end_of_stream over `frames`: the stream."""
    out = bytearray()
    for f in frames:
        enc.push_frame(f)
        out += enc.pull() or b""
    return bytes(out + enc.end_of_stream())


def phase_backref_quality(card):
    """smoke-1080p-backref-quality; returns its launches."""
    cfg = EncoderConfig(gop_structure="backref")
    small = make_frames(9, *SMALL)
    vf_s = video_format(*SMALL)
    streams, psnrs = [], []
    for dev in (None, "cpu"):
        stream = api.Encoder(vf_s, cfg, device=dev).encode_stream(small)
        dec = api.Decoder(device=dev)
        psnrs.append(np.mean(check_frames(dec.decode_stream(stream), small,
                                           dec, f"phase15 {SMALL} {dev}")))
        streams.append(stream)
    print(f"phase15 {SMALL[0]}x{SMALL[1]} x9 backref constant quality: cuda "
          f"{len(streams[0])} bytes {psnrs[0]:.3f} dB, cpu {len(streams[1])}"
          f" bytes {psnrs[1]:.3f} dB; streams "
          f"{'equal' if streams[0] == streams[1] else 'differ'} [{card}]",
          flush=True)
    if abs(psnrs[0] - psnrs[1]) >= 0.7 or \
            abs(len(streams[0]) - len(streams[1])) >= 0.15 * len(streams[1]):
        raise AssertionError("phase15: card and CPU streams outside the "
                             "bands")
    (W, H), N = FULL, 13
    vf = video_format(W, H)
    frames = make_frames(N + 4, W, H)
    stream, launches, gop, _ = run_rate_phase(
        card, "phase15", "smoke-1080p-backref-quality (encode_stream)",
        lambda: api.Encoder(vf, cfg), frames[:N])
    if gop.gop_structure != "backref" or gop.qengine is None:
        raise AssertionError("phase15: not the backref engine under the "
                             "constant-quality engine")
    _, pushed, _, _ = run_rate_phase(
        card, "phase15", "smoke-1080p-backref-quality (push_frame)",
        lambda: api.Encoder(vf, cfg), frames[N:],
        encode=lambda e: push_all(e, frames[N:]))
    return {"launches_backref_quality": launches,
            "launches_backref_push": pushed}


def phase_backref_cbr(card):
    """smoke-1080p-backref-cbr; returns its launches."""
    (W, H), N = FULL, 13
    vf = video_format(W, H)
    frames = make_frames(N, W, H)
    share = N * CONFIG_BENCH["bitrate"] / CONFIG_BENCH["fps"] / 8
    out = {}
    for key, name, kw in (("launches_backref_cbr", "TM5", {}),
                          ("launches_backref_alloc", "allocation",
                           {"rdo_cbr": False})):
        cfg = dict(CONFIG_BENCH, gop_structure="backref", **kw)
        stream, launches, gop, _ = run_rate_phase(
            card, "phase16", f"smoke-1080p-backref-cbr ({name})",
            lambda cfg=cfg: GopEncoder(vf, **cfg), frames)
        if type(gop.rc).__name__ != ("CbrControllerTM5" if name == "TM5"
                                     else "CbrController"):
            raise AssertionError(f"phase16 {name}: controller "
                                 f"{type(gop.rc).__name__}")
        if not 0.1 * share <= len(stream) <= 4 * share:
            raise AssertionError(f"phase16 {name}: {len(stream)} bytes "
                                 f"outside 0.1x-4x of the pro-rata "
                                 f"{share:.0f}")
        print(f"phase16 {name}: {len(stream)} bytes = "
              f"{len(stream) / share:.3f} of the pro-rata {share:.0f}",
              flush=True)
        out[key] = launches
    return out


def phase_constant_error(card):
    """smoke-1080p-constant-error; returns its launches."""
    W, H = FULL
    vf = video_format(W, H)
    out = {}
    for key, mode, n in (("launches_constant_error", "constant_error", 13),
                         ("launches_noise_threshold",
                          "constant_noise_threshold", 9)):
        frames = make_frames(n, W, H)
        picks, restore = record_picks()
        try:
            stream, launches, gop, seen = run_rate_phase(
                card, "phase17", f"smoke-1080p-{mode.replace('_', '-')}",
                lambda mode=mode: api.Encoder(
                    vf, EncoderConfig(rate_control=mode)), frames)
        finally:
            restore()
        if any(took for _, took, _ in seen) or not seen:
            raise AssertionError(f"phase17 {mode}: a batch of B pictures "
                                 f"({seen})")
        qm = np.asarray(gop._params(1).quant_matrix, np.int32)
        moved = []
        inter = [(n, ref) for n, r, ref in picture_kinds(stream) if r]
        for num, is_ref in inter[1:]:
            qi, _ = picks[num]
            base_qi = gop.base_qi_inter if is_ref else gop.base_qi_b
            base = np.tile(np.clip(base_qi - qm[:len(qi) // 3], 0, 60), 3)
            moved.append(bool((qi != base).any()))
        print(f"phase17 {mode}: the engine's picks differ from the base "
              f"indices on {sum(moved)} of {len(moved)} inter pictures after "
              f"the first; every B picture on its own", flush=True)
        if not any(moved):
            raise AssertionError(f"phase17 {mode}: the engine never picked")
        out[key] = launches
    return out


def phase_multiquant(card):
    """smoke-1080p-multiquant; returns its launches."""
    (W, H), N = FULL, 13
    vf = video_format(W, H)
    frames = make_frames(N, W, H)
    picks, restore = record_picks()
    try:
        stream, launches, gop, seen = run_rate_phase(
            card, "phase18", "smoke-1080p-multiquant",
            lambda: api.Encoder(vf, EncoderConfig(enable_multiquant=True)),
            frames)
    finally:
        restore()
    if not any(took for _, took, _ in seen):
        raise AssertionError("phase18: no batch of B pictures")
    varied = sum(len(np.unique(cb)) > 1 for _, cbs in picks.values()
                 for cb in cbs.values())
    bands = sum(len(cbs) for _, cbs in picks.values())
    print(f"phase18 multiquant: {varied} of {bands} multiquant bands of "
          f"{len(picks)} inter pictures take more than one codeblock index",
          flush=True)
    if not varied:
        raise AssertionError("phase18: every codeblock at its band's index")
    return {"launches_multiquant": launches}


def phases_rate(card):
    """Phases 15-18; returns their launch counts."""
    out = phase_backref_quality(card)
    out.update(phase_backref_cbr(card))
    out.update(phase_constant_error(card))
    out.update(phase_multiquant(card))
    return out


def phases_vc2(card):
    """Phases 10-14; returns the launches of kernel #1 on the no-arith
    long-GOP path (the VC-2 profiles launch no hand kernel)."""
    phase_lowdelay_cli(card)
    phase_lowdelay_lossless(card)
    W, H = FULL
    phase_intra_profile(card, "phase12", "vc2_simple", video_format(W, H),
                        EncoderConfig(enable_noarith=True),
                        make_frames(8, W, H), 255.0, 1)
    phase_intra_profile(card, "phase13", "vc2_main",
                        video_format(W, H, C422, 10),
                        EncoderConfig(gop_structure="intra_only"),
                        make_frames(8, W, H, chroma_format=C422,
                                    bit_depth=10), PEAK10, 2)
    return phase_bench_noarith(card)


# ---- the long-GOP encoder's remaining settings (phases 19-22) -----------

CARD = "cuda"            # the device of phases 21 and 22's own tensors

def hold_shapes(card, tag, searches, done):
    """Kernel == plain (torch.equal) on the recorded inputs of every launch
    shape not held before (`done`, updated), each timed on the device
    (CUDA-graph replay) beside its bound and the plain version's time
    from Python; returns the largest |diff|."""
    worst = 0
    for key, args in sorted(searches.first.items()):
        if key in done:
            continue
        got = pr.me_search(*args)
        want = pr.me_search_plain(*args)
        torch.cuda.synchronize()
        worst = max(worst, assert_equal_outputs(got, want, f"{tag} {key}"))
        b_ms, by = refine_bound_ms(args)
        ms = graph_ms(pr.me_search, args)
        p_ms = time_ms(pr.me_search_plain, args)
        done[key] = {"ms": ms, "plain_ms": p_ms, "bound_ms": b_ms,
                     "bound_by": by, "launches": searches.count[key]}
        print(f"{tag} me_search cur {key[0]}, blocks {key[1]}x{key[2]}, rad "
              f"{key[3]}, scale {key[4]}: kernel == plain; {ms:.4f} ms per "
              f"launch on the device, plain {p_ms:.4f} ms, bound "
              f"{b_ms:.5f} ms by {by}, {searches.count[key]} launches "
              f"recorded [{card}]", flush=True)
    return worst


def run_setting_phase(card, tag, name, cfg, frames, per_ref, done):
    """One setting through api.Encoder on the card (run_rate_phase's
    checks, per_ref launches a reference), its launch shapes held to the
    plain version.  Returns (stream, launches, encoder, batches, max
    |diff|)."""
    W, H = FULL
    with record_searches() as searches:
        stream, launches, gop, seen = run_rate_phase(
            card, tag, name, lambda: api.Encoder(video_format(W, H), cfg),
            frames, per_ref=per_ref, warm=2)
    return stream, launches, gop, seen, hold_shapes(card, tag, searches,
                                                    done)


def phase_block_geometry(card, done):
    """smoke-1080p-block-geometry; returns (launches, max |diff|)."""
    W, H = FULL
    frames = make_frames(9, W, H)
    launches, worst = 0, 0
    # (name, settings, (bsep, blen) or None for the automatic geometry);
    # at 1080p small blocks make a 240 x 136 grid, medium a 160 x 92 one
    for name, kw, geo in (
            ("small blocks, full overlap",
             dict(motion_block_size="small", motion_block_overlap="full"),
             (8, 16)),
            ("small codeblocks", dict(codeblock_size="small"), None),
            ("medium blocks", dict(motion_block_size="medium"), (12, 16))):
        stream, n, gop, seen, err = run_setting_phase(
            card, "phase19", f"smoke-1080p-block-geometry ({name})",
            EncoderConfig(**kw), frames, LAUNCHES_PER_REF, done)
        p = gop._params(1)
        got = (p.xbsep_luma, p.xblen_luma, p.x_num_blocks, p.y_num_blocks)
        if geo and got != geo + (4 * -(-W // (4 * geo[0])),
                                 4 * -(-H // (4 * geo[0]))):
            raise AssertionError(f"phase19 {name}: geometry {got}")
        print(f"phase19 {name}: bsep {got[0]}, blen {got[1]}, {got[2]} x "
              f"{got[3]} blocks, codeblocks {p.horiz_codeblocks} x "
              f"{p.vert_codeblocks}", flush=True)
        if name == "small codeblocks" and p.horiz_codeblocks[3] < 2:
            raise AssertionError("phase19: codeblock_size=small kept one "
                                 "codeblock per band")
        launches += n
        worst = max(worst, err)
    return launches, worst


def phase_estimation(card, done):
    """smoke-1080p-estimation; returns (launches, max |diff|)."""
    W, H = FULL
    frames = make_frames(13, W, H)
    launches, worst = 0, 0
    # (name, settings, frames, launches per reference: the pyramid's
    # levels and the candidates' searches)
    for name, kw, n, per_ref in (
            ("phase correlation", dict(enable_phasecorr_estimation=1), 13,
             LAUNCHES_PER_REF + 1),
            ("chroma ME", dict(enable_chroma_me=1), 9,
             LAUNCHES_PER_REF + 6),
            ("no hierarchical", dict(enable_hierarchical_estimation=0), 9,
             3),
            ("no deep", dict(enable_deep_estimation=0), 9,
             LAUNCHES_PER_REF - 2),
            ("full scan", dict(enable_fullscan_estimation=1), 3, 3)):
        stream, count, gop, seen, err = run_setting_phase(
            card, "phase20", f"smoke-1080p-estimation ({name})",
            EncoderConfig(**kw), frames[:n], per_ref, done)
        if kw.get("enable_phasecorr_estimation") and any(
                took for _, took, _ in seen):
            raise AssertionError("phase20: a batch of B pictures under "
                                 "phase correlation")
        launches += count
        worst = max(worst, err)
    return launches, worst


def gather_streams(vf, frame):
    """1080p streams whose second picture needs the gather render: an I
    picture coded on the card, then a P picture written as its
    prediction alone (inter.write_prediction_unit) with global motion on
    every block (a pan, then an affine a-matrix) or with every vector
    near 200 pel.  Returns {name: (stream, Params of the P picture)}."""
    from schroedinger_tpu_torch.encoder import inter
    from schroedinger_tpu_torch.params import GlobalMotion
    enc = GopEncoder(vf, base_qi_intra=10, gop_length=1)
    head = enc.encode_frame(frame)
    out = {}
    rng = np.random.default_rng(21)
    for name, gm in (("pan", GlobalMotion(b0=32, b1=-16, a00=0, a11=0)),
                     ("affine", GlobalMotion(b0=12, b1=-8, a_exp=16,
                                             a00=2600, a01=-650, a10=650,
                                             a11=2600)),
                     ("mv200", None)):
        p = enc._params(1)
        p.mv_precision = 2
        yb, xb = p.y_num_blocks, p.x_num_blocks
        z = np.zeros((yb, xb), np.int32)
        mv = dict(split=z + 2, pred_mode=z + 1, using_global=z, dx2=z,
                  dy2=z, dc0=z, dc1=z, dc2=z)
        if gm is None:
            for k in ("dx1", "dy1"):
                mv[k] = (rng.choice([-1, 1], (yb, xb)) * 800
                         + rng.integers(-40, 41, (yb, xb))).astype(np.int32)
        else:
            p.have_global_motion = True
            p.global_motion = (gm, GlobalMotion())
            mv.update(using_global=z + 1, dx1=z, dy1=z)
        unit = inter.write_prediction_unit(p, 1, [0], mv)
        out[name] = (head + bs.fixup_offsets([unit, bs.make_eos_unit()],
                                             prev=enc._chain.prev), p, mv)
    return out


def phase_gather_decode(card):
    """smoke-1080p-gather-decode: both decoders on the card give the CPU
    decode's planes bit for bit; the gather render timed per picture."""
    from schroedinger_tpu_torch.decoder.core import _MV_FIELDS
    from schroedinger_tpu_torch.ops import obmc
    W, H = FULL
    vf = video_format(W, H)
    frame = make_frames(1, W, H)[0]
    for name, (stream, p, mv) in gather_streams(vf, frame).items():
        outs = {}
        for label, dec in (("pipelined", api.Decoder()),
                           ("per-picture", StreamDecoder()),
                           ("cpu", StreamDecoder(device="cpu"))):
            t0 = time.perf_counter()
            out = dec.decode_stream(stream)
            torch.cuda.synchronize()
            if len(out) != 2 or dec.errors:
                raise AssertionError(f"phase21 {name} {label}: {len(out)} "
                                     f"frames, errors {dec.errors}")
            outs[label] = (out, time.perf_counter() - t0)
        cpu = outs["cpu"][0]
        for label in ("pipelined", "per-picture"):
            if not all(np.array_equal(a, b) for fa, fb in zip(
                    outs[label][0], cpu) for a, b in zip(fa, fb)):
                raise AssertionError(f"phase21 {name}: {label} decode on the"
                                     " card differs from the CPU decode")
        if np.array_equal(cpu[1][0], cpu[0][0]):
            raise AssertionError(f"phase21 {name}: the P picture repeats "
                                 "the I picture")
        # the gather render alone, as the decoder calls it, on the card
        ups = tuple(obmc.make_halfpel(obmc.upsample_plane(
            torch.tensor(pl, device=CARD))) for pl in cpu[0])
        mvt = {k: torch.tensor(mv[k], device=CARD) for k in _MV_FIELDS}
        body = obmc.make_render_body(p, 1, use_patches=False)
        ms = time_ms(lambda: body(mvt, ups, None), (), iters=5, warmups=1)
        print(f"phase21 smoke-1080p-gather-decode ({name}): pipelined and "
              f"per-picture decoders on the card == CPU decode; decode "
              f"{outs['pipelined'][1]:.3f} s pipelined, "
              f"{outs['per-picture'][1]:.3f} s per-picture, "
              f"{outs['cpu'][1]:.3f} s CPU for 2 frames; gather render "
              f"{ms:.3f} ms per picture on the card [{card}]", flush=True)


def phase_prefilter_metrics(card):
    """smoke-1080p-prefilter-metrics; returns its launches."""
    from schroedinger_tpu_torch.ops.filters import apply_prefilter
    from schroedinger_tpu_torch.ops.metrics import ssim_frame
    W, H = FULL
    frames = make_frames(5, W, H)
    launches = 0
    for filtering in ("gaussian", "adaptive_gaussian", "lowpass",
                      "center_weighted_median"):
        card_f = apply_prefilter(frames[0], filtering, 5.0, CARD)
        cpu_f = [apply_prefilter(f, filtering, 5.0) for f in frames]
        if not all(np.array_equal(a, b) for a, b in zip(card_f, cpu_f[0])):
            raise AssertionError(f"phase22 {filtering}: the prefilter on the"
                                 " card differs from the CPU's")
        cfg = EncoderConfig(filtering=filtering, enable_psnr=True,
                            enable_ssim=True)
        stream, n, gop, _ = run_rate_phase(
            card, "phase22", f"smoke-1080p-prefilter-metrics ({filtering})",
            lambda: api.Encoder(video_format(W, H), cfg), frames, warm=1)
        out = StreamDecoder().decode_stream(stream)
        worst_ssim = 0.0
        for rec in gop.stats.frames:
            num = rec["frame"]
            src = cpu_f[num][0].astype(np.float64)
            got = out[num][0].astype(np.float64)
            mse = np.mean((got - src) ** 2)
            want = round(99.0 if mse == 0
                         else 10 * np.log10(255.0 ** 2 / mse), 3)
            if rec["psnr"] != want:
                raise AssertionError(f"phase22 {filtering} frame {num}: "
                                     f"PSNR {rec['psnr']} on the card, "
                                     f"{want} from the CPU")
            d = abs(rec["ssim"] - ssim_frame(src, got))
            worst_ssim = max(worst_ssim, d)
            if d > 1e-4:
                raise AssertionError(f"phase22 {filtering} frame {num}: "
                                     f"SSIM {rec['ssim']} differs by {d}")
        print(f"phase22 {filtering}: prefilter on the card == CPU; per-frame"
              f" PSNR {[r['psnr'] for r in gop.stats.frames]} == the CPU's "
              f"to 3 decimals, SSIM {[r['ssim'] for r in gop.stats.frames]}"
              f" within {worst_ssim:.2e} of the CPU's", flush=True)
        launches += n
    return launches


def phases_settings(card):
    """Phases 19-22; returns their launch counts and the largest |diff| of
    the kernel against its plain version at their launch shapes."""
    done = {}
    out = {}
    out["launches_block_geometry"], w1 = phase_block_geometry(card, done)
    out["launches_estimation"], w2 = phase_estimation(card, done)
    phase_gather_decode(card)
    out["launches_prefilter_metrics"] = phase_prefilter_metrics(card)
    out["setting_shapes"] = [
        dict(cur=list(k[0]), bs_y=k[1], bs_x=k[2], rad=k[3], scale=k[4], **v)
        for k, v in sorted(done.items())]
    return out, max(w1, w2)


# ---- interlaced coding, the streaming decoder, telemetry, tools (23-26) --

# (width, height, frames) of phases 23 and 24: 1080i25 and the SD field
# cell of tools/bench_breadth.py
FIELD_HD = (1920, 1080, 13)
FIELD_SD = (720, 576, 25)
FIELD_SMALL = (128, 64)  # the card-vs-CPU size of phase 25


def interlaced_format(w, h, tff=True):
    """video_format(w, h) marked interlaced in the `tff` field order; a
    config with interlaced_coding codes it as field pictures."""
    return dataclasses.replace(video_format(w, h), interlaced=True,
                               top_field_first=tff)


def sd_frames(n, w, h, seed=0):
    """tools/bench_breadth.py's interlaced SD content: a smooth luma
    pattern panned 2 px a frame plus N(0, 4) noise, flat chroma."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = 128 + 64 * np.sin(xx / 23.0) * np.cos(yy / 17.0)
    u = np.full((h // 2, w // 2), 120, np.uint8)
    v = np.full((h // 2, w // 2), 135, np.uint8)
    return [((np.roll(base, 2 * i, axis=1) + rng.normal(0, 4, (h, w)))
             .clip(0, 255).astype(np.uint8), u, v) for i in range(n)]


def stream_pieces(stream, seed, lo=1024, hi=65536):
    """The stream cut into seeded random pieces of lo..hi bytes."""
    rng = np.random.default_rng(seed)
    i = 0
    while i < len(stream):
        n = int(rng.integers(lo, hi + 1))
        yield stream[i:i + n]
        i += n


def streaming_decode(stream, seed, device=None):
    """StreamingDecoder over the stream pushed in seeded pieces of 1-64
    KiB, pulling as it goes.  Returns (decoder, [(number, planes)],
    seconds)."""
    dec = StreamingDecoder(device=device)
    out = []
    t0 = time.perf_counter()
    for piece in stream_pieces(stream, seed):
        dec.push(piece)
        out += dec.pull_all()
    out += dec.pull_all()
    return dec, out, time.perf_counter() - t0


def same_planes(a, b):
    return all(np.array_equal(x, y) for x, y in zip(a, b))


def check_fields(stream, frames, made, card, tag, tff, seed):
    """The field stream on the card through api.Decoder (woven frames),
    StreamDecoder (fields) and the StreamingDecoder (fields pushed in
    seeded pieces of 1-64 KiB): every field number once, equal fields in
    both, the woven frames equal to the weave of the fields, every
    reference field equal to the encoder's reconstruction, no MD5
    failure or picture error, luma PSNR >= 30 dB on every frame.
    Returns (PSNRs, api.Decoder frames/s, StreamDecoder frames/s)."""
    n = len(frames)
    t0 = time.perf_counter()
    dec = api.Decoder()
    woven = dec.decode_stream(stream)
    torch.cuda.synchronize()
    t_api = time.perf_counter() - t0
    base = StreamDecoder()
    t0 = time.perf_counter()
    fields = base.decode_stream(stream)
    torch.cuda.synchronize()
    t_base = time.perf_counter() - t0
    sdec, pairs, _ = streaming_decode(stream, seed)
    if len(fields) != 2 * n or sorted(k for k, _ in pairs) != list(
            range(2 * n)):
        raise AssertionError(f"{tag}: {len(fields)} fields from "
                             f"StreamDecoder, numbers "
                             f"{[k for k, _ in pairs]} from the "
                             "StreamingDecoder")
    for d in (base, sdec):
        if d.md5_failures or d.errors:
            raise AssertionError(f"{tag}: md5_failures={d.md5_failures} "
                                 f"errors={d.errors}")
    for num, planes in pairs:
        if not same_planes(planes, fields[num]):
            raise AssertionError(f"{tag}: field {num}: the StreamingDecoder "
                                 "differs from StreamDecoder")
    for k in range(n):
        if not same_planes(woven[k], weave_fields(
                fields[2 * k], fields[2 * k + 1], tff=tff)):
            raise AssertionError(f"{tag}: frame {k}: api.Decoder's weave "
                                 "differs from the fields")
    for num, rf in made.items():
        if not all(torch.equal(torch.from_numpy(x), y.cpu())
                   for x, y in zip(fields[num], rf.planes)):
            raise AssertionError(f"{tag}: reference field {num} decodes "
                                 "to other planes than the encoder's "
                                 "reconstruction")
    vals = check_frames(woven, frames, dec, tag)
    return vals, n / t_api, n / t_base


def run_field_phase(card, tag, name, make, frames, done, seed, bitrate,
                    warm):
    """Encode `frames` as fields with the api.Encoder `make()` gives
    (after a warm-up of the first `warm`), with the kernel's launches
    counted and its launch shapes recorded, and hold the stream to
    check_fields, the launches the picture mix implies, every full
    subgroup's B fields batched and the bytes within 0.1x-4x of the
    pro-rata share; then the kernel to its plain version at every new
    launch shape.  Returns (stream, launches, max |diff|, encoder)."""
    make().encode_stream(frames[:warm])                     # warm-up
    torch.cuda.synchronize()
    enc = make()
    gop = enc._gop
    seen = record_batches(gop)
    made = record_refs(gop)
    with record_searches() as searches:
        pr.LAUNCHES = 0
        t0 = time.perf_counter()
        stream = enc.encode_stream(frames)
        torch.cuda.synchronize()
        t_enc = time.perf_counter() - t0
        launches = pr.LAUNCHES
    expect = expected_searches(stream, seen, LAUNCHES_PER_REF)
    if launches != expect:
        raise AssertionError(f"{tag}: {launches} launches, expected "
                             f"{expect}")
    full = gop.subgroup_length - 1
    if any(len(s[0]) == full and not s[1] for s in seen):
        raise AssertionError(f"{tag}: a full subgroup of B fields went "
                             f"per picture: {seen}")
    share = len(frames) * bitrate / 25 / 8
    if not 0.1 * share <= len(stream) <= 4 * share:
        raise AssertionError(f"{tag}: {len(stream)} bytes outside 0.1x-4x "
                             f"of the pro-rata {share:.0f}")
    vals, fps_api, fps_base = check_fields(
        stream, frames, made, card, tag, gop.vf.top_field_first, seed)
    n_i, n_p, n_b = picture_mix(stream)
    print(f"{tag} {name} x{len(frames)} frames ({2 * len(frames)} fields: "
          f"{n_i} I, {n_p} P, {n_b} B, {sum(1 for s in seen if s[1])} "
          f"batches): me_search launches {launches} (expected {expect}); "
          f"{len(stream)} bytes ({len(stream) / share:.3f} of the pro-rata "
          f"{share:.0f}), luma PSNR mean {np.mean(vals):.3f} min "
          f"{min(vals):.3f} dB, {len(made)} reference fields equal to the "
          f"encoder's; encode {len(frames) / t_enc:.3f} frames/s, decode "
          f"{fps_api:.3f} frames/s api.Decoder, {fps_base:.3f} "
          f"StreamDecoder [{card}]", flush=True)
    worst = hold_shapes(card, tag, searches, done)
    return stream, launches, worst, enc


def phase_1080i(card, done):
    """smoke-1080i25-biref-cbr: returns (stream, frames, launches, max
    |diff|)."""
    W, H, N = FIELD_HD
    frames = make_frames(N, W, H)

    def make():
        return api.Encoder(interlaced_format(W, H), EncoderConfig(
            rate_control="constant_bitrate", bitrate=8_000_000,
            interlaced_coding=1, mv_precision=2))
    stream, launches, worst, _ = run_field_phase(
        card, "phase23", "smoke-1080i25-biref-cbr", make, frames, done,
        seed=23, bitrate=8_000_000, warm=3)
    return stream, frames, launches, worst


def phase_576i(card, done):
    """smoke-576i25-sd-cbr, then 4 frames bottom field first with MD5;
    returns (the MD5 stream, launches, max |diff|)."""
    W, H, N = FIELD_SD
    frames = sd_frames(N, W, H)

    def make(tff=True, **kw):
        return api.Encoder(interlaced_format(W, H, tff), EncoderConfig(
            rate_control="constant_bitrate", bitrate=4_000_000,
            interlaced_coding=True, mv_precision=2, **kw))
    _, launches, worst, _ = run_field_phase(
        card, "phase24", "smoke-576i25-sd-cbr", make, frames, done, seed=24,
        bitrate=4_000_000, warm=2)
    md5_stream = make(tff=False, enable_md5=1).encode_stream(frames[:4])
    dec = api.Decoder()
    out = dec.decode_stream(md5_stream)
    sdec, pairs, _ = streaming_decode(md5_stream, seed=240)
    check_frames(out, frames[:4], dec, "phase24 bottom field first")
    if len(pairs) != 8 or sdec.md5_failures or sdec.errors:
        raise AssertionError(f"phase24 bottom field first: {len(pairs)} "
                             f"fields, md5_failures={sdec.md5_failures} "
                             f"errors={sdec.errors}")
    print(f"phase24 576i25 x4 bottom field first with MD5: {len(md5_stream)}"
          f" bytes, md5_failures == [] in api.Decoder and the "
          f"StreamingDecoder [{card}]", flush=True)
    return md5_stream, launches, worst


def phase_interlaced_card_vs_cpu(card):
    """128x64 field streams (biref TM5 CBR top field first, backref
    constant quality bottom field first) on the card equal to the CPU
    encode byte for byte; a VC-2 profile refuses interlaced coding."""
    W, H = FIELD_SMALL
    small = make_frames(4, W, H)
    runs = {"biref TM5 CBR, top field first": (dict(
                rate_control="constant_bitrate", bitrate=500_000,
                interlaced_coding=1, mv_precision=2), True),
            "backref constant quality, bottom field first": (dict(
                gop_structure="backref", interlaced_coding=1), False)}
    for name, (kw, tff) in runs.items():
        streams = [api.Encoder(interlaced_format(W, H, tff),
                               EncoderConfig(**kw), device=dev
                               ).encode_stream(small)
                   for dev in (None, "cpu")]
        if streams[0] != streams[1]:
            raise AssertionError(f"phase25 {name}: the card's stream "
                                 f"({len(streams[0])} bytes) differs from "
                                 f"the CPU's ({len(streams[1])})")
        dec = api.Decoder()
        vals = check_frames(dec.decode_stream(streams[0]), small, dec,
                             f"phase25 {name}")
        print(f"phase25 {W}x{H} x4 {name}: card == CPU, {len(streams[0])} "
              f"bytes, luma PSNR mean {np.mean(vals):.3f} dB [{card}]",
              flush=True)
    try:
        api.Encoder(video_format(W, H), EncoderConfig(
            rate_control="low_delay", interlaced_coding=True))
    except ValueError as e:
        print(f"phase25 VC-2 low delay with interlaced_coding: ValueError "
              f"({e})", flush=True)
    else:
        raise AssertionError("phase25: VC-2 low delay took interlaced "
                             "coding")


def run_tool(name, *args):
    """`python -m schroedinger_tpu_torch.tools.<name> args`: its stdout."""
    env = dict(os.environ, PYTHONPATH=os.path.dirname(
        os.path.abspath(__file__)))
    return subprocess.run([sys.executable, "-m",
                           f"schroedinger_tpu_torch.tools.{name}", *args],
                          check=True, env=env, timeout=300,
                          capture_output=True, text=True).stdout


def phase_telemetry_tools(card, stream, frames, md5_stream):
    """Telemetry decodes of phase 23's stream on the card (StreamDecoder
    and the CLI's `decode --telemetry`) equal to a CPU telemetry decode;
    a telemetry decode of an MD5 stream holds its MD5s; the three stream
    tools on phase 23's stream (the cut stream decodes); the
    StreamingDecoder's frames/s beside the pipelined decoder's."""
    n = len(frames)
    t0 = time.perf_counter()
    dec = StreamDecoder(telemetry=True)
    got = dec.decode_stream(stream)
    torch.cuda.synchronize()
    t_tel = time.perf_counter() - t0
    cpu = StreamDecoder(telemetry=True, device="cpu")
    want = cpu.decode_stream(stream)
    clean = StreamDecoder().decode_stream(stream)
    if not len(got) == len(want) == 2 * n or dec.errors or cpu.errors:
        raise AssertionError(f"phase26: {len(got)} / {len(want)} fields, "
                             f"errors {dec.errors} {cpu.errors}")
    marked = 0
    for num, (a, b, c) in enumerate(zip(got, want, clean)):
        if not same_planes(a, b):
            raise AssertionError(f"phase26: telemetry field {num}: card "
                                 "differs from the CPU")
        if not same_planes(a[1:], c[1:]):
            raise AssertionError(f"phase26: telemetry field {num}: chroma "
                                 "touched")
        marked += not np.array_equal(a[0], c[0])
    n_i = picture_mix(stream)[0]
    if marked != 2 * n - n_i:
        raise AssertionError(f"phase26: {marked} fields overlaid, expected "
                             f"the {2 * n - n_i} inter fields")
    md5_dec = StreamDecoder(telemetry=True)
    md5_out = md5_dec.decode_stream(md5_stream)
    if md5_dec.md5_failures or md5_dec.errors or len(md5_out) != 8:
        raise AssertionError(f"phase26: telemetry on the MD5 stream: "
                             f"md5_failures={md5_dec.md5_failures} "
                             f"errors={md5_dec.errors}")
    with tempfile.TemporaryDirectory() as tmp:
        drc, dst, cut = (os.path.join(tmp, f) for f in ("in.drc", "out.y4m",
                                                        "cut.drc"))
        with open(drc, "wb") as f:
            f.write(stream)
        t0 = time.perf_counter()
        run_tool("schro_tpu", "decode", drc, dst, "--telemetry")
        t_cli = time.perf_counter() - t0
        _, cli, _ = y4m.read_y4m(dst)
        cli = list(cli)
        inspect = run_tool("dirac_inspect", drc, "-v")
        gop_lines = run_tool("dump_gop", drc).splitlines()
        cut_line = run_tool("drc_cut", drc, cut, "--start", "0",
                            "--count", "9").strip()
        cut_stream = open(cut, "rb").read()
    if len(cli) != n or not all(same_planes(cli[k], weave_fields(
            got[2 * k], got[2 * k + 1], tff=dec.vf.top_field_first))
            for k in range(n)):
        raise AssertionError("phase26: the CLI's telemetry y4m differs from "
                             "the woven telemetry fields")
    if inspect.count("picture(") != 2 * n or len(gop_lines) != 2 * n:
        raise AssertionError(f"phase26: dirac_inspect / dump_gop list "
                             f"{inspect.count('picture(')} / "
                             f"{len(gop_lines)} pictures")
    # the cut keeps the first 9 pictures in coded order
    kept = sorted(num for num, _, _ in picture_kinds(stream)[:9])
    cut_dec = StreamDecoder()
    cut_fields = cut_dec.decode_stream(cut_stream)
    cut_frames = api.Decoder().decode_stream(cut_stream)
    if (len(cut_fields) != 9 or cut_dec.errors
            or not all(same_planes(a, clean[num])
                       for a, num in zip(cut_fields, kept))
            or len(cut_frames) != 4):
        raise AssertionError(f"phase26: the cut stream: {len(cut_fields)} "
                             f"fields, errors {cut_dec.errors}, "
                             f"{len(cut_frames)} frames")
    # the StreamingDecoder beside the pipelined decoder, in turns
    runs = {"pipelined": [], "streaming": []}
    for name in ("pipelined", "streaming", "streaming", "pipelined"):
        if name == "pipelined":
            t0 = time.perf_counter()
            api.Decoder().decode_stream(stream)
            torch.cuda.synchronize()
            runs[name].append(time.perf_counter() - t0)
        else:
            runs[name].append(streaming_decode(stream, seed=26)[2])
    fps = {k: np.mean([n / t for t in v]) for k, v in runs.items()}
    print(f"phase26 telemetry decode of phase 23's stream on the card == "
          f"the CPU's ({marked} inter fields overlaid, {t_tel:.3f} s on the "
          f"card), the CLI's `decode --telemetry` == the woven fields "
          f"({t_cli:.3f} s with the process); MD5 stream with telemetry: "
          f"md5_failures == []; dirac_inspect {len(inspect.splitlines())} "
          f"lines, dump_gop {len(gop_lines)} pictures, drc_cut '{cut_line}'"
          f": fields {kept} decode equal to the full decode's [{card}]",
          flush=True)
    print(f"phase26 decode of the 1080i25 stream ({2 * n} fields): "
          f"StreamingDecoder (pieces of 1-64 KiB) {fps['streaming']:.3f} "
          f"frames/s, api.Decoder (pipelined) {fps['pipelined']:.3f} "
          f"frames/s [{card}]", flush=True)


def phases_interlaced(card):
    """Phases 23-26; returns their launch counts, the launch shapes held
    and the largest |diff| of the kernel against its plain version."""
    done = {}
    out = {}
    stream, frames, out["launches_1080i"], w1 = phase_1080i(card, done)
    md5_stream, out["launches_576i"], w2 = phase_576i(card, done)
    phase_interlaced_card_vs_cpu(card)
    phase_telemetry_tools(card, stream, frames, md5_stream)
    out["interlaced_shapes"] = [
        dict(cur=list(k[0]), bs_y=k[1], bs_x=k[2], rad=k[3], scale=k[4], **v)
        for k, v in sorted(done.items())]
    return out, max(w1, w2)


# ---- the multi-device paths on torch.distributed (27-31) ----------------

WORLD = 4                        # ranks of phases 27 and 28, on cuda:0
FRAMES_IN_GOP_STAGES = (1, 5, 6)  # graft_entry stages of phase 27
HOLD_STAGE = 6                   # the stage whose launch shapes are held
# phase 28: the wavelet frame (rows, cols) at depth 3 and its wavelets,
# the upsampled plane, the rendered picture (W, H, blen, bsep)
TILES_WAVE = ((1088, 1920), 3, (Wavelet.LE_GALL_5_3,
                                Wavelet.DESLAURIERS_DUBUC_9_7,
                                Wavelet.FIDELITY))
TILES_PLANE = (1080, 1920)
TILES_PICTURE = (1920, 1080, 24, 16)
TILES_REPEAT = 5                 # timed calls of each form
SHARD_SIZE = "1080p"             # the worker's clip of phases 29 and 30


def phase_frames_in_gop(card):
    """Graft-entry stages 1, 5 and 6 over a world of WORLD ranks on the
    card (gloo: they share it), then kernel #1 held to its plain version
    at every launch shape of one step of stage 6 (2160p, 24/16 blocks).
    Returns (launches, the shapes held, max |diff|)."""
    t0 = time.perf_counter()
    reports = graft_entry.dryrun_multichip(WORLD,
                                           stages=FRAMES_IN_GOP_STAGES)
    t_world = time.perf_counter() - t0
    launches = 0
    for stage in FRAMES_IN_GOP_STAGES:
        r = reports[stage]
        W, H, blen, bsep = graft_entry.FRAMES_IN_GOP[stage]
        # 7 searches a reference at full size; the 64x64 pyramid has fewer
        # levels, so there every rank must match the batch
        want = 2 * LAUNCHES_PER_REF if W >= 1920 else r["batch_launches"]
        if set(r["launches"]) != {want} or r["batch_launches"] != want:
            raise AssertionError(f"phase27 stage {stage}: kernel #1 "
                                 f"launched {r['launches']} times per rank "
                                 f"and {r['batch_launches']} for the batch, "
                                 f"expected {want} each")
        launches += sum(r["launches"]) + r["batch_launches"]
        print(f"phase27 stage {stage} {W}x{H} ({blen}/{bsep} blocks): every "
              f"rank's B picture == rank 0's batched step; kernel #1 "
              f"launches per rank {r['launches']}, batch "
              f"{r['batch_launches']}; device ms (CUDA events, with the "
              f"fetch) of rank 0's batched step of {WORLD} "
              f"{r['batch_ms']:.3f}, of one rank's N = 1 step "
              f"{r['single_ms']:.3f} [{card}]", flush=True)
    frames, step = graft_entry.frames_in_gop_step(HOLD_STAGE, 1,
                                                  torch.device(CARD))
    done = {}
    with record_searches() as searches:
        step([frames[1]])
    worst = hold_shapes(card, "phase27", searches, done)
    shapes = [dict(cur=list(k[0]), bs_y=k[1], bs_x=k[2], rad=k[3],
                   scale=k[4], **v) for k, v in sorted(done.items())]
    print(f"phase27 frames-within-GOP over {WORLD} ranks: {t_world:.1f} s "
          f"with the world's start [{card}]", flush=True)
    return launches, shapes, worst


def phase_tiles(card):
    """The row-sharded wavelet (forward and inverse), upsample and banded
    render at 1080p over WORLD ranks, each equal to the unsharded op on
    the card, both forms timed."""
    (wave_hw, depth, wavelets), plane_hw = TILES_WAVE, TILES_PLANE
    t0 = time.perf_counter()
    times = group.run_world(graft_entry.tiles_check, WORLD, wave_hw, depth,
                            wavelets, plane_hw, TILES_PICTURE,
                            TILES_REPEAT)[0]
    t_world = time.perf_counter() - t0
    for op, (ms_sharded, ms_whole) in times.items():
        print(f"phase28 {op}: {WORLD} ranks == the unsharded op; host ms a "
              f"call (synchronized, {TILES_REPEAT} calls): sharded "
              f"{ms_sharded:.3f}, "
              f"unsharded {ms_whole:.3f} on one rank [{card}]", flush=True)
    print(f"phase28 tiles: wavelet {wave_hw[0]}x{wave_hw[1]} int16 at depth "
          f"{depth}, upsample {plane_hw[0]}x{plane_hw[1]}, render "
          f"{TILES_PICTURE[0]}x{TILES_PICTURE[1]} luma; {t_world:.1f} s with "
          f"the world's start [{card}]", flush=True)


def chunk_bytes(stream, ranges):
    """Bytes of the picture units of each chunk range (in frames)."""
    out = [0] * len(ranges)
    for code, payload in bs.split_units(stream):
        if bs.is_picture(code):
            num = int.from_bytes(payload[:4], "big")
            k = next(i for i, (a, b) in enumerate(ranges) if a <= num < b)
            out[k] += 13 + len(payload)
    return out


def timed_encode(fn):
    """fn() timed on the host around a synchronise: (its result,
    seconds); encode_timed's form for an encode that is not one
    encoder's."""
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_gop_sharded(card):
    """smoke-1080p-gop-sharded: 48 frames of bench.py's pan + noise, two
    GOPs of 24, on two shard threads.  CONFIG with scene change off: the
    sharded stream == the serial one.  CONFIG_BENCH, exact=False: threads
    == sequential, decodes in order, luma PSNR >= 30 dB, each chunk's
    picture bytes within 0.1x-4x of its pro-rata share, kernel #1's
    launches as the pictures imply.  Returns (launches, the sequential
    exact=False stream)."""
    frames = mw.make_frames(SHARD_SIZE)
    vf = mw.make_encoder(SHARD_SIZE).vf
    n = len(frames)

    def exact():
        return GopEncoder(vf, **dict(CONFIG, enable_scene_change=False))
    serial, t_serial = timed_encode(lambda: exact().encode_stream(frames))
    sharded, t_sharded = timed_encode(
        lambda: gops.encode_gops_sharded(frames, exact, n_shards=2))
    if sharded != serial:
        raise AssertionError(f"phase29 CONFIG: the sharded stream "
                             f"({len(sharded)} bytes) differs from the "
                             f"serial one ({len(serial)})")
    print(f"phase29 CONFIG (backref, fixed quantisers, scene change off) "
          f"x{n}: two shard threads == serial, {len(serial)} bytes; encode "
          f"{n / t_sharded:.3f} frames/s sharded, {n / t_serial:.3f} serial "
          f"[{card}]", flush=True)

    seens = []

    def bench():
        enc = mw.make_encoder(SHARD_SIZE)
        seens.append(record_batches(enc))
        return enc
    # serial and sharded in turns; the count is set to 0 just before each
    # sharded encode and read just after
    runs = {"serial": [], "sharded": []}
    for name in ("serial", "sharded", "sharded", "serial"):
        if name == "serial":
            _, t = timed_encode(
                lambda: mw.make_encoder(SHARD_SIZE).encode_stream(frames))
        else:
            seens.clear()
            pr.LAUNCHES = 0
            threaded, t = timed_encode(lambda: gops.encode_gops_sharded(
                frames, bench, n_shards=2, exact=False))
            launches = pr.LAUNCHES
        runs[name].append(round(n / t, 3))
    sequential = gops.encode_gops_sharded(
        frames, lambda: mw.make_encoder(SHARD_SIZE), n_shards=2,
        sequential=True, exact=False)
    if threaded != sequential:
        raise AssertionError("phase29 CONFIG_BENCH: the threaded shards' "
                             "stream differs from the sequential one")
    want = expected_searches(
        threaded, [b for seen in seens for b in seen], LAUNCHES_PER_REF)
    if launches != want:
        raise AssertionError(f"phase29: {launches} launches of kernel #1, "
                             f"the pictures imply {want}")
    dec = api.Decoder()
    vals = check_frames(dec.decode_stream(threaded), frames, dec,
                         "phase29")
    enc = mw.make_encoder(SHARD_SIZE)
    ranges = gops.chunk_ranges(n, enc.gop_length, 2)
    shares = [(b - a) * enc.rc.bits_per_picture / 8 for a, b in ranges]
    sizes = chunk_bytes(threaded, ranges)
    if not all(0.1 * s <= b <= 4 * s for b, s in zip(sizes, shares)):
        raise AssertionError(f"phase29: chunk picture bytes {sizes} outside "
                             f"0.1x-4x of {shares}")
    n_i, n_p, n_b = picture_mix(threaded)
    print(f"phase29 smoke-{SHARD_SIZE}-gop-sharded (CONFIG_BENCH, exact="
          f"False) x{n}: {n_i} I, {n_p} P, {n_b} B; {len(threaded)} bytes, "
          f"chunks {sizes} of pro-rata {[round(s) for s in shares]}; luma "
          f"PSNR mean {np.mean(vals):.3f} min {min(vals):.3f} dB; threads =="
          f" sequential; kernel #1 launches {launches} over both threads; "
          f"encode frames/s in turns (serial, sharded, sharded, serial): "
          f"sharded {runs['sharded']}, serial {runs['serial']} [{card}]",
          flush=True)
    return launches, sequential


def first_differing_picture(a, b):
    """The picture number of the first picture unit in which two streams
    differ (in coded order), or None."""
    ua = [(c, p) for c, p in bs.split_units(a) if bs.is_picture(c)]
    ub = [(c, p) for c, p in bs.split_units(b) if bs.is_picture(c)]
    for (ca, pa), (cb, pb) in zip(ua, ub):
        if (ca, pa) != (cb, pb):
            return int.from_bytes(pa[:4], "big")
    return None


def phase_multiprocess(card, sequential):
    """smoke-1080p-multiprocess: two processes of the worker on the one
    card (gloo), CONFIG_BENCH: the merged streams equal each other and
    phase 29's sequential exact=False stream.  Returns the workers'
    launches."""
    t0 = time.perf_counter()
    streams, reports = graft_entry.multiprocess_encode(SHARD_SIZE,
                                                       torch.device(CARD))
    wall = time.perf_counter() - t0
    for s in streams:
        if s != sequential:
            raise AssertionError(
                f"phase30: a worker's merged stream ({len(s)} bytes) differs "
                f"from the sequential one ({len(sequential)}); first "
                f"differing picture {first_differing_picture(s, sequential)}")
    launches = sum(r["launches"] for r in reports)
    if any(r["launches"] == 0 for r in reports):
        raise AssertionError(f"phase30: a worker launched no kernel: "
                             f"{reports}")
    print(f"phase30 smoke-{SHARD_SIZE}-multiprocess: 2 worker processes on "
          f"{[r['device'] for r in reports]}, merged {len(streams[0])} bytes "
          f"on both == phase 29's sequential stream; kernel #1 launches "
          f"{[r['launches'] for r in reports]}; {wall:.1f} s with the "
          f"processes' start [{card}]", flush=True)
    return launches


def phase_entry(card):
    """graft_entry.entry(): the CIF low-delay analysis on the card equal to
    the CPU's."""
    fn, args = graft_entry.entry()
    got = fn(*args)
    fn_cpu, args_cpu = graft_entry.entry(device="cpu")
    want = fn_cpu(*args_cpu)

    def flat(outs):
        return list(outs[:3]) + [a for agg in outs[3:] for a in agg]
    for k, (g, w) in enumerate(zip(flat(got), flat(want))):
        if not torch.equal(g.cpu(), w):
            raise AssertionError(f"phase31 entry(): output {k} on the card "
                                 "differs from the CPU's")
    print(f"phase31 entry(): the CIF low-delay analysis on "
          f"{args[0].device} == the CPU's ({len(flat(got))} outputs) "
          f"[{card}]", flush=True)


def phases_distributed(card):
    """Phases 27-31; returns their launch counts, the launch shapes held
    and the largest |diff| of the kernel against its plain version."""
    out = {}
    out["launches_frames_in_gop"], out["frames_in_gop_shapes"], worst = \
        phase_frames_in_gop(card)
    phase_tiles(card)
    out["launches_gop_sharded"], sequential = phase_gop_sharded(card)
    out["launches_multiprocess"] = phase_multiprocess(card, sequential)
    phase_entry(card)
    return out, worst


# ---- the bench entry points (32-35) -------------------------------------

UHD = (3840, 2160)               # the picture size of phase 33
DEEP_HD = (1280, 720)            # the picture size of phase 34
LEG_FRAMES = {"zoomrot": 12, "scenecut": 16, "4k-biref": 6,
              "4k-backref": 4, "720p10-422-intra": 4, "rd": 96}
# PROFILE.md §6's two lowest rates, on the slope of the RD curve: over
# fewer frames the I picture's bytes overrun a low rate's share and the
# quality sits at the clip's noise floor at any rate
RD_RATES = (500_000, 1_000_000)


def run_bench_leg(card, tag, name, make, frames, bitrate, warm):
    """One leg's encode on the card through the bench's own functions:
    a warm-up of the first `warm` frames, the count set to 0, the timed
    encode, the count read, then the leg's gates (bench.quality: both
    decoders, every reference picture, PSNR, the bytes, the searches the
    picture mix implies, each one a launch).  Returns (launches, report,
    the encode)."""
    dev = torch.device(CARD)
    make().encode_stream(frames[:warm])                     # warm-up
    torch.cuda.synchronize()
    pr.LAUNCHES = 0
    run = bench.timed_encode(make, frames, dev, warm=0, tag=tag)
    launches = pr.LAUNCHES
    rep = bench.quality(run, frames, tag, bitrate)
    if launches != rep["searches"] or launches == 0:
        raise AssertionError(f"{tag}: {launches} launches of kernel #1 for "
                             f"{rep['searches']} searches")
    print(f"{tag} {name} x{len(frames)}: {rep['mix']} ({rep['batches']} "
          f"batches); me_search launches {launches} ({rep['searches']} "
          f"searches the mix implies, {rep['searches_per_reference']} a "
          f"reference); {rep['bytes']} bytes ({rep['bytes_vs_pro_rata']} of "
          f"the pro-rata share), luma PSNR mean {rep['psnr_db']:.3f} min "
          f"{rep['psnr_min_db']:.3f} dB, {rep['references_checked']} "
          f"reference pictures equal to the encoder's; encode "
          f"{run.fps:.3f} frames/s, decode {rep['decode_fps_pipelined']:.3f} "
          f"frames/s pipelined, {rep['decode_fps_per_picture']:.3f} "
          f"StreamDecoder [{card}]", flush=True)
    return launches, rep, run


def bench_encoder(vf, **kw):
    return lambda: GopEncoder(vf, device=CARD, **dict(CONFIG_BENCH, **kw))


def phase_content_legs(card):
    """smoke-1080p-zoomrot and smoke-1080p-scenecut (the cut at frame 11,
    the third picture of its subgroup); returns their launches."""
    W, H = FULL
    vf = video_format(W, H)
    out = {}
    frames = bench.make_frames_zoomrot(LEG_FRAMES["zoomrot"], width=W,
                                       height=H)
    out["launches_zoomrot"], _, _ = run_bench_leg(
        card, "phase32", "smoke-1080p-zoomrot", bench_encoder(vf), frames,
        CONFIG_BENCH["bitrate"], warm=6)
    frames = bench.make_frames_scenecut(LEG_FRAMES["scenecut"], width=W,
                                        height=H)
    out["launches_scenecut"], _, run = run_bench_leg(
        card, "phase32", "smoke-1080p-scenecut", bench_encoder(vf), frames,
        CONFIG_BENCH["bitrate"], warm=6)
    kind = {n: ("I" if r == 0 else "P" if ref else "B")
            for n, r, ref in picture_kinds(run.stream)}
    print(f"phase32 smoke-1080p-scenecut: the cut at frame 11 became "
          f"{kind[11]}; B pictures coded one at a time "
          f"{bench.per_picture_b(run)}; coded order "
          f"{[(n, kind[n]) for n, _, _ in picture_kinds(run.stream)]} "
          f"[{card}]", flush=True)
    if kind[11] != "I":
        raise AssertionError(f"phase32 scenecut: the cut at frame 11 became "
                             f"{kind[11]}, not an I picture")
    return out


def phase_uhd_legs(card):
    """smoke-2160p-biref and smoke-2160p-backref (bench_4k's legs, 24
    Mbit/s, each with both decoders), then kernel #1 held to its plain
    version at every launch shape of the biref encode (a 2160p reference
    at N = 1 and a batch of three B pictures at N = 3), each timed by
    CUDA-graph replay beside its bound.  Returns (launches, the shapes
    held, max |diff|)."""
    W, H = UHD
    vf = video_format(W, H)
    out = {}
    common = dict(gop_length=24, mv_precision=2, bitrate=bench_4k.BITRATE,
                  fps=25)
    frames = bench_4k.make_frames(LEG_FRAMES["4k-biref"], W, H)
    with record_searches() as searches:
        out["launches_4k_biref"], _, _ = run_bench_leg(
            card, "phase33", "smoke-2160p-biref", lambda: GopEncoder(
                vf, device=CARD, gop_structure="biref", **common), frames,
            bench_4k.BITRATE, warm=2)
    out["launches_4k_backref"], _, _ = run_bench_leg(
        card, "phase33", "smoke-2160p-backref", lambda: GopEncoder(
            vf, device=CARD, **common), frames[:LEG_FRAMES["4k-backref"]],
        bench_4k.BITRATE, warm=2)
    done = {}
    worst = hold_shapes(card, "phase33", searches, done)
    if {k[0][0] for k in done if len(k[0]) == 3} != {1, 3}:
        raise AssertionError(f"phase33: the 2160p launches held are "
                             f"{sorted(done)}, not N = 1 and N = 3")
    out["uhd_shapes"] = [dict(cur=list(k[0]), bs_y=k[1], bs_x=k[2],
                              rad=k[3], scale=k[4], **v)
                         for k, v in sorted(done.items())]
    for n in (1, 3):
        ms = sum(v["ms"] for k, v in done.items() if k[0][0] == n)
        b_ms = sum(v["bound_ms"] for k, v in done.items() if k[0][0] == n)
        print(f"phase33 me_search, the launches of one 2160p reference at "
              f"N = {n}: {ms:.4f} ms on the device, bound {b_ms:.5f} ms "
              f"[{card}]", flush=True)
    return out, worst


def phase_deep_intra(card):
    """smoke-720p10-422-intra: bench_breadth's 10-bit 4:2:2 intra leg."""
    rep = bench_breadth.deep_intra(LEG_FRAMES["720p10-422-intra"], DEEP_HD,
                                   CARD)
    print(f"phase34 smoke-720p10-422-intra x{rep['frames']}: "
          f"{rep['bytes']} bytes, luma PSNR mean {rep['psnr_db']:.3f} min "
          f"{rep['psnr_min_db']:.3f} dB at peak 1023, max |error| "
          f"{rep['max_abs_err']}, both decoders equal; encode "
          f"{rep['fps']:.3f} frames/s, decode "
          f"{rep['decode_fps_pipelined']:.3f} frames/s pipelined [{card}]",
          flush=True)


def phase_rd(card):
    """smoke-1080p-rd: bench_rd's sweep at two rates on the slope of the
    curve, each stream held to the leg's gates; the higher rate must code
    more bytes less the padding units (TM5 CBR pads a stream up to its
    rate) and a higher mean luma PSNR.  Returns its launches."""
    W, H = FULL
    args = argparse.Namespace(size=(W, H), frames=LEG_FRAMES["rd"],
                              bitrates=list(RD_RATES), device=CARD)
    pr.LAUNCHES = 0
    rep = bench_rd.leg_rd(args)
    launches = pr.LAUNCHES
    lo, hi = rep["points"]
    coded = [p["bytes"] - p["padding_bytes"] for p in (lo, hi)]
    print(f"phase35 smoke-1080p-rd x{rep['frames']} (zoomrot, noise 1): "
          + "; ".join(f"{p['bitrate']} bit/s {p['bytes']} bytes "
                      f"({p['padding_bytes']} of padding) "
                      f"{p['psnr_db']:.3f} dB {p['fps']:.3f} frames/s"
                      for p in rep["points"])
          + f"; me_search launches {launches} [{card}]", flush=True)
    if coded[1] <= coded[0] or hi["psnr_db"] <= lo["psnr_db"]:
        raise AssertionError(
            f"phase35: {hi['bitrate']} bit/s coded {coded[1]} bytes less "
            f"padding at {hi['psnr_db']:.3f} dB, {lo['bitrate']} bit/s "
            f"{coded[0]} at {lo['psnr_db']:.3f} dB: the quality does not "
            "follow the rate")
    return launches


def phases_bench(card):
    """Phases 32-35; returns their launch counts, the 2160p launch shapes
    held and the largest |diff| of the kernel against its plain
    version."""
    out = phase_content_legs(card)
    uhd, worst = phase_uhd_legs(card)
    out.update(uhd)
    phase_deep_intra(card)
    out["launches_rd"] = phase_rd(card)
    return out, worst


def main() -> int:
    card = gpu_line()
    print(f"phase0 gpu: {card}", flush=True)
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: this smoke "
                           "run needs an NVIDIA GPU")
    print(f"phase0 torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    t_start = time.perf_counter()
    secs = pr.build()
    print(f"phase1 built {pr.LIBRARY} in {secs:.2f} s", flush=True)
    for line in pr.BUILD_LOG.splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            print(f"phase1 ptxas: {line.strip()}", flush=True)
    print(f"phase1 built {coder.build()}", flush=True)

    entry = phase_kernel(card)
    entry.update(phase_batch_kernel(card))
    entry["launches_backref"] = phase_backref(card)
    probe_entry = phase_probe(card)
    entry["launches_flagship"] = phase_flagship(card)
    phase_small_card_vs_cpu(card)
    # this slice's main path: bench.py's headline encode; each count is
    # set to 0 just before its path and read just after
    entry.update(phase_bench_headline(card))
    entry["launches_api_default"] = phase_api_default(card)
    # the VC-2 profiles and no-arith long GOP; the count is set to 0 just
    # before the no-arith path and read just after
    entry["launches_bench_noarith"] = phases_vc2(card)
    # the long-GOP rate controls; each count is set to 0 just before its
    # path and read just after
    entry.update(phases_rate(card))
    t_rate = time.perf_counter()
    # the long-GOP encoder's remaining settings; each count is set to 0
    # just before its path and read just after
    settings, worst = phases_settings(card)
    entry.update(settings)
    entry["max_abs_err"] = max(entry["max_abs_err"], worst)
    t_settings = time.perf_counter()
    # interlaced coding at 1080i25 and 576i25, the streaming decoder,
    # telemetry and the stream tools; each count is set to 0 just before
    # its path and read just after
    fields, worst = phases_interlaced(card)
    entry.update(fields)
    entry["max_abs_err"] = max(entry["max_abs_err"], worst)
    t_fields = time.perf_counter()
    # the multi-device paths: each count is set to 0 just before its path
    # and read just after (in the ranks and workers for 27 and 30)
    dist_counts, worst = phases_distributed(card)
    entry.update(dist_counts)
    entry["max_abs_err"] = max(entry["max_abs_err"], worst)
    t_dist = time.perf_counter()
    # the bench entry points: each count is set to 0 just before its path
    # and read just after
    legs, worst = phases_bench(card)
    entry.update(legs)
    entry["max_abs_err"] = max(entry["max_abs_err"], worst)
    t_end = time.perf_counter()
    print(f"wall: phases 1-18 {t_rate - t_start:.1f} s, phases 19-22 "
          f"{t_settings - t_rate:.1f} s, phases 23-26 "
          f"{t_fields - t_settings:.1f} s, phases 27-31 "
          f"{t_dist - t_fields:.1f} s, phases 32-35 {t_end - t_dist:.1f} s, "
          f"the whole script {t_end - t_start:.1f} s (host clock, from the "
          f"build on)", flush=True)

    print(json.dumps({"kernels": [entry, probe_entry]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
