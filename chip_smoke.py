"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints a line; any failure ends the run with a non-zero exit
and no result line):
  0. the card's name and power limit (nvidia-smi); no CUDA -> fail
  1. build the patch-refine kernel from csrc/ with nvcc
  2. kernel == plain version (torch.equal) at the four 1080p refine shapes
     of one P picture, on random planes/MVs and on a flat all-tie plane;
     both timed with CUDA events
  3. the main path: a small stream encoded on the card must equal the
     CPU encode byte for byte; then 8 frames of 1080p25 4:2:0 pan + noise
     through the port's GopEncoder (backref, fixed quantisers, quarter-pel
     MVs, MD5) and StreamDecoder on the card: 4 kernel launches per P
     picture, 8 frames out, no MD5 failure, no picture error, luma PSNR
     >= 30 dB
The last two lines are the nvidia-smi line and
{"ok": true, "device": {...}}; the kernel summary JSON comes before them.
"""
import json
import subprocess
import sys
import time

import numpy as np
import torch

from schroedinger_tpu_torch.decoder.core import StreamDecoder
from schroedinger_tpu_torch.encoder import me as me_mod
from schroedinger_tpu_torch.encoder.gop import GopEncoder
from schroedinger_tpu_torch.ops import patch_refine as pr
from schroedinger_tpu_torch.slice_config import (CONFIG, make_frames,
                                                 video_format)

MARGIN = me_mod.ME_BOUND_PEL + 2 * 8 + 16    # make_me_body, coarse radius 8
RAD = 2
# (level, nby, nbx, bs) of the four patch-refine launches of a 1080p P
# picture (5-level pyramid on the 1088x1920 block grid)
REFINE_SHAPES = [(3, 34, 60, 4), (2, 68, 120, 4), (1, 68, 120, 8),
                 (0, 68, 120, 16)]


def gpu_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def refine_inputs(nby, nbx, bs, flat, dev, seed):
    rng = np.random.default_rng(seed)
    h, w = nby * bs, nbx * bs
    if flat:
        cur = np.full((h, w), 77, np.uint8)
        ref = np.full((h, w), 90, np.uint8)
    else:
        cur = rng.integers(0, 256, (h, w)).astype(np.uint8)
        ref = rng.integers(0, 256, (h, w)).astype(np.uint8)
    bound = me_mod.ME_BOUND_PEL
    mvy = rng.integers(-bound, bound + 1, (nby, nbx)).astype(np.int32)
    mvx = rng.integers(-bound, bound + 1, (nby, nbx)).astype(np.int32)
    cb = me_mod._to_blocks(torch.tensor(cur, device=dev).to(torch.int32),
                           nby, bs, nbx, bs).contiguous()
    P = me_mod._pad_ref(torch.tensor(ref, device=dev), MARGIN).contiguous()
    return (cb, P, torch.tensor(mvy, device=dev),
            torch.tensor(mvx, device=dev), nby, nbx, bs, bs, RAD, MARGIN)


def time_ms(fn, args, iters=20):
    for _ in range(3):
        fn(*args)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn(*args)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_kernel(card):
    """Kernel vs plain at the 1080p shapes; returns the summary entry."""
    dev = torch.device("cuda")
    max_err = 0
    tot_k = tot_p = 0.0
    for level, nby, nbx, bs in REFINE_SHAPES:
        for flat in (False, True):
            args = refine_inputs(nby, nbx, bs, flat, dev, seed=level)
            got = pr.patch_refine(*args)
            want = pr.patch_refine_plain(*args)
            torch.cuda.synchronize()
            for g, w_, name in zip(got, want, ("dy", "dx", "sad")):
                err = int((g.to(torch.int64) - w_).abs().max())
                max_err = max(max_err, err)
                if not torch.equal(g, w_):
                    raise AssertionError(
                        f"patch_refine level {level} "
                        f"{'flat' if flat else 'random'}: kernel {name} "
                        f"differs from plain (max |diff| {err})")
            if flat:
                assert torch.equal(got[0], args[2] - RAD), "tie order"
        args = refine_inputs(nby, nbx, bs, False, dev, seed=level)
        # turns: plain, kernel, kernel, plain
        p1 = time_ms(pr.patch_refine_plain, args)
        k1 = time_ms(pr.patch_refine, args)
        k2 = time_ms(pr.patch_refine, args)
        p2 = time_ms(pr.patch_refine_plain, args)
        k_ms, p_ms = (k1 + k2) / 2, (p1 + p2) / 2
        tot_k += k_ms
        tot_p += p_ms
        print(f"phase2 patch_refine level {level} ({nby}x{nbx} blocks of "
              f"{bs}x{bs}, rad {RAD}): kernel == plain on random and flat; "
              f"kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms [{card}]",
              flush=True)
    return {"name": "patch_refine", "route": "cuda",
            "source": "schroedinger_tpu_torch/csrc/patch_refine.cu",
            "replaces": "schroedinger_tpu/ops/pallas_me.py:71",
            "launches": None, "max_abs_err": max_err,
            "ms": tot_k, "plain_ms": tot_p}


def psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return 99.0 if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


def phase_slice(card):
    """The port's encode + decode on the card; returns kernel launches."""
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

    W, H, N = 1920, 1080, 8
    vf = video_format(W, H)
    frames = make_frames(N, W, H)
    # warm-up: one I + one P at full size (allocator, library init)
    GopEncoder(vf, device="cuda", **CONFIG).encode_stream(frames[:2])
    torch.cuda.synchronize()

    pr.LAUNCHES = 0
    enc = GopEncoder(vf, device="cuda", **CONFIG)
    t0 = time.perf_counter()
    stream = enc.encode_stream(frames)
    torch.cuda.synchronize()
    t_enc = time.perf_counter() - t0
    dec = StreamDecoder(device="cuda")
    t0 = time.perf_counter()
    out = dec.decode_stream(stream)
    torch.cuda.synchronize()
    t_dec = time.perf_counter() - t0
    launches = pr.LAUNCHES

    n_p = sum(1 for f in enc.stats.frames if not f["intra"])
    print(f"phase3 coded {N - n_p} I + {n_p} P pictures "
          f"({'intra bailout/scene cut fired' if n_p != N - 1 else 'no intra bailout'}); "
          f"patch_refine launches {launches}", flush=True)
    if launches != 4 * n_p or n_p == 0:
        raise AssertionError(f"expected 4 launches per P picture "
                             f"({4 * n_p}), counted {launches}")
    if len(out) != N:
        raise AssertionError(f"decoded {len(out)} frames, expected {N}")
    if dec.md5_failures or dec.errors:
        raise AssertionError(f"md5_failures={dec.md5_failures} "
                             f"errors={dec.errors}")
    for planes, (y, u, v) in zip(out, frames):
        for got, src in zip(planes, (y, u, v)):
            if got.shape != src.shape or got.dtype != np.uint8:
                raise AssertionError(f"plane {got.shape} {got.dtype}")
    vals = [psnr(o[0], f[0]) for o, f in zip(out, frames)]
    if min(vals) < 30.0:
        raise AssertionError(f"luma PSNR {min(vals):.2f} dB < 30")
    print(f"phase3 1080p25 4:2:0 x{N}: {len(stream)} bytes, luma PSNR "
          f"mean {np.mean(vals):.3f} min {min(vals):.3f} dB, "
          f"md5_failures=[] errors=[]; encode {N / t_enc:.3f} frames/s, "
          f"decode {N / t_dec:.3f} frames/s [{card}]", flush=True)
    return launches


def main() -> int:
    card = gpu_line()
    print(f"phase0 gpu: {card}", flush=True)
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: this smoke "
                           "run needs an NVIDIA GPU")
    print(f"phase0 torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    secs = pr.build()
    print(f"phase1 built {pr.LIBRARY} in {secs:.2f} s", flush=True)
    for line in pr.BUILD_LOG.splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            print(f"phase1 ptxas: {line.strip()}", flush=True)

    entry = phase_kernel(card)
    entry["launches"] = phase_slice(card)

    print(json.dumps({"kernels": [entry]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
