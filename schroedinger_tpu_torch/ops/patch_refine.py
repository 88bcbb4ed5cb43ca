"""ME patch refine: (2rad+1)^2 full-pel SAD search around per-block hints.

`patch_refine` is the entry point.  On CUDA tensors it launches the
hand-written kernel `csrc/patch_refine.cu` (the port of the Pallas kernel
`schroedinger_tpu/ops/pallas_me.py:71 make_patch_refine`), built with nvcc
at first use into `build/schroedinger_tpu_torch/` and bound with ctypes.
On CPU tensors it runs `patch_refine_plain`, the plain PyTorch version
(the port of `schroedinger_tpu/encoder/me.py _patch_refine`).  A CUDA
tensor never takes the plain path: the wrapper launches or raises.

LAUNCHES counts kernel launches (and nothing else), so a run can show
that its ME went through the kernel.

`patch_refine_probe` launches one of the kernel's four compile-time cost
variants (the port of the TPU probe `tools/profile_pk_parts.py:113`; see
the source's head and `tools/profile_patch_refine.py`); PROBE_LAUNCHES
counts those launches.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

import torch

from schroedinger_tpu_torch.ops.obmc import _round8, extract_patches

_HERE = os.path.dirname(os.path.abspath(__file__))
_PKG = os.path.dirname(_HERE)
SOURCE = os.path.join(_PKG, "csrc", "patch_refine.cu")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build",
                         "schroedinger_tpu_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

LAUNCHES = 0        # kernel launches since import (or the last reset)
PROBE_LAUNCHES = 0  # launches of the cost probe's variants, likewise
# the probe's variants, by their number in the source; only "full" gives
# right answers
PROBE_VARIANTS = ("full", "nostage", "nosad", "onewindow")
BUILD_LOG = ""      # nvcc's output of the last build (ptxas usage lines)
LIBRARY = None      # path of the built library, set by build()

_lib = None


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the patch-refine kernel is built "
                       "with the CUDA toolkit")


def build() -> float:
    """Compile the kernel library unless it is built already.  The file
    name carries a hash of the source, NVCC_FLAGS and nvcc's version, so
    a change to any of them builds anew.  Sets LIBRARY; returns the
    seconds spent compiling (0.0 when up to date)."""
    global BUILD_LOG, LIBRARY
    nvcc = _nvcc()
    version = subprocess.run([nvcc, "--version"], capture_output=True,
                             text=True, check=True).stdout
    key = hashlib.sha256()
    with open(SOURCE, "rb") as f:
        key.update(f.read())
    key.update("\0".join([*NVCC_FLAGS, version]).encode())
    LIBRARY = os.path.join(BUILD_DIR,
                           f"libpatch_refine-{key.hexdigest()[:16]}.so")
    if os.path.exists(LIBRARY):
        return 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{LIBRARY}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    res = subprocess.run([nvcc, *NVCC_FLAGS, "-o", tmp, SOURCE],
                         capture_output=True, text=True)
    BUILD_LOG = res.stdout + res.stderr
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {SOURCE}:\n{BUILD_LOG}")
    os.replace(tmp, LIBRARY)
    return time.perf_counter() - t0


def _load():
    global _lib
    if _lib is None:
        build()
        lib = ctypes.CDLL(LIBRARY)
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.patch_refine_launch.argtypes = [vp] * 7 + [ci] * 8 + [vp]
        lib.patch_refine_launch.restype = ci
        lib.patch_refine_probe_launch.argtypes = [ci] + [vp] * 7 + [ci] * 8 \
            + [vp]
        lib.patch_refine_probe_launch.restype = ci
        _lib = lib
    return _lib


def extract_ref_patches(P, mv_y, mv_x, nby, nbx, bs_y, bs_x, rad, margin):
    """Per-block (bs+2rad) patches of the padded ref at the block origin
    displaced by its MV (origins clamped into P).  Returns (nb, ph, pw)
    int32 with ph, pw = round8(bs_y + 2rad), round8(bs_x + 2rad)."""
    ph = _round8(bs_y + 2 * rad)
    pw = _round8(bs_x + 2 * rad)
    dev = P.device
    oy = ((torch.arange(nby, dtype=torch.int32, device=dev) * bs_y)[:, None]
          + mv_y - rad + margin).reshape(-1)
    ox = ((torch.arange(nbx, dtype=torch.int32, device=dev) * bs_x)[None, :]
          + mv_x - rad + margin).reshape(-1)
    return extract_patches(P, oy, ox, ph, pw).to(torch.int32)


def patch_refine_plain(cur_blocks, P, mv_y, mv_x, nby, nbx, bs_y, bs_x, rad,
                       margin):
    """(2rad+1)^2 full-pel refine around (mv_y, mv_x) via per-block patches
    of the padded reference (plain PyTorch; any device).

    cur_blocks: (nb, bs_y, bs_x) int32; P: (Hp, Wp) u8/int; mv_*: (nby,
    nbx) int32.  Returns (mv_y, mv_x, best_sad) each (nby, nbx) int32."""
    pat = extract_ref_patches(P, mv_y, mv_x, nby, nbx, bs_y, bs_x, rad,
                              margin)
    K = 2 * rad + 1
    sads = [(cur_blocks - pat[:, a:a + bs_y, b:b + bs_x]).abs().sum(
        (1, 2), dtype=torch.int32) for a in range(K) for b in range(K)]
    s = torch.stack(sads)                        # (K*K, nb)
    best = torch.argmin(s, dim=0)                # first index on ties
    doy = (torch.div(best, K, rounding_mode="floor") - rad).to(torch.int32)
    dox = (best % K - rad).to(torch.int32)
    best_sad = torch.gather(s, 0, best[None])[0]
    return (mv_y + doy.reshape(nby, nbx), mv_x + dox.reshape(nby, nbx),
            best_sad.reshape(nby, nbx))


def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"patch_refine: {name} on {t.device}, "
                         f"expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"patch_refine: {name} is {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"patch_refine: {name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"patch_refine: {name} is not contiguous")


def _launch(variant, cur_blocks, P, mv_y, mv_x, nby, nbx, bs_y, bs_x, rad,
            margin):
    """Check the arguments and launch the kernel (variant None) or the
    probe's variant of that number.  Returns the three output tensors."""
    dev = cur_blocks.device
    if dev.type != "cuda":
        raise ValueError(f"patch_refine_cuda: tensors on {dev}")
    _check("cur_blocks", cur_blocks, torch.int32, (nby * nbx, bs_y, bs_x),
           dev)
    if P.ndim != 2:
        raise ValueError(f"patch_refine: P must be 2-D, got {P.ndim}-D")
    _check("P", P, torch.uint8, P.shape, dev)
    Ph, Pw = P.shape
    if Ph < _round8(bs_y + 2 * rad) or Pw < _round8(bs_x + 2 * rad):
        raise ValueError(f"patch_refine: P {tuple(P.shape)} smaller than "
                         "one search window")
    _check("mv_y", mv_y, torch.int32, (nby, nbx), dev)
    _check("mv_x", mv_x, torch.int32, (nby, nbx), dev)
    outs = [torch.empty((nby, nbx), dtype=torch.int32, device=dev)
            for _ in range(3)]
    stream = torch.cuda.current_stream(dev).cuda_stream
    args = (cur_blocks.data_ptr(), P.data_ptr(), mv_y.data_ptr(),
            mv_x.data_ptr(), outs[0].data_ptr(), outs[1].data_ptr(),
            outs[2].data_ptr(), nby, nbx, bs_y, bs_x, rad, margin, Ph, Pw,
            stream)
    if variant is None:
        err = _load().patch_refine_launch(*args)
    else:
        err = _load().patch_refine_probe_launch(variant, *args)
    if err != 0:
        raise RuntimeError(f"patch_refine kernel launch failed: CUDA error "
                           f"{err}")
    return tuple(outs)


def patch_refine_cuda(cur_blocks, P, mv_y, mv_x, nby, nbx, bs_y, bs_x, rad,
                      margin):
    """Launch the CUDA kernel (no plain fallback).  P must be u8."""
    global LAUNCHES
    outs = _launch(None, cur_blocks, P, mv_y, mv_x, nby, nbx, bs_y, bs_x,
                   rad, margin)
    LAUNCHES += 1
    return outs


def patch_refine_probe(variant: str, cur_blocks, P, mv_y, mv_x, nby, nbx,
                       bs_y, bs_x, rad, margin):
    """Launch one cost variant of the kernel (PROBE_VARIANTS) on CUDA
    tensors.  Same arguments and outputs as patch_refine_cuda; only
    "full" computes the search, the others exist to be timed."""
    global PROBE_LAUNCHES
    outs = _launch(PROBE_VARIANTS.index(variant), cur_blocks, P, mv_y, mv_x,
                   nby, nbx, bs_y, bs_x, rad, margin)
    PROBE_LAUNCHES += 1
    return outs


def patch_refine(cur_blocks, P, mv_y, mv_x, nby, nbx, bs_y, bs_x, rad,
                 margin):
    """Exhaustive (2rad+1)^2 SAD search per block around its hint MV.

    CUDA tensors launch the kernel; CPU tensors run the plain version."""
    if cur_blocks.device.type == "cuda":
        return patch_refine_cuda(cur_blocks, P, mv_y, mv_x, nby, nbx, bs_y,
                                 bs_x, rad, margin)
    if cur_blocks.device.type != "cpu":
        raise ValueError(f"patch_refine: unsupported device "
                         f"{cur_blocks.device}")
    return patch_refine_plain(cur_blocks, P, mv_y, mv_x, nby, nbx, bs_y,
                              bs_x, rad, margin)
