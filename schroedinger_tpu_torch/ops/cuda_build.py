"""Build and load of the port's hand-written CUDA kernels.

Every `.cu` file in `csrc/` is compiled by nvcc for sm_90a into one shared
library with a plain C interface, at first use, into
`build/schroedinger_tpu_torch/`, and loaded with ctypes.  The library's
file name carries a hash of every source and header in `csrc/`,
NVCC_FLAGS and nvcc's version, so a change to any of them builds anew
and an unchanged checkout finds its library built.  The build and the
load run once per process, under a lock: the encoder runs on several
threads when GOP shards encode at once.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
_PKG = os.path.dirname(_HERE)
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build",
                         "schroedinger_tpu_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

BUILD_LOG = ""      # nvcc's output of the last build (ptxas usage lines)
LIBRARY = None      # path of the built library, set by build()

_vp, _ci, _cll, _cf = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_float)
# the C entry points of the library and their arguments
SIGNATURES = {
    # csrc/patch_refine.cu: variant, n, cur, ref, field, out, h, w, hy,
    # hx, scale, bs_y, bs_x, rad, bound, margin, stream
    "me_search_launch": [_ci, _ci] + [_vp] * 4 + [_ci] * 10 + [_vp],
    # csrc/stat_tables.cu: elem_bytes, pow_mode, ip, power, n_pics, n,
    # v, qtab, tiles, ntiles, col_ptr, col_segs, ncol, part_bits,
    # part_err, mag, nz, err, stream
    "stat_tables_launch": [_ci, _ci, _ci, _cf, _ci, _cll, _vp, _vp, _vp,
                           _ci, _vp, _vp, _ci] + [_vp] * 6,
    # csrc/me_final.cu: n, cur, ref, up, mv, sad, out, nby, nbx, bs_y,
    # bs_x, h2, w2, prec, compete, zero_cand, bound, margin, sp_margin,
    # stream
    "me_final_launch": [_ci] + [_vp] * 6 + [_ci] * 12 + [_vp],
}

_lib = None
_LOCK = threading.Lock()


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the port's kernels are built with "
                       "the CUDA toolkit")


def _sources():
    """Every file the build compiles or includes: the .cu files and the
    headers in csrc/, sorted by name."""
    return sorted(os.path.join(CSRC, n) for n in os.listdir(CSRC)
                  if n.endswith((".cu", ".cuh", ".h")))


def build() -> float:
    """Compile the kernel library unless it is built already.  Sets
    LIBRARY; returns the seconds spent compiling (0.0 when up to date)."""
    global BUILD_LOG, LIBRARY
    nvcc = _nvcc()
    version = subprocess.run([nvcc, "--version"], capture_output=True,
                             text=True, check=True).stdout
    key = hashlib.sha256()
    sources = _sources()
    for path in sources:
        key.update(os.path.basename(path).encode() + b"\0")
        with open(path, "rb") as f:
            key.update(f.read())
    key.update("\0".join([*NVCC_FLAGS, version]).encode())
    LIBRARY = os.path.join(BUILD_DIR, f"libkernels-{key.hexdigest()[:16]}.so")
    if os.path.exists(LIBRARY):
        return 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{LIBRARY}.{os.getpid()}.tmp"
    units = [p for p in sources if p.endswith(".cu")]
    t0 = time.perf_counter()
    res = subprocess.run([nvcc, *NVCC_FLAGS, "-o", tmp, *units],
                         capture_output=True, text=True)
    BUILD_LOG = res.stdout + res.stderr
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {units}:\n{BUILD_LOG}")
    os.replace(tmp, LIBRARY)
    return time.perf_counter() - t0


def load():
    """The kernel library, built and loaded on first use, with the
    argument types of every entry point set."""
    global _lib
    if _lib is None:                  # checked again under the lock
        with _LOCK:
            if _lib is None:
                build()
                lib = ctypes.CDLL(LIBRARY)
                for name, argtypes in SIGNATURES.items():
                    fn = getattr(lib, name)
                    fn.argtypes = argtypes
                    fn.restype = _ci
                _lib = lib
    return _lib
