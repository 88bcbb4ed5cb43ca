"""Build + ctypes bindings for the reference decoder's native entropy
decoding (the arithmetic-coded subbands, the block motion data and the
intra DC prediction).

Compiles `schro_coding.cpp` (the decoding half of a frozen copy of the
port's C++ coder) with
g++ at first use into `<checkout>/build/benchmark_refcodec/`; the file name
carries a hash of the source, the flags and the compiler's resolved
target, so a change to any of them builds anew.  A failed build raises;
there is no Python fallback.
"""
from __future__ import annotations

import ctypes as C
import hashlib
import os
import subprocess

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "schro_coding.cpp")
_PKG = os.path.dirname(os.path.dirname(_DIR))
# <checkout>/build/benchmark_refcodec: beside the program's own build
# directory, never shared with it
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_PKG)), "build",
                         "benchmark_refcodec")
CXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17"]
LIBRARY = None      # path of the built library, set by build()

_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")


def build() -> str:
    """Compile the coder library unless it is built already; returns its
    path.  -march=native resolves per machine, so the key also hashes the
    target options g++ resolves it to."""
    global LIBRARY
    target = subprocess.run(["g++", *CXX_FLAGS, "-Q", "--help=target"],
                            capture_output=True, text=True, check=True).stdout
    key = hashlib.sha256()
    with open(_SRC, "rb") as f:
        key.update(f.read())
    key.update("\0".join([*CXX_FLAGS, target]).encode())
    LIBRARY = os.path.join(BUILD_DIR,
                           f"libschro_coding-{key.hexdigest()[:16]}.so")
    if not os.path.exists(LIBRARY):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{LIBRARY}.{os.getpid()}.tmp"
        res = subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, _SRC],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"g++ failed on {_SRC}:\n{res.stderr}")
        os.replace(tmp, LIBRARY)
    return LIBRARY


def _load():
    """The built library with its functions declared."""
    lib = C.CDLL(build())
    lib.dc_predict_integrate.restype = None
    lib.dc_predict_integrate.argtypes = [_i32p, C.c_int, C.c_int, C.c_int]
    lib.subband_decode_arith.restype = None
    lib.subband_decode_arith.argtypes = [
        C.c_char_p, C.c_int64, C.c_int, C.c_int, C.c_int,
        C.c_void_p, C.c_int, C.c_int, C.c_int, C.c_int, C.c_int, C.c_int,
        C.c_int, _i32p]
    lib.motion_decode.restype = None
    lib.motion_decode.argtypes = [
        C.c_char_p, _i64p, _i64p,
        C.c_int, C.c_int, C.c_int, C.c_int, C.c_int] + [_i32p] * 10
    return lib


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        _LIB = _load()
    return _LIB


def dc_predict_integrate(band, deep=False):
    b = np.ascontiguousarray(band, np.int32)
    _lib().dc_predict_integrate(b, b.shape[0], b.shape[1], 1 if deep else 0)
    return b


def decode_subband_arith(payload, shape, quant_index, parent_deq, position,
                         hcb, vcb, have_quant_offset, is_intra, num_refs=0):
    h, w = shape
    out = np.zeros((h, w), dtype=np.int32)
    if parent_deq is not None:
        p = np.ascontiguousarray(parent_deq, np.int32)
        pptr = p.ctypes.data_as(C.c_void_p)
        pw = p.shape[1]
    else:
        pptr = None
        pw = 0
    _lib().subband_decode_arith(
        payload, len(payload), h, w, quant_index, pptr, pw,
        position, hcb, vcb, 1 if have_quant_offset else 0,
        1 if is_intra else 0, num_refs, out)
    return out.astype(np.int64)


def motion_decode(buffers, x_num_blocks, y_num_blocks, num_refs,
                  have_global, is_noarith):
    """buffers: list of 9 bytes objects (None for absent ref2 streams).
    Returns dict of (ynb, xnb) int32 arrays."""
    datas = [b if b is not None else b"" for b in buffers]
    offsets = np.zeros(9, dtype=np.int64)
    lengths = np.zeros(9, dtype=np.int64)
    blob = bytearray()
    for i, b in enumerate(datas):
        offsets[i] = len(blob)
        lengths[i] = len(b)
        blob += b
    blob = bytes(blob) or b"\x00"
    n = x_num_blocks * y_num_blocks
    outs = [np.zeros(n, dtype=np.int32) for _ in range(10)]
    _lib().motion_decode(blob, offsets, lengths, x_num_blocks,
                         y_num_blocks, num_refs, 1 if have_global else 0,
                         1 if is_noarith else 0, *outs)
    names = ["split", "pred_mode", "using_global", "dx1", "dy1", "dx2",
             "dy2", "dc0", "dc1", "dc2"]
    return {k: v.reshape(y_num_blocks, x_num_blocks)
            for k, v in zip(names, outs)}
