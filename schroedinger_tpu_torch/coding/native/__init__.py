"""Build + ctypes bindings for the native coding layer.

Compiles this package's own schro_coding.cpp (through ld_pack.cpp, which
includes it) and arith_pool.cpp with g++ at first use into `build/schroedinger_tpu_torch/` (the file name carries a
hash of the sources, the flags and the compiler's resolved target, so a
change to any of them builds anew) and exposes the coder that the codec
pipelines call: the port has no other.  A failed build raises; there is
no Python fallback.

Whole copy of `schroedinger_tpu/coding/native/__init__.py` apart from the
build: the port imports nothing of the JAX package and never loads its
library, and later slices find their entry points here.
"""
from __future__ import annotations

import ctypes as C
import hashlib
import os
import subprocess
import threading

import numpy as np

from schroedinger_tpu_torch.utils.telemetry import counters

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "schro_coding.cpp")
_POOL_SRC = os.path.join(_DIR, "arith_pool.cpp")
# built in _SRC's place: it includes _SRC (the JAX package's coder, line for
# line) and adds the low-delay packing on the pool's threads
_LD_SRC = os.path.join(_DIR, "ld_pack.cpp")
_PKG = os.path.dirname(os.path.dirname(_DIR))
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build",
                         "schroedinger_tpu_torch")
CXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
             "-pthread"]
LIBRARY = None      # path of the built library, set by build()
# guards the build, the load and the late declarations of the library
# (reentrant: a declaration reaches the library through _Library):
# encoders and decoders may run on several threads
_LOCK = threading.RLock()

_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")


def build() -> str:
    """Compile the coder library unless it is built already; returns its
    path.  -march=native resolves per machine, so the key also hashes the
    target options g++ resolves it to."""
    global LIBRARY
    target = subprocess.run(["g++", *CXX_FLAGS, "-Q", "--help=target"],
                            capture_output=True, text=True, check=True).stdout
    key = hashlib.sha256()
    for src in (_SRC, _LD_SRC, _POOL_SRC):
        with open(src, "rb") as f:
            key.update(f.read())
    key.update("\0".join([*CXX_FLAGS, target]).encode())
    LIBRARY = os.path.join(BUILD_DIR,
                           f"libschro_coding-{key.hexdigest()[:16]}.so")
    if not os.path.exists(LIBRARY):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{LIBRARY}.{os.getpid()}.tmp"
        res = subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, _LD_SRC,
                              _POOL_SRC], capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"g++ failed on {_LD_SRC}, {_POOL_SRC}:\n"
                               f"{res.stderr}")
        os.replace(tmp, LIBRARY)
    return LIBRARY


class _ArithBand(C.Structure):
    """One band of `subband_encode_arith_batch` (arith_pool.cpp's
    ArithBand, field for field)."""
    _fields_ = [("data", C.c_void_p), ("parent", C.c_void_p),
                ("quant_indices", C.c_void_p), ("out", C.c_void_p),
                ("capacity", C.c_int64), ("n_bytes", C.c_int64),
                ("h", C.c_int32), ("w", C.c_int32),
                ("parent_h", C.c_int32), ("parent_w", C.c_int32),
                ("elem", C.c_int32), ("parent_elem", C.c_int32),
                ("position", C.c_int32), ("hcb", C.c_int32),
                ("vcb", C.c_int32), ("have_quant_offset", C.c_int32),
                ("first_qi", C.c_int32), ("on_worker", C.c_int32)]


def _declare(lib) -> None:
    lib.ld_decode.restype = C.c_int64
    lib.ld_decode.argtypes = [
        C.c_char_p, C.c_int64, _i32p, _i32p,
        C.c_int, C.c_int, C.c_int, C.c_int, C.c_int,
        _i64p, _i32p, _i32p, _i32p, _i32p]

    lib.dc_predict_integrate.restype = None
    lib.dc_predict_integrate.argtypes = [_i32p, C.c_int, C.c_int, C.c_int]

    lib.subband_encode_arith.restype = C.c_int64
    lib.subband_encode_arith.argtypes = [
        _i32p, C.c_int, C.c_int, C.c_void_p, C.c_int,
        C.c_int, C.c_int, C.c_int, C.c_int, _i32p,
        _u8p, C.c_int64, C.POINTER(C.c_int32)]

    lib.subband_encode_arith_batch.restype = None
    lib.subband_encode_arith_batch.argtypes = [
        C.POINTER(_ArithBand), C.c_int, C.c_int]
    lib.arith_pool_cpus.restype = C.c_int
    lib.arith_pool_cpus.argtypes = []

    lib.subband_decode_arith.restype = None
    lib.subband_decode_arith.argtypes = [
        C.c_char_p, C.c_int64, C.c_int, C.c_int, C.c_int,
        C.c_void_p, C.c_int, C.c_int, C.c_int, C.c_int, C.c_int, C.c_int,
        C.c_int, _i32p]

    lib.subband_decode_arith_raw.restype = None
    lib.subband_decode_arith_raw.argtypes = [
        C.c_char_p, C.c_int64, C.c_int, C.c_int, C.c_int,
        C.c_void_p, C.c_int, C.c_int, C.c_int, C.c_int, C.c_int,
        _i32p, _i32p]

    lib.subband_quantise.restype = None
    lib.subband_quantise.argtypes = [
        _i32p, C.c_int, C.c_int, C.c_int, C.c_int, C.c_int, _i32p,
        C.c_int, C.c_int, C.c_int, _i32p]


class _Library:
    """The coder library, built and loaded at the first attribute access."""

    _cdll = None

    def _get(self):
        if _Library._cdll is None:    # checked again under the lock
            with _LOCK:
                if _Library._cdll is None:
                    lib = C.CDLL(build())
                    _declare(lib)
                    _Library._cdll = lib
        return _Library._cdll

    def __getattr__(self, name):
        return getattr(self._get(), name)

    def __setattr__(self, name, value):
        setattr(self._get(), name, value)


_lib = _Library()


def ld_decode(payload, y_qmo, uv_qmo, ny, nx, Sy, Suv, slice_bytes):
    """Decode low-delay slices -> dequantised slice tensors + bases."""
    slice_bytes = np.ascontiguousarray(slice_bytes, np.int64)
    y_out = np.zeros((ny * nx, Sy), dtype=np.int32)
    u_out = np.zeros((ny * nx, Suv), dtype=np.int32)
    v_out = np.zeros((ny * nx, Suv), dtype=np.int32)
    bases = np.zeros(ny * nx, dtype=np.int32)
    n = _lib.ld_decode(payload, len(payload),
                       np.ascontiguousarray(y_qmo, np.int32),
                       np.ascontiguousarray(uv_qmo, np.int32),
                       ny, nx, Sy, Suv, 0, slice_bytes.reshape(-1),
                       y_out, u_out, v_out, bases)
    if n < 0:
        raise ValueError("low-delay decode error")
    return (y_out.reshape(ny, nx, Sy), u_out.reshape(ny, nx, Suv),
            v_out.reshape(ny, nx, Suv), bases.reshape(ny, nx))


def dc_predict_integrate(band, deep=False):
    b = np.ascontiguousarray(band, np.int32)
    _lib.dc_predict_integrate(b, b.shape[0], b.shape[1], 1 if deep else 0)
    return b


def encode_subband_arith(qdata, parent_deq, position, hcb, vcb,
                         have_quant_offset, quant_indices):
    q = np.ascontiguousarray(qdata, np.int32)
    h, w = q.shape
    if parent_deq is not None:
        p = np.ascontiguousarray(parent_deq, np.int32)
        pptr = p.ctypes.data_as(C.c_void_p)
        pw = p.shape[1]
    else:
        pptr = None
        pw = 0
    out = np.zeros(h * w * 8 + 1024, dtype=np.uint8)
    first_qi = C.c_int32(-1)
    n = _lib.subband_encode_arith(
        q, h, w, pptr, pw, position, hcb, vcb,
        1 if have_quant_offset else 0,
        np.ascontiguousarray(quant_indices, np.int32),
        out, len(out), C.byref(first_qi))
    return out[:n].tobytes(), int(first_qi.value)


# A picture's bands go to the coder's thread pool only from this many
# coefficients on; below it they are coded on the calling thread, where
# the pool's hand-off would cost more than it saves.  The crossover was
# 5,120 to 19,584 coefficients on the hosts measured
# (tools/profile_arith_pool.py; PERF.md, Findings).
POOL_MIN_COEFFS = 1 << 16


def _coder_array(a):
    """a as C-contiguous int16 or int32, the element types the batch
    reads; anything else becomes int32, as encode_subband_arith makes it."""
    a = np.asarray(a)
    if a.dtype != np.int16:
        a = a.astype(np.int32, copy=False)
    return np.ascontiguousarray(a)


def _arith_jobs(bands):
    """(jobs, keep, out, offsets, coeffs) of subband_encode_arith_batch
    for `bands` (encode_subbands_arith's argument): the ctypes band array,
    the arrays it points into, the payloads' buffer and each band's
    offset in it, and the picture's coefficients."""
    n = len(bands)
    jobs = (_ArithBand * n)()
    keep = []
    offsets = [0] * (n + 1)
    coeffs = 0
    for k, (qdata, parent, position, hcb, vcb, have_qo, qi) in enumerate(
            bands):
        q = _coder_array(qdata)
        h, w = q.shape
        qi = np.ascontiguousarray(qi, np.int32)
        if qi.shape != (vcb, hcb):
            raise ValueError(f"quant indices {qi.shape} for ({vcb}, {hcb}) "
                             "codeblocks")
        job = jobs[k]
        if position >= 4:
            if parent is None:
                raise ValueError(f"band at position {position} needs its "
                                 "parent")
            pa = _coder_array(parent)
            if pa.shape[0] < (h + 1) // 2 or pa.shape[1] < (w + 1) // 2:
                raise ValueError(f"parent {pa.shape} too small for {q.shape}")
            job.parent = pa.ctypes.data
            job.parent_h, job.parent_w = pa.shape
            job.parent_elem = pa.itemsize
            keep.append(pa)
        keep += [q, qi]
        job.data = q.ctypes.data
        job.quant_indices = qi.ctypes.data
        job.h, job.w, job.elem = h, w, q.itemsize
        job.position, job.hcb, job.vcb = position, hcb, vcb
        job.have_quant_offset = 1 if have_qo else 0
        job.capacity = h * w * 8 + 1024
        offsets[k + 1] = offsets[k] + job.capacity
        coeffs += h * w
    # uninitialised: the coder writes each byte before it reads it (a
    # carry adds to a byte already written), and zeroing a 1080p
    # picture's 25 MB costs milliseconds on the calling thread
    out = np.empty(offsets[-1], dtype=np.uint8)
    for k in range(n):
        jobs[k].out = out.ctypes.data + offsets[k]
    return jobs, keep, out, offsets, coeffs


def encode_subbands_arith(bands):
    """Arith-encode the non-empty subbands of one picture at once.

    bands: [(qdata, parent, position, hcb, vcb, have_quant_offset,
    quant_indices)], each as encode_subband_arith takes them (parent None
    below position 4).  Returns [(payload, first_qi)] in the same order,
    each equal to encode_subband_arith's for its band.  A picture of at
    least POOL_MIN_COEFFS coefficients is coded on the library's thread
    pool; `counters` count the bands that a pool thread coded
    (arith_pool_bands) and those the calling thread coded
    (arith_inline_bands)."""
    jobs, keep, out, offsets, coeffs = _arith_jobs(bands)
    _lib.subband_encode_arith_batch(jobs, len(jobs),
                                    1 if coeffs >= POOL_MIN_COEFFS else 0)
    del keep            # the library has returned: the inputs may go
    pooled = sum(job.on_worker for job in jobs)
    counters.add("arith_pool_bands", pooled)
    counters.add("arith_inline_bands", len(jobs) - pooled)
    return [(out[o:o + job.n_bytes].tobytes(), int(job.first_qi))
            for o, job in zip(offsets, jobs)]


def arith_pool_cpus() -> int:
    """The CPUs the coder's thread pool may use (the process's affinity,
    read once); with one, every band is coded on the calling thread."""
    return _lib.arith_pool_cpus()


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
    _lib.subband_decode_arith(
        payload, len(payload), h, w, quant_index, pptr, pw,
        position, hcb, vcb, 1 if have_quant_offset else 0,
        1 if is_intra else 0, num_refs, out)
    return out.astype(np.int64)


def decode_subband_arith_raw(payload, shape, quant_index, parent_q,
                             position, hcb, vcb, have_quant_offset):
    """Arith-decode one subband to SIGNED QUANTISED values (no dequant)
    plus the (vcb, hcb) per-codeblock quant indices actually used —
    context-stream-identical to decode_subband_arith, letting the
    dequantisation run on device (parent_q must be the QUANTISED parent;
    contexts only zero-test it)."""
    h, w = shape
    out = np.zeros((h, w), dtype=np.int32)
    qi_out = np.zeros((vcb, hcb), dtype=np.int32)
    if parent_q is not None:
        p = np.ascontiguousarray(parent_q, np.int32)
        pptr = p.ctypes.data_as(C.c_void_p)
        pw = p.shape[1]
    else:
        pptr = None
        pw = 0
    _lib.subband_decode_arith_raw(
        payload, len(payload), h, w, quant_index, pptr, pw,
        position, hcb, vcb, 1 if have_quant_offset else 0, out, qi_out)
    return out, qi_out


def subband_quantise(data, position, hcb, vcb, quant_indices, is_intra,
                     num_refs=0, deep=False):
    """Quantise a subband in codeblock order, with the DC prediction of
    an intra band 0; returns (qdata, dequantised)."""
    d = np.ascontiguousarray(data, np.int32)
    h, w = d.shape
    qout = np.zeros((h, w), dtype=np.int32)
    _lib.subband_quantise(d, h, w, position, hcb, vcb,
                          np.ascontiguousarray(quant_indices, np.int32),
                          1 if is_intra else 0, num_refs,
                          1 if deep else 0, qout)
    return qout.astype(np.int64), d.astype(np.int64)


_lib2 = None


def _ensure_motion():
    global _lib2
    with _LOCK:
        if _lib2 is None:
            _lib.motion_decode.restype = None
            _lib.motion_decode.argtypes = [
                C.c_char_p, _i64p, _i64p,
                C.c_int, C.c_int, C.c_int, C.c_int, C.c_int] + [_i32p] * 10
            _lib2 = _lib
    return _lib2


def motion_decode(buffers, x_num_blocks, y_num_blocks, num_refs,
                  have_global, is_noarith):
    """buffers: list of 9 bytes objects (None for absent ref2 streams).
    Returns dict of (ynb, xnb) int32 arrays."""
    L = _ensure_motion()
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
    L.motion_decode(blob, offsets, lengths, x_num_blocks, y_num_blocks,
                    num_refs, 1 if have_global else 0,
                    1 if is_noarith else 0, *outs)
    names = ["split", "pred_mode", "using_global", "dx1", "dy1", "dx2",
             "dy2", "dc0", "dc1", "dc2"]
    return {k: v.reshape(y_num_blocks, x_num_blocks)
            for k, v in zip(names, outs)}


def _ensure_noarith():
    with _LOCK:
        if not hasattr(_lib, "_na_ready"):
            _lib.subband_encode_noarith.restype = C.c_int64
            _lib.subband_encode_noarith.argtypes = [
                _i32p, C.c_int, C.c_int, C.c_int, C.c_int, C.c_int, C.c_int,
                _u8p, C.c_int64]
            _lib.subband_decode_noarith.restype = None
            _lib.subband_decode_noarith.argtypes = [
                C.c_char_p, C.c_int64, C.c_int, C.c_int, C.c_int,
                C.c_int, C.c_int, C.c_int, C.c_int, C.c_int, _i32p]
            _lib._na_ready = True


def encode_subband_noarith(qdata, position, hcb, vcb, have_quant_offset_mode):
    _ensure_noarith()
    q = np.ascontiguousarray(qdata, np.int32)
    h, w = q.shape
    out = np.zeros(h * w * 8 + 1024, dtype=np.uint8)
    n = _lib.subband_encode_noarith(q, h, w, position, hcb, vcb,
                                    1 if have_quant_offset_mode else 0,
                                    out, len(out))
    return out[:n].tobytes()


def decode_subband_noarith(payload, shape, quant_index, position, hcb, vcb,
                           have_quant_offset_mode, num_refs=0):
    _ensure_noarith()
    h, w = shape
    out = np.zeros((h, w), dtype=np.int32)
    _lib.subband_decode_noarith(payload, len(payload), h, w, quant_index,
                                position, hcb, vcb,
                                1 if have_quant_offset_mode else 0,
                                num_refs, out)
    return out.astype(np.int64)


def _ensure_motion_enc():
    with _LOCK:
        if not hasattr(_lib, "_me_ready"):
            _lib.motion_encode.restype = C.c_int64
            _lib.motion_encode.argtypes = (
                [C.c_int, C.c_int, C.c_int, C.c_int, C.c_int]
                + [_i32p] * 10 + [_u8p, C.c_int64, _i64p, _i64p])
            _lib._me_ready = True


def motion_encode(mv: dict, x_num_blocks, y_num_blocks, num_refs,
                  have_global=False, is_noarith=False):
    """Encode MV fields; returns list of 9 bytes objects (stream payloads)."""
    _ensure_motion_enc()
    n = x_num_blocks * y_num_blocks
    arrays = [np.ascontiguousarray(mv[k].reshape(-1), np.int32)
              for k in ("split", "pred_mode", "using_global", "dx1", "dy1",
                        "dx2", "dy2", "dc0", "dc1", "dc2")]
    cap = max(4096, n * 32) * 9
    out = np.zeros(cap, dtype=np.uint8)
    offsets = np.zeros(9, dtype=np.int64)
    lengths = np.zeros(9, dtype=np.int64)
    total = _lib.motion_encode(x_num_blocks, y_num_blocks, num_refs,
                               1 if have_global else 0,
                               1 if is_noarith else 0,
                               *arrays, out, cap, offsets, lengths)
    if total < 0:
        raise ValueError("motion encode overflow")
    bufs = []
    for s in range(9):
        if num_refs < 2 and s in (4, 5):
            bufs.append(None)
        else:
            bufs.append(out[offsets[s]:offsets[s] + lengths[s]].tobytes())
    return bufs


def frame_md5(planes):
    """schro_frame_md5: raw row-padded MD5 over Y,U,V planes -> 16 bytes."""
    with _LOCK:
        if not hasattr(_lib, "_md5_ready"):
            _lib.frame_md5.restype = None
            _lib.frame_md5.argtypes = [_u8p, C.c_int, C.c_int, _u8p, _u8p,
                                       C.c_int, C.c_int, _u8p]
            _lib._md5_ready = True
    y, u, v = (np.ascontiguousarray(p, np.uint8) for p in planes)
    out = np.zeros(16, dtype=np.uint8)
    _lib.frame_md5(y, y.shape[1], y.shape[0], u, v,
                   u.shape[1], u.shape[0], out)
    return out.tobytes()


def _ensure_tab():
    with _LOCK:
        if not hasattr(_lib, "_tab_ready"):
            _lib.ld_encode_tab_pooled.restype = C.c_int64
            _lib.ld_encode_tab_pooled.argtypes = [
                _i32p, _i32p, _i32p, _i32p, _i32p,
                C.c_int, C.c_int, C.c_int, C.c_int,
                C.c_int, C.c_int, C.c_int, C.c_int,
                _i32p, _i32p, _i32p,
                C.c_int, C.c_int, C.c_int, C.c_int,
                C.c_int, C.c_int, _i64p,
                _i32p, _i32p, _i32p, _i32p, _i32p, _i32p,
                _u8p, C.c_int64, _i32p, C.c_int]
            _lib._tab_ready = True


def ld_pack_helpers(coeffs: int) -> int:
    """Pool threads that help pack a low-delay picture of `coeffs`
    coefficients: none below POOL_MIN_COEFFS, else all but two of the
    process's CPUs (one is the caller's, one is left to the thread that
    queues the next picture's device work)."""
    if coeffs < POOL_MIN_COEFFS:
        return 0
    return max(0, arith_pool_cpus() - 2)


def ld_encode_tab(yd, ud, vd, y_qmo, uv_qmo, ny, nx, y_bh, y_bw, uv_bh, uv_bw,
                  y_ll, u_ll, v_ll, dc_qm, slice_bytes,
                  y_bits, y_last, u_bits, u_last, v_bits, v_last,
                  deep=False, helpers=None):
    """Slice search using TPU-precomputed per-base aggregates, then the
    slices packed by rows on the calling thread and `helpers` pool
    threads (None: `ld_pack_helpers` of the picture); the bytes do not
    depend on `helpers`."""
    _ensure_tab()
    yd = np.ascontiguousarray(yd, np.int32)
    ud = np.ascontiguousarray(ud, np.int32)
    vd = np.ascontiguousarray(vd, np.int32)
    Sy = yd.shape[-1]
    Suv = ud.shape[-1]
    y_ll = np.ascontiguousarray(y_ll, np.int32)
    u_ll = np.ascontiguousarray(u_ll, np.int32)
    v_ll = np.ascontiguousarray(v_ll, np.int32)
    slice_bytes = np.ascontiguousarray(slice_bytes, np.int64)
    cap = int(slice_bytes.sum())
    out = np.zeros(cap, dtype=np.uint8)
    bases = np.zeros(ny * nx, dtype=np.int32)
    tabs = [np.ascontiguousarray(t.reshape(61, -1), np.int32)
            for t in (y_bits, y_last, u_bits, u_last, v_bits, v_last)]
    if helpers is None:
        helpers = ld_pack_helpers(yd.size + ud.size + vd.size)
    n = _lib.ld_encode_tab_pooled(
        yd.reshape(-1, Sy), ud.reshape(-1, Suv), vd.reshape(-1, Suv),
        np.ascontiguousarray(y_qmo, np.int32),
        np.ascontiguousarray(uv_qmo, np.int32),
        ny, nx, Sy, Suv, y_bh, y_bw, uv_bh, uv_bw,
        y_ll, u_ll, v_ll,
        y_ll.shape[1], y_ll.shape[0], u_ll.shape[1], u_ll.shape[0],
        dc_qm, 1 if deep else 0, slice_bytes.reshape(-1), *tabs, out, cap,
        bases, int(helpers))
    if n < 0:
        raise ValueError("low-delay slice overflow")
    return out.tobytes(), bases.reshape(ny, nx)
