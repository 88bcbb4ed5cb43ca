"""The port's GOP sharding (`schroedinger_tpu_torch/parallel/gops.py`)
against the JAX package on the CPU, at 96x80, 16 frames, GOPs of 4 (the
inputs of tests/test_gop_sharding.py): the chunk ranges, sharded ==
serial == the JAX serial stream (sequential and on threads), the
single-process fallback of the multi-process form, the payload gather on
a stand-in allgather, the validation, byte-equal streams from cold and
warm caches, the exact=False biref CBR merge equal to JAX's, the JAX
decoder on the port's merged stream, and the locks of what shard threads
share: from cold caches and a cold library loader the threaded encode
equals the serial one and the native library loads once, and a built-
once step or kernel library is built once under many threads."""
import ctypes
import sys
import threading
import time

import numpy as np
import pytest

from schroedinger_tpu.decoder.core import StreamDecoder as JStreamDecoder
from schroedinger_tpu.encoder.gop import GopEncoder as JGopEncoder
from schroedinger_tpu.parallel import gops as j_gops
from schroedinger_tpu.video_format import (ChromaFormat as JChroma,
                                           VideoFormat as JVideoFormat)

import schroedinger_tpu_torch
from schroedinger_tpu_torch.coding import native
from schroedinger_tpu_torch.decoder.core import StreamDecoder
from schroedinger_tpu_torch.encoder import inter
from schroedinger_tpu_torch.encoder.gop import GopEncoder
from schroedinger_tpu_torch.ops import patch_refine as pr
from schroedinger_tpu_torch.parallel import gops
from schroedinger_tpu_torch.slice_config import video_format

W, H = 96, 80
GOP = 4
N = 16
SERIAL = dict(base_qi_intra=12, base_qi_inter=16, gop_length=GOP,
              enable_scene_change=False)
CBR = dict(gop_length=GOP, gop_structure="biref", subgroup_length=2,
           bitrate=400000, fps=25, enable_scene_change=False)


def make_frames(n=N, seed=9):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W]
    base = 128 + 55 * np.sin(xx / 6.0) * np.cos(yy / 5.0)
    out = []
    for i in range(n):
        y = np.roll(base, (i, 2 * i), axis=(0, 1)) + rng.normal(0, 3, (H, W))
        u = 128 + 20 * np.cos((xx[::2, ::2] + i) / 8.0)
        v = 128 + 20 * np.sin((yy[::2, ::2] + i) / 7.0)
        out.append((y.clip(0, 255).astype(np.uint8),
                    u.clip(0, 255).astype(np.uint8),
                    v.clip(0, 255).astype(np.uint8)))
    return out


def _enc(**kw):
    return GopEncoder(video_format(W, H), device="cpu", **dict(SERIAL, **kw))


def _jenc(**kw):
    vf = JVideoFormat(width=W, height=H, clean_width=W, clean_height=H,
                      chroma_format=JChroma.C420, frame_rate_numerator=25,
                      frame_rate_denominator=1)
    return JGopEncoder(vf, **dict(SERIAL, **kw))


@pytest.fixture(scope="module")
def frames():
    return make_frames()


@pytest.fixture(scope="module")
def jax_serial(frames):
    return _jenc().encode_stream(frames)


@pytest.fixture(scope="module")
def threaded(frames):
    return gops.encode_gops_sharded(frames, _enc, n_shards=2)


def test_chunk_ranges():
    assert gops.chunk_ranges(16, 4, 2) == [(0, 8), (8, 16)]
    assert gops.chunk_ranges(17, 4, 2) == [(0, 12), (12, 17)]
    assert gops.chunk_ranges(8, 4, 8) == [(0, 4), (4, 8)]
    assert gops.chunk_ranges(3, 4, 4) == [(0, 3)]
    for args in ((16, 4, 2), (17, 4, 2), (8, 4, 8), (3, 4, 4), (50, 24, 3)):
        assert gops.chunk_ranges(*args) == j_gops.chunk_ranges(*args)


def test_sharded_equals_serial_and_jax(frames, jax_serial):
    serial = _enc().encode_stream(frames)
    assert serial == jax_serial
    assert gops.encode_gops_sharded(frames, _enc, n_shards=4,
                                    sequential=True) == serial


def test_threaded_shards_match(threaded, jax_serial):
    assert threaded == jax_serial


def test_jax_decoder_reads_merged_stream(threaded):
    """The JAX StreamDecoder decodes the port's merged stream to the port
    decoder's planes, MD5-free and error-free."""
    jdec = JStreamDecoder()
    want = jdec.decode_stream(threaded)
    dec = StreamDecoder(device="cpu")
    got = dec.decode_stream(threaded)
    assert dec.errors == [] and jdec.errors == []
    assert len(got) == len(want) == N
    for n, (g3, w3) in enumerate(zip(got, want)):
        for g, w, name in zip(g3, w3, "yuv"):
            np.testing.assert_array_equal(g, w, err_msg=f"{n} {name}")


def test_multihost_single_process_fallback(frames):
    stream = gops.encode_gops_multihost(frames[:8], _enc)
    assert stream == _enc().encode_stream(frames[:8])


def test_gather_and_merge_fake_two_process(frames):
    """The gather's padding and unpacking with a stand-in allgather: two
    simulated processes encode their chunk, 'gather', and the merged
    stream is the serial encode on both ranks."""
    clip = frames[:8]
    locals_ = []
    for start, stop in gops.chunk_ranges(len(clip), GOP, 2):
        enc = _enc()
        gops._seed_shard_state(enc, start)
        locals_.append(enc.encode_stream(clip[start:stop]))

    def fake_allgather(arr):
        if arr.dtype == np.int64:
            return np.stack([np.asarray([len(s)], np.int64)
                             for s in locals_])
        out = np.zeros((2, arr.shape[0]), np.uint8)
        for i, s in enumerate(locals_):
            out[i, :len(s)] = np.frombuffer(s, np.uint8)
        return out

    serial = _enc().encode_stream(clip)
    assert gops.gather_and_merge(locals_[0], 2, fake_allgather) == serial
    assert gops.gather_and_merge(locals_[1], 2, fake_allgather) == serial
    with pytest.raises(ValueError, match="gathered 2 payloads"):
        gops.gather_and_merge(locals_[0], 3, fake_allgather)


def test_shard_encoder_validation(frames):
    with pytest.raises(ValueError, match="enable_scene_change"):
        gops.encode_gops_sharded(frames[:4], lambda: _enc(
            enable_scene_change=True), n_shards=2)
    with pytest.raises(ValueError, match="bitrate/CBR"):
        gops.encode_gops_sharded(frames[:4], lambda: _enc(**CBR), n_shards=2)


def test_cold_and_warm_caches_give_the_same_bytes(frames):
    """Cold vs warm step caches: byte-equal biref CBR streams."""
    clip = frames[:8]
    a = _enc(**CBR).encode_stream(clip)
    schroedinger_tpu_torch.clear_compiled_caches()
    b = _enc(**CBR).encode_stream(clip)
    c = _enc(**CBR).encode_stream(clip)
    assert a == b == c


def test_exact_false_biref_cbr_matches_jax(frames):
    """Per-chunk reservoirs: the port's merged biref TM5 CBR stream is
    JAX's encode_gops_sharded(..., exact=False) byte for byte."""
    got = gops.encode_gops_sharded(frames, lambda: _enc(**CBR), n_shards=2,
                                   exact=False)
    want = j_gops.encode_gops_sharded(frames, lambda: _jenc(**CBR),
                                      n_shards=2, sequential=True,
                                      exact=False)
    assert got == want


def test_threaded_shards_from_cold_caches_load_native_once(frames,
                                                           monkeypatch):
    """Two shard threads start with every step cache empty and the native
    coder unloaded (short switch interval): the merged stream is the
    serial one, and the library is loaded once."""
    clip = frames[:8]
    serial = _enc().encode_stream(clip)
    schroedinger_tpu_torch.clear_compiled_caches()
    monkeypatch.setattr(native._Library, "_cdll", None)
    monkeypatch.setattr(native, "_lib2", None)
    loads = []
    real_cdll = ctypes.CDLL

    def counting(path, *a, **k):
        loads.append(path)
        return real_cdll(path, *a, **k)
    monkeypatch.setattr(ctypes, "CDLL", counting)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        stream = gops.encode_gops_sharded(clip, _enc, n_shards=2)
    finally:
        sys.setswitchinterval(old)
    assert stream == serial
    assert loads.count(native.LIBRARY) == 1


def _hammer(fn, n=16):
    """fn() on n threads at once (short switch interval); the results."""
    out = [None] * n
    start = threading.Barrier(n)

    def run(i):
        start.wait()
        out[i] = fn()
    threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    return out


def test_step_cache_builds_once_under_threads(monkeypatch):
    p = _enc()._params(2)
    schroedinger_tpu_torch.clear_compiled_caches()
    builds = []
    real = inter.make_p_step

    def slow_build(*a, **k):
        builds.append(1)
        time.sleep(0.01)
        return real(*a, **k)
    monkeypatch.setattr(inter, "make_p_step", slow_build)
    out = _hammer(lambda: inter.get_p_step(p, rdo_pick=True))
    assert len(builds) == 1
    assert all(o is out[0] for o in out)


def test_kernel_loader_builds_and_loads_once_under_threads(monkeypatch):
    """The ME kernel's library is built and loaded once however many
    threads reach the loader first (nvcc and the library stand in)."""
    builds, loads = [], []

    class FakeLibrary:
        me_search_launch = type("Fn", (), {})()

    def build():
        builds.append(1)
        time.sleep(0.01)
        return 0.0

    def load(path):
        loads.append(path)
        return FakeLibrary()
    monkeypatch.setattr(pr, "_lib", None)
    monkeypatch.setattr(pr, "build", build)
    monkeypatch.setattr(pr, "LIBRARY", "libpatch_refine-test.so")
    monkeypatch.setattr(ctypes, "CDLL", load)
    out = _hammer(pr._load)
    assert len(builds) == 1 and loads == ["libpatch_refine-test.so"]
    assert all(o is out[0] for o in out)
