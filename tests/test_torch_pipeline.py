"""The port's PipelinedStreamDecoder against the JAX package's and against
the port's own StreamDecoder, on the CPU at 96x80.

Every stream must decode to the same planes in all three: the backref
slice (fixed quantisers, MD5), the flagship biref CBR slice (MD5), a
stream with batched B pictures (bench.py's configuration, no MD5), and a
JAX stream with per-codeblock quantisers (`enable_multiquant=True`),
which the packed path sends to the per-picture path (`_Fallback`).  A
stream with one corrupted byte must end in the same MD5 failures and
picture errors in all three.
"""
import numpy as np
import pytest
import torch

from schroedinger_tpu.decoder import pipeline as j_pipe
from schroedinger_tpu.encoder import gop as j_gop
from schroedinger_tpu_torch import bitstream as bs
from schroedinger_tpu_torch.decoder import core as t_core
from schroedinger_tpu_torch.decoder import pipeline as t_pipe
from schroedinger_tpu_torch.encoder import gop as t_gop
from schroedinger_tpu_torch.slice_config import (CONFIG, CONFIG_BENCH,
                                                 CONFIG_FLAGSHIP,
                                                 make_frames, video_format)

torch.set_num_threads(1)

W, H = 96, 80
SMALL = dict(bitrate=500_000, gop_length=8)


@pytest.fixture(scope="module")
def streams():
    frames = make_frames(9, W, H)
    vf = video_format(W, H)
    out = {name: t_gop.GopEncoder(vf, device="cpu", **cfg).encode_stream(
        frames[:n])
        for name, cfg, n in (
            ("backref", CONFIG, 5),
            ("flagship", dict(CONFIG_FLAGSHIP, **SMALL), 9),
            ("b_batch", dict(CONFIG_BENCH, **SMALL), 9))}
    # test_multiquant_picks_per_codeblock_quants's stream: left half flat,
    # right half busy, small codeblocks, CBR on the backref engine, so
    # that the inter pictures' quantisers vary per codeblock
    rng = np.random.default_rng(5)
    yy, xx = np.mgrid[0:H, 0:W]
    y0 = np.where(xx < W // 2, 128,
                  128 + 90 * np.sin(xx * 1.1) * np.cos(yy * 0.9))
    flat = np.full((H // 2, W // 2), 128, np.uint8)
    mq_frames = [((np.roll(y0, i, axis=1) + rng.normal(0, 2, (H, W))).clip(
        0, 255).astype(np.uint8), flat, flat) for i in range(4)]
    out["multiquant"] = j_gop.GopEncoder(
        vf, enable_multiquant=True, codeblock_size="small",
        gop_structure="backref", gop_length=8, bitrate=400000, fps=25,
        enable_md5=True).encode_stream(mq_frames)
    bad = bytearray(out["backref"])
    bad[len(bad) // 2] ^= 0xFF          # one arith payload byte
    out["corrupted"] = bytes(bad)
    return out


def _decode_all(stream):
    port = t_pipe.PipelinedStreamDecoder(device="cpu")
    fallbacks = []
    orig = port.decode_picture_unit

    def counted(code, payload):
        fallbacks.append(code)
        return orig(code, payload)
    port.decode_picture_unit = counted
    base = t_core.StreamDecoder(device="cpu")
    jax = j_pipe.PipelinedStreamDecoder()
    outs = [d.decode_stream(stream) for d in (port, base, jax)]
    return (port, base, jax), outs, fallbacks


@pytest.mark.parametrize("name", ["backref", "flagship", "b_batch",
                                  "multiquant", "corrupted"])
def test_pipelined_decoder_matches(streams, name):
    decs, outs, fallbacks = _decode_all(streams[name])
    n = {"backref": 5, "multiquant": 4}.get(name, 9)
    for out in outs[1:]:
        assert len(out) == len(outs[0])
        for a, b in zip(outs[0], out):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, np.asarray(y))
    port, base, jax = decs
    assert port.md5_failures == base.md5_failures == jax.md5_failures
    assert ([e["kind"] for e in port.errors]
            == [e["kind"] for e in base.errors]
            == [e["kind"] for e in jax.errors])
    if name == "corrupted":
        assert port.md5_failures or port.errors or len(outs[0]) < 5
        return
    assert len(outs[0]) == n and port.errors == []
    assert port.md5_failures == []
    if name == "multiquant":
        # per-codeblock quantisers: those pictures go per picture
        assert fallbacks, "no picture took the per-picture path"
    else:
        assert fallbacks == []


def test_pipelined_decoder_keeps_the_telemetry_overlay_out(streams):
    """With the telemetry overlay on, the packed path is kept out: every
    picture goes per picture, as in the JAX decoder, and the output
    equals StreamDecoder's telemetry decode.  The MD5s hold (checked on
    the clean pictures), the overlay marks each inter picture's luma
    only, and the intra pictures come out clean."""
    stream = streams["flagship"]
    port = t_pipe.PipelinedStreamDecoder(telemetry=True, device="cpu")
    fallbacks = []
    orig = port.decode_picture_unit

    def counted(code, payload):
        fallbacks.append(code)
        return orig(code, payload)
    port.decode_picture_unit = counted
    got = port.decode_stream(stream)
    base = t_core.StreamDecoder(telemetry=True, device="cpu")
    want = base.decode_stream(stream)
    clean = t_core.StreamDecoder(device="cpu").decode_stream(stream)
    assert len(fallbacks) == len(got) == len(want) == len(clean) == 9
    assert port.md5_failures == base.md5_failures == []
    assert port.errors == []
    kinds = {int.from_bytes(p[:4], "big"): bs.num_refs(c)
             for c, p in bs.split_units(stream) if bs.is_picture(c)}
    for num, (a, b, c) in enumerate(zip(got, want, clean)):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(a[1], c[1])
        np.testing.assert_array_equal(a[2], c[2])
        assert np.array_equal(a[0], c[0]) == (kinds[num] == 0)
