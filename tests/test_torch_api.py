"""The port's entry points against the JAX package's on the CPU, at 96x80:
the settings registry, `api.Encoder` / `api.Decoder` for each in-scope
profile and rate mode, push/pull, what the port refuses (interlaced
coding on a VC-2 profile, deep long GOP), `y4m` and the CLI.  The other
long-GOP rate controls (the backref engine, the constant-error engines,
the allocation controller, multiquant) are held to the JAX package in
`tests/test_torch_rate_engines.py`.

The long-GOP modes run the biref engine with its B pictures batched (MD5
is off by default): lossless and vc2_main are integer paths and must be
byte-equal to the JAX encoder; the lambda-driven modes are expected
byte-equal, and are held, as float32 sums decide picks, to the bands of
`tests/test_biref_gop.py` (0.7 dB, 15 %).  Whatever the bytes, the JAX
decoder must decode the port's stream to the port decoder's planes.
"""
import io
import os

import numpy as np
import pytest
import torch

from schroedinger_tpu import api as j_api
from schroedinger_tpu import config as j_config
from schroedinger_tpu import y4m as j_y4m
from schroedinger_tpu.video_format import ChromaFormat as JChroma
from schroedinger_tpu.video_format import VideoFormat as JVideoFormat
from schroedinger_tpu_torch import api as t_api
from schroedinger_tpu_torch import config as t_config
from schroedinger_tpu_torch import y4m as t_y4m
from schroedinger_tpu_torch.slice_config import make_frames, video_format
from schroedinger_tpu_torch.tools import schro_tpu

torch.set_num_threads(1)

W, H, N = 96, 80, 7     # I, a batch of three B before a P, a tail


def _jvf():
    return JVideoFormat(width=W, height=H, clean_width=W, clean_height=H,
                        chroma_format=JChroma.C420,
                        frame_rate_numerator=25, frame_rate_denominator=1)


def _psnr(out, frames):
    vals = []
    for (y, _, _), (y0, _, _) in zip(out, frames):
        mse = np.mean((np.asarray(y, np.float64) - y0) ** 2)
        vals.append(99.0 if mse == 0 else 10 * np.log10(255.0 ** 2 / mse))
    return float(np.mean(vals))


def _same_planes(a, b):
    assert len(a) == len(b)
    for x3, y3 in zip(a, b):
        for x, y in zip(x3, y3):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_settings_table_equals_the_jax_registry():
    def rows(settings):
        return [(s.name, s.type, s.min, s.max, s.default, s.enum_list)
                for s in settings]
    assert rows(t_config.SETTINGS) == rows(j_config.SETTINGS)
    assert t_config.PROFILES == j_config.PROFILES
    t, j = t_config.EncoderConfig(), j_config.EncoderConfig()
    for s in j_config.SETTINGS:
        assert t.get(s.name) == j.get(s.name), s.name


MODES = {
    "constant_quality": (dict(), "main", False),
    "constant_lambda": (dict(rate_control="constant_lambda"), "main", False),
    "constant_bitrate": (dict(rate_control="constant_bitrate",
                              bitrate=300_000), "main", False),
    "lossless": (dict(rate_control="lossless"), "main", True),
    "vc2_main": (dict(gop_structure="intra_only"), "vc2_main", True),
}


@pytest.fixture(scope="module")
def frames():
    return make_frames(N, W, H)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_encoder_matches_jax(frames, mode):
    kw, profile, exact = MODES[mode]
    enc = t_api.Encoder(video_format(W, H), t_config.EncoderConfig(**kw),
                        device="cpu")
    assert enc.profile == profile
    stream = enc.encode_stream(frames)
    j_stream = j_api.Encoder(_jvf(), j_config.EncoderConfig(
        **kw)).encode_stream(frames)
    print(f"{mode}: port {len(stream)} bytes, JAX {len(j_stream)} bytes, "
          f"byte-equal: {stream == j_stream}")
    dec = t_api.Decoder(device="cpu")
    mine = dec.decode_stream(stream)
    assert len(mine) == N and dec.errors == [] and dec.md5_failures == []
    _same_planes(j_api.Decoder().decode_stream(stream), mine)
    if exact:
        assert stream == j_stream
    else:
        theirs = t_api.Decoder(device="cpu").decode_stream(j_stream)
        assert abs(_psnr(mine, frames) - _psnr(theirs, frames)) < 0.7
        assert abs(len(stream) - len(j_stream)) < 0.15 * len(j_stream)


def test_push_pull_equals_encode_stream(frames):
    """push_frame / pull / end_of_stream (tests/test_biref_gop.py
    test_biref_push_pull_api's drive) give encode_stream's bytes."""
    cfg = dict(gop_structure="biref", quality=7.0)
    enc = t_api.Encoder(video_format(W, H), t_config.EncoderConfig(**cfg),
                        device="cpu")
    out = bytearray()
    for f in frames:
        enc.push_frame(f)
        b = enc.pull()
        if b:
            out += b
    out += enc.end_of_stream()
    whole = t_api.Encoder(video_format(W, H), t_config.EncoderConfig(**cfg),
                          device="cpu").encode_stream(frames)
    assert bytes(out) == whole
    assert len(t_api.Decoder(device="cpu").decode_stream(whole)) == N


@pytest.mark.parametrize("kw,bit_depth,error", [
    # the VC-2 profiles code whole frames: interlaced coding is refused
    # (the JAX package fails there with a shape error, ROADMAP Queue 3)
    (dict(rate_control="low_delay", interlaced_coding=True), 8, ValueError),
    (dict(enable_noarith=True, interlaced_coding=True), 8, ValueError),
    # long GOP codes fields (tests/test_torch_interlaced*.py); what stays
    # out is deep long GOP, refused on purpose
    (dict(interlaced_coding=True), 10, NotImplementedError),
], ids=["vc2_low_delay", "vc2_simple", "interlaced"])
def test_out_of_scope_raises_not_implemented(kw, bit_depth, error):
    with pytest.raises(error, match="long-GOP profile|Queue 3"):
        t_api.Encoder(video_format(W, H, bit_depth=bit_depth),
                      t_config.EncoderConfig(**kw), device="cpu")


def test_y4m_round_trip_against_jax(frames):
    """The port's writer gives the JAX writer's bytes, and each reader
    reads the other's file back to the frames."""
    streams = []
    for mod, vf in ((t_y4m, video_format(W, H)), (j_y4m, _jvf())):
        buf = io.BytesIO()
        wr = mod.Y4MWriter(buf, vf)
        wr.write_frames(frames[:3])
        streams.append(buf.getvalue())
    assert streams[0] == streams[1]
    for mod in (t_y4m, j_y4m):
        vf, got, depth = mod.read_y4m(io.BytesIO(streams[0]))
        assert (vf.width, vf.height, depth) == (W, H, 8)
        _same_planes(list(got), frames[:3])


def test_cli_encodes_and_decodes_on_the_cpu(frames, tmp_path):
    src, drc, dst = (str(tmp_path / n) for n in ("in.y4m", "out.drc",
                                                 "out.y4m"))
    with open(src, "wb") as f:
        wr = t_y4m.Y4MWriter(f, video_format(W, H))
        wr.write_frames(frames[:5])
    schro_tpu.main(["encode", src, drc, "--profile", "longgop",
                    "--device", "cpu", "--set", "enable_md5=1"])
    schro_tpu.main(["decode", drc, dst, "--device", "cpu"])
    stream = open(drc, "rb").read()
    _, got, _ = t_y4m.read_y4m(dst)
    got = list(got)
    assert len(got) == 5 and os.path.getsize(dst) > 0
    _same_planes(got, j_api.Decoder().decode_stream(stream))
    assert _psnr(got, frames) > 25.0
