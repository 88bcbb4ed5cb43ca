"""Interlaced (field) coding on the backref engine: the port's
`api.Encoder` against the JAX package's on the CPU, at 96x80 (96x40
fields), 3 frames of pan + noise.

Each stream is byte-identical to the JAX encoder's: constant quality
bottom field first (4:2:0), and TM5 CBR with MD5 on 4:2:2 (chroma fields
of 48x40).  The sequence header carries the field order, the port's
`Decoder` weaves the fields into the JAX `Decoder`'s frames, and the
GopEncoder takes an interlaced format directly.  The biref engine's
cases are in `tests/test_torch_interlaced.py`; the JAX references are
built once per module.
"""
import dataclasses

import numpy as np
import pytest
import torch

from tests import jax_cache  # noqa: F401 (turns the disk cache on)
from schroedinger_tpu import api as j_api
from schroedinger_tpu import config as j_config
from schroedinger_tpu.encoder import gop as j_gop
from schroedinger_tpu.video_format import ChromaFormat as JChroma
from schroedinger_tpu.video_format import VideoFormat as JVideoFormat
from schroedinger_tpu_torch import api as t_api
from schroedinger_tpu_torch import bitstream as bs
from schroedinger_tpu_torch import config as t_config
from schroedinger_tpu_torch.coding.bitio import BitReader
from schroedinger_tpu_torch.encoder import gop as t_gop
from schroedinger_tpu_torch.slice_config import make_frames, video_format
from schroedinger_tpu_torch.video_format import ChromaFormat

torch.set_num_threads(1)

W, H, N = 96, 80, 3
# name: (config, top field first, 4:2:2)
CASES = {
    "quality_bff": (dict(gop_structure="backref", interlaced_coding=1),
                    False, False),
    "cbr_md5_422": (dict(gop_structure="backref", interlaced_coding=1,
                         rate_control="constant_bitrate", bitrate=400_000,
                         enable_md5=1), True, True),
}


def _tvf(tff, c422):
    cf = ChromaFormat.C422 if c422 else ChromaFormat.C420
    return dataclasses.replace(video_format(W, H, cf), interlaced=True,
                               top_field_first=tff)


def _jvf(tff, c422):
    return JVideoFormat(width=W, height=H, clean_width=W, clean_height=H,
                        chroma_format=JChroma.C422 if c422 else JChroma.C420,
                        frame_rate_numerator=25, frame_rate_denominator=1,
                        interlaced=True, top_field_first=tff)


def _frames(c422):
    return make_frames(N, W, H, chroma_format=ChromaFormat.C422 if c422
                       else ChromaFormat.C420)


@pytest.fixture(scope="module")
def streams():
    out = {}
    for name, (kw, tff, c422) in CASES.items():
        frames = _frames(c422)
        enc = t_api.Encoder(_tvf(tff, c422), t_config.EncoderConfig(**kw),
                            device="cpu")
        j_stream = j_api.Encoder(_jvf(tff, c422), j_config.EncoderConfig(
            **kw)).encode_stream(frames)
        out[name] = (enc.encode_stream(frames), j_stream, enc, frames)
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_stream_equals_jax(streams, name):
    stream, j_stream, enc, _ = streams[name]
    _, tff, c422 = CASES[name]
    assert stream == j_stream
    assert enc._gop.gop_structure == "backref" and enc._gop.field_factor == 2
    kinds = [(int.from_bytes(p[:4], "big"), bs.num_refs(c))
             for c, p in bs.split_units(stream) if bs.is_picture(c)]
    # both fields of the access unit's frame intra (the GOP counts
    # frames), every later field a P from the field before it
    assert kinds == [(0, 0), (1, 0)] + [(n, 1) for n in range(2, 2 * N)]
    for code, payload in bs.split_units(stream):
        if code == bs.SEQUENCE_HEADER:
            vf = bs.read_sequence_header(BitReader(payload)).video_format
            assert vf.interlaced and vf.interlaced_coding
            assert vf.top_field_first == tff
            assert vf.picture_chroma_size() == (W // 2, H // 2 if c422
                                                else H // 4)
            break


@pytest.mark.parametrize("name", sorted(CASES))
def test_decoder_weaves_as_jax(streams, name):
    stream, _, _, frames = streams[name]
    dec = t_api.Decoder(device="cpu")
    mine = dec.decode_stream(stream)
    assert len(mine) == N and dec.errors == [] and dec.md5_failures == []
    jdec = j_api.Decoder()
    theirs = jdec.decode_stream(stream)
    assert jdec.md5_failures == []
    assert len(theirs) == N
    for m3, t3, f3 in zip(mine, theirs, frames):
        for m, t, f in zip(m3, t3, f3):
            assert m.shape == f.shape
            np.testing.assert_array_equal(m, np.asarray(t))
        mse = np.mean((m3[0].astype(np.float64) - f3[0]) ** 2)
        assert 10 * np.log10(255.0 ** 2 / mse) > 28


def test_gop_encoder_takes_interlaced_formats():
    """GopEncoder on an interlaced format directly (as bench.py would
    build it): the JAX encoder's stream, frame by frame."""
    frames = _frames(False)
    vf = dataclasses.replace(_tvf(True, False), interlaced_coding=True)
    jvf = _jvf(True, False)
    jvf.interlaced_coding = True
    kw = dict(base_qi_intra=12, base_qi_inter=16)
    tenc = t_gop.GopEncoder(vf, device="cpu", **kw)
    jenc = j_gop.GopEncoder(jvf, **kw)
    for f in frames:
        assert tenc.encode_frame(f) == jenc.encode_frame(f)
    assert tenc.frame_number == jenc.frame_number == 2 * N
