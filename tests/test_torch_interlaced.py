"""Interlaced (field) coding on the biref engine: the port's `api.Encoder`
against the JAX package's on the CPU, at 96x80 4:2:0 (96x40 fields), 3
frames of pan + noise top field first (6 field pictures: I, a P, a batch
of three B pictures, a P).

Every stream is byte-identical to the JAX encoder's: TM5 CBR at 400
kbit/s with the B pictures batched, and with MD5 (B pictures one at a
time); push_frame / pull gives encode_stream's bytes; the port's
`Decoder` weaves the fields into the JAX `Decoder`'s frames (an unpaired
last field dropped in both); the VC-2 profiles refuse interlaced coding
in both packages (the JAX package with a shape error, ROADMAP.md Queue
3; the port with its own ValueError).  The backref engine, bottom field
first and 4:2:2 are in `tests/test_torch_interlaced_backref.py`.  The JAX
references are built once per module.
"""
import dataclasses

import numpy as np
import pytest
import torch

from schroedinger_tpu import api as j_api
from schroedinger_tpu import config as j_config
from schroedinger_tpu.video_format import ChromaFormat as JChroma
from schroedinger_tpu.video_format import VideoFormat as JVideoFormat
from schroedinger_tpu_torch import api as t_api
from schroedinger_tpu_torch import bitstream as bs
from schroedinger_tpu_torch import config as t_config
from schroedinger_tpu_torch.coding.bitio import BitReader
from schroedinger_tpu_torch.decoder.core import StreamDecoder
from schroedinger_tpu_torch.frontends import weave_fields
from schroedinger_tpu_torch.slice_config import make_frames, video_format

torch.set_num_threads(1)

W, H, N = 96, 80, 3
CBR = dict(rate_control="constant_bitrate", bitrate=400_000,
           interlaced_coding=1, mv_precision=2)
CASES = {"cbr": CBR, "cbr_md5": dict(CBR, enable_md5=1)}


def _tvf():
    return dataclasses.replace(video_format(W, H), interlaced=True,
                               top_field_first=True)


def _jvf():
    return JVideoFormat(width=W, height=H, clean_width=W, clean_height=H,
                        chroma_format=JChroma.C420,
                        frame_rate_numerator=25, frame_rate_denominator=1,
                        interlaced=True, top_field_first=True)


def _same_planes(a, b):
    assert len(a) == len(b)
    for x3, y3 in zip(a, b):
        for x, y in zip(x3, y3):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.fixture(scope="module")
def frames():
    return make_frames(N, W, H)


@pytest.fixture(scope="module")
def jax_streams(frames):
    return {name: j_api.Encoder(_jvf(), j_config.EncoderConfig(
        **kw)).encode_stream(frames) for name, kw in CASES.items()}


@pytest.fixture(scope="module")
def port_streams(frames):
    out = {}
    for name, kw in CASES.items():
        enc = t_api.Encoder(_tvf(), t_config.EncoderConfig(**kw),
                            device="cpu")
        batches = []
        orig = enc._gop._start_b_batch

        def recording(bs_, orig=orig, batches=batches):
            got = orig(bs_)
            batches.append(([b[0] for b in bs_], got is not None))
            return got
        enc._gop._start_b_batch = recording
        out[name] = (enc.encode_stream(frames), batches, enc)
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_stream_equals_jax(port_streams, jax_streams, name):
    stream, batches, enc = port_streams[name]
    assert stream == jax_streams[name]
    # six field pictures, numbered 2n and 2n+1; one subgroup of three B
    # fields, batched unless MD5 wants their reconstructions
    nums = [int.from_bytes(p[:4], "big")
            for c, p in bs.split_units(stream) if bs.is_picture(c)]
    assert sorted(nums) == list(range(2 * N))
    assert batches == [([1, 2, 3], name == "cbr")]
    assert enc._gop.field_factor == 2
    assert enc._gop.rc.bits_per_picture == CBR["bitrate"] / 25 / 2
    # the sequence header carries the flags api.Encoder set on the format
    for code, payload in bs.split_units(stream):
        if code == bs.SEQUENCE_HEADER:
            vf = bs.read_sequence_header(BitReader(payload)).video_format
            assert vf.interlaced and vf.interlaced_coding
            assert vf.top_field_first
            assert vf.picture_luma_size() == (W, H // 2)
            break


def test_push_pull_equals_encode_stream(port_streams, frames):
    enc = t_api.Encoder(_tvf(), t_config.EncoderConfig(**CBR), device="cpu")
    out = bytearray()
    for f in frames:
        enc.push_frame(f)
        out += enc.pull() or b""
    out += enc.end_of_stream()
    assert bytes(out) == port_streams["cbr"][0]
    assert enc.frame_number == N and enc._gop.frame_number == 2 * N


def _cut(stream, n_pictures):
    """The stream's sequence header and first n picture units, with an
    end of sequence."""
    units, pics = [], 0
    for code, payload in bs.split_units(stream):
        if bs.is_picture(code):
            if pics == n_pictures:
                continue
            pics += 1
        if code == bs.END_OF_SEQUENCE:
            continue
        w = bs.BitWriter()
        bs.write_parse_info(w, code)
        units.append(w.get_bytes() + payload)
    units.append(bs.make_eos_unit())
    return bs.fixup_offsets(units)


@pytest.mark.parametrize("name", sorted(CASES))
def test_decoder_weaves_as_jax(port_streams, frames, name):
    stream = port_streams[name][0]
    dec = t_api.Decoder(device="cpu")
    mine = dec.decode_stream(stream)
    assert len(mine) == N and dec.errors == [] and dec.md5_failures == []
    assert mine[0][0].shape == (H, W) and mine[0][1].shape == (H // 2, W // 2)
    _same_planes(mine, j_api.Decoder().decode_stream(stream))
    fields = StreamDecoder(device="cpu").decode_stream(stream)
    _same_planes(mine, [weave_fields(fields[2 * i], fields[2 * i + 1])
                        for i in range(N)])
    for (y, _, _), (y0, _, _) in zip(mine, frames):
        mse = np.mean((y.astype(np.float64) - y0) ** 2)
        assert 10 * np.log10(255.0 ** 2 / mse) > 28
    # an unpaired last field is dropped by both decoders (coded order I0
    # P4 B1 B2 B3: fields 0-3 pair up, field 4 stands alone)
    cut = _cut(stream, 5)
    got = t_api.Decoder(device="cpu").decode_stream(cut)
    assert len(got) == 2
    _same_planes(got, j_api.Decoder().decode_stream(cut))


@pytest.mark.parametrize("kw", [
    dict(rate_control="low_delay"), dict(enable_noarith=True),
    dict(gop_structure="intra_only")],
    ids=["vc2_low_delay", "vc2_simple", "vc2_main"])
def test_vc2_profiles_refuse_interlaced_coding(frames, kw):
    """Only the long-GOP encoder splits frames into fields: the JAX VC-2
    encoders fail with a shape error (ROADMAP.md Queue 3), the port
    refuses at construction and leaves the caller's format as it was."""
    with pytest.raises(ValueError, match="negative values"):
        j_api.Encoder(_jvf(), j_config.EncoderConfig(
            interlaced_coding=True, **kw)).encode_stream(frames[:1])
    vf = video_format(W, H)
    with pytest.raises(ValueError, match="long-GOP profile"):
        t_api.Encoder(vf, t_config.EncoderConfig(interlaced_coding=True,
                                                 **kw), device="cpu")
    assert not vf.interlaced and not vf.interlaced_coding
