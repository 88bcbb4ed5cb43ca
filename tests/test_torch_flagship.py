"""The flagship slice as a whole against the JAX package on the CPU, at
96x80: the biref engine (I, one- and two-reference P, subgroups of three
two-reference B pictures) under TM5 CBR with the on-device RD pick and
MD5 aux units, 17 frames across two access units.

Float32 sums decide quantiser picks, and XLA and torch may take them in
another order, so whole CBR streams are held in bands, not bytes: luma
PSNR within 0.7 dB and stream bytes within 15 % of the JAX encoder's.
What crosses a package boundary exactly is checked exactly: the JAX
decoder accepts the port's stream with every MD5 matching, the port
decodes the JAX stream to the JAX decoder's planes, and from identical
state (convert.load_encoder_state) the next subgroup codes to the same
bytes.
"""
import numpy as np
import pytest
import torch

from tests import jax_cache  # noqa: F401 (turns the disk cache on)
from schroedinger_tpu import bitstream as j_bs
from schroedinger_tpu.decoder import core as j_core
from schroedinger_tpu.encoder import gop as j_gop
from schroedinger_tpu_torch import convert
from schroedinger_tpu_torch.decoder import core as t_core
from schroedinger_tpu_torch.encoder import gop as t_gop
from schroedinger_tpu_torch.slice_config import (CONFIG_FLAGSHIP,
                                                 make_frames, video_format)

torch.set_num_threads(1)

W, H, N = 96, 80, 17
# the flagship's options at a size and rate where the controller binds:
# two access units in 17 frames (a two-reference P needs three subgroups
# in one), 500 kbit/s
CFG = dict(CONFIG_FLAGSHIP, bitrate=500_000, gop_length=12)
# a reservoir below 0.7 engages the per-picture lambda fit (target > 0)
CFG_FIT = dict(CFG, buffer_size=2_000_000, buffer_level=600_000)
# at 20 kbit/s with a half-empty reservoir a P picture's allocation is
# less than its cost at the controller's lambda: the fit binds (settles
# on a scale well below 1)
CFG_BIND = dict(CFG, bitrate=20_000, buffer_level=30_000)


@pytest.fixture(scope="module")
def frames():
    return make_frames(N, W, H)


@pytest.fixture(scope="module")
def jax_run(frames):
    enc = j_gop.GopEncoder(video_format(W, H), **CFG)
    return enc, enc.encode_stream(frames)


@pytest.fixture(scope="module")
def port_run(frames):
    enc = t_gop.GopEncoder(video_format(W, H), device="cpu", **CFG)
    return enc, enc.encode_stream(frames)


def _kinds(stream):
    """Coded-order (picture number, references, is reference)."""
    return [(int.from_bytes(pl[:4], "big"), j_bs.num_refs(c),
             j_bs.is_reference(c))
            for c, pl in j_bs.split_units(stream) if j_bs.is_picture(c)]


def _mean_psnr(out, frames):
    vals = []
    for (y, _, _), (y0, _, _) in zip(out, frames):
        mse = np.mean((y.astype(np.float64) - y0) ** 2)
        vals.append(99.0 if mse == 0 else 10 * np.log10(255.0 ** 2 / mse))
    return float(np.mean(vals)), float(np.min(vals))


def test_port_stream_structure(port_run, jax_run):
    kinds = _kinds(port_run[1])
    assert kinds == _kinds(jax_run[1])
    assert [k[0] for k in kinds] == [0, 4, 1, 2, 3, 8, 5, 6, 7, 12, 9, 10,
                                     11, 16, 13, 14, 15]
    # I, one-reference P (only the I to lean on), B B B, two-reference P
    # (previous P + the long-term I), B B B, the next access unit's I ...
    assert [k[1] for k in kinds] == [0, 1, 2, 2, 2, 2, 2, 2, 2, 0, 2, 2, 2,
                                     1, 2, 2, 2]
    assert [k[0] for k in kinds if k[2]] == [0, 4, 8, 12, 16]
    # the stream opens with the sequence header and the two aux units
    codes = [c for c, _ in j_bs.split_units(port_run[1])]
    assert codes[:3] == [j_bs.SEQUENCE_HEADER, j_bs.AUXILIARY_DATA,
                         j_bs.AUXILIARY_DATA]


def test_jax_decoder_accepts_port_stream_within_bands(port_run, jax_run,
                                                      frames):
    dec = j_core.StreamDecoder()
    out = dec.decode_stream(port_run[1])
    assert dec.md5_failures == [] and dec.errors == []
    assert len(out) == N
    jdec = j_core.StreamDecoder()
    jout = jdec.decode_stream(jax_run[1])
    assert jdec.md5_failures == [] and len(jout) == N
    p_port, min_port = _mean_psnr(out, frames)
    p_jax, _ = _mean_psnr(jout, frames)
    assert min_port > 30
    assert abs(p_port - p_jax) < 0.7, (p_port, p_jax)
    assert abs(len(port_run[1]) - len(jax_run[1])) < 0.15 * len(jax_run[1])
    # the rate trajectory, picture by picture, in the same bands
    for a, b in zip(port_run[0].stats.frames, jax_run[0].stats.frames):
        assert a["frame"] == b["frame"]
        assert abs(a["bits"] - b["bits"]) <= 0.15 * b["bits"] + 64
        assert a["buffer_level"] == pytest.approx(b["buffer_level"],
                                                  rel=0.02)


def test_port_decoder_matches_jax_decoder_on_jax_stream(jax_run):
    """Two-reference patch render, reference retirement in decode order
    and presentation reorder of the B pictures: the JAX decoder's planes."""
    want = j_core.StreamDecoder().decode_stream(jax_run[1])
    tdec = t_core.StreamDecoder(device="cpu")
    got = tdec.decode_stream(jax_run[1])
    assert tdec.md5_failures == [] and tdec.errors == []
    assert len(got) == len(want) == N
    for n, (g3, w3) in enumerate(zip(got, want)):
        for g, w_, name in zip(g3, w3, "yuv"):
            np.testing.assert_array_equal(g, w_, err_msg=f"{n} {name}")
    coded = t_core.StreamDecoder(device="cpu").decode_stream(
        jax_run[1], presentation_order=False)
    assert not all(np.array_equal(a[0], b[0]) for a, b in zip(coded, got))


def test_subgroup_from_identical_state_codes_the_same_bytes(frames):
    """Both encoders brought to the same state (controller, correction
    tables, overhead EMAs, reference buffer) after 5 frames of a JAX
    encode with the lambda fit engaged: the next two subgroups (a
    two-reference P and three B, then the next access unit's I and three
    B) code to the same units, and the controllers end in the same
    state."""
    vf = video_format(W, H)
    jenc = j_gop.GopEncoder(vf, **CFG_FIT)
    for planes in frames[:5]:
        jenc.encode_frame(planes)
    jenc.flush()
    tenc = t_gop.GopEncoder(vf, device="cpu", **CFG_FIT)
    convert.load_encoder_state(tenc, jenc, device="cpu")
    assert vars(tenc.rc) == vars(jenc.rc)
    assert tenc._quant_args("P")["target_bits"] > 0      # the fit is on
    got, want = bytearray(), bytearray()
    for planes in frames[5:13]:
        got += tenc.encode_frame(planes)
        want += jenc.encode_frame(planes)
    got += tenc.flush()
    want += jenc.flush()
    assert [k[:2] for k in _kinds(bytes(want))] == [
        (8, 2), (5, 2), (6, 2), (7, 2), (12, 0), (9, 2), (10, 2), (11, 2)]
    assert bytes(got) == bytes(want)
    assert vars(tenc.rc) == vars(jenc.rc)
    # the correction ratios divide by the float32 bit estimates, which
    # agree between the packages to the tables' tolerance, not exactly
    np.testing.assert_allclose(tenc.acorr.inter, jenc.acorr.inter, rtol=2e-6)
    np.testing.assert_allclose(tenc.acorr.intra, jenc.acorr.intra, rtol=2e-6)
    assert tenc._oh_inter == jenc._oh_inter
    assert tenc._last_max_qi == jenc._last_max_qi


def test_binding_fit_stream_within_bands_of_jax(frames):
    """A draining reservoir at a rate the content cannot meet: the
    22-step lambda fit binds in the port as in the JAX encoder, picture by
    picture, and the JAX decoder accepts the port's stream."""
    vf = video_format(W, H)
    tenc = t_gop.GopEncoder(vf, device="cpu", **CFG_BIND)
    got = tenc.encode_stream(frames[:9])
    jenc = j_gop.GopEncoder(vf, **CFG_BIND)
    want = jenc.encode_stream(frames[:9])
    inter = [f for f in tenc.stats.frames if not f["intra"]]
    assert all(f["target_bits"] > 0 for f in inter)
    bound = [f["frame"] for f in inter if f["lam_scale"] < 0.99]
    assert {4, 8} <= set(bound), bound            # both P pictures
    assert all(0 < f["lam_scale"] <= 1.0 for f in inter)
    assert abs(len(got) - len(want)) < 0.15 * len(want)
    for a, b in zip(tenc.stats.frames, jenc.stats.frames):
        assert a["frame"] == b["frame"]
        assert abs(a["bits"] - b["bits"]) <= 0.15 * b["bits"] + 64
        assert a["buffer_level"] == pytest.approx(b["buffer_level"],
                                                  rel=0.02, abs=256)
    dec = j_core.StreamDecoder()
    out = dec.decode_stream(got)
    assert len(out) == 9 and dec.md5_failures == [] and dec.errors == []


@pytest.mark.parametrize("open_gop,max_refs", [(True, 3), (False, 3),
                                              (True, 2)])
def test_fixed_quantiser_biref_matches_jax(frames, open_gop, max_refs):
    """The biref engine without a controller (fixed base indices) is
    integer all the way, so the stream is the JAX encoder's byte for
    byte: open and closed GOP, a scene cut at the head of a subgroup and
    one in its middle, the forced retire of a two-deep reference buffer."""
    cfg = dict(gop_structure="biref", mv_precision=2, gop_length=8,
               enable_md5=True, enable_b_batch=False, open_gop=open_gop,
               max_refs=max_refs)
    # cuts: frame 5 opens a subgroup, frame 11 falls inside one
    flipped = [tuple(np.ascontiguousarray(pl[::-1, ::-1]) for pl in f)
               for f in frames]
    seq = frames[:5] + flipped[5:11] + frames[11:14]
    vf = video_format(W, H)
    tenc = t_gop.GopEncoder(vf, device="cpu", **cfg)
    got = tenc.encode_stream(seq)
    want = j_gop.GopEncoder(vf, **cfg).encode_stream(seq)
    assert got == want
    intra = [f["frame"] for f in tenc.stats.frames if f["intra"]]
    assert {0, 5, 11} <= set(intra), intra       # both cuts became I
    dec = t_core.StreamDecoder(device="cpu")
    out = dec.decode_stream(got)
    assert len(out) == len(seq) and dec.md5_failures == []


def test_noarith_cbr_stream_matches_jax(frames):
    """The flagship under TM5 CBR with enable_noarith=True: its intra
    pictures take the unfused RD branch (the fused step codes arith only:
    stat tables, a host RD pick at the intra lambda, the arith-correction
    update from the coded band bits), the inter pictures VLC residuals
    and MVs.  Byte for byte the JAX encoder's stream, and the port's
    decoders read it to the JAX decoder's planes, every MD5 matching."""
    cfg = dict(CFG, enable_noarith=True)
    vf = video_format(W, H)
    tenc = t_gop.GopEncoder(vf, device="cpu", **cfg)
    got = tenc.encode_stream(frames[:9])
    jenc = j_gop.GopEncoder(vf, **cfg)
    assert got == jenc.encode_stream(frames[:9])
    # the ratios rest on the float32 stat tables (held to 2e-6)
    np.testing.assert_allclose(tenc.acorr.intra, jenc.acorr.intra,
                               rtol=2e-6)
    assert [k[1] for k in _kinds(got)] == [0, 1, 2, 2, 2, 2, 2, 2, 2]
    want = j_core.StreamDecoder().decode_stream(got)
    dec = t_core.StreamDecoder(device="cpu")
    out = dec.decode_stream(got)
    assert dec.md5_failures == [] and dec.errors == []
    for g3, w3 in zip(out, want):
        for g, w in zip(g3, w3):
            np.testing.assert_array_equal(g, w)
