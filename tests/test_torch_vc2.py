"""The VC-2 profiles of the port against the JAX package on the CPU: the
s32 (deep) wavelet, the exact sint bit count, the low-delay analysis,
low-delay streams at 8, 10 and 12 bits in 4:2:0 and 4:2:2 (the "table"
and "direct" host halves), a lossless low-delay round trip, vc2_simple
(no-arith intra), deep vc2_main intra, the decoders on the JAX streams
and the CLI's default encode.

Every stage here is integer, so everything is held exactly: streams byte
for byte, planes and analysis outputs with torch.equal.  Inputs are
pan + noise frames from a numpy seed (`slice_config.make_frames`).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from schroedinger_tpu import api as j_api
from schroedinger_tpu import config as j_config
from schroedinger_tpu import pipeline as j_pipe
from schroedinger_tpu.decoder import core as j_core
from schroedinger_tpu.encoder import lowdelay as j_loe
from schroedinger_tpu.ops import wavelet as j_wv
from schroedinger_tpu.video_format import ChromaFormat as JChroma
from schroedinger_tpu.video_format import VideoFormat as JVideoFormat
from schroedinger_tpu.wavelets import MAX_DEPTH_S16, Wavelet
from schroedinger_tpu_torch import api as t_api
from schroedinger_tpu_torch import bitstream as t_bs
from schroedinger_tpu_torch import config as t_config
from schroedinger_tpu_torch import pipeline as t_pipe
from schroedinger_tpu_torch import y4m as t_y4m
from schroedinger_tpu_torch.coding import slices as t_sl
from schroedinger_tpu_torch.coding.bitio import BitReader
from schroedinger_tpu_torch.decoder import core as t_core
from schroedinger_tpu_torch.encoder import lowdelay as t_loe
from schroedinger_tpu_torch.ops import wavelet as t_wv
from schroedinger_tpu_torch.slice_config import make_frames, video_format
from schroedinger_tpu_torch.tools import schro_tpu
from schroedinger_tpu_torch.video_format import ChromaFormat

torch.set_num_threads(1)

W, H, N = 96, 80, 3
# the CLI's low-delay settings (LeGall 5,3, default slices and bitrate)
# at depth 3, which these picture sizes divide into slices
LD = dict(rate_control="low_delay", transform_depth=3, intra_wavelet=1)


def _formats(chroma, bit_depth):
    tvf = video_format(W, H, getattr(ChromaFormat, chroma), bit_depth)
    jvf = JVideoFormat(**{f: getattr(tvf, f) for f in (
        "width", "height", "clean_width", "clean_height",
        "frame_rate_numerator", "frame_rate_denominator", "luma_offset",
        "luma_excursion", "chroma_offset", "chroma_excursion")},
        chroma_format=getattr(JChroma, chroma))
    return tvf, jvf


def _frames(chroma, bit_depth, n=N):
    return make_frames(n, W, H, chroma_format=getattr(ChromaFormat, chroma),
                       bit_depth=bit_depth)


def _same_planes(got, want):
    assert len(got) == len(want)
    for g3, w3 in zip(got, want):
        for g, w in zip(g3, w3):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def _bands(pyr, depth):
    return t_sl.subband_arrays(pyr, depth)


_J_FORWARD = jax.jit(j_wv.forward, static_argnums=(1, 2))
_J_INVERSE = jax.jit(j_wv.inverse, static_argnums=1)


@pytest.mark.parametrize("bit_depth", [10, 12, 16])
@pytest.mark.parametrize("wavelet", list(Wavelet))
def test_s32_wavelet_matches_jax(wavelet, bit_depth):
    """The int32 lifting at MAX_DEPTH_S16, forward and inverse, on
    full-range unsigned samples (the deep path does not recentre), the
    extremes included.  The pyramid holds every level's subbands, so
    depths 1 to MAX_DEPTH_S16 are all compared; the inverse must give
    the input back."""
    rng = np.random.default_rng(100 * int(wavelet) + bit_depth)
    top = (1 << bit_depth) - 1
    x = rng.integers(0, top + 1, (64, 64)).astype(np.int32)
    x[:4] = top
    x[4:8] = 0
    x[8:12, ::2] = top
    depth = MAX_DEPTH_S16[wavelet]
    tp = t_wv.forward(torch.as_tensor(x), depth, wavelet)
    jp = _J_FORWARD(jnp.asarray(x), depth, wavelet)
    for tb, jb in zip(_bands(tp, depth), _bands(jp, depth)):
        assert tb.dtype == torch.int32
        assert torch.equal(tb, torch.as_tensor(np.array(jb)))
    back = t_wv.inverse(tp, wavelet)
    assert torch.equal(back, torch.as_tensor(np.array(_J_INVERSE(jp,
                                                                 wavelet))))
    assert torch.equal(back, torch.as_tensor(x))


def test_sint_bits_exact_at_the_edges():
    """The port has no clz: its bit length must still equal the JAX
    32 - clz(|v| + 1) at 0, +-1, 2^k - 1, 2^k, 2^k + 1 and the int32
    extremes (where |v| + 1 wraps)."""
    ks = np.arange(1, 31, dtype=np.int64)
    mags = np.concatenate([[0, 1, 2, 3], 2 ** ks - 1, 2 ** ks, 2 ** ks + 1,
                           [2 ** 31 - 2, 2 ** 31 - 1]])
    v = np.concatenate([mags, -mags, [-2 ** 31]]).astype(np.int32)
    want = np.asarray(j_pipe._sint_bits_jnp(jnp.asarray(v)))
    got = t_pipe._sint_bits(torch.as_tensor(v))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("chroma,bit_depth", [("C420", 8), ("C422", 10),
                                              ("C444", 16)])
def test_lowdelay_analysis_matches_jax(chroma, bit_depth):
    """make_lowdelay_analyze: slice arrays, per-base bit sums and last
    nonzero positions, torch.equal to the JAX program; the base loop in
    chunks gives the same integers as one base at a time."""
    tvf, jvf = _formats(chroma, bit_depth)
    planes = _frames(chroma, bit_depth, 1)[0]
    tp = t_api.Encoder(tvf, t_config.EncoderConfig(**LD),
                       device="cpu").params
    jp = j_api.Encoder(jvf, j_config.EncoderConfig(**LD)).params
    want = j_pipe.make_lowdelay_analyze(jp)(*[jnp.asarray(p)
                                              for p in planes])
    want = [np.asarray(a) for a in want[:3]] + [
        np.asarray(a) for agg in want[3:] for a in agg]
    analyze = t_pipe.make_lowdelay_analyze(tp)
    old = t_pipe.PASS_ELEMS
    try:
        for budget in (old, 1):          # all bases at once; one a pass
            t_pipe.PASS_ELEMS = budget
            got = analyze(*t_pipe.planes_to_device(planes, bit_depth,
                                                   "cpu"))
            got = list(got[:3]) + [a for agg in got[3:] for a in agg]
            assert got[0].dtype == (torch.int32 if bit_depth > 8
                                    else torch.int16)
            for g, w in zip(got, want):
                assert torch.equal(g, torch.from_numpy(np.array(w)))
    finally:
        t_pipe.PASS_ELEMS = old
    assert (want[3] > 0).all() and (want[4] >= 0).any()


@pytest.mark.parametrize("chroma,bit_depth", [("C420", 8), ("C422", 8),
                                              ("C422", 10), ("C420", 12)])
def test_lowdelay_stream_matches_jax(chroma, bit_depth):
    """api.Encoder(low_delay): the port's stream is the JAX encoder's
    byte for byte on both host halves; every picture unit is its headers
    plus its slice budgets; the port's decoders give the JAX decoder's
    planes on the JAX stream, u16 when deep, without a recentring
    offset."""
    tvf, jvf = _formats(chroma, bit_depth)
    frames = _frames(chroma, bit_depth)
    want = j_api.Encoder(jvf, j_config.EncoderConfig(**LD)).encode_stream(
        frames)
    streams = []
    for path in ("table", "direct"):
        enc = t_api.Encoder(tvf, t_config.EncoderConfig(**LD), device="cpu")
        enc.ld_path = path
        streams.append(enc.encode_stream(frames))
    assert streams[0] == want and streams[1] == want
    p = enc.params
    budget = p.slice_bytes_num // p.slice_bytes_denom * p.n_horiz_slices \
        * p.n_vert_slices
    headers = len(t_loe._picture_headers(p, 0, False))
    pics = [pl for c, pl in t_bs.split_units(want) if t_bs.is_picture(c)]
    assert len(pics) == N
    assert all(len(pl) + 13 - headers == budget for pl in pics)

    ref = j_api.Decoder().decode_stream(want)
    for dec in (t_api.Decoder(device="cpu"),
                t_core.StreamDecoder(device="cpu")):
        _same_planes(dec.decode_stream(want), ref)
    top = (1 << bit_depth) - 1
    err = np.abs(ref[0][0].astype(np.int64) - frames[0][0])
    assert float(err.mean()) < (top + 1) / 64


def test_lowdelay_lossless_round_trip():
    """A slice budget large enough that every slice picks base 0: the
    decode equals the source exactly (8-bit 4:2:0 and 10-bit 4:2:2)."""
    for chroma, bit_depth in (("C420", 8), ("C422", 10)):
        tvf, jvf = _formats(chroma, bit_depth)
        frames = _frames(chroma, bit_depth, 2)
        cfg = dict(LD, bitrate=400_000_000)
        stream = t_api.Encoder(tvf, t_config.EncoderConfig(**cfg),
                               device="cpu").encode_stream(frames)
        assert stream == j_api.Encoder(
            jvf, j_config.EncoderConfig(**cfg)).encode_stream(frames)
        out = t_api.Decoder(device="cpu").decode_stream(stream)
        for o3, f3 in zip(out, frames):
            for o, f in zip(o3, f3):
                assert torch.equal(torch.from_numpy(o), torch.from_numpy(f))


def test_slice_layout_and_scalar_helpers_match_jax():
    """The slice layout (to_slices / from_slices, band sizes, per-position
    quant-matrix offsets, unflatten_host) on numpy and torch arrays, and
    the scalar DC divides and dequantiser of both low-delay modules."""
    from schroedinger_tpu.coding import slices as j_sl
    from schroedinger_tpu.decoder import lowdelay as j_lod
    from schroedinger_tpu_torch.decoder import lowdelay as t_lod
    rng = np.random.default_rng(3)
    shapes = [(4, 6), (4, 6), (8, 12), (8, 12)]
    arrays = [rng.integers(-900, 900, s).astype(np.int32) for s in shapes]
    jsl, jbi = j_sl.to_slices(arrays, 2, 3)
    tsl, tbi = t_sl.to_slices(arrays, 2, 3)
    np.testing.assert_array_equal(tsl, jsl)
    np.testing.assert_array_equal(tbi, jbi)
    tt, _ = t_sl.to_slices([torch.as_tensor(a) for a in arrays], 2, 3)
    assert torch.equal(tt, torch.as_tensor(jsl))
    for back, orig in zip(t_sl.from_slices(tt, shapes, 2, 3), arrays):
        assert torch.equal(back, torch.as_tensor(orig))
    assert t_sl.band_sizes(arrays, 2, 3) == j_sl.band_sizes(arrays, 2, 3)
    tvf, jvf = _formats("C420", 8)
    tp = t_api.Encoder(tvf, t_config.EncoderConfig(**LD), device="cpu").params
    jp = j_api.Encoder(jvf, j_config.EncoderConfig(**LD)).params
    np.testing.assert_array_equal(t_sl.qmat_offsets(tp, jbi),
                                  j_sl.qmat_offsets(jp, jbi))
    for a, b in zip(t_loe._band_pos_offsets(tp), j_loe._band_pos_offsets(jp)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(t_loe._slice_bytes_array(tp),
                                  j_loe._slice_bytes_array(jp))
    flat = np.arange(4 * 6 + 8 * 12)
    for a, b in zip(t_sl.unflatten_host(flat, [(4, 6), (8, 12)]),
                    j_sl.unflatten_host(flat, [(4, 6), (8, 12)])):
        np.testing.assert_array_equal(a, b)
    vals = np.arange(-40000, 40000, 7)
    for mod_t, mod_j in ((t_loe, j_loe), (t_lod, j_lod)):
        for v in vals[::50]:
            assert mod_t.divide3(v) == mod_j.divide3(v)
            assert mod_t.divide3_s32(v) == mod_j.divide3_s32(v)
        for qi in (0, 7, 30, 60):
            np.testing.assert_array_equal(
                mod_t.dequantise_np(vals, t_loe.QF[qi], t_loe.QO[qi]),
                mod_j.dequantise_np(vals, j_loe.QF[qi], j_loe.QO[qi]))
    np.testing.assert_array_equal(
        t_loe.quantise_np(vals, t_loe.QF[9], t_loe.QO[9]),
        j_loe.quantise_np(vals, j_loe.QF[9], j_loe.QO[9]))
    assert t_loe.ilog2up(2160) == t_lod.ilog2up(2160) == j_loe.ilog2up(2160)


def test_dc_chain_matches_jax():
    """The Python DC prediction chain (8-bit and s32 divides)."""
    rng = np.random.default_rng(5)
    ll = rng.integers(-3000, 3000, (8, 12)).astype(np.int32)
    for deep in (False, True):
        tc, jc = t_loe.DCChain(ll, deep), j_loe.DCChain(ll, deep)
        for qi, (y0, x0) in zip((0, 9, 30, 4), ((0, 0), (0, 6), (4, 0),
                                                (4, 6))):
            np.testing.assert_array_equal(
                tc.quantise_block(y0, y0 + 4, x0, x0 + 6, qi),
                jc.quantise_block(y0, y0 + 4, x0, x0 + 6, qi))
        np.testing.assert_array_equal(tc.recon, jc.recon)


@pytest.mark.parametrize("profile", ["vc2_simple", "vc2_main_10",
                                     "vc2_main_12_lossless"])
def test_intra_profiles_match_jax(profile):
    """vc2_simple (no-arith residuals, sequence-header profile 1) and
    deep vc2_main (s32 path): the port's stream is the JAX encoder's byte
    for byte, and both the port's decoders give the JAX decoder's planes
    on it; a deep lossless picture decodes to its source exactly."""
    kw = dict(rate_control="constant_quality", gop_structure="intra_only")
    chroma, bit_depth = "C422", 8
    if profile == "vc2_simple":
        kw["enable_noarith"] = True
    else:
        chroma, bit_depth = ("C422", 10) if "10" in profile else ("C420", 12)
    if profile.endswith("lossless"):
        kw["rate_control"] = "lossless"
    tvf, jvf = _formats(chroma, bit_depth)
    frames = _frames(chroma, bit_depth, 2)
    enc = t_api.Encoder(tvf, t_config.EncoderConfig(**kw), device="cpu")
    got = enc.encode_stream(frames)
    assert got == j_api.Encoder(jvf, j_config.EncoderConfig(**kw)
                                ).encode_stream(frames)
    seq = [pl for c, pl in t_bs.split_units(got)
           if c == t_bs.SEQUENCE_HEADER]
    info = t_bs.read_sequence_header(BitReader(seq[0]))
    assert info.profile == (1 if profile == "vc2_simple" else 2)
    ref = j_core.StreamDecoder().decode_stream(got)
    for dec in (t_api.Decoder(device="cpu"),
                t_core.StreamDecoder(device="cpu")):
        _same_planes(dec.decode_stream(got), ref)
    if profile.endswith("lossless"):
        _same_planes(ref, frames)


def test_cli_default_encode_and_deep_y4m(tmp_path):
    """`schro_tpu encode` with no --profile (low delay at depth 4) on an
    8-bit y4m, and on a 10-bit 4:2:2 y4m with a 10-bit y4m out; `--set
    enable_noarith=1` (the vc2_simple profile).  At 128x64, which depth
    4 divides into slices.  The CLI's output equals api.Decoder's planes
    of its stream."""
    w, h = 128, 64
    for chroma, bit_depth, extra in (("C420", 8, []), ("C422", 10, []),
                                     ("C420", 8, ["--profile", "longgop",
                                                  "--set",
                                                  "enable_noarith=1"])):
        cf = getattr(ChromaFormat, chroma)
        frames = make_frames(N, w, h, chroma_format=cf, bit_depth=bit_depth)
        src, drc, dst = (str(tmp_path / f"{bit_depth}{chroma}{len(extra)}"
                             f".{x}") for x in ("y4m", "drc", "out.y4m"))
        wr = t_y4m.Y4MWriter(src, video_format(w, h, cf, bit_depth),
                             bit_depth)
        wr.write_frames(frames)
        wr.close()
        schro_tpu.main(["encode", src, drc, "--device", "cpu"] + extra)
        schro_tpu.main(["decode", drc, dst, "--device", "cpu"])
        stream = open(drc, "rb").read()
        _, got, depth = t_y4m.read_y4m(dst)
        assert depth == bit_depth
        _same_planes(list(got),
                     t_api.Decoder(device="cpu").decode_stream(stream))
