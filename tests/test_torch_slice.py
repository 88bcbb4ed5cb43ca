"""The port's whole slice against the JAX package on the CPU: the
fixed-quantiser backref long-GOP encode (I P P P, quarter-pel ME, MD5
aux units) and the decode of its stream, at 128x64.

  (a) the port's stream is byte-identical to the JAX encoder's;
  (b) the JAX decoder decodes the port's stream with no MD5 failure;
  (c) the port's decoder decodes the JAX stream to the JAX decoder's
      planes;
  (d) importing and running the port (both slices) leaves jax and the
      JAX package unimported;
  (e) reference state carried across with convert.py seeds the port's
      inter step to the JAX step's exact output.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from schroedinger_tpu.decoder import core as j_core
from schroedinger_tpu.decoder import intra as j_dintra
from schroedinger_tpu.encoder import gop as j_gop
from schroedinger_tpu.encoder import inter as j_inter
from schroedinger_tpu.encoder import intra as j_intra
from schroedinger_tpu_torch import convert
from schroedinger_tpu_torch.decoder import core as t_core
from schroedinger_tpu_torch.decoder import intra as t_dintra
from schroedinger_tpu_torch.encoder import gop as t_gop
from schroedinger_tpu_torch.encoder import inter as t_inter
from schroedinger_tpu_torch.encoder import intra as t_intra
from schroedinger_tpu_torch.encoder.ratecontrol import QuantiserEngine
from schroedinger_tpu_torch.slice_config import (CONFIG, make_frames,
                                                 video_format)

torch.set_num_threads(1)

W, H = 128, 64
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def frames():
    return make_frames(4, W, H)


@pytest.fixture(scope="module")
def port_stream(frames):
    return t_gop.GopEncoder(video_format(W, H), device="cpu", **CONFIG).encode_stream(
        frames)


@pytest.fixture(scope="module")
def jax_stream(frames):
    return j_gop.GopEncoder(video_format(W, H), **CONFIG).encode_stream(frames)


def _picture_kinds(stream):
    from schroedinger_tpu import bitstream as bs
    return ["I" if bs.num_refs(c) == 0 else "P"
            for c, _ in bs.split_units(stream) if bs.is_picture(c)]


def test_a_port_stream_is_byte_identical(port_stream, jax_stream):
    assert _picture_kinds(port_stream) == ["I", "P", "P", "P"]
    assert len(port_stream) == len(jax_stream)
    assert port_stream == jax_stream


def test_a_noarith_stream_is_byte_identical(frames):
    """GopEncoder(enable_noarith=True) at fixed quantisers: VLC residuals
    and MVs (the JAX unit writers' no-arith branches), byte for byte, and
    the port's decoders read the stream back to the JAX decoder's planes."""
    cfg = dict(CONFIG, enable_noarith=True)
    got = t_gop.GopEncoder(video_format(W, H), device="cpu",
                           **cfg).encode_stream(frames)
    assert got == j_gop.GopEncoder(video_format(W, H),
                                   **cfg).encode_stream(frames)
    assert _picture_kinds(got) == ["I", "P", "P", "P"]
    want = j_core.StreamDecoder().decode_stream(got)
    dec = t_core.StreamDecoder(device="cpu")
    out = dec.decode_stream(got)
    assert dec.md5_failures == [] and dec.errors == []
    for g3, w3 in zip(out, want):
        for g, w in zip(g3, w3):
            np.testing.assert_array_equal(g, w)


def test_b_jax_decoder_accepts_port_stream(port_stream, frames):
    dec = j_core.StreamDecoder()
    out = dec.decode_stream(port_stream)
    assert dec.md5_failures == [] and dec.errors == []
    assert len(out) == len(frames)
    for (y, _, _), (y0, _, _) in zip(out, frames):
        mse = np.mean((y.astype(np.float64) - y0) ** 2)
        assert 10 * np.log10(255.0 ** 2 / mse) > 30


def test_c_port_decoder_matches_jax_decoder(jax_stream):
    jdec = j_core.StreamDecoder()
    want = jdec.decode_stream(jax_stream)
    tdec = t_core.StreamDecoder(device="cpu")
    got = tdec.decode_stream(jax_stream)
    assert tdec.md5_failures == [] and tdec.errors == []
    assert len(got) == len(want) == 4
    for n, (g3, w3) in enumerate(zip(got, want)):
        for g, w, name in zip(g3, w3, "yuv"):
            np.testing.assert_array_equal(g, w, err_msg=f"{n} {name}")


def test_d_port_runs_without_jax():
    code = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {REPO!r})
        from schroedinger_tpu_torch.decoder.core import StreamDecoder
        from schroedinger_tpu_torch.encoder.gop import GopEncoder
        from schroedinger_tpu_torch.slice_config import (
            CONFIG, CONFIG_FLAGSHIP, make_frames, video_format)
        frames = make_frames(3, 64, 64)
        s = GopEncoder(video_format(64, 64), device="cpu",
                       **CONFIG).encode_stream(frames)
        d = StreamDecoder(device="cpu")
        out = d.decode_stream(s)
        assert len(out) == 3 and d.md5_failures == [] and d.errors == []
        assert "jax" not in sys.modules, sorted(
            m for m in sys.modules if m.startswith("jax"))
        flag = make_frames(6, 64, 64)
        s = GopEncoder(video_format(64, 64), device="cpu",
                       **dict(CONFIG_FLAGSHIP, bitrate=300_000)
                       ).encode_stream(flag)
        d = StreamDecoder(device="cpu")
        out = d.decode_stream(s)
        assert len(out) == 6 and d.md5_failures == [] and d.errors == []
        # the entry points of the fourth slice: the API (B pictures
        # batched, the pipelined decoder), the settings, y4m and the CLI
        from schroedinger_tpu_torch import api, config, y4m
        from schroedinger_tpu_torch.decoder import pipeline
        from schroedinger_tpu_torch.tools import schro_tpu
        s = api.Encoder(video_format(64, 64), config.EncoderConfig(),
                        device="cpu").encode_stream(flag)
        out = api.Decoder(device="cpu").decode_stream(s)
        assert len(out) == 6
        assert pipeline.PipelinedStreamDecoder(device="cpu").decode_stream(
            s)[5][0].shape == (64, 64)
        assert callable(schro_tpu.main) and callable(y4m.read_y4m)
        # the fifth slice's profiles: low delay (8-bit and 10-bit 4:2:2),
        # vc2_simple, deep vc2_main and no-arith long GOP
        from schroedinger_tpu_torch.video_format import ChromaFormat
        c422 = ChromaFormat.C422
        for kw, cf, bd in ((dict(rate_control="low_delay",
                                 transform_depth=3), None, 8),
                           (dict(rate_control="low_delay",
                                 transform_depth=3), c422, 10),
                           (dict(enable_noarith=True), None, 8),
                           (dict(gop_structure="intra_only"), c422, 10)):
            cf = cf or ChromaFormat.C420
            src = make_frames(2, 64, 64, chroma_format=cf, bit_depth=bd)
            s = api.Encoder(video_format(64, 64, cf, bd),
                            config.EncoderConfig(**kw),
                            device="cpu").encode_stream(src)
            out = api.Decoder(device="cpu").decode_stream(s)
            assert len(out) == 2 and out[0][0].dtype == src[0][0].dtype
        s = GopEncoder(video_format(64, 64), device="cpu",
                       enable_noarith=True, **CONFIG).encode_stream(
                           frames[:2])
        d = StreamDecoder(device="cpu")
        assert len(d.decode_stream(s)) == 2 and d.md5_failures == []
        # the sixth slice's rate controls: the backref engine under an RD
        # pick and a host pick, the allocation controller, multiquant
        for kw in (dict(gop_structure="backref"),
                   dict(gop_structure="backref",
                        rate_control="constant_error"),
                   dict(rate_control="constant_bitrate", bitrate=300_000,
                        enable_rdo_cbr=False),
                   dict(enable_multiquant=True)):
            s = api.Encoder(video_format(64, 64), config.EncoderConfig(**kw),
                            device="cpu").encode_stream(frames)
            assert len(api.Decoder(device="cpu").decode_stream(s)) == 3
        loaded = sorted(m for m in sys.modules
                        if m == "jax" or m.startswith("jax.")
                        or m == "schroedinger_tpu"
                        or m.startswith("schroedinger_tpu."))
        assert loaded == [], loaded
        print("NOJAX-OK")
    """)
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "NOJAX-OK" in res.stdout


def test_e_convert_roundtrip_seeds_inter_step(frames):
    """A JAX RefFrame (planes + half-pel planes) crosses into the port
    through convert.py and seeds its P step: the parse unit and the
    reconstruction equal the JAX step's."""
    enc = j_gop.GopEncoder(video_format(W, H), **CONFIG)
    p_i = enc._params(0)
    _unit, jrecon = j_intra.encode_picture(frames[0], p_i, 0,
                                           quant_indices=12, is_ref=True,
                                           return_recon=True)
    jref = j_core.RefFrame(tuple(np.asarray(pl) for pl in jrecon))
    jups = [np.asarray(u) for u in jref.get_upsampled()]
    tref = convert.ref_frame_from_numpy(jref.planes, jups, device="cpu")
    planes, ups = convert.ref_frame_to_numpy(tref)
    for a, b in zip(planes + tuple(ups), jref.planes + tuple(jups)):
        np.testing.assert_array_equal(a, b)
    # the port recomputes the same half-pel planes when none are given
    fresh = convert.ref_frame_from_numpy(jref.planes, device="cpu")
    for a, b in zip(fresh.get_upsampled(), jups):
        np.testing.assert_array_equal(a.numpy(), b)

    p = enc._params(1)
    ju, jrec, *_ = j_inter.encode_inter_picture(frames[1], p, 1, 0, jref,
                                                base_qi=20, retired=0)
    tu, trec, *_ = t_inter.encode_inter_picture(frames[1], p, 1, 0, tref,
                                                base_qi=20, retired=0,
                                                device="cpu")
    assert tu == ju
    for a, b in zip(trec, jrec):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_intra_picture_parity(frames):
    """Intra encode (bytes + decoder-exact recon) and decode."""
    p = j_gop.GopEncoder(video_format(W, H), **CONFIG)._params(0)
    ju, jrec = j_intra.encode_picture(frames[2], p, 2, quant_indices=16,
                                      is_ref=True, retired=0,
                                      return_recon=True)
    tu, trec = t_intra.encode_picture(frames[2], p, 2, quant_indices=16,
                                      is_ref=True, retired=0,
                                      return_recon=True, device="cpu")
    assert tu == ju
    for a, b in zip(trec, jrec):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # transform data starts after parse info (13) + header + params
    from schroedinger_tpu.coding.bitio import BitReader
    from schroedinger_tpu import bitstream as bs
    from schroedinger_tpu.params import Params
    payload = ju[13:]
    r = BitReader(payload)
    r.read_bits(32)
    r.read_sint()
    r.sync()
    q = Params(video_format=video_format(W, H), num_refs=0)
    bs.read_transform_parameters(r, q)
    r.sync()
    data = payload[r.bits_read // 8:]
    jdec = j_dintra.decode_picture(data, q)
    tdec = t_dintra.decode_picture(data, q, device="cpu")
    for a, b, c in zip(tdec, jdec, trec):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert torch.equal(a, c)


def test_encode_frame_path_matches_jax(frames):
    """The unpipelined per-frame path (encode_frame -> _encode_ref, with
    the intra-bailout check) gives the JAX encoder's units."""
    tenc = t_gop.GopEncoder(video_format(W, H), device="cpu", **CONFIG)
    jenc = j_gop.GopEncoder(video_format(W, H), **CONFIG)
    for planes in frames[:3]:
        assert tenc.encode_frame(planes) == jenc.encode_frame(planes)
    assert tenc.flush() == jenc.flush() == b""


def test_unported_options_raise():
    """The port's GopEncoder takes the JAX constructor's whole signature
    with its defaults and every value of its options, interlaced coding
    included (tests/test_torch_interlaced*.py); what it refuses on
    purpose (deep long GOP) raises NotImplementedError naming its
    ROADMAP.md item."""
    import dataclasses
    import inspect
    vf = video_format(W, H)
    jsig = inspect.signature(j_gop.GopEncoder.__init__).parameters
    tsig = inspect.signature(t_gop.GopEncoder.__init__).parameters
    assert list(jsig) == [k for k in tsig if k != "device"]
    for k, v in jsig.items():
        assert tsig[k].default == v.default, k
    for kw in (dict(block_size="small"), dict(codeblock_size="full"),
               dict(downsample_levels=3), dict(enable_phasecorr=True),
               dict(filtering="gaussian"), dict(estimation=("fullscan",)),
               dict(enable_psnr=True)):
        t_gop.GopEncoder(vf, device="cpu", **kw)
    fields = t_gop.GopEncoder(dataclasses.replace(vf, interlaced_coding=True),
                              device="cpu")
    assert fields.field_factor == 2
    with pytest.raises(NotImplementedError, match="Queue 3"):
        t_gop.GopEncoder(video_format(W, H, bit_depth=10), device="cpu")
    # the defaults are taken, a full subgroup's B pictures batched
    enc = t_gop.GopEncoder(vf, device="cpu", gop_structure="biref",
                           block_size="automatic", downsample_levels=5,
                           quantiser_engine=QuantiserEngine(
                               "constant_lambda"))
    assert enc.enable_b_batch is True
    # every magic constant of the JAX encoder, and no other
    with pytest.raises(ValueError, match="keyframe_wait"):
        t_gop.GopEncoder(vf, device="cpu", magic={"keyframe_wait": 7.5})
    enc = t_gop.GopEncoder(vf, device="cpu", magic={"scan_distance": 2.0,
                                                    "keyframe_weight": 9.0})
    assert enc.magic["scan_distance"] == 2.0 and len(enc.magic) == 18


def test_entry_points_need_the_card_unless_asked_for_the_cpu(frames):
    """With no `device` the port's entry points mean the card: where
    there is none they raise, they do not carry on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: nothing to refuse")
    vf = video_format(W, H)
    p = t_gop.GopEncoder(vf, device="cpu", **CONFIG)._params(0)
    ref = convert.ref_frame_from_numpy(frames[0], device="cpu")
    for call in (lambda: t_gop.GopEncoder(vf, **CONFIG),
                 lambda: t_core.StreamDecoder(),
                 lambda: t_intra.encode_picture(frames[0], p, 0),
                 lambda: t_intra.encode_picture_fused(
                     frames[0], p, 0, np.ones(30)),
                 lambda: t_dintra.decode_picture(b"", p),
                 lambda: t_inter.start_inter_picture(
                     frames[1], t_gop.GopEncoder(
                         vf, device="cpu", **CONFIG)._params(1), ref),
                 lambda: convert.ref_frame_from_numpy(frames[0])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def _two_ref_params():
    from schroedinger_tpu_torch.slice_config import CONFIG_FLAGSHIP
    vf = video_format(W, H)
    return (t_gop.GopEncoder(vf, device="cpu",
                             **CONFIG_FLAGSHIP)._params(2),
            j_gop.GopEncoder(vf, **CONFIG_FLAGSHIP)._params(2))


@pytest.mark.parametrize("lam", [0.5, 6.0, 40.0])
def test_rd_split_body2_fields_exact(lam):
    """The two-reference RD split + mode search on seeded inputs: every
    field equals the JAX body's (modes DC / ref1 / ref2 / biref at all
    three granularities; lam moves the split)."""
    import jax.numpy as jnp
    from schroedinger_tpu.encoder import me as j_me
    from schroedinger_tpu_torch.encoder import me as t_me
    tp, jp = _two_ref_params()
    ynb, xnb = tp.y_num_blocks, tp.x_num_blocks
    bs_ = tp.ybsep_luma
    rng = np.random.default_rng(int(lam * 10))
    ph, pw = ynb * bs_, xnb * bs_
    margin = t_me.ME_BOUND_PEL + 16
    assert margin == j_me.ME_BOUND_PEL + 16
    # a smooth scene seen three times with independent noise: the current
    # picture, and two references displaced by (+1, -2) and (-1, +2) pel
    yy, xx = np.mgrid[0:ph + 16, 0:pw + 16]
    scene = 128 + 60 * np.sin(xx / 9.0) * np.cos(yy / 7.0)

    def view(oy, ox):
        v = scene[8 + oy:8 + oy + ph, 8 + ox:8 + ox + pw]
        return (v + rng.normal(0, 4, (ph, pw))).clip(0, 255).astype(np.uint8)

    c = view(0, 0).astype(np.int32)
    P1 = np.pad(view(1, -2), margin, mode="edge")
    P2 = np.pad(view(-1, 2), margin, mode="edge")
    sub = 1 << tp.mv_precision

    def mvs(pel):
        # the true vector, off by a subpel step in one block of five
        off = rng.integers(-2, 3, (ynb, xnb)) * (rng.random((ynb, xnb)) < .2)
        return (pel * sub + off).astype(np.int32)

    def sads():
        return rng.integers(230, 350, (ynb, xnb))

    args = [mvs(1), mvs(-2), sads(), mvs(-1), mvs(2), sads(),
            rng.integers(0, 1500, (ynb, xnb)),
            rng.integers(0, 256, (ynb, xnb)),
            rng.integers(0, 256, (ynb, xnb)),
            rng.integers(0, 256, (ynb, xnb))]
    args = [a.astype(np.int32) for a in args]
    want = j_inter.make_rd_split_body2(jp)(
        jnp.asarray(c), jnp.asarray(P1), jnp.asarray(P2),
        *[jnp.asarray(a) for a in args], jnp.float32(lam))
    got = t_inter.make_rd_split_body2(tp)(
        torch.tensor(c), torch.tensor(P1), torch.tensor(P2),
        *[torch.tensor(a) for a in args],
        torch.tensor(lam, dtype=torch.float32))
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == torch.int32, k
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    # the search really chose: all four modes at small lambdas, and
    # whole superblocks beside single blocks at the large one
    modes = set(np.unique(np.asarray(want["pred_mode"])).tolist())
    splits = set(np.unique(np.asarray(want["split"])).tolist())
    assert modes == ({0, 1, 2, 3} if lam < 10 else {1, 2, 3})
    assert splits == ({2} if lam < 10 else {0, 2})


def test_two_reference_render_exact(frames):
    """The two-reference OBMC patch render (modes DC, ref1, ref2 and the
    weighted biref average, quarter-pel MVs) equals the JAX render."""
    import jax.numpy as jnp
    from schroedinger_tpu.ops import obmc as j_obmc
    from schroedinger_tpu_torch.ops import obmc as t_obmc
    tp, jp = _two_ref_params()
    ynb, xnb = tp.y_num_blocks, tp.x_num_blocks
    rng = np.random.default_rng(21)
    mv = {k: rng.integers(-37, 38, (ynb, xnb)).astype(np.int32)
          for k in ("dx1", "dy1", "dx2", "dy2")}
    mv["pred_mode"] = rng.integers(0, 4, (ynb, xnb)).astype(np.int32)
    for k in ("dc0", "dc1", "dc2"):
        mv[k] = rng.integers(-128, 128, (ynb, xnb)).astype(np.int32)
    r1 = convert.ref_frame_from_numpy(frames[0], device="cpu")
    r2 = convert.ref_frame_from_numpy(frames[2], device="cpu")
    ups1 = [u.numpy() for u in r1.get_upsampled()]
    ups2 = [u.numpy() for u in r2.get_upsampled()]
    got = t_obmc.make_render_body(tp, 2)(
        {k: torch.tensor(v) for k, v in mv.items()},
        tuple(r1.get_upsampled()), tuple(r2.get_upsampled()))
    want = j_obmc.make_render_body(jp, 2)(
        {k: jnp.asarray(v) for k, v in mv.items()},
        tuple(jnp.asarray(u) for u in ups1),
        tuple(jnp.asarray(u) for u in ups2))
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_))
