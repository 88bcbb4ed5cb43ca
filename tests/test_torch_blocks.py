"""The long-GOP block geometry of the port against the JAX package's, on
the CPU with numpy-seeded inputs: the block size, overlap and codeblock
settings, the per-pixel gather render, global motion in the bitstream,
and the decoders on the streams that need the gather (global motion,
|mv| > MV_BOUND_PEL, overlap beyond twice the separation).

- Geometry: `GopEncoder._params` (block separation and length, codeblock
  counts) and the written prediction parameters equal the JAX encoder's
  for every block size, overlap and codeblock size.
- Streams: `api.Encoder(..., device="cpu")` codes the same bytes as the
  JAX `api.Encoder` for each setting (backref engine, I + 2 P at 96x80),
  and both port decoders decode them to the JAX StreamDecoder's planes.
- The gather render (`obmc.render_component` through
  `make_render_body(use_patches=False)`) is bit-exact against the JAX
  package's on random fields: one and two references, MV precision 0-3,
  4:2:0 / 4:2:2 / 4:4:4, |mv| up to 512 pel, global motion (pan,
  affine, perspective) and every overlap; where the patch render applies
  too, the two agree.
- Pictures written as their prediction alone (`inter.write_prediction_unit`,
  zero residual) with global motion, with |mv| ~ 200 pel and with blen =
  3 bsep decode in both port decoders to the JAX StreamDecoder's planes.
"""
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests import jax_cache  # noqa: F401 (turns the disk cache on)
from schroedinger_tpu import api as j_api
from schroedinger_tpu import config as j_config
from schroedinger_tpu.bitstream import BitWriter as JBitWriter
from schroedinger_tpu.decoder import core as j_core
from schroedinger_tpu.encoder import gop as j_gop
from schroedinger_tpu.encoder import inter as j_inter
from schroedinger_tpu.ops import obmc as j_obmc
from schroedinger_tpu.params import Params as JParams
from schroedinger_tpu.video_format import ChromaFormat as JChroma
from schroedinger_tpu.video_format import VideoFormat as JVideoFormat
from schroedinger_tpu_torch import api as t_api
from schroedinger_tpu_torch import bitstream as t_bs
from schroedinger_tpu_torch import config as t_config
from schroedinger_tpu_torch.bitstream import BitWriter
from schroedinger_tpu_torch.decoder.core import StreamDecoder
from schroedinger_tpu_torch.encoder import gop as t_gop
from schroedinger_tpu_torch.encoder import inter as t_inter
from schroedinger_tpu_torch.ops import obmc
from schroedinger_tpu_torch.params import Params
from schroedinger_tpu_torch.slice_config import make_frames, video_format
from schroedinger_tpu_torch.video_format import ChromaFormat

torch.set_num_threads(1)

W, H = 96, 80
SIZES = [(96, 80), (1920, 1080)]
BLOCK_SIZES = ["automatic", "small", "medium", "large"]
OVERLAPS = ["automatic", "none", "partial", "full"]
CODEBLOCKS = ["automatic", "small", "medium", "large", "full"]
# one stream case per setting (the default at 96x80 is already small
# blocks with partial overlap)
STREAM_CASES = {
    "small_full": dict(motion_block_size="small",
                       motion_block_overlap="full"),
    "medium": dict(motion_block_size="medium"),
    "large": dict(motion_block_size="large"),
    "overlap_none": dict(motion_block_overlap="none"),
    "codeblock_small": dict(codeblock_size="small"),
    "codeblock_medium": dict(codeblock_size="medium"),
    "codeblock_full": dict(codeblock_size="full"),
}
STREAM_BASE = dict(gop_structure="backref", au_distance=6)


def _jvf(w, h, chroma=JChroma.C420):
    return JVideoFormat(width=w, height=h, clean_width=w, clean_height=h,
                        chroma_format=chroma, frame_rate_numerator=25,
                        frame_rate_denominator=1)


def _geometry(p):
    return (p.xblen_luma, p.yblen_luma, p.xbsep_luma, p.ybsep_luma,
            p.x_num_blocks, p.y_num_blocks, tuple(p.horiz_codeblocks),
            tuple(p.vert_codeblocks), p.codeblock_mode_index)


def _pred_bytes(writer, w, p):
    writer(w, p)
    w.sync()
    return bytes(w.get_bytes())


def _both_params(size, num_refs, **kw):
    t = t_gop.GopEncoder(video_format(*size), device="cpu", **kw)
    j = j_gop.GopEncoder(_jvf(*size), **kw)
    return t._params(num_refs), j._params(num_refs)


@pytest.mark.parametrize("overlap", OVERLAPS)
@pytest.mark.parametrize("block_size", BLOCK_SIZES)
@pytest.mark.parametrize("size", SIZES, ids=["96x80", "1080p"])
def test_block_geometry_matches_jax(size, block_size, overlap):
    """Block separation and length by setting, and the prediction
    parameters as written (a table index or the custom tuple)."""
    tp, jp = _both_params(size, 1, block_size=block_size,
                          block_overlap=overlap, mv_precision=2)
    assert _geometry(tp) == _geometry(jp)
    assert (_pred_bytes(t_inter.write_prediction_parameters, BitWriter(), tp)
            == _pred_bytes(j_inter.write_prediction_parameters,
                           JBitWriter(), jp))


@pytest.mark.parametrize("dc_mq", [False, True], ids=["", "dc_multiquant"])
@pytest.mark.parametrize("codeblocks", CODEBLOCKS)
@pytest.mark.parametrize("size", SIZES, ids=["96x80", "1080p"])
def test_codeblock_counts_match_jax(size, codeblocks, dc_mq):
    """Per-level codeblock counts of intra and inter pictures, with the
    DC-multiquant workaround applied after them."""
    for num_refs in (0, 1, 2):
        tp, jp = _both_params(size, num_refs, codeblock_size=codeblocks,
                              enable_dc_multiquant=dc_mq,
                              enable_multiquant=dc_mq)
        assert _geometry(tp) == _geometry(jp)


GM_CASES = {
    "pan": [dict(b0=8, b1=-4, a00=0, a11=0)],
    "affine": [dict(b0=-3, b1=5, a_exp=16, a00=65536 + 700, a01=-400,
                    a10=350, a11=65536 - 900)],
    "perspective": [dict(b0=2, b1=1, a_exp=2, a00=4, a01=0, a10=0, a11=4,
                         c_exp=12, c0=1, c1=-1)],
    "two_refs": [dict(b0=8, b1=-4), dict(a_exp=3, a00=9, a01=1, a10=-1,
                                         a11=7)],
}


def _set_gm(p, gms):
    p.have_global_motion = True
    for g, vals in zip(p.global_motion, gms):
        for k, v in vals.items():
            setattr(g, k, v)


@pytest.mark.parametrize("case", list(GM_CASES))
def test_global_motion_parameters_written_as_jax(case):
    """Global motion in the prediction parameters: the same bits as the
    JAX writer, read back by the port's parser to the same values."""
    gms = GM_CASES[case]
    tp, jp = _both_params((W, H), len(gms), mv_precision=1)
    _set_gm(tp, gms)
    _set_gm(jp, gms)
    data = _pred_bytes(t_inter.write_prediction_parameters, BitWriter(), tp)
    assert data == _pred_bytes(j_inter.write_prediction_parameters,
                               JBitWriter(), jp)
    from schroedinger_tpu_torch.coding.bitio import BitReader
    from schroedinger_tpu_torch.decoder.core import \
        read_picture_prediction_parameters
    back = Params(video_format=tp.video_format, num_refs=tp.num_refs)
    read_picture_prediction_parameters(BitReader(data), back)
    assert back.have_global_motion
    assert back.global_motion[:len(gms)] == tp.global_motion[:len(gms)]


def _render_params(mod_params, vf, blocks, prec, num_refs):
    p = mod_params(video_format=vf, num_refs=num_refs, transform_depth=3,
                   wavelet_filter_index=1)
    p.set_default_codeblocks()
    p.set_default_quant_matrix()
    p.xblen_luma, p.yblen_luma, p.xbsep_luma, p.ybsep_luma = blocks
    p.mv_precision = prec
    return p


# (refs, prec, chroma, (xblen, yblen, xbsep, ybsep), |mv| pel, global
# motion case or None); the luma picture is 40x36 (not a block multiple)
RENDER_CASES = {
    "1ref_prec0_420_partial": (1, 0, "C420", (12, 12, 8, 8), 20, None),
    "1ref_prec1_422_none": (1, 1, "C422", (8, 8, 8, 8), 20, None),
    "1ref_prec2_444_full": (1, 2, "C444", (16, 16, 8, 8), 20, None),
    "1ref_prec3_420_custom": (1, 3, "C420", (10, 12, 8, 8), 20, None),
    "2ref_prec2_420_partial": (2, 2, "C420", (12, 12, 8, 8), 20, None),
    "2ref_prec0_422_full": (2, 0, "C422", (16, 16, 8, 8), 20, None),
    "1ref_prec2_420_mv512": (1, 2, "C420", (12, 12, 8, 8), 512, None),
    "2ref_prec1_444_mv300": (2, 1, "C444", (12, 12, 8, 8), 300, None),
    "1ref_prec2_420_wide": (1, 2, "C420", (24, 24, 8, 8), 20, None),
    "2ref_prec3_422_wide": (2, 3, "C422", (20, 16, 8, 4), 20, None),
    "1ref_prec2_420_pan": (1, 2, "C420", (12, 12, 8, 8), 20, "pan"),
    "1ref_prec1_444_affine": (1, 1, "C444", (12, 12, 8, 8), 20, "affine"),
    "1ref_prec0_420_perspective": (1, 0, "C420", (16, 16, 8, 8), 20,
                                   "perspective"),
    "2ref_prec2_420_gm": (2, 2, "C420", (12, 12, 8, 8), 20, "two_refs"),
}


def _random_fields(rng, yb, xb, num_refs, mv_pel, prec, gm):
    b = mv_pel << prec
    f = {
        "split": np.full((yb, xb), 2, np.int32),
        "pred_mode": rng.integers(0, 4 if num_refs == 2 else 2,
                                  (yb, xb)).astype(np.int32),
        "using_global": (rng.integers(0, 2, (yb, xb)) if gm
                         else np.zeros((yb, xb))).astype(np.int32),
    }
    for k in ("dx1", "dy1", "dx2", "dy2"):
        f[k] = rng.integers(-b, b + 1, (yb, xb)).astype(np.int32)
    for k in ("dc0", "dc1", "dc2"):
        f[k] = rng.integers(-128, 128, (yb, xb)).astype(np.int32)
    return f


@pytest.mark.parametrize("case", list(RENDER_CASES))
def test_gather_render_matches_jax(case):
    num_refs, prec, chroma, blocks, mv_pel, gm = RENDER_CASES[case]
    rng = np.random.default_rng(list(RENDER_CASES).index(case))
    w, h = 40, 36
    tvf = video_format(w, h, getattr(ChromaFormat, chroma))
    jvf = _jvf(w, h, getattr(JChroma, chroma))
    tp = _render_params(Params, tvf, blocks, prec, num_refs)
    jp = _render_params(JParams, jvf, blocks, prec, num_refs)
    if gm:
        _set_gm(tp, GM_CASES[gm])
        _set_gm(jp, GM_CASES[gm])
    f = _random_fields(rng, tp.y_num_blocks, tp.x_num_blocks, num_refs,
                       mv_pel, prec, gm)
    sizes = [tvf.picture_luma_size()] + [tvf.picture_chroma_size()] * 2
    refs = [[rng.integers(0, 256, (ph, pw), dtype=np.uint8)
             for (pw, ph) in sizes] for _ in range(num_refs)]
    t_ups = [tuple(obmc.make_halfpel(obmc.upsample_plane(torch.tensor(pl)))
                   for pl in r) for r in refs]
    j_ups = [tuple(j_obmc.make_halfpel(j_obmc.upsample_plane(jnp.asarray(pl)))
                   for pl in r) for r in refs]
    t_mv = {k: torch.tensor(v) for k, v in f.items()}
    j_mv = {k: jnp.asarray(v) for k, v in f.items()}
    t2 = t_ups[1] if num_refs == 2 else None
    j2 = j_ups[1] if num_refs == 2 else None
    got = obmc.make_render_body(tp, num_refs, use_patches=False)(
        t_mv, t_ups[0], t2)
    want = j_obmc.make_render_body(jp, num_refs, use_patches=False)(
        j_mv, j_ups[0], j2)
    for k in range(3):
        assert got[k].dtype == torch.int32
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=f"plane {k}")
    auto = obmc.make_render_body(tp, num_refs)(t_mv, t_ups[0], t2)
    for k in range(3):
        # the automatic dispatch: the patch render where it applies, and
        # there it agrees with the gather
        assert torch.equal(auto[k], got[k])
    if not gm and mv_pel <= obmc.MV_BOUND_PEL and blocks[0] <= 2 * blocks[2]:
        fast = obmc.make_render_body(tp, num_refs, use_patches=True)(
            t_mv, t_ups[0], t2)
        for k in range(3):
            assert torch.equal(fast[k], got[k])


def test_fetch_block_and_global_vectors_match_jax():
    """The two helpers on their own: a sub-pel patch fetch at every
    precision (origins past the plane's edges) and the per-pixel global
    vectors (int32 wraparound included)."""
    rng = np.random.default_rng(3)
    up = rng.integers(0, 256, (40, 56), dtype=np.uint8)
    for prec in range(4):
        for px0, py0 in ((5, 7), (-40, 3), (200, -9), (37, 61)):
            got = obmc.fetch_block(torch.tensor(up), prec, px0, py0, 6, 10)
            want = j_obmc.fetch_block(jnp.asarray(up), prec, px0, py0, 6, 10)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for gm in ((8, -4, 0, 0, 0, 0, 0, 0, 0, 0),
               (3, -2, 16, 66000, -1200, 900, 64000, 0, 0, 0),
               (1, 2, 2, 5, 1, -1, 3, 12, 2, -3),
               (9, 9, 20, 1 << 20, 77, -5, 1 << 20, 4, 3, 1)):
        xs, ys = np.arange(0, 1920, 7), np.arange(0, 1080, 5)
        got = obmc.global_vectors(gm, torch.tensor(xs), torch.tensor(ys))
        want = j_obmc.global_vectors(gm, jnp.asarray(xs, jnp.int32),
                                     jnp.asarray(ys, jnp.int32))
        for g, w_ in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w_))


def _jax_decode(stream):
    dec = j_core.StreamDecoder()
    return dec.decode_stream(stream), dec.errors


def _stream_case(case):
    """Both packages' streams of a case, and the JAX decoder's decode of
    the port's stream with its errors."""
    kw = dict(STREAM_BASE, **STREAM_CASES[case])
    frames = make_frames(3, W, H)
    port = t_api.Encoder(video_format(W, H), t_config.EncoderConfig(**kw),
                         device="cpu").encode_stream(frames)
    jax = j_api.Encoder(_jvf(W, H), j_config.EncoderConfig(
        **kw)).encode_stream(frames)
    return frames, port, jax, _jax_decode(port)


@pytest.fixture(scope="module")
def streams():
    """Every stream case, each made once, on four threads that start with
    the first test that asks for them and work ahead of the next (XLA
    compiles, nearly all of the time, release the GIL): {case: future}."""
    with ThreadPoolExecutor(4) as pool:
        jobs = {case: pool.submit(_stream_case, case)
                for case in STREAM_CASES}
        yield jobs
        for job in jobs.values():
            job.cancel()


def _decode_all(stream, n, jax_decoded=None):
    """(port pipelined, port per-picture, JAX) decodes of a stream; each
    decoder gives n frames and no picture error.  jax_decoded: the JAX
    decoder's (frames, errors) on this stream, if made already."""
    decoded = [(dec.decode_stream(stream), dec.errors)
               for dec in (t_api.Decoder(device="cpu"),
                           StreamDecoder(device="cpu"))]
    decoded.append(jax_decoded or _jax_decode(stream))
    outs = []
    for out, errors in decoded:
        assert len(out) == n and errors == []
        outs.append([tuple(np.asarray(pl) for pl in f) for f in out])
    for a3, b3, c3 in zip(*outs):
        for a, b, c in zip(a3, b3, c3):
            np.testing.assert_array_equal(a, c)
            np.testing.assert_array_equal(b, c)
    return outs[0]


@pytest.mark.parametrize("case", list(STREAM_CASES))
def test_stream_matches_jax(streams, case):
    frames, stream, j_stream, j_decoded = streams[case].result()
    assert stream == j_stream
    _decode_all(stream, len(frames), j_decoded)


def _intra_and_refs(n_refs):
    """A port stream's head: the sequence header and n_refs intra-coded
    reference pictures of make_frames, with the encoder that made them."""
    frames = make_frames(n_refs, W, H)
    enc = t_gop.GopEncoder(video_format(W, H), base_qi_intra=10,
                           gop_length=1, device="cpu")
    head = b"".join(enc.encode_frame(f) for f in frames)
    return enc, head


def _crafted_stream(blocks=None, gm=None, mv_pel=0, num_refs=1, seed=0):
    """I picture(s), then one inter picture written by
    `inter.write_prediction_unit` with random block fields."""
    enc, head = _intra_and_refs(num_refs)
    p = enc._params(num_refs)
    p.mv_precision = 2
    if blocks:
        p.xblen_luma, p.yblen_luma, p.xbsep_luma, p.ybsep_luma = blocks
    if gm:
        _set_gm(p, GM_CASES[gm])
    rng = np.random.default_rng(seed)
    f = _random_fields(rng, p.y_num_blocks, p.x_num_blocks, num_refs,
                       mv_pel or 20, 2, gm)
    if mv_pel:
        # every vector past the patch render's bound
        for k in ("dx1", "dy1", "dx2", "dy2"):
            f[k] = np.where(f[k] >= 0, 1, -1) * (mv_pel << 2) + f[k] % 4
    unit = t_inter.write_prediction_unit(
        p, num_refs, list(range(num_refs)), f)
    return head + t_bs.fixup_offsets([unit, t_bs.make_eos_unit()],
                                     prev=enc._chain.prev), num_refs + 1


@pytest.mark.parametrize("kind", ["pan", "affine", "two_refs", "mv200",
                                  "wide_overlap"])
def test_gather_streams_decode_as_jax(kind):
    """Streams whose inter picture needs the gather render: the port's
    two decoders give the JAX StreamDecoder's planes."""
    if kind == "mv200":
        stream, n = _crafted_stream(mv_pel=200)
    elif kind == "wide_overlap":
        stream, n = _crafted_stream(blocks=(24, 24, 8, 8))
    else:
        stream, n = _crafted_stream(gm=kind,
                                    num_refs=len(GM_CASES[kind]))
    out = _decode_all(stream, n)
    assert not np.array_equal(out[-1][0], out[0][0])
