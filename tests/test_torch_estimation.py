"""The long-GOP motion-estimation settings of the port against the JAX
package's, on the CPU with numpy-seeded inputs: the ME options, phase
correlation, the estimation switches of the inter step, and the global
motion fit.

- `me.make_me_body` with injected candidates (n_extra), without the
  candidate competition (no deep estimation), without the zero
  candidate, with chroma ME and at a reduced pyramid depth gives the JAX
  ME's (dy, dx, sad) exactly; a batch of two pictures gives each
  picture's own result.
- `phasecorr.make_phasecorr_fn` finds the JAX package's window vectors
  on content with a clear shift, and `pick_candidates` the same
  candidates.
- `globalest.estimate_global_motion` returns the JAX package's
  GlobalMotion on the synthetic field of tests/test_global_motion.py.
- The `enable_*_estimation` settings map to the JAX API's estimation
  tokens, and each switch, `downsample_levels` and phase correlation
  code the JAX stream byte for byte through `api.Encoder` (backref engine,
  I + 2 P), decoded by both port decoders to the JAX decoder's planes.

The JAX step of the full-scan case compiles its 65 x 65-candidate coarse
scan as 4225 unrolled slices, minutes of XLA compile.  Its stream is made
with a stand-in for the JAX `me._dense_scan` that maps one slice over the
candidates (`_dense_scan_mapped`); `test_dense_scan_stand_in_is_exact`
holds the stand-in equal to the original, run eagerly, at that radius.
"""
import threading
from concurrent.futures import ThreadPoolExecutor
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests import jax_cache  # noqa: F401 (turns the disk cache on)
from schroedinger_tpu import api as j_api
from schroedinger_tpu import config as j_config
from schroedinger_tpu.decoder import core as j_core
from schroedinger_tpu.encoder import globalest as j_ge
from schroedinger_tpu.encoder import me as j_me
from schroedinger_tpu.encoder import phasecorr as j_pc
from schroedinger_tpu.params import Params as JParams
from schroedinger_tpu.video_format import ChromaFormat as JChroma
from schroedinger_tpu.video_format import VideoFormat as JVideoFormat
from schroedinger_tpu_torch import api as t_api
from schroedinger_tpu_torch import config as t_config
from schroedinger_tpu_torch.decoder.core import StreamDecoder
from schroedinger_tpu_torch.encoder import globalest as t_ge
from schroedinger_tpu_torch.encoder import inter as t_inter
from schroedinger_tpu_torch.encoder import me as t_me
from schroedinger_tpu_torch.encoder import phasecorr as t_pc
from schroedinger_tpu_torch.params import Params
from schroedinger_tpu_torch.slice_config import make_frames, video_format

torch.set_num_threads(1)

W, H = 96, 80
BASE = dict(gop_structure="backref", au_distance=6)
STREAM_CASES = {
    "no_hierarchical": (dict(enable_hierarchical_estimation=0), (W, H)),
    "no_deep": (dict(enable_deep_estimation=0, mv_precision=2), (W, H)),
    # enable_zero_estimation is off by default: no_bigblock brings no_zero
    "no_bigblock_no_zero": (dict(enable_bigblock_estimation=0), (W, H)),
    "chroma_me": (dict(enable_chroma_me=1), (W, H)),
    "fullscan": (dict(enable_fullscan_estimation=1), (W, H)),
    "downsample_levels_2": (dict(downsample_levels=2), (W, H)),
    # phase correlation's windows need a 4x-down frame of >= 32 x 16
    "phasecorr": (dict(enable_phasecorr_estimation=1), (128, 64)),
}


def _jvf(w, h):
    return JVideoFormat(width=w, height=h, clean_width=w, clean_height=h,
                        chroma_format=JChroma.C420, frame_rate_numerator=25,
                        frame_rate_denominator=1)


def _texture(h, w, seed=7):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = (128 + 50 * np.sin(xx / 9.0) * np.cos(yy / 7.0)
           + 20 * np.sin((xx + 2 * yy) / 5.0) + rng.normal(0, 3, (h, w)))
    return img.clip(0, 255).astype(np.uint8)


def _dense_scan_mapped(c, r, nby, nbx, bs_y, bs_x, rad):
    """The JAX `me._dense_scan` with its candidates mapped over one
    dynamic slice (lax.map) instead of unrolled: the same SADs, the same
    first-minimum pick."""
    K = 2 * rad + 1
    h, w = c.shape
    ci = c.astype(jnp.int32)
    ppad = jnp.pad(r.astype(jnp.int32), rad, mode="edge")
    offs = jnp.stack(jnp.meshgrid(jnp.arange(K), jnp.arange(K),
                                  indexing="ij"), -1).reshape(-1, 2)

    def one(o):
        d = jnp.abs(ci - jax.lax.dynamic_slice(ppad, (o[0], o[1]), (h, w)))
        return d.reshape(nby, bs_y, nbx, bs_x).sum((1, 3))

    s = jax.lax.map(one, offs)
    best = jnp.argmin(s, axis=0)
    return ((best // K - rad).astype(jnp.int32),
            (best % K - rad).astype(jnp.int32),
            jnp.take_along_axis(s, best[None], axis=0)[0])


def test_dense_scan_stand_in_is_exact():
    rng = np.random.default_rng(4)
    c = rng.integers(0, 256, (H, W), dtype=np.uint8)
    r = np.roll(c, (3, -5), (0, 1)) // 2 + rng.integers(0, 128, (H, W),
                                                        dtype=np.uint8)
    with jax.disable_jit():
        want = j_me._dense_scan(jnp.asarray(c), jnp.asarray(r), 10, 12, 8,
                                8, 32)
    got = jax.jit(_dense_scan_mapped, static_argnums=range(2, 7))(
        jnp.asarray(c), jnp.asarray(r), 10, 12, 8, 8, 32)
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w_))


# name -> make_me_body keywords (both packages), extras?, chroma?
ME_CASES = {
    "extra_candidates": (dict(levels=3, n_extra=4), True, False),
    "no_zero": (dict(levels=3, zero_cand=False), False, False),
    "chroma": (dict(levels=3), False, True),
    "chroma_extra_no_zero": (dict(levels=2, n_extra=4, zero_cand=False),
                             True, True),
    "no_candidates_extra": (dict(levels=3, candidates=False, n_extra=2),
                            True, False),
}


@pytest.mark.parametrize("case", list(ME_CASES))
def test_me_body_options_match_jax(case):
    kw, with_extra, with_chroma = ME_CASES[case]
    h, w, bs = 64, 96, 8
    nby, nbx = h // bs, w // bs
    ref = _texture(h, w, seed=3)
    cur = np.roll(ref, (-3, 5), (0, 1))
    cur[10:30, 20:50] = _texture(20, 30, seed=9)
    cref = [_texture(h // 2, w // 2, seed=s) for s in (5, 6)]
    ccur = [np.roll(c, (2, -1), (0, 1)) for c in cref]
    extra = (np.array([[0, 0], [3, -5], [-9, 12], [1, 1]],
                      np.int32)[:kw.get("n_extra", 0)]
             if with_extra else None)
    chroma = (bs // 2, bs // 2, h // 2, w // 2) if with_chroma else None
    t_body = t_me.make_me_body(h, w, bs, bs, nbx, nby, chroma=chroma, **kw)
    j_body = jax.jit(j_me.make_me_body(h, w, bs, bs, nbx, nby,
                                       chroma=chroma, **kw))
    t_cpl = (tuple(torch.tensor(x) for x in ccur + cref)
             if with_chroma else None)
    j_cpl = (tuple(jnp.asarray(x) for x in ccur + cref)
             if with_chroma else None)
    got = t_body(torch.tensor(cur), torch.tensor(ref), extra, t_cpl)
    want = j_body(jnp.asarray(cur), jnp.asarray(ref),
                  None if extra is None else jnp.asarray(extra), j_cpl)
    for g, w_, name in zip(got, want, ("dy", "dx", "sad")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_),
                                      err_msg=name)
    # a batch of two pictures: each comes out as it does alone
    cur2 = np.roll(ref, (2, 2), (0, 1))
    t_cpl2 = (tuple(torch.stack([torch.tensor(x)] * 2) for x in ccur)
              + tuple(torch.tensor(x) for x in cref)) if with_chroma \
        else None
    both = t_body(torch.stack([torch.tensor(cur), torch.tensor(cur2)]),
                  torch.tensor(ref), extra, t_cpl2)
    for g, b in zip(got, both):
        assert torch.equal(b[0], g)


@pytest.fixture(scope="module")
def shifted_pair():
    h, w = 128, 256
    ref = _texture(h, w)
    return np.roll(ref, (8, -12), axis=(0, 1)), ref


def test_phasecorr_vectors_match_jax(shifted_pair):
    cur, ref = shifted_pair
    h, w = cur.shape
    got = t_pc.make_phasecorr_fn(h, w)(torch.tensor(cur),
                                       torch.tensor(ref)).numpy()
    want = np.asarray(j_pc.make_phasecorr_fn(h, w)(jnp.asarray(cur),
                                                   jnp.asarray(ref)))
    assert got.dtype == np.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    cands = t_pc.pick_candidates(got, n=8)
    np.testing.assert_array_equal(cands, j_pc.pick_candidates(want, n=8))
    assert [-8, 12] in cands.tolist()


def test_phasecorr_small_frame_and_peaks_match_jax():
    """A frame too small for any window gives one zero window; the peak
    finder alone matches on random surfaces (ties and wraps included)."""
    got = t_pc.make_phasecorr_fn(H, W)(
        torch.tensor(_texture(H, W)), torch.tensor(_texture(H, W, 2)))
    assert got.shape == (1, 2, 2) and not got.any()
    rng = np.random.default_rng(8)
    surf = rng.normal(0, 1, (6, 16, 32)).astype(np.float32)
    surf[0] = 0.0
    surf[1, 3, 31] = 9.0
    got = t_pc._find_peaks(torch.tensor(surf), 16, 32)
    want = j_pc._find_peaks(jnp.asarray(surf), 16, 32)
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_))


def _synthetic_field(mod_params, vf_cls, chroma):
    vf = vf_cls(width=192, height=160, clean_width=192, clean_height=160,
                chroma_format=chroma)
    p = mod_params(video_format=vf, num_refs=1, transform_depth=3)
    p.set_default_codeblocks()
    p.mv_precision = 1
    return p


def test_global_estimation_matches_jax():
    """The field of tests/test_global_motion.py (pan + zoom + rotation,
    noise, 10 % outliers, DC blocks) gives the JAX package's
    GlobalMotion, and a degenerate field the identity in both."""
    from schroedinger_tpu_torch.video_format import ChromaFormat, VideoFormat
    tp = _synthetic_field(Params, VideoFormat, ChromaFormat.C420)
    jp = _synthetic_field(JParams, JVideoFormat, JChroma.C420)
    xnb, ynb = tp.x_num_blocks, tp.y_num_blocks
    b0, b1 = 6.0, -3.0
    m = np.array([[0.010, 0.004], [-0.004, 0.010]])
    ii, jj = np.meshgrid(np.arange(xnb), np.arange(ynb))
    xs = ii * tp.xbsep_luma + tp.xbsep_luma // 2
    ys = jj * tp.ybsep_luma + tp.ybsep_luma // 2
    rng = np.random.default_rng(3)
    dx = np.rint(b0 + m[0, 0] * xs + m[0, 1] * ys
                 + rng.normal(0, 0.3, xs.shape)).astype(np.int32)
    dy = np.rint(b1 + m[1, 0] * xs + m[1, 1] * ys
                 + rng.normal(0, 0.3, xs.shape)).astype(np.int32)
    out = rng.random(dx.shape) < 0.10
    dx = np.where(out, rng.integers(-40, 40, dx.shape), dx)
    dy = np.where(out, rng.integers(-40, 40, dy.shape), dy)
    mode = np.ones((ynb, xnb), np.int32)
    mode[::5, ::3] = 0
    field = {"dx1": dx, "dy1": dy, "pred_mode": mode}
    got = t_ge.estimate_global_motion(field, tp, ref=1)
    want = j_ge.estimate_global_motion(field, jp, ref=1)
    assert got.a_exp == t_ge.A_EXP and (got.a00, got.a11) != (1, 1)
    assert dataclass_tuple(got) == dataclass_tuple(want)
    few = {"dx1": dx, "dy1": dy, "pred_mode": np.zeros_like(mode)}
    assert dataclass_tuple(t_ge.estimate_global_motion(few, tp)) == \
        dataclass_tuple(j_ge.estimate_global_motion(few, jp))
    fit = t_ge.fit_affine_mv_field(dy[mode > 0], dx[mode > 0],
                                   xs[mode > 0], ys[mode > 0])
    jfit = j_ge.fit_affine_mv_field(dy[mode > 0], dx[mode > 0],
                                    xs[mode > 0], ys[mode > 0])
    np.testing.assert_allclose(fit[:6], jfit[:6], rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(fit[6], jfit[6])


def dataclass_tuple(gm):
    return (gm.b0, gm.b1, gm.a_exp, gm.a00, gm.a01, gm.a10, gm.a11,
            gm.c_exp, gm.c0, gm.c1)


SWITCHES = ["enable_hierarchical_estimation", "enable_deep_estimation",
            "enable_bigblock_estimation", "enable_zero_estimation",
            "enable_chroma_me", "enable_fullscan_estimation"]


@pytest.mark.parametrize("bits", range(0, 64, 3))
def test_estimation_tokens_match_jax_api(bits):
    """Each combination of the six enable_*_estimation settings gives the
    JAX API's estimation tokens (chroma ME needs deep estimation), and
    the port's inter step resolves them as the JAX step does."""
    kw = {name: (bits >> i) & 1 for i, name in enumerate(SWITCHES)}
    kw.update(downsample_levels=3, magic_scan_distance=2.5)
    t = t_api.Encoder(video_format(W, H), t_config.EncoderConfig(**kw),
                      device="cpu")._gop
    j = j_api.Encoder(_jvf(W, H), j_config.EncoderConfig(**kw))._gop
    assert t.estimation == j.estimation
    assert t.downsample_levels == j.downsample_levels == 3
    levels, rad, deep, bigblock, zero, chroma = t_inter._estimation(
        t.estimation, 3, 2.5)
    est = set(j.estimation)
    assert levels == (1 if est & {"fullscan", "no_hierarchical"} else 3)
    assert rad == (32 if "fullscan" in est else 5)
    assert (deep, bigblock, zero, chroma) == (
        "no_deep" not in est, "no_bigblock" not in est,
        "no_zero" not in est, "chroma_me" in est)


_STAND_IN = threading.local()


def _dense_scan_on_streams(*args):
    """The JAX `me._dense_scan` while the module's streams are made: the
    mapped stand-in on their threads, the original elsewhere."""
    if getattr(_STAND_IN, "on", False):
        return _dense_scan_mapped(*args)
    return _DENSE_SCAN(*args)


_DENSE_SCAN = j_me._dense_scan


def _stream_case(case):
    """Both packages' streams of a case (the JAX one with the stand-in
    coarse scan), and the JAX decoder's decode of the port's stream with
    its errors."""
    kw, (w, h) = STREAM_CASES[case]
    kw = dict(BASE, **kw)
    frames = make_frames(3, w, h)
    port = t_api.Encoder(video_format(w, h), t_config.EncoderConfig(**kw),
                         device="cpu").encode_stream(frames)
    _STAND_IN.on = True
    try:
        jax_stream = j_api.Encoder(_jvf(w, h), j_config.EncoderConfig(
            **kw)).encode_stream(frames)
    finally:
        _STAND_IN.on = False
    jdec = j_core.StreamDecoder()
    return frames, port, jax_stream, (jdec.decode_stream(port), jdec.errors)


@pytest.fixture(scope="module")
def streams():
    """Every stream case, each made once, on four threads that start with
    the first test that asks for them and work ahead of the next (XLA
    compiles, nearly all of the time, release the GIL): {case: future}."""
    with mock.patch.object(j_me, "_dense_scan", _dense_scan_on_streams), \
            ThreadPoolExecutor(4) as pool:
        jobs = {case: pool.submit(_stream_case, case)
                for case in STREAM_CASES}
        yield jobs
        for job in jobs.values():
            job.cancel()


@pytest.mark.parametrize("case", list(STREAM_CASES))
def test_stream_matches_jax(streams, case):
    frames, stream, j_stream, (j_out, j_errors) = streams[case].result()
    assert stream == j_stream
    assert len(j_out) == len(frames) and j_errors == []
    outs = []
    for dec in (t_api.Decoder(device="cpu"), StreamDecoder(device="cpu")):
        out = dec.decode_stream(stream)
        assert len(out) == len(frames) and dec.errors == []
        outs.append(out)
    outs.append(j_out)
    for a3, b3, c3 in zip(*outs):
        for a, b, c in zip(a3, b3, c3):
            np.testing.assert_array_equal(a, np.asarray(c))
            np.testing.assert_array_equal(b, np.asarray(c))


def test_phasecorr_codes_b_pictures_one_at_a_time():
    """Phase correlation comes first among the B-batch conditions (its
    candidates are per picture): a full subgroup goes as one batch
    without it and picture by picture with it."""
    frames = make_frames(5, 128, 64)
    for pc, want in ((0, [True]), (1, [False])):
        gop = t_api.Encoder(video_format(128, 64), t_config.EncoderConfig(
            enable_phasecorr_estimation=pc), device="cpu")._gop
        orig = gop._start_b_batch
        took = []

        def wrapped(bs_, orig=orig, took=took):
            out = orig(bs_)
            took.append(out is not None)
            return out
        gop._start_b_batch = wrapped
        gop.encode_stream(frames)
        assert took == want
