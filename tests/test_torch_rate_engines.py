"""Every long-GOP rate control of the port on both engines against the
JAX package's, on the CPU at 96x80 (and at two sizes that are not
multiples of 16), with numpy-seeded inputs.

- `CbrController` (the allocation controller of enable_rdo_cbr=0) on a
  seeded sequence of pictures: targets, padding, reservoir and
  correction equal (float64 numpy in both packages).
- The inter step with a host engine's picks (`qi_bands_override`) and
  its stat tables brought back (`want_stats`): the unit byte for byte,
  the tables within TABLE_RTOL.
- Whole streams through `api.Encoder`, one case per (engine, entry
  point, rate control): the JAX decoder decodes the port's stream to the
  port decoder's planes, and the stream lies within the bands of
  `tests/test_biref_gop.py` (luma PSNR within 0.7 dB, bytes within 15 %)
  of the JAX stream; whether the bytes are equal is printed (they are
  expected equal).
- Multiquant on the one-reference step and on a batch of B pictures:
  every per-codeblock quant index equal to the JAX step's.

The JAX encoder's unpipelined backref path (`push_frame`) cannot code an
on-device RD pick: its `encode_inter_picture` does not take the
`corr_bands` and `target_bits` its `_quant_args` passes, and raises
TypeError.  Its reference stream for that case is made with a stand-in
for that one function that passes every keyword on to its
`start_inter_picture` and `finish_inter_picture`, as its pipelined path
does.
"""
import threading
from concurrent.futures import ThreadPoolExecutor
from unittest import mock

import numpy as np
import pytest
import torch

from tests import jax_cache  # noqa: F401 (turns the disk cache on)
from schroedinger_tpu import api as j_api
from schroedinger_tpu import config as j_config
from schroedinger_tpu.decoder import core as j_core
from schroedinger_tpu.encoder import inter as j_inter
from schroedinger_tpu.encoder import intra as j_intra
from schroedinger_tpu.encoder import ratecontrol as j_rc
from schroedinger_tpu.video_format import ChromaFormat as JChroma
from schroedinger_tpu.video_format import VideoFormat as JVideoFormat
from schroedinger_tpu_torch import api as t_api
from schroedinger_tpu_torch import config as t_config
from schroedinger_tpu_torch import convert
from schroedinger_tpu_torch.encoder import inter as t_inter
from schroedinger_tpu_torch.encoder import ratecontrol as t_rc
from schroedinger_tpu_torch.params import subband_count
from schroedinger_tpu_torch.slice_config import make_frames, video_format

torch.set_num_threads(1)

W, H = 96, 80
# the float32 stat tables (see tests/test_torch_rate.py)
TABLE_RTOL = 2e-6

BACKREF = dict(gop_structure="backref")
ALLOC = dict(rate_control="constant_bitrate", bitrate=300_000,
             enable_rdo_cbr=False)
# a cleaner target than constant_error's default (noise_threshold 25), so
# that the two engines' cases code different streams
NOISE = dict(rate_control="constant_noise_threshold", noise_threshold=40.0)
# id -> (entry point, EncoderConfig keywords, frames, (width, height)),
# in an order where the cases that share the JAX package's compiled
# programs follow each other.  Backref streams: I and four P (the
# host-pick engines engage from the second P).  Biref streams: I, a
# one-reference P, three B, a two-reference P, three B (under a host
# pick each B goes on its own).
CASES = {
    "backref_constant_quality": ("stream", BACKREF, 5, (W, H)),
    "backref_constant_lambda": (
        "stream", dict(BACKREF, rate_control="constant_lambda"), 5, (W, H)),
    "backref_cbr": ("stream", dict(BACKREF, rate_control="constant_bitrate",
                                   bitrate=300_000), 5, (W, H)),
    "backref_push_constant_quality": ("push", BACKREF, 5, (W, H)),
    "backref_constant_error": (
        "stream", dict(BACKREF, rate_control="constant_error"), 5, (W, H)),
    "backref_constant_noise_threshold": (
        "stream", dict(BACKREF, **NOISE), 5, (W, H)),
    "backref_alloc_cbr": ("stream", dict(BACKREF, **ALLOC), 5, (W, H)),
    "backref_push_alloc_cbr": ("push", dict(BACKREF, **ALLOC), 5, (W, H)),
    "constant_error": ("stream", dict(rate_control="constant_error"), 9,
                       (W, H)),
    "constant_noise_threshold": ("stream", NOISE, 9, (W, H)),
    "alloc_cbr": ("stream", ALLOC, 9, (W, H)),
    # sizes off the 16-pixel block grid: each engine at one of them
    "72x66_backref_constant_quality": ("stream", BACKREF, 4, (72, 66)),
    "79x79_alloc_cbr": ("stream", ALLOC, 5, (79, 79)),
}
# multiquant on the default engine (biref, constant quality): I, a
# one-reference P, a batch of three B
MQ = dict(enable_multiquant=True)
MQ_FRAMES = 5
# the host-pick step's engine
HOST_PICK = dict(BACKREF, rate_control="constant_error")


def _jvf(w, h):
    return JVideoFormat(width=w, height=h, clean_width=w, clean_height=h,
                        chroma_format=JChroma.C420,
                        frame_rate_numerator=25, frame_rate_denominator=1)


def _jax_encode_inter_picture(planes_u8, p, frame_number, ref1_num, ref1,
                              base_qi=20, is_ref=True, retired=None, **kw):
    """The JAX package's encode_inter_picture with every keyword of its
    start_inter_picture passed on (see the module docstring)."""
    pend = j_inter.start_inter_picture(planes_u8, p, ref1, base_qi=base_qi,
                                       **kw)
    unit, stats = j_inter.finish_inter_picture(pend, frame_number, ref1_num,
                                               is_ref=is_ref,
                                               retired=retired)
    return (unit, pend["recon"], base_qi, stats, pend["up"],
            pend.get("dc_ratio", 0.0), pend)


def _encode(enc, entry, frames):
    if entry == "stream":
        return enc.encode_stream(frames)
    out = bytearray()
    for f in frames:
        enc.push_frame(f)
        out += enc.pull() or b""
    out += enc.end_of_stream()
    return bytes(out)


def _psnr(out, frames):
    vals = []
    for (y, _, _), (y0, _, _) in zip(out, frames):
        mse = np.mean((np.asarray(y, np.float64) - y0) ** 2)
        vals.append(99.0 if mse == 0 else 10 * np.log10(255.0 ** 2 / mse))
    return float(np.mean(vals))


def _record_unit_picks(module, only=None):
    """Patch a package's finish_inter_picture to keep, per picture number,
    its band picks and multiquant codeblock picks (with `only`, a
    threading.local, those of a thread while its `on` is set: other
    encodes pass through)."""
    seen = {}
    orig = module.finish_inter_picture

    def recording(pending, frame_number, *a, **k):
        out = orig(pending, frame_number, *a, **k)
        if only is None or getattr(only, "on", False):
            seen[frame_number] = (np.asarray(pending["qi_bands"]).ravel(),
                                  dict(pending.get("qi_cb", {})))
        return out
    return mock.patch.object(module, "finish_inter_picture", recording), seen


def _controller_fields(c):
    return (c.buffer_level, c.correction, c.buffer_size,
            c.bits_per_picture)


def _stream_case(case):
    """Both packages' streams of a case, and the JAX decoder's decode of
    the port's stream with its errors."""
    entry, kw, n, (w, h) = CASES[case]
    frames = make_frames(n, w, h)
    port = _encode(t_api.Encoder(video_format(w, h),
                                 t_config.EncoderConfig(**kw),
                                 device="cpu"), entry, frames)
    jax = _encode(j_api.Encoder(_jvf(w, h), j_config.EncoderConfig(**kw)),
                  entry, frames)
    jdec = j_core.StreamDecoder()
    return frames, port, jax, (jdec.decode_stream(port), jdec.errors)


def _jax_host_pick(me_levels):
    """Picture 0 intra-coded by the JAX package at quant index 12, then
    picture 1 through its one-reference step at a seeded host pick with
    the stat tables wanted: (the reconstruction's planes, the override,
    the pending picture, finish's output)."""
    frames = make_frames(2, W, H)
    jgop = j_api.Encoder(_jvf(W, H), j_config.EncoderConfig(
        **HOST_PICK))._gop
    _, rec = j_intra.encode_picture(frames[0], jgop._params(0), 0,
                                    quant_indices=12, is_ref=True,
                                    return_recon=True)
    planes = tuple(np.asarray(pl) for pl in rec)
    p_j = jgop._params(1)
    override = np.random.default_rng(5).integers(
        10, 34, subband_count(p_j.transform_depth))
    jp = j_inter.start_inter_picture(frames[1], p_j, j_core.RefFrame(planes),
                                     qi_bands_override=override,
                                     want_stats=True, me_levels=me_levels)
    return planes, override, jp, j_inter.finish_inter_picture(jp, 1, 0)


def _jax_multiquant(only):
    """The JAX multiquant stream, its picks (recorded while `only.on` is
    set on this thread) and its B batches."""
    enc = j_api.Encoder(_jvf(W, H), j_config.EncoderConfig(**MQ))
    batches = []
    orig = enc._gop._start_b_batch

    def wrapped(bs_):
        took = orig(bs_)
        batches.append(([b[0] for b in bs_], took is not None))
        return took
    enc._gop._start_b_batch = wrapped
    only.on = True
    try:
        return enc.encode_stream(make_frames(MQ_FRAMES, W, H)), batches
    finally:
        only.on = False


@pytest.fixture(scope="module")
def jax_side():
    """The module's encodes and the reference side of its comparisons,
    each made once, on eight threads that start with the first test that
    asks for them and work ahead of the next (XLA compiles, nearly all of
    the time, release the GIL): ({key: future}, the JAX multiquant picks).  The JAX streams are
    made with the stand-in encode_inter_picture (see the module
    docstring)."""
    only = threading.local()
    patch, seen = _record_unit_picks(j_inter, only)
    with patch, mock.patch.object(j_inter, "encode_inter_picture",
                                  _jax_encode_inter_picture), \
            ThreadPoolExecutor(8) as pool:
        levels = t_api.Encoder(video_format(W, H), t_config.EncoderConfig(
            **HOST_PICK), device="cpu")._gop.downsample_levels
        jobs = {"multiquant": pool.submit(_jax_multiquant, only),
                "host_pick": pool.submit(_jax_host_pick, levels)}
        # the longest first: the odd sizes, then the biref host picks
        for case in sorted(CASES, key=lambda c: (CASES[c][3] == (W, H),
                                                 CASES[c][2] < 9)):
            jobs[case] = pool.submit(_stream_case, case)
        yield jobs, seen
        for job in jobs.values():
            job.cancel()


def test_cbr_controller_matches_jax():
    """40 seeded (kind, bits, estimate) pictures through both packages'
    CbrController: every target, padding, reservoir level and correction
    equal (float64 arithmetic, so equal means equal); the reservoir both
    overruns (padding) and underruns on the way."""
    rng = np.random.default_rng(11)
    kw = dict(buffer_size=0, buffer_level=0, keyframe_weight=7.5,
              inter_p_weight=1.5, inter_b_weight=0.2, allocation_scale=1.1)
    t = t_rc.CbrController(300_000, 25.0, 12, **kw)
    j = j_rc.CbrController(300_000, 25.0, 12, **kw)
    assert _controller_fields(t) == _controller_fields(j)
    pads = levels = 0
    for step in range(40):
        kind = "IPB"[rng.integers(3)] if step else "I"
        extra = float(rng.uniform(0.0, 3.0))
        target = t.frame_target(kind=kind, extra_weight=extra)
        assert target == j.frame_target(kind=kind, extra_weight=extra)
        assert t.frame_target(kind == "I") == j.frame_target(kind == "I")
        # spend from a tenth of the target to several times it; twice
        # more than the reservoir holds, twice (at a full reservoir) less
        # than the rate
        bits = int(target * rng.uniform(0.1, 6.0 if step > 30 else 1.5))
        if step in (12, 33):
            bits = int(1.2 * t.buffer_size)
        elif step in (0, 20):
            # below the per-picture rate at a full reservoir: padding
            bits = int(0.2 * t.bits_per_picture)
        est = None if step % 5 == 0 else float(bits * rng.uniform(0.7, 1.3))
        pad = t.update(bits, est)
        assert pad == j.update(bits, est)
        assert _controller_fields(t) == _controller_fields(j), step
        pads += pad > 0
        levels += t.buffer_level == 0
    assert pads and levels and t.correction != 1.0


@pytest.mark.parametrize("kw", [
    dict(gop_structure="backref"),
    dict(gop_structure="backref", rate_control="constant_lambda"),
    dict(gop_structure="backref", rate_control="constant_bitrate",
         bitrate=300_000, enable_rdo_cbr=True),
    dict(gop_structure="backref", rate_control="constant_bitrate",
         bitrate=300_000, enable_rdo_cbr=False),
    dict(rate_control="constant_error"),
    dict(rate_control="constant_noise_threshold"),
    dict(gop_structure="backref", rate_control="constant_error"),
    dict(gop_structure="backref", rate_control="constant_noise_threshold"),
    dict(rate_control="constant_bitrate", bitrate=300_000,
         enable_rdo_cbr=False),
    dict(enable_multiquant=True),
    dict(enable_multiquant=True, enable_dc_multiquant=True),
], ids=["backref", "backref_lambda", "backref_tm5", "backref_alloc",
        "error", "noise_threshold", "backref_error",
        "backref_noise_threshold", "alloc", "multiquant",
        "dc_multiquant"])
def test_settings_encode_on_the_cpu(kw):
    """Each setting builds `api.Encoder` on the CPU and codes a short
    stream through encode_stream and through push_frame / pull that the
    port's decoder reads back.  On the biref engine the two give the same
    bytes; the backref engine's push path codes each picture to its end
    before the next (other rate-control lags, other bytes)."""
    frames = make_frames(3, W, H)
    cfg = t_config.EncoderConfig(**kw)
    stream = t_api.Encoder(video_format(W, H), cfg,
                           device="cpu").encode_stream(frames)
    enc = t_api.Encoder(video_format(W, H), cfg, device="cpu")
    pushed = _encode(enc, "push", frames)
    if kw.get("gop_structure") != "backref":
        # the biref engine's push path is its stream path
        assert pushed == stream
    dec = t_api.Decoder(device="cpu")
    assert len(dec.decode_stream(stream)) == 3 and dec.errors == []
    dec = t_api.Decoder(device="cpu")
    assert len(dec.decode_stream(pushed)) == 3 and dec.errors == []


@pytest.fixture(scope="module")
def host_pick_picture(jax_side):
    """Picture 1 against picture 0 (intra-coded by the JAX package at
    quant index 12) through both packages' one-reference step at a seeded
    host pick, with the stat tables wanted."""
    frames = make_frames(2, W, H)
    tgop = t_api.Encoder(video_format(W, H), t_config.EncoderConfig(
        **HOST_PICK), device="cpu")._gop
    planes, override, jp, j_out = jax_side[0]["host_pick"].result()
    p_t = tgop._params(1)
    nb = subband_count(p_t.transform_depth)
    tp = t_inter.start_inter_picture(
        frames[1], p_t, convert.ref_frame_from_numpy(planes, device="cpu"),
        device="cpu", qi_bands_override=override, want_stats=True,
        me_levels=tgop.downsample_levels)
    t_out = t_inter.finish_inter_picture(tp, 1, 0)
    return override, nb, (tp, t_out), (jp, j_out)


def test_host_pick_step_matches_jax(host_pick_picture):
    """The override (nb,) tiled to the three components, the parse unit
    byte for byte, the stat tables that come back within TABLE_RTOL, the
    arith-correction estimates from them, and the reconstruction."""
    override, nb, (tp, (tunit, tstats)), (jp, (junit, jstats)) = \
        host_pick_picture
    np.testing.assert_array_equal(tp["qi_bands"], np.tile(override, 3))
    np.testing.assert_array_equal(tp["qi_bands"], jp["qi_bands"])
    assert tunit == junit
    assert tp["lam_scale"] is None and tp["target_bits"] is None
    for t, j in zip(tstats, jstats):
        assert t.dtype == np.float32 and t.shape == (61, 3 * nb)
        np.testing.assert_allclose(t, j, rtol=TABLE_RTOL)
    np.testing.assert_allclose(tp["band_bits_est"], jp["band_bits_est"],
                               rtol=TABLE_RTOL)
    np.testing.assert_array_equal(tp["band_bits_actual"],
                                  jp["band_bits_actual"])
    for a, b in zip(tp["recon"], jp["recon"]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("case", list(CASES))
def test_stream_matches_jax(jax_side, case):
    frames, stream, j_stream, (theirs_of_mine, j_errors) = \
        jax_side[0][case].result()
    print(f"{case}: port {len(stream)} bytes, JAX {len(j_stream)} bytes, "
          f"byte-equal: {stream == j_stream}")
    dec = t_api.Decoder(device="cpu")
    mine = dec.decode_stream(stream)
    assert len(mine) == len(frames) and dec.errors == []
    assert len(theirs_of_mine) == len(frames) and j_errors == []
    for a3, b3 in zip(theirs_of_mine, mine):
        for a, b in zip(a3, b3):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    theirs = t_api.Decoder(device="cpu").decode_stream(j_stream)
    assert abs(_psnr(mine, frames) - _psnr(theirs, frames)) < 0.7
    assert abs(len(stream) - len(j_stream)) < 0.15 * len(j_stream)


@pytest.fixture(scope="module")
def multiquant(jax_side):
    """Both packages' multiquant streams, with each picture's band and
    codeblock picks and whether its subgroup went as one batch."""
    jobs, j_seen = jax_side
    frames = make_frames(MQ_FRAMES, W, H)
    # the port's encodes of jax_side's threads pass through the recorder
    only = threading.local()
    patch, seen = _record_unit_picks(t_inter, only)
    enc = t_api.Encoder(video_format(W, H), t_config.EncoderConfig(**MQ),
                        device="cpu")
    batches = []
    orig = enc._gop._start_b_batch

    def wrapped(bs_):
        took = orig(bs_)
        batches.append(([b[0] for b in bs_], took is not None))
        return took
    enc._gop._start_b_batch = wrapped
    only.on = True
    with patch:
        stream = enc.encode_stream(frames)
    only.on = False
    j_stream, j_batches = jobs["multiquant"].result()
    return frames, {"port": (stream, seen, batches),
                    "jax": (j_stream, j_seen, j_batches)}


def test_multiquant_codeblock_picks_match_jax(multiquant):
    """Every codeblock's quant index of every inter picture equal to the
    JAX step's: the one-reference P and the three B of one batch; the
    refinement is active (a band's codeblocks take different indices);
    the stream decodes on the JAX decoder to the port decoder's planes
    and lies within the bands of the JAX stream."""
    frames, out = multiquant
    (stream, seen, batches), (j_stream, j_seen, j_batches) = (out["port"],
                                                              out["jax"])
    print(f"multiquant: port {len(stream)} bytes, JAX {len(j_stream)} "
          f"bytes, byte-equal: {stream == j_stream}")
    assert batches == j_batches == [([1, 2, 3], True)]
    assert sorted(seen) == sorted(j_seen) == [1, 2, 3, 4]
    varied = 0
    for num in seen:
        (qi, cb), (j_qi, j_cb) = seen[num], j_seen[num]
        np.testing.assert_array_equal(qi, j_qi)
        assert sorted(cb) == sorted(j_cb) and cb, num
        for key in cb:
            np.testing.assert_array_equal(cb[key], j_cb[key])
            varied += len(np.unique(cb[key])) > 1
    assert varied
    dec = t_api.Decoder(device="cpu")
    mine = dec.decode_stream(stream)
    assert len(mine) == MQ_FRAMES and dec.errors == []
    jdec = j_core.StreamDecoder()
    for a3, b3 in zip(jdec.decode_stream(stream), mine):
        for a, b in zip(a3, b3):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert jdec.errors == []
    theirs = t_api.Decoder(device="cpu").decode_stream(j_stream)
    assert abs(_psnr(mine, frames) - _psnr(theirs, frames)) < 0.7
    assert abs(len(stream) - len(j_stream)) < 0.15 * len(j_stream)
