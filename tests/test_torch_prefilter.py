"""The prefilters, quality metrics and perceptual weighting of the port
against the JAX package's, on the CPU with numpy-seeded inputs.

- `ops/filters.py`: the recursive Gaussian, the adaptive Gaussian's
  sigma, the 3-tap lowpass, the center-weighted median and the
  `apply_prefilter` dispatch give the JAX package's planes exactly.
  add_noise draws from a seeded `torch.Generator`, not from the JAX
  package's threefry stream, so it is held to its statistics instead:
  the same noise on every call and device, mean within 0.05 and standard
  deviation within 2 % of `filter_value` on a mid-grey plane.
- `ops/metrics.py`: `ssim_frame` (the reference's IIR3 MSSIM, host
  float64) equal to the JAX package's; `mse`, `psnr` and the box `ssim`
  within float32 rounding.
- The per-band lambda multipliers of every perceptual weighting and
  distance equal the JAX encoder's.
- Streams through `api.Encoder` (backref engine, I + 2 P at 96x80) with
  each filter, with PSNR and SSIM on, and with each perceptual setting
  are the JAX stream byte for byte, and the per-frame PSNR / SSIM the
  encoders record are equal.  A biref stream with the Gaussian filter is
  held to the JAX per-picture path (`enable_b_batch=False` on both
  sides): the JAX batched path filters B pictures a second time, the port
  filters each picture once, batched or not.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from schroedinger_tpu import api as j_api
from schroedinger_tpu import config as j_config
from schroedinger_tpu.decoder import core as j_core
from schroedinger_tpu.encoder import gop as j_gop
from schroedinger_tpu.ops import filters as j_f
from schroedinger_tpu.ops import metrics as j_m
from schroedinger_tpu.video_format import ChromaFormat as JChroma
from schroedinger_tpu.video_format import VideoFormat as JVideoFormat
from schroedinger_tpu_torch import api as t_api
from schroedinger_tpu_torch import config as t_config
from schroedinger_tpu_torch.decoder.core import StreamDecoder
from schroedinger_tpu_torch.encoder import gop as t_gop
from schroedinger_tpu_torch.ops import filters as t_f
from schroedinger_tpu_torch.ops import metrics as t_m
from schroedinger_tpu_torch.slice_config import make_frames, video_format

torch.set_num_threads(1)

W, H = 96, 80
BASE = dict(gop_structure="backref", au_distance=6)
STREAM_CASES = {
    "gaussian": dict(filtering="gaussian", filter_value=3.0),
    "adaptive_gaussian": dict(filtering="adaptive_gaussian"),
    "lowpass": dict(filtering="lowpass", filter_value=40.0),
    "center_weighted_median": dict(filtering="center_weighted_median",
                                   filter_value=3.0),
    "psnr_ssim": dict(enable_psnr=1, enable_ssim=1),
    "gaussian_psnr_ssim": dict(filtering="gaussian", filter_value=2.0,
                               enable_psnr=1, enable_ssim=1),
    "perceptual_none": dict(perceptual_weighting="none"),
    "perceptual_manos_sakrison": dict(perceptual_weighting="manos_sakrison"),
    "perceptual_distance_1": dict(perceptual_distance=1.0),
}


def _jvf(w, h):
    return JVideoFormat(width=w, height=h, clean_width=w, clean_height=h,
                        chroma_format=JChroma.C420, frame_rate_numerator=25,
                        frame_rate_denominator=1)


def _planes(seed, w=W, h=H):
    """A textured luma with noise and two chroma planes, u8."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    y = 128 + 60 * np.sin(xx / 5.0) * np.cos(yy / 7.0) + rng.normal(0, 9,
                                                                   (h, w))
    u = rng.integers(90, 170, (h // 2, w // 2))
    v = rng.integers(60, 200, (h // 2, w // 2))
    return tuple(a.clip(0, 255).astype(np.uint8) for a in (y, u, v))


@pytest.mark.parametrize("sigma,shift", [(0.6, 0), (2.0, 0), (3.0, 1),
                                         (7.5, 0), (0.0, 0)])
def test_gaussian_lowpass_matches_jax(sigma, shift):
    y = _planes(1)[0]
    got = t_f.gaussian_lowpass(y, sigma, chroma_shift=shift)
    want = np.asarray(j_f.gaussian_lowpass(jnp.asarray(y), sigma,
                                           chroma_shift=shift))
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("tap", [0, 20, 64, 100])
def test_lowpass3_matches_jax(tap):
    y = _planes(2)[0]
    got = t_f.lowpass3(torch.tensor(y), tap).numpy()
    np.testing.assert_array_equal(got, np.asarray(j_f.lowpass3(
        jnp.asarray(y), tap)))


@pytest.mark.parametrize("weight", [1, 3, 5, 8])
def test_center_weighted_median_matches_jax(weight):
    y = _planes(3)[0]
    got = t_f.center_weighted_median(torch.tensor(y), weight).numpy()
    np.testing.assert_array_equal(got, np.asarray(
        j_f.center_weighted_median(jnp.asarray(y), weight)))


@pytest.mark.parametrize("seed", [4, 5, 6])
def test_adaptive_sigma_matches_jax(seed):
    y = _planes(seed, 128, 64)[0]
    if seed == 6:
        y = (y // 32 * 32).astype(np.uint8)      # few levels: steep slope
    assert t_f.adaptive_lowpass_sigma(y) == j_f.adaptive_lowpass_sigma(y)


@pytest.mark.parametrize("filtering,value", [
    ("none", 5.0), ("gaussian", 4.0), ("adaptive_gaussian", 5.0),
    ("lowpass", 30.0), ("center_weighted_median", 5.0), ("unknown", 5.0)])
def test_apply_prefilter_matches_jax(filtering, value):
    planes = _planes(7)
    got = t_f.apply_prefilter(planes, filtering, value)
    want = j_f.apply_prefilter(planes, filtering, value)
    for g, w_ in zip(got, want):
        assert isinstance(g, np.ndarray) and g.dtype == np.uint8
        np.testing.assert_array_equal(g, np.asarray(w_))


@pytest.mark.parametrize("amount", [2.0, 10.0])
def test_add_noise_statistics(amount):
    """The port's add_noise against its stated criterion: the same noise
    on every call, zero-mean noise of standard deviation `amount` on a
    mid-grey plane, and the JAX package's distribution of the same
    (not its values)."""
    flat = np.full((240, 320), 128, np.uint8)
    planes = (flat, flat[::2, ::2].copy(), flat[::2, ::2].copy())
    a = t_f.apply_prefilter(planes, "add_noise", amount)
    b = t_f.apply_prefilter(planes, "add_noise", amount)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    d = a[0].astype(np.float64) - 128
    assert abs(d.mean()) < 0.05 and abs(d.std() / amount - 1) < 0.02
    jd = np.asarray(j_f.apply_prefilter(planes, "add_noise", amount)[0],
                    np.float64) - 128
    assert abs(d.std() - jd.std()) < 0.02 * amount
    assert not np.array_equal(a[1], a[2])   # each plane its own draw


def test_metrics_match_jax():
    a = _planes(8)[0]
    b = t_f.gaussian_lowpass(a, 1.5)
    assert t_m.ssim_frame(a, b) == j_m.ssim_frame(a, b)
    assert t_m.ssim_frame(a, a) == j_m.ssim_frame(a, a)
    ta, tb = torch.tensor(a), torch.tensor(b)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    np.testing.assert_allclose(float(t_m.mse(ta, tb)),
                               float(j_m.mse(ja, jb)), rtol=1e-6)
    np.testing.assert_allclose(float(t_m.psnr(ta, tb)),
                               float(j_m.psnr(ja, jb)), rtol=1e-6)
    assert float(t_m.psnr(ta, ta)) == float(j_m.psnr(ja, ja)) == np.inf
    np.testing.assert_allclose(float(t_m.ssim(ta, tb)),
                               float(j_m.ssim(ja, jb)), rtol=1e-5)


@pytest.mark.parametrize("distance", [1.0, 4.0, 12.0])
@pytest.mark.parametrize("weighting", ["none", "ccir959", "moo",
                                       "manos_sakrison"])
def test_band_scales_match_jax(weighting, distance):
    kw = dict(perceptual_weighting=weighting, perceptual_distance=distance)
    for size in ((W, H), (1920, 1080)):
        t = t_gop.GopEncoder(video_format(*size), device="cpu", **kw)
        j = j_gop.GopEncoder(_jvf(*size), **kw)
        for intra in (True, False):
            np.testing.assert_array_equal(t._band_scales3(intra),
                                          j._band_scales3(intra))


@pytest.fixture(scope="module")
def streams():
    made = {}

    def get(case):
        if case not in made:
            kw = dict(BASE, **STREAM_CASES[case])
            frames = make_frames(3, W, H)
            te = t_api.Encoder(video_format(W, H),
                               t_config.EncoderConfig(**kw), device="cpu")
            je = j_api.Encoder(_jvf(W, H), j_config.EncoderConfig(**kw))
            made[case] = (frames, te.encode_stream(frames), te,
                          je.encode_stream(frames), je)
        return made[case]
    return get


def _decode_equal(stream, n):
    outs = []
    for dec in (t_api.Decoder(device="cpu"), StreamDecoder(device="cpu"),
                j_core.StreamDecoder()):
        out = dec.decode_stream(stream)
        assert len(out) == n and dec.errors == []
        outs.append(out)
    for a3, b3, c3 in zip(*outs):
        for a, b, c in zip(a3, b3, c3):
            np.testing.assert_array_equal(a, np.asarray(c))
            np.testing.assert_array_equal(b, np.asarray(c))
    return outs[0]


@pytest.mark.parametrize("case", list(STREAM_CASES))
def test_stream_matches_jax(streams, case):
    frames, stream, te, j_stream, je = streams(case)
    assert stream == j_stream
    _decode_equal(stream, len(frames))
    metrics = [{k: r[k] for k in ("psnr", "ssim") if k in r}
               for r in te._gop.stats.frames]
    assert metrics == [{k: r[k] for k in ("psnr", "ssim") if k in r}
                       for r in je._gop.stats.frames]
    if STREAM_CASES[case].get("enable_psnr"):
        assert all(set(m) == {"psnr", "ssim"} for m in metrics)


def test_stats_object_is_filled():
    """GopEncoder fills the FrameStats the caller passes."""
    from schroedinger_tpu_torch.utils.telemetry import FrameStats
    stats = FrameStats()
    enc = t_gop.GopEncoder(video_format(W, H), stats=stats,
                           enable_psnr=True, device="cpu")
    enc.encode_stream(make_frames(3, W, H))
    assert enc.stats is stats and len(stats.frames) == 3
    assert all(20 < r["psnr"] <= 99 for r in stats.frames)


def test_biref_filter_once_matches_jax_per_picture():
    """Biref with the Gaussian prefilter and B pictures: the JAX
    per-picture path (each picture filtered once) gives the port's bytes;
    the port's batched path decodes to frames whose reference pictures
    are the per-picture stream's."""
    frames = make_frames(5, W, H)
    kw = dict(au_distance=6, filtering="gaussian", filter_value=2.0)
    out = {}
    for name, api, vf, cfg in (
            ("port", t_api, video_format(W, H), t_config),
            ("jax", j_api, _jvf(W, H), j_config)):
        enc = (api.Encoder(vf, cfg.EncoderConfig(**kw), device="cpu")
               if name == "port" else api.Encoder(vf, cfg.EncoderConfig(
                   **kw)))
        enc._gop.enable_b_batch = False
        out[name] = enc.encode_stream(frames)
    assert out["port"] == out["jax"]
    batched = t_api.Encoder(video_format(W, H), t_config.EncoderConfig(**kw),
                            device="cpu").encode_stream(frames)
    a = _decode_equal(batched, len(frames))
    b = _decode_equal(out["port"], len(frames))
    for k in (0, 4):           # the I and the P picture
        for x, y in zip(a[k], b[k]):
            np.testing.assert_array_equal(x, y)


CLI_SETS = {"motion_block_size": "medium", "motion_block_overlap": "full",
            "codeblock_size": "small", "enable_chroma_me": 1,
            "enable_phasecorr_estimation": 1, "downsample_levels": 2,
            "enable_hierarchical_estimation": 1,
            "filtering": "gaussian", "filter_value": 2.5, "enable_psnr": 1,
            "enable_ssim": 1, "perceptual_weighting": "manos_sakrison",
            "perceptual_distance": 2.0}


def test_cli_set_reaches_every_setting(tmp_path):
    """`schro_tpu encode --set NAME=VAL` for this slice's settings codes
    what api.Encoder codes with them, and each reaches the GopEncoder."""
    from schroedinger_tpu_torch import y4m as t_y4m
    from schroedinger_tpu_torch.tools import schro_tpu
    frames = make_frames(3, W, H)
    src, drc = str(tmp_path / "in.y4m"), str(tmp_path / "out.drc")
    with open(src, "wb") as f:
        t_y4m.Y4MWriter(f, video_format(W, H)).write_frames(frames)
    argv = ["encode", src, drc, "--profile", "longgop", "--device", "cpu"]
    for k, v in CLI_SETS.items():
        argv += ["--set", f"{k}={v}"]
    schro_tpu.main(argv)
    cfg = schro_tpu.encoder_config("longgop")
    for k, v in CLI_SETS.items():
        cfg.set(k, v)
    enc = t_api.Encoder(video_format(W, H), cfg, device="cpu")
    assert open(drc, "rb").read() == enc.encode_stream(frames)
    gop = enc._gop
    p = gop._params(1)
    assert (p.xbsep_luma, p.xblen_luma) == (12, 24)
    assert gop.codeblock_size == "small" and gop.downsample_levels == 2
    assert gop.estimation == ("chroma_me",) and gop.enable_phasecorr
    assert (gop.filtering, gop.filter_value) == ("gaussian", 2.5)
    assert gop.enable_psnr and gop.enable_ssim
    assert (gop.perceptual_weighting, gop.perceptual_distance) == (
        "manos_sakrison", 2.0)
    assert all({"psnr", "ssim"} <= set(r) for r in gop.stats.frames)
