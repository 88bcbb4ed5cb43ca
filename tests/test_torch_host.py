"""The port's own copies of the host modules against the JAX package's, on
seeded inputs on the CPU: the C++ entropy coder (built from the port's own
source into build/), MD5, MV coding, stream headers, Params, the tables
and the perceptual band weights.  Everything here is integer or float64
host code, so every comparison is exact.
"""
import dataclasses
import os

import numpy as np
import pytest

from schroedinger_tpu import bitstream as j_bs
from schroedinger_tpu import params as j_params
from schroedinger_tpu import tables as j_tables
from schroedinger_tpu import video_format as j_vf
from schroedinger_tpu.coding import native as j_native
from schroedinger_tpu.coding import subband as j_sb
from schroedinger_tpu.encoder import weights as j_weights
from schroedinger_tpu.wavelets import Wavelet as JWavelet
from schroedinger_tpu_torch import bitstream as t_bs
from schroedinger_tpu_torch import params as t_params
from schroedinger_tpu_torch import tables as t_tables
from schroedinger_tpu_torch import video_format as t_vf
from schroedinger_tpu_torch.coding import native as t_native
from schroedinger_tpu_torch.coding import subband as t_sb
from schroedinger_tpu_torch.encoder import weights as t_weights
from schroedinger_tpu_torch.wavelets import Wavelet as TWavelet

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _vf(mod, w, h):
    return mod.VideoFormat(width=w, height=h, clean_width=w, clean_height=h,
                           chroma_format=mod.ChromaFormat.C420,
                           frame_rate_numerator=25, frame_rate_denominator=1)


def test_coder_library_is_the_ports_own_build():
    lib = t_native.build()
    assert os.path.dirname(lib) == os.path.join(REPO, "build",
                                                "schroedinger_tpu_torch")
    assert os.path.exists(lib)
    assert os.path.commonpath([lib, j_native._SO]) == REPO
    with open(t_native._SRC, "rb") as a, open(j_native._SRC, "rb") as b:
        # the same coder: the sources differ in one comment line
        la, lb = a.read().splitlines(), b.read().splitlines()
    assert len(la) == len(lb)
    assert sum(x != y for x, y in zip(la, lb)) == 1


@pytest.mark.parametrize("position,shape,hcb,vcb,scale", [
    (0, (8, 16), 1, 1, 40), (1, (8, 16), 1, 1, 6), (5, (16, 32), 2, 2, 3),
    (11, (32, 64), 4, 3, 1)])
def test_subband_arith_bytes_and_round_trip(position, shape, hcb, vcb, scale):
    rng = np.random.default_rng(position)
    qdata = np.round(rng.laplace(0, scale, shape)).astype(np.int64)
    parent = None
    if position >= 4:
        parent = np.round(rng.laplace(0, scale, (shape[0] // 2,
                                                 shape[1] // 2))).astype(
            np.int64)
    qi = np.full((vcb, hcb), 12, np.int32)
    got = t_sb.encode_subband_arith(qdata, parent, position, hcb, vcb,
                                    False, qi)
    want = j_sb.encode_subband_arith(qdata, parent, position, hcb, vcb,
                                     False, qi)
    assert got[0] == want[0] and got[1] == want[1]
    assert len(got[0]) > 0
    for sb in (t_sb, j_sb):
        dec = sb.decode_subband_arith(got[0], shape, 12, parent, position,
                                      hcb, vcb, False, is_intra=False)
        back, _ = t_sb.quantise_subband(dec, qi, position, hcb, vcb,
                                        is_intra=False)
        np.testing.assert_array_equal(back, qdata)


def test_quantise_subband_intra_dc_predict_matches():
    rng = np.random.default_rng(5)
    band = rng.integers(-400, 400, (9, 13)).astype(np.int64)
    qi = np.full((1, 1), 17, np.int32)
    for a, b in zip(t_sb.quantise_subband(band, qi, 0, 1, 1, is_intra=True),
                    j_sb.quantise_subband(band, qi, 0, 1, 1, is_intra=True)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(t_native.dc_predict_integrate(band),
                                  j_native.dc_predict_integrate(band))


def test_frame_md5_matches():
    rng = np.random.default_rng(1)
    planes = (rng.integers(0, 256, (34, 50)).astype(np.uint8),
              rng.integers(0, 256, (17, 25)).astype(np.uint8),
              rng.integers(0, 256, (17, 25)).astype(np.uint8))
    assert t_native.frame_md5(planes) == j_native.frame_md5(planes)
    assert len(t_native.frame_md5(planes)) == 16


@pytest.mark.parametrize("num_refs", [1, 2])
def test_motion_encode_decode_matches(num_refs):
    rng = np.random.default_rng(num_refs)
    ynb, xnb = 8, 12
    split = np.repeat(np.repeat(rng.integers(0, 3, (ynb // 4, xnb // 4)),
                                4, 0), 4, 1)
    mode = rng.integers(0, 2 ** num_refs, (ynb, xnb))
    mv = {"split": split, "pred_mode": mode,
          "using_global": np.zeros((ynb, xnb), np.int64)}
    for k in ("dx1", "dy1", "dx2", "dy2"):
        use = (mode & (1 if k.endswith("1") else 2)) != 0
        mv[k] = rng.integers(-40, 41, (ynb, xnb)) * use
    for k in ("dc0", "dc1", "dc2"):
        mv[k] = rng.integers(-128, 128, (ynb, xnb)) * (mode == 0)
    # a split-0/1 superblock codes one value per unit: make fields
    # constant inside each coded unit so that decode gives them back
    for k in list(mv):
        if k == "split":
            continue
        f = mv[k].copy()
        for sy in range(0, ynb, 4):
            for sx in range(0, xnb, 4):
                step = {0: 4, 1: 2, 2: 1}[int(split[sy, sx])]
                for y in range(sy, sy + 4, step):
                    for x in range(sx, sx + 4, step):
                        f[y:y + step, x:x + step] = f[y, x]
        mv[k] = f
    mv = {k: np.ascontiguousarray(v, np.int32) for k, v in mv.items()}
    got = t_native.motion_encode(mv, xnb, ynb, num_refs)
    want = j_native.motion_encode(mv, xnb, ynb, num_refs)
    assert got == want
    for nat in (t_native, j_native):
        dec = nat.motion_decode(got, xnb, ynb, num_refs, False, False)
        for k in mv:
            np.testing.assert_array_equal(dec[k], mv[k], err_msg=k)


@pytest.mark.parametrize("w,h", [(1920, 1080), (128, 64)])
def test_sequence_header_bytes_and_params_defaults(w, h):
    tvf, jvf = _vf(t_vf, w, h), _vf(j_vf, w, h)
    assert dataclasses.asdict(tvf) == dataclasses.asdict(jvf)
    assert (t_bs.write_sequence_header(tvf, profile=8, level=0)
            == j_bs.write_sequence_header(jvf, profile=8, level=0))
    for num_refs, wav in ((0, 1), (2, 1), (1, 0)):
        tp = t_params.Params(video_format=tvf, num_refs=num_refs,
                             transform_depth=3,
                             wavelet_filter_index=TWavelet(wav))
        jp = j_params.Params(video_format=jvf, num_refs=num_refs,
                             transform_depth=3,
                             wavelet_filter_index=JWavelet(wav))
        for p in (tp, jp):
            p.set_default_codeblocks()
            p.set_default_quant_matrix()
        assert dataclasses.asdict(tp) == dataclasses.asdict(jp)
        for name in ("iwt_luma_width", "iwt_luma_height", "iwt_chroma_width",
                     "iwt_chroma_height", "x_num_blocks", "y_num_blocks"):
            assert getattr(tp, name) == getattr(jp, name), name


def test_tables_and_parse_codes_match():
    for name in ("QUANT_FACTOR", "QUANT_OFFSET_1_2", "QUANT_OFFSET_3_8",
                 "LOWDELAY_QUANTS"):
        a, b = getattr(t_tables, name), getattr(j_tables, name)
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b, name)
        else:
            assert a == b, name
    for args in ((True, 0, False, False), (True, 2, False, False),
                 (False, 2, False, False), (True, 1, False, True)):
        assert t_bs.parse_code_picture(*args) == j_bs.parse_code_picture(
            *args)
    assert t_bs.make_eos_unit() == j_bs.make_eos_unit()
    assert (t_bs.make_aux_unit(t_bs.AUX_BITRATE, b"\x00\x7a\x12\x00")
            == j_bs.make_aux_unit(j_bs.AUX_BITRATE, b"\x00\x7a\x12\x00"))
    assert t_bs.make_padding_unit(40) == j_bs.make_padding_unit(40)


@pytest.mark.parametrize("wavelet", list(range(7)))
@pytest.mark.parametrize("intra", [True, False])
def test_band_lambda_scales_match(wavelet, intra):
    cpd_t = t_weights.cycles_per_degree(1080, 1, 1, 4.0, False)
    cpd_j = j_weights.cycles_per_degree(1080, 1, 1, 4.0, False)
    assert cpd_t == cpd_j
    kw = dict(inter_cpd_scale=1.0, intra=intra, subband0_scale=10.0,
              diagonal_scale=1.0)
    got = t_weights.band_lambda_scales(TWavelet(wavelet), 3, "ccir959",
                                       *cpd_t, **kw)
    want = j_weights.band_lambda_scales(JWavelet(wavelet), 3, "ccir959",
                                        *cpd_j, **kw)
    np.testing.assert_array_equal(got, want)
    assert got.shape == (10,) and np.all(got > 0)
