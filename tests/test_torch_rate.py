"""The port's rate control against the JAX package's, on the CPU at 96x80
with numpy-seeded inputs: the 61-way stat tables (integer parts exact, the
float32 tables within a stated tolerance), the RD pick and lambda fit
(exact on the JAX tables), the controllers and the host picks (exact: they
are float64 numpy in both packages).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from schroedinger_tpu.decoder import core as j_core
from schroedinger_tpu.encoder import gop as j_gop
from schroedinger_tpu.encoder import inter as j_inter
from schroedinger_tpu.encoder import intra as j_intra
from schroedinger_tpu.encoder import ratecontrol as j_rc
from schroedinger_tpu.ops import quant as j_quant
from schroedinger_tpu import tables as j_tables
from schroedinger_tpu_torch import convert
from schroedinger_tpu_torch.encoder import gop as t_gop
from schroedinger_tpu_torch.encoder import inter as t_inter
from schroedinger_tpu_torch.encoder import intra as t_intra
from schroedinger_tpu_torch.encoder import ratecontrol as t_rc
from schroedinger_tpu_torch.slice_config import (CONFIG_FLAGSHIP,
                                                 make_frames, video_format)

torch.set_num_threads(1)

W, H = 96, 80
# The float32 tables: the port sums the error terms in float64 and rounds
# once, the JAX package keeps float32 running sums in XLA's order, and
# both take float32 log2 for the flag entropy.  1e-5 relative was asked
# for; 2e-6 is what these inputs need (measured 4e-7 at most).
TABLE_RTOL = 2e-6


@pytest.fixture(scope="module")
def frames():
    return make_frames(3, W, H)


@pytest.fixture(scope="module")
def encoders():
    vf = video_format(W, H)
    return (t_gop.GopEncoder(vf, device="cpu", **CONFIG_FLAGSHIP),
            j_gop.GopEncoder(vf, **CONFIG_FLAGSHIP))


@pytest.fixture(scope="module")
def refs(frames, encoders):
    """Two references (frames 0 and 2, intra-coded by the JAX package at
    quant index 12) in both packages' RefFrame."""
    _, jenc = encoders
    out = []
    for k in (0, 2):
        _, rec = j_intra.encode_picture(frames[k], jenc._params(0), k,
                                        quant_indices=12, is_ref=True,
                                        return_recon=True)
        planes = tuple(np.asarray(pl) for pl in rec)
        out.append((convert.ref_frame_from_numpy(planes, device="cpu"),
                    j_core.RefFrame(planes)))
    return out


def _band_lists(rng, depth=3):
    """Three components' subband arrays of a (H, W) / 4:2:0 pyramid."""
    lists = []
    for (h, w) in ((H, W), (H // 2, W // 2), (H // 2, W // 2)):
        bands = [rng.integers(-900, 900, (h >> depth, w >> depth))]
        for level in range(depth):
            sh = depth - level
            for _ in range(3):
                scale = 40 >> level
                bands.append(np.round(rng.laplace(0, max(scale, 2),
                                                  (h >> sh, w >> sh))))
        lists.append([b.astype(np.int16) for b in bands])
    return lists


def test_sint_bits_and_error_metric_match():
    rng = np.random.default_rng(0)
    v = rng.integers(-70000, 70000, 4096).astype(np.int32)
    v[:64] = np.arange(-32, 32)
    np.testing.assert_array_equal(
        t_rc._sint_bits(torch.tensor(v)).numpy(),
        np.asarray(j_rc._sint_bits(jnp.asarray(v))))
    ad = np.abs(rng.normal(0, 30, 4096)).astype(np.float32)
    for power in (1.0, 2.0, 4.0, 5.0):
        np.testing.assert_array_equal(
            t_rc.error_metric(torch.tensor(ad), power).numpy(),
            np.asarray(j_rc.error_metric(jnp.asarray(ad), power)))


@pytest.mark.parametrize("intra", [True, False])
def test_stats_tables_match(encoders, intra):
    tenc, jenc = encoders
    lists = _band_lists(np.random.default_rng(3 + intra))
    p = jenc._params(0 if intra else 2)
    jb, je = j_rc.stats_tables(lists, p, intra=intra)
    tb, te = t_rc.stats_tables(
        [[torch.tensor(b) for b in bands] for bands in lists],
        tenc._params(0 if intra else 2), intra=intra)
    assert tb.shape == jb.shape == (61, 30) and tb.dtype == np.float32
    for target in (2_000, 60_000, 10 ** 9):
        assert (t_rc.pick_base_qi(
            [[torch.tensor(b) for b in bands] for bands in lists],
            tenc._params(0), target, intra, correction=0.8)
            == j_rc.pick_base_qi(lists, p, target, intra, correction=0.8))
    np.testing.assert_allclose(tb, jb, rtol=TABLE_RTOL)
    np.testing.assert_allclose(te, je, rtol=TABLE_RTOL)


@pytest.mark.parametrize("intra", [True, False])
def test_table_integer_parts_are_exact(intra):
    """Magnitude bits and nonzero counts against integer sums of the JAX
    package's own quantiser and sint length."""
    rng = np.random.default_rng(11)
    flat = np.round(rng.laplace(0, 25, 6000)).astype(np.int32)
    bounds = [(0, 0, 1000), (1, 1000, 1500), (2, 1500, 6000), (1, 0, 10)]
    mag, nz, err = t_rc.band_counts(torch.tensor(flat), bounds, 3, intra)
    QF = np.asarray(j_tables.QUANT_FACTOR)
    QO = np.asarray(j_tables.QUANT_OFFSET_1_2 if intra
                    else j_tables.QUANT_OFFSET_3_8)
    for base in (0, 7, 23, 60):
        qq = np.asarray(j_quant.quantise(jnp.asarray(flat), int(QF[base]),
                                         int(QO[base])))
        dq = np.asarray(j_quant.dequantise(jnp.asarray(qq), int(QF[base]),
                                           int(QO[base])))
        bits = (np.asarray(j_rc._sint_bits(jnp.asarray(qq))) - 1) * (qq != 0)
        e2 = np.square(np.abs(flat - dq).astype(np.float32))
        e4 = e2 * e2                      # float32, as both packages
        want_mag = np.zeros(3, np.int64)
        want_nz = np.zeros(3, np.int64)
        want_err = np.zeros(3, np.float64)
        for col, lo, hi in bounds:
            want_mag[col] += bits[lo:hi].sum()
            want_nz[col] += (qq[lo:hi] != 0).sum()
            want_err[col] += e4[lo:hi].astype(np.float64).sum()
        np.testing.assert_array_equal(mag[base].numpy(), want_mag)
        np.testing.assert_array_equal(nz[base].numpy(), want_nz)
        np.testing.assert_allclose(err[base].numpy(), want_err, rtol=1e-12)
    got = t_rc.bits_per_base(torch.tensor(flat),
                             torch.zeros(6000, dtype=torch.int32), intra)
    want = j_rc.bits_per_base(jnp.asarray(flat),
                              jnp.zeros(6000, jnp.int32), jnp.asarray(intra))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _two_ref_pictures(frames, refs, encoders, lam, target, corr):
    """Frame 1 between the two references through both packages' step;
    returns the two finished pending dicts and units."""
    tenc, jenc = encoders
    (t0, j0), (t2, j2) = refs
    kw = dict(lam_bands=lam, me_lam=4.0, target_bits=target,
              corr_bands=corr)
    jp = j_inter.start_inter_picture(frames[1], jenc._params(2), j0,
                                     ref2=j2, want_stats=True, **kw)
    junit, jstats = j_inter.finish_inter_picture(jp, 1, 0, is_ref=False,
                                                 ref2_num=2)
    tp = t_inter.start_inter_picture(frames[1], tenc._params(2), t0,
                                     ref2=t2, device="cpu", **kw)
    tunit, _ = t_inter.finish_inter_picture(tp, 1, 0, is_ref=False,
                                            ref2_num=2)
    return tp, tunit, jp, junit, jstats


@pytest.fixture(scope="module")
def two_ref_case(frames, refs, encoders):
    tenc, _ = encoders
    lam = 0.02 * tenc._band_scales3(False)
    return _two_ref_pictures(frames, refs, encoders, lam, 0.0, None), lam


def test_inter_step_tables_and_picture_match(two_ref_case):
    """The two-reference step on the same picture and references: fields,
    badblock ratio and dc ratio equal; tables within TABLE_RTOL; and, the
    picks agreeing, the parse unit and reconstruction byte for byte."""
    (tp, tunit, jp, junit, jstats), _ = two_ref_case
    np.testing.assert_allclose(tp["rc_bits"].numpy(), jstats[0],
                               rtol=TABLE_RTOL)
    np.testing.assert_allclose(tp["rc_err"].numpy(), jstats[1],
                               rtol=TABLE_RTOL)
    assert tp["dc_ratio"] == jp["dc_ratio"]
    assert tp["badblock_ratio"] == jp["badblock_ratio"]
    np.testing.assert_array_equal(tp["qi_bands"], jp["qi_bands"])
    assert tunit == junit
    np.testing.assert_array_equal(tp["band_bits_actual"],
                                  jp["band_bits_actual"])
    np.testing.assert_allclose(tp["band_bits_est"], jp["band_bits_est"],
                               rtol=TABLE_RTOL)
    for a, b in zip(tp["recon"], jp["recon"]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("scale,target,corr_seed,binds", [
    (1.0, 0.0, None, False), (30.0, 0.0, 1, False),
    (30.0, 9000.0, None, True), (200.0, 4000.0, 2, True),
    (0.05, 2500.0, 3, True), (1.0, 90000.0, None, False)])
def test_rd_pick_and_fit_exact_on_jax_tables(frames, refs, encoders,
                                             two_ref_case, scale, target,
                                             corr_seed, binds):
    """The JAX step's picks for several lambdas, targets (0: no fit; > 0:
    the 22-step fit) and correction ratios, against the port's rd_pick on
    the JAX step's own tables."""
    _, lam = two_ref_case
    corr = (None if corr_seed is None else
            np.random.default_rng(corr_seed).uniform(0.5, 2.0, 30))
    jenc = encoders[1]
    jp = j_inter.start_inter_picture(
        frames[1], jenc._params(2), refs[0][1], ref2=refs[1][1],
        want_stats=True, lam_bands=lam * scale, me_lam=4.0,
        target_bits=target, corr_bands=corr)
    _, (jbits, jerr) = j_inter.finish_inter_picture(jp, 1, 0, is_ref=False,
                                                    ref2_num=2)
    cb = torch.tensor((np.ones(30) if corr is None
                       else corr).astype(np.float32))
    lam_t = torch.tensor((lam * scale).astype(np.float32))
    tables = (torch.tensor(jbits), torch.tensor(jerr))
    qi, s_fit = t_rc.rd_pick(*tables, lam_t, cb, float(np.float32(target)),
                             s_hi=1.0)
    if target > 0:
        # the fit scales down only, and the inter step's final pick runs
        # at the fitted scale squared (see inter.make_p_step's back)
        assert 0 < float(s_fit) <= 1.0
        # the fit binds (settles below 1) exactly where the picks at the
        # unscaled lambdas cost more than the target
        qi1, _ = t_rc.rd_pick(*tables, lam_t, cb)
        bits1 = float((cb * tables[0])[qi1.long(), torch.arange(30)].sum())
        assert (float(s_fit) < 0.999) == (bits1 > target), (s_fit, bits1)
        assert binds == (bits1 > target)
        qi, _ = t_rc.rd_pick(*tables, s_fit * (s_fit * lam_t), cb)
    else:
        assert float(s_fit) == 1.0
    np.testing.assert_array_equal(qi.numpy(), jp["qi_bands"])
    assert qi.dtype == torch.int32 and int(qi.max()) <= 59
    # and through the port's own step, whose tables agree to TABLE_RTOL:
    # a pick may differ only where two costs lie that close
    tp = t_inter.start_inter_picture(
        frames[1], encoders[0]._params(2), refs[0][0], ref2=refs[1][0],
        lam_bands=lam * scale, me_lam=4.0, target_bits=target,
        corr_bands=corr, device="cpu")
    assert int((tp["qi_dev"].numpy() != jp["qi_bands"]).sum()) <= 1
    # the picture's record of the fit: its target and the settled scale
    t_inter.finish_inter_picture(tp, 1, 0, is_ref=False, ref2_num=2)
    assert tp["target_bits"] == float(np.float32(target))
    assert tp["lam_scale"] == pytest.approx(float(s_fit), rel=1e-3)


def test_rd_pick_takes_the_first_of_equal_costs():
    """Two quant indices of equal cost: the lower wins, as jnp.argmin and
    torch.argmin both return the first minimum over rows 0..59."""
    bits = torch.full((61, 4), 100.0)
    err = torch.zeros((61, 4))
    bits[7, 0] = bits[9, 0] = 50.0          # equal minima at 7 and 9
    bits[60, 1] = 1.0                       # row 60 is never picked
    bits[59, 2] = 10.0
    err[:, 3] = torch.arange(61.0)          # cost rises with the index
    qi, s_fit = t_rc.rd_pick(bits, err, torch.ones(4), torch.ones(4))
    assert qi.tolist() == [7, 0, 59, 0]
    assert float(s_fit) == 1.0


def test_fused_intra_picture_matches(frames, encoders):
    """encode_picture_fused: tables within TABLE_RTOL, the JAX picks
    reproduced exactly from the JAX tables (fit in both directions), and
    the unit and reconstruction equal."""
    tenc, jenc = encoders
    lam = 0.003 * tenc._band_scales3(True)
    corr = np.random.default_rng(4).uniform(0.6, 1.5, 30)
    for target in (0.0, 30000.0):
        ju, jrec, jqi, jstats, jact, jest = j_intra.encode_picture_fused(
            frames[0], jenc._params(0), 0, lam, corr=corr,
            target_bits=target)
        tu, trec, tqi, tstats, tact, test_ = t_intra.encode_picture_fused(
            frames[0], tenc._params(0), 0, lam, corr=corr,
            target_bits=target, device="cpu")
        np.testing.assert_allclose(tstats[0], jstats[0], rtol=TABLE_RTOL)
        np.testing.assert_allclose(tstats[1], jstats[1], rtol=TABLE_RTOL)
        qi, _ = t_rc.rd_pick(
            torch.tensor(jstats[0]), torch.tensor(jstats[1]),
            torch.tensor(lam.astype(np.float32)),
            torch.tensor(np.maximum(corr, 1e-3).astype(np.float32)),
            float(np.float32(target)), s_hi=16384.0)
        np.testing.assert_array_equal(qi.numpy(), jqi)
        np.testing.assert_array_equal(tqi, jqi)
        assert tu == ju
        np.testing.assert_array_equal(tact, jact)
        for a, b in zip(trec, jrec):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _fields(obj):
    return {k: v for k, v in vars(obj).items()}


def test_tm5_controller_matches_after_every_update():
    """One seeded sequence of (kind, bits, frame) through both packages'
    CbrControllerTM5: every field and every frame lambda equal after every
    update (float64 arithmetic, so equal means equal)."""
    rng = np.random.default_rng(7)
    kw = dict(subgroup_length=4, buffer_size=0, buffer_level=0,
              b_lambda_scale=0.01, p_lambda_scale=0.25, i_lambda_scale=1.0)
    t = t_rc.CbrControllerTM5(500_000, 25.0, 12, **kw)
    j = j_rc.CbrControllerTM5(500_000, 25.0, 12, **kw)
    assert _fields(t) == _fields(j)
    order = []
    for g in range(6):                       # coded order: I/P then 3 B
        base = 12 * (g // 3)
        first = 4 * (g % 3)
        order.append(("I" if first == 0 else "P", base + first))
        order += [("B", base + first - 3 + k) for k in range(3)
                  if base + first - 3 + k >= 0 and first]
    for kind, num in order:
        assert t.frame_lambda(kind) == j.frame_lambda(kind)
        mean = {"I": 90_000, "P": 30_000, "B": 6_000}[kind]
        bits = int(mean * rng.uniform(0.2, 4.0))
        assert t.update(kind, bits, num, 1) == j.update(kind, bits, num, 1)
        assert _fields(t) == _fields(j), (kind, num)
    assert t.base_lambda != float(np.exp(0.921034 * 7.0 - 13.825))


def test_host_picks_and_arith_correction_match():
    rng = np.random.default_rng(9)
    bits = np.sort(rng.uniform(10, 5000, (61, 30)), axis=0)[::-1].copy()
    err = np.sort(rng.uniform(1, 1e7, (61, 30)), axis=0).copy()
    scales = rng.uniform(0.1, 10, 30)
    corr = rng.uniform(0.5, 2.0, 30)
    np.testing.assert_array_equal(
        t_rc.qi_from_lambda(bits, err, 0.01, scales),
        j_rc.qi_from_lambda(bits, err, 0.01, scales))
    for target in (3000.0, 40000.0, 120000.0):
        assert (t_rc.lambda_for_bits(bits, err, target, scales, corr)
                == j_rc.lambda_for_bits(bits, err, target, scales, corr))
        np.testing.assert_array_equal(
            t_rc.pick_bands_rdo((bits, err), target, scales, corr),
            j_rc.pick_bands_rdo((bits, err), target, scales, corr))
    assert (t_rc.lambda_for_error(bits, err, 5e6, band_scales=scales)
            == j_rc.lambda_for_error(bits, err, 5e6, band_scales=scales))
    qi = t_rc.qi_from_lambda(bits, err, 0.01, scales)
    assert (t_rc.estimate_bits_at(bits, qi)
            == j_rc.estimate_bits_at(bits, qi))

    ta, ja = t_rc.ArithCorrection(30), j_rc.ArithCorrection(30)
    for step in range(6):
        actual = rng.uniform(0, 4000, 30)
        est = rng.uniform(0, 4000, 30)
        ta.update(step % 2 == 0, actual, est)
        ja.update(step % 2 == 0, actual, est)
        np.testing.assert_array_equal(ta.intra, ja.intra)
        np.testing.assert_array_equal(ta.inter, ja.inter)
