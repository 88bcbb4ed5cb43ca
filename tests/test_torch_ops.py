"""Exact CPU parity of the port's tensor ops with the JAX package:
quantiser, the 7 lifting wavelets, half-pel upsampling and the OBMC patch
render.  Inputs come from numpy seeds; both sides see the same arrays and
must agree bit for bit (every stage is integer)."""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from schroedinger_tpu import tables
from schroedinger_tpu.ops import obmc as j_obmc
from schroedinger_tpu.ops import quant as j_quant
from schroedinger_tpu.ops import wavelet as j_wv
from schroedinger_tpu.wavelets import Wavelet
from schroedinger_tpu_torch.coding import slices as t_sl
from schroedinger_tpu_torch.ops import obmc as t_obmc
from schroedinger_tpu_torch.ops import quant as t_quant
from schroedinger_tpu_torch.ops import wavelet as t_wv

torch.set_num_threads(1)

I32_EXTREMES = np.array([-2 ** 31, -2 ** 31 + 1, -2 ** 30 - 1, -2 ** 29,
                         -65536, -1, 0, 1, 65535, 2 ** 29, 2 ** 30 + 1,
                         2 ** 31 - 2, 2 ** 31 - 1], np.int32)


def _eq(t, j, msg=""):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=msg)


@pytest.mark.parametrize("intra", [True, False])
def test_quant_all_indices(intra):
    rng = np.random.default_rng(1)
    v = np.concatenate([rng.integers(-40000, 40000, 4000),
                        rng.integers(-2 ** 31, 2 ** 31, 500),
                        I32_EXTREMES]).astype(np.int32)
    table = tables.QUANT_OFFSET_1_2 if intra else tables.QUANT_OFFSET_3_8
    vt = torch.as_tensor(v)
    for qi in range(61):
        qf, qo = int(tables.QUANT_FACTOR[qi]), int(table[qi])
        assert int(t_quant.quant_factor(qi)) == qf
        assert int(t_quant.quant_offset(qi, intra)) == qo
        jq = j_quant.quantise(jnp.asarray(v), qf, qo)
        tq = t_quant.quantise(vt, qf, qo)
        _eq(tq, jq, f"quantise qi={qi}")
        # dequantise of arbitrary int32 codes, extremes included (wraps)
        _eq(t_quant.dequantise(vt, qf, qo),
            j_quant.dequantise(jnp.asarray(v), qf, qo), f"dequant qi={qi}")
        _eq(t_quant.dequantise(tq, qf, qo), j_quant.dequantise(jq, qf, qo),
            f"roundtrip qi={qi}")


def test_quant_per_coefficient_tables():
    """Broadcast qf/qo tensors (the per-band gather of the inter step)."""
    rng = np.random.default_rng(2)
    v = rng.integers(-3000, 3000, 2048).astype(np.int32)
    qi = rng.integers(0, 61, 2048)
    qf = tables.QUANT_FACTOR[qi].astype(np.int32)
    qo = tables.QUANT_OFFSET_3_8[qi].astype(np.int32)
    jq = j_quant.quantise(jnp.asarray(v), jnp.asarray(qf), jnp.asarray(qo))
    tq = t_quant.quantise(torch.as_tensor(v), torch.as_tensor(qf),
                          torch.as_tensor(qo))
    _eq(tq, jq)
    _eq(t_quant.dequantise(tq, torch.as_tensor(qf), torch.as_tensor(qo)),
        j_quant.dequantise(jq, jnp.asarray(qf), jnp.asarray(qo)))


@pytest.mark.parametrize("depth", [1, 2, 3])
@pytest.mark.parametrize("wavelet", list(Wavelet))
def test_wavelet_forward_inverse(wavelet, depth):
    rng = np.random.default_rng(10 * int(wavelet) + depth)
    x = rng.integers(-32768, 32768, (32, 48)).astype(np.int16)
    jp = j_wv.forward(jnp.asarray(x), depth, wavelet)
    tp = t_wv.forward(torch.as_tensor(x), depth, wavelet)
    jflat, jshapes = (np.concatenate([np.asarray(b).ravel() for b in
                                      _j_bands(jp, depth)]),
                      [b.shape for b in _j_bands(jp, depth)])
    tflat, tshapes = t_sl.flatten_pyramid(tp, depth)
    assert tflat.dtype == torch.int16
    assert [tuple(s) for s in jshapes] == tshapes
    _eq(tflat, jflat, "forward")
    # inverse of the same (wrapped) pyramid
    _eq(t_wv.inverse(tp, wavelet), j_wv.inverse(jp, wavelet), "inverse")
    # inverse of arbitrary full-range bands (not a forward's output)
    bands = [rng.integers(-32768, 32768, s).astype(np.int16)
             for s in tshapes]
    jr = j_wv.inverse(_j_pyr([jnp.asarray(b) for b in bands], depth),
                      wavelet)
    tr = t_wv.inverse(t_sl.arrays_to_pyramid(
        [torch.as_tensor(b) for b in bands], depth), wavelet)
    _eq(tr, jr, "inverse of random bands")


def _j_bands(pyr, depth):
    from schroedinger_tpu.coding import slices as j_sl
    return j_sl.subband_arrays(pyr, depth)


def _j_pyr(arrays, depth):
    from schroedinger_tpu.coding import slices as j_sl
    return j_sl.arrays_to_pyramid(arrays, depth)


@pytest.mark.parametrize("shape", [(64, 128), (33, 20)])
def test_upsample_halfpel(shape):
    rng = np.random.default_rng(3)
    p = rng.integers(0, 256, shape).astype(np.uint8)
    jup = j_obmc.make_halfpel(j_obmc.upsample_plane(jnp.asarray(p)))
    tup = t_obmc.make_halfpel(t_obmc.upsample_plane(torch.as_tensor(p)))
    assert tup.dtype == torch.uint8
    _eq(tup, jup)
    np.testing.assert_array_equal(tup.numpy(), j_obmc.upsample_frame_np(p))


def test_extract_patches_clamps_like_dynamic_slice():
    """Out-of-range origins clamp into the plane (jax.lax.dynamic_slice
    semantics) instead of raising."""
    P = np.arange(20 * 24, dtype=np.int32).reshape(20, 24) % 251
    oy = np.array([-5, 0, 7, 13, 40], np.int32)
    ox = np.array([-9, 3, 16, 30, 2], np.int32)
    jpat = j_obmc.extract_patches(jnp.asarray(P), jnp.asarray(oy),
                                  jnp.asarray(ox), 8, 8)
    tpat = t_obmc.extract_patches(torch.as_tensor(P), torch.as_tensor(oy),
                                  torch.as_tensor(ox), 8, 8)
    _eq(tpat, jpat)


@pytest.mark.parametrize("chroma", [False, True])
@pytest.mark.parametrize("prec", [0, 1, 2, 3])
def test_render_component_patches(prec, chroma):
    rng = np.random.default_rng(40 + prec + 4 * chroma)
    yb, xb = 8, 16
    xblen, xbsep = 12, 8
    hs = vs = 1 if chroma else 0
    h, w = (64 >> vs), (128 >> hs)
    bl, bsp = xblen >> hs, xbsep >> hs
    ref = rng.integers(0, 256, (h, w)).astype(np.uint8)
    bound = 40 << prec
    mv = {k: rng.integers(-bound, bound + 1, (yb, xb)).astype(np.int32)
          for k in ("dx1", "dy1", "dx2", "dy2")}
    mode = rng.integers(0, 2, (yb, xb)).astype(np.int32)
    dc = rng.integers(-128, 128, (yb, xb)).astype(np.int32)
    jup = j_obmc.make_halfpel(j_obmc.upsample_plane(jnp.asarray(ref)))
    tup = t_obmc.make_halfpel(t_obmc.upsample_plane(torch.as_tensor(ref)))
    args = lambda cv: (cv(mv["dx1"]), cv(mv["dy1"]), cv(mv["dx2"]),  # noqa
                       cv(mv["dy2"]), cv(mode), cv(dc))
    tail = (bl, bl, bsp, bsp, prec, 1, 1, 1, h, w, hs, vs)
    jpred = j_obmc.render_component_patches(*args(jnp.asarray), jup, None,
                                            *tail)
    tpred = t_obmc.render_component_patches(*args(torch.as_tensor), tup,
                                            None, *tail)
    _eq(tpred, jpred)
