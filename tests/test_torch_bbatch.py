"""The batched B step of the port against per-picture steps and against
the JAX package's batched path, on the CPU at 96x80.

A subgroup's three B pictures go through `inter.start_inter_batch` as one
batch: a leading batch dimension through the ME (one kernel launch per
search on the card), the RD split, the render, the stat tables and the RD
pick.  Each row must equal the per-picture step on the same inputs:
integer fields, picks and quantised bands exactly, the float32 tables
within TABLE_RTOL.  The batched driver takes all three pictures' quant
args before any of them commits, as the JAX encoder does, so its stream
differs from the per-picture path's; held against the JAX encoder's
batched stream it is expected byte-equal (float32 sums decide picks, so
the gate is the bands of `tests/test_biref_gop.py`: 0.7 dB, 15 %).
"""
import numpy as np
import pytest
import torch

from tests import jax_cache  # noqa: F401 (turns the disk cache on)
from schroedinger_tpu import bitstream as j_bs
from schroedinger_tpu.decoder import core as j_core
from schroedinger_tpu.encoder import gop as j_gop
from schroedinger_tpu.encoder import me as j_me
from schroedinger_tpu_torch.decoder import core as t_core
from schroedinger_tpu_torch.encoder import gop as t_gop
from schroedinger_tpu_torch.encoder import inter as t_inter
from schroedinger_tpu_torch.ops import patch_refine as pr
from schroedinger_tpu_torch.slice_config import video_format

torch.set_num_threads(1)

W, H = 96, 80
TABLE_RTOL = 2e-6
# test_b_batch_path_equivalence's configuration (tests/test_biref_gop.py)
CFG = dict(gop_length=8, gop_structure="biref", mv_precision=2,
           bitrate=500000, fps=25, enable_scene_change=False)
# with scene cuts on (the threshold of test_biref_au_boundary_and_scene_cut),
# 12 frames cut at frame 4: a cut subgroup and a tail, each with two B
CFG_CUT = dict(CFG, enable_scene_change=True, scene_change_threshold=2.0)


def make_frames(n, seed=21, cut_at=None):
    """tests/test_biref_gop.py's frames: a moving pattern plus noise, a
    new pattern from `cut_at` on."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W]
    out = []
    for i in range(n):
        if cut_at is not None and i >= cut_at:
            base = 100 + 80 * np.cos(xx / 4.0 + 1) * np.sin(yy / 9.0)
            y = np.roll(base, (-i, i * 2), axis=(0, 1))
        else:
            base = 128 + 60 * np.sin(xx / 7.0) * np.cos(yy / 5.0)
            y = np.roll(base, (i * 2, i * 3), axis=(0, 1))
        y = y + rng.normal(0, 3, (H, W))
        u = 128 + 25 * np.cos((xx[::2, ::2] + 4 * i) / 9.0)
        v = 128 + 25 * np.sin((yy[::2, ::2] + 3 * i) / 11.0)
        out.append((y.clip(0, 255).astype(np.uint8),
                    u.clip(0, 255).astype(np.uint8),
                    v.clip(0, 255).astype(np.uint8)))
    return out


def _record_batches(enc):
    """Wrap an encoder's _start_b_batch: the B picture numbers of every
    subgroup offered to it, and whether it took the batch."""
    seen = []
    orig = enc._start_b_batch

    def wrapped(bs_):
        out = orig(bs_)
        seen.append(([b[0] for b in bs_], out is not None))
        return out
    enc._start_b_batch = wrapped
    return seen


def _encode(package, cfg, frames):
    if package == "jax":
        enc = j_gop.GopEncoder(video_format(W, H), **cfg)
    else:
        enc = t_gop.GopEncoder(video_format(W, H), device="cpu", **cfg)
    seen = _record_batches(enc)
    return enc.encode_stream(frames), seen


@pytest.fixture(scope="module")
def runs():
    """Both packages' batched streams: the equivalence configuration (10
    frames) and the scene-cut one (12 frames, cut at 4)."""
    f_eq, f_cut = make_frames(10), make_frames(12, cut_at=4)
    return {(pkg, name): _encode(pkg, cfg, fr)
            for pkg in ("jax", "port")
            for name, cfg, fr in (("eq", CFG, f_eq),
                                  ("cut", CFG_CUT, f_cut))}, f_eq, f_cut


def _psnr(out, frames):
    vals = []
    for (y, _, _), (y0, _, _) in zip(out, frames):
        mse = np.mean((np.asarray(y, np.float64) - y0) ** 2)
        vals.append(99.0 if mse == 0 else 10 * np.log10(255.0 ** 2 / mse))
    return float(np.mean(vals))


def test_port_b_batch_stream_matches_jax(runs):
    """The port's batched stream in test_b_batch_path_equivalence's
    configuration against the JAX encoder's: the JAX decoder decodes it
    to the port decoder's planes, and it lies within the bands (0.7 dB,
    15 %) of the JAX stream; byte equality is reported."""
    streams, frames, _ = runs
    s_port, _ = streams[("port", "eq")]
    s_jax, _ = streams[("jax", "eq")]
    print(f"port {len(s_port)} bytes, JAX {len(s_jax)} bytes, "
          f"byte-equal: {s_port == s_jax}")
    jdec = j_core.StreamDecoder()
    j_out = jdec.decode_stream(s_port)
    t_out = t_core.StreamDecoder(device="cpu").decode_stream(s_port)
    assert len(j_out) == len(t_out) == len(frames) and jdec.errors == []
    for a, b in zip(j_out, t_out):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(np.asarray(x), y)
    j_ref = j_core.StreamDecoder().decode_stream(s_jax)
    assert abs(_psnr(t_out, frames) - _psnr(j_ref, frames)) < 0.7
    assert abs(len(s_port) - len(s_jax)) < 0.15 * len(s_jax)


@pytest.mark.parametrize("name", ["eq", "cut"])
def test_same_pictures_take_the_batched_path(runs, name):
    """Which subgroups go batched is decided by the same conditions in
    both packages: full subgroups batch, a cut subgroup and the stream's
    tail go per picture; the coded order agrees."""
    streams = runs[0]
    (s_port, seen_port), (s_jax, seen_jax) = (streams[("port", name)],
                                              streams[("jax", name)])
    assert seen_port == seen_jax
    assert any(took for _, took in seen_port)
    if name == "cut":
        # cut before 4: B 1, 2 per picture; a full subgroup; the tail
        assert seen_port == [([1, 2], False), ([5, 6, 7], True),
                             ([9, 10], False)], seen_port

    def order(stream):
        return [(int.from_bytes(pl[:4], "big"), j_bs.num_refs(c))
                for c, pl in j_bs.split_units(stream) if j_bs.is_picture(c)]
    assert order(s_port) == order(s_jax)


def _refs_and_qsels():
    frames = make_frames(5)
    enc = t_gop.GopEncoder(video_format(W, H), device="cpu", **CFG)
    refs = [t_core.RefFrame(tuple(torch.tensor(pl) for pl in frames[k]))
            for k in (0, 4)]
    lam = enc._band_scales3(False)
    rng = np.random.default_rng(3)
    # three pictures, three lambdas; the second fits to a target, the
    # third carries arith-correction ratios
    qsels = [dict(lam_bands=0.02 * lam, me_lam=4.0, target_bits=0.0,
                  corr_bands=None),
             dict(lam_bands=0.5 * lam, me_lam=9.0, target_bits=3000.0,
                  corr_bands=None),
             dict(lam_bands=0.1 * lam, me_lam=2.5, target_bits=0.0,
                  corr_bands=rng.uniform(0.5, 2.0, 30))]
    return frames, enc._params(2), refs, qsels


@pytest.fixture(scope="module")
def step_rows():
    frames, p, (r0, r4), qsels = _refs_and_qsels()
    batch = t_inter.start_inter_batch([frames[k] for k in (1, 2, 3)], p, r0,
                                      r4, qsels, device="cpu")
    singles = [t_inter.start_inter_picture(
        frames[k], p, r0, ref2=r4, want_recon=False, device="cpu", **qs)
        for k, qs in zip((1, 2, 3), qsels)]
    units = [(t_inter.finish_inter_picture(b, k, 0, is_ref=False,
                                           ref2_num=4)[0],
              t_inter.finish_inter_picture(s, k, 0, is_ref=False,
                                           ref2_num=4)[0])
             for k, b, s in zip((1, 2, 3), batch, singles)]
    return batch, singles, units


@pytest.mark.parametrize("row", [0, 1, 2])
def test_batched_step_rows_equal_per_picture_steps(step_rows, row):
    """Row `row` of the batched step against the per-picture step on the
    same picture, references and quant args: fields, picks and quantised
    bands by torch.equal, the stat tables within TABLE_RTOL, and the
    parse unit byte for byte."""
    batch, singles, units = step_rows
    b, s = batch[row], singles[row]
    for key in ("fields", "qi_dev", "badblock", "lam_scale_dev"):
        assert torch.equal(b[key], s[key]), key
    for x, y in zip(b["qflats"], s["qflats"]):
        assert torch.equal(x, y)
    for key in ("rc_bits", "rc_err"):
        np.testing.assert_allclose(b[key].numpy(), s[key].numpy(),
                                   rtol=TABLE_RTOL)
    assert units[row][0] == units[row][1]
    assert b["lam_scale"] == s["lam_scale"]
    if row == 1:
        assert b["target_bits"] == 3000.0


@pytest.mark.parametrize("mode", ["coarse", "refine", "median", "zero"])
def test_me_search_plain_batch_equals_single_pictures(mode):
    """me_search_plain (and me_search on CPU tensors) at N = 3 equals
    three N = 1 calls, and each N = 1 call the JAX ME's own piece."""
    rng = np.random.default_rng(11)
    bs, nby, nbx, margin, bound = 8, 5, 6, 40, 24
    scale, rad, hint = {"coarse": (0, 4, None), "refine": (2, 2, (3, 3)),
                        "median": (1, 0, (5, 6)), "zero": (0, 0, None)}[mode]
    cur = torch.tensor(rng.integers(0, 256, (3, nby * bs, nbx * bs)),
                       dtype=torch.uint8)
    ref = torch.tensor(rng.integers(0, 256, (nby * bs, nbx * bs)),
                       dtype=torch.uint8)
    field = (None if hint is None else torch.tensor(
        rng.integers(-12, 13, (3,) + hint + (2,)), dtype=torch.int32))
    args = (scale, bs, bs, rad, bound, margin)
    mv, sad = pr.me_search_plain(cur, ref, field, *args)
    mv2, sad2 = pr.me_search(cur, ref, field, *args)
    assert torch.equal(mv, mv2) and torch.equal(sad, sad2)
    assert mv.shape == (3, nby, nbx, 2) and sad.shape == (3, nby, nbx)
    for k in range(3):
        one = pr.me_search_plain(cur[k], ref,
                                 None if field is None else field[k], *args)
        assert torch.equal(mv[k], one[0]) and torch.equal(sad[k], one[1])
    if mode == "coarse":
        # the coarse scan is the JAX ME's dense scan, picture by picture
        for k in range(3):
            dy, dx, s = j_me._dense_scan(cur[k].numpy(), ref.numpy(), nby,
                                         nbx, bs, bs, rad)
            np.testing.assert_array_equal(mv[k, ..., 0].numpy(),
                                          np.asarray(dy))
            np.testing.assert_array_equal(mv[k, ..., 1].numpy(),
                                          np.asarray(dx))
            np.testing.assert_array_equal(sad[k].numpy(), np.asarray(s))


def test_cache_reset_drops_the_b_batch_steps(step_rows):
    """The port's cache reset drops the steps that ran the B batches (the
    JAX package's reset leaves its B-batch programs alive)."""
    import schroedinger_tpu_torch
    assert t_inter._STEP_CACHE
    schroedinger_tpu_torch.clear_compiled_caches()
    assert not t_inter._STEP_CACHE
