"""Motion estimation parity: the port's full-pel search `me_search` (its
plain version on the CPU) in its four modes (coarse scan, hint refine,
median SAD, zero SAD), the whole hierarchical ME and the subpel refine
against the JAX package, bit for bit.  The JAX side of the hint refine
runs both as me._patch_refine and as the Pallas kernel in interpret mode.
The CUDA kernel itself is checked against its plain version in
tests/test_torch_cuda.py, which runs only where there is a card."""
import functools
import os
import shutil

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from schroedinger_tpu.encoder import me as j_me
from schroedinger_tpu.ops import obmc as j_obmc
from schroedinger_tpu.ops import pallas_me
from schroedinger_tpu_torch.encoder import me as t_me
from schroedinger_tpu_torch.ops import obmc as t_obmc
from schroedinger_tpu_torch.ops import patch_refine as pr

torch.set_num_threads(1)

W, H = 128, 64
XNB, YNB, BSEP = 16, 8, 8


def _eq(t, j, msg=""):
    np.testing.assert_array_equal(t.cpu().numpy(), np.asarray(j),
                                  err_msg=msg)


def _refine_case(rad, bs, flat, seed=0):
    nby, nbx = 3, 5
    bound = 24
    margin = bound + 2 * rad + 16
    rng = np.random.default_rng(seed + 7 * rad + bs + 100 * flat)
    if flat:      # every candidate ties: the first (dy, dx) must win
        cur = np.full((nby * bs, nbx * bs), 77, np.uint8)
        ref = np.full((nby * bs, nbx * bs), 90, np.uint8)
    else:
        cur = rng.integers(0, 256, (nby * bs, nbx * bs)).astype(np.uint8)
        ref = rng.integers(0, 256, (nby * bs, nbx * bs)).astype(np.uint8)
    mv_y = rng.integers(-bound + rad, bound - rad, (nby, nbx)).astype(
        np.int32)
    mv_x = rng.integers(-bound + rad, bound - rad, (nby, nbx)).astype(
        np.int32)
    return nby, nbx, bound, margin, cur, ref, mv_y, mv_x


@functools.lru_cache(maxsize=None)
def _pallas_refine(nby, nbx, bs, rad, bound, margin, Hp, Wp):
    """The Pallas kernel in interpret mode, compiled once per geometry
    (the random and the all-tie case share it)."""
    return jax.jit(pallas_me.make_patch_refine(
        nby, nbx, bs, bs, rad, bound, margin, Hp, Wp, interpret=True))


@pytest.mark.parametrize("flat", [False, True], ids=["random", "flat"])
@pytest.mark.parametrize("rad,bs", [(2, 4), (2, 8), (2, 16), (1, 16)])
def test_patch_refine_plain_matches_jax_and_pallas(rad, bs, flat):
    nby, nbx, bound, margin, cur, ref, mv_y, mv_x = _refine_case(rad, bs,
                                                                 flat)
    jcb = j_me._to_blocks(jnp.asarray(cur, jnp.int32), nby, bs, nbx, bs)
    jP = j_me._pad_ref(jnp.asarray(ref), margin)
    ey, ex, es = j_me._patch_refine(jcb, jP, jnp.asarray(mv_y),
                                    jnp.asarray(mv_x), nby, nbx, bs, bs,
                                    rad, margin)
    fn = _pallas_refine(nby, nbx, bs, rad, bound, margin, *jP.shape)
    gy, gx, gs = fn(jcb, jP, jnp.asarray(mv_y), jnp.asarray(mv_x))

    # the hints as a field at the block grid's own size, scale 1
    field = torch.as_tensor(np.stack([mv_y, mv_x], -1))
    before = pr.LAUNCHES
    mv, ts = pr.me_search(torch.as_tensor(cur), torch.as_tensor(ref), field,
                          1, bs, bs, rad, bound, margin)
    assert pr.LAUNCHES == before          # CPU tensors: plain version
    ty, tx = mv[..., 0], mv[..., 1]
    for t, e, g, name in ((ts, es, gs, "sad"), (ty, ey, gy, "dy"),
                          (tx, ex, gx, "dx")):
        _eq(t, e, name + " vs me._patch_refine")
        _eq(t, g, name + " vs the Pallas kernel")
    if flat:
        _eq(ty, mv_y - rad)
        _eq(tx, mv_x - rad)


def test_patch_refine_clamps_out_of_contract_hints():
    """Hints beyond the margin clamp the window into P (the kernel and
    the plain version share this rule; dynamic_slice clamps the same)."""
    nby, nbx, bs, rad, margin = 2, 3, 8, 2, 6
    rng = np.random.default_rng(5)
    cur = rng.integers(0, 256, (nby * bs, nbx * bs)).astype(np.uint8)
    ref = rng.integers(0, 256, (nby * bs, nbx * bs)).astype(np.uint8)
    mv_y = np.array([[-40, 0, 33], [9, -7, 50]], np.int32)
    mv_x = np.array([[45, -60, 0], [3, 21, -9]], np.int32)
    jcb = j_me._to_blocks(jnp.asarray(cur, jnp.int32), nby, bs, nbx, bs)
    jP = j_me._pad_ref(jnp.asarray(ref), margin)
    ey, ex, es = j_me._patch_refine(jcb, jP, jnp.asarray(mv_y),
                                    jnp.asarray(mv_x), nby, nbx, bs, bs,
                                    rad, margin)
    # a bound past the margin lets the hints through unclamped
    mv, ts = pr.me_search(torch.as_tensor(cur), torch.as_tensor(ref),
                          torch.as_tensor(np.stack([mv_y, mv_x], -1)), 1,
                          bs, bs, rad, 100, margin)
    ty, tx = mv[..., 0], mv[..., 1]
    _eq(ts, es)
    _eq(ty, ey)
    _eq(tx, ex)


def test_patch_refine_rejects_other_devices():
    t = torch.zeros((4, 4), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError):
        pr.me_search(t, t, None, 0, 4, 4, 1, 2, 2)
    with pytest.raises(ValueError):       # the probe runs only on a card
        c = torch.zeros((4, 4), dtype=torch.uint8)
        pr.me_search_probe("full", c, c, None, 0, 4, 4, 1, 2, 2)


def test_kernel_build_keys_on_flags_and_toolkit(tmp_path, monkeypatch):
    """build() reuses a library only if sources, headers, flags and nvcc
    match."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    shutil.copy(pr.SOURCE, csrc)
    monkeypatch.setattr(pr, "CSRC", str(csrc))
    monkeypatch.setattr(pr, "SOURCE",
                        str(csrc / os.path.basename(pr.SOURCE)))
    nvcc = tmp_path / "nvcc"
    calls = tmp_path / "calls"
    nvcc.write_text('#!/bin/sh\nif [ "$1" = --version ]; then '
                    'cat "$(dirname "$0")/version"; exit 0; fi\n'
                    'echo x >> "$(dirname "$0")/calls"\n'
                    'while [ "$1" != -o ]; do shift; done; touch "$2"\n')
    nvcc.chmod(0o755)
    (tmp_path / "version").write_text("release 12.4\n")
    monkeypatch.setattr(pr, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(pr, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(pr, "LIBRARY", None)

    def builds():
        pr.build()
        return pr.LIBRARY, len(calls.read_text().split())

    first, n = builds()
    assert n == 1 and os.path.exists(first)
    assert builds() == (first, 1)                      # up to date
    monkeypatch.setattr(pr, "NVCC_FLAGS", pr.NVCC_FLAGS + ["-lineinfo"])
    second, n = builds()
    assert n == 2 and second != first
    (tmp_path / "version").write_text("release 12.8\n")
    third, n = builds()
    assert n == 3 and third not in (first, second)
    # a header beside the source: adding it and changing it each rebuild
    (csrc / "search.cuh").write_text("// v1\n")
    fourth, n = builds()
    assert n == 4 and fourth not in (first, second, third)
    assert builds() == (fourth, 4)
    (csrc / "search.cuh").write_text("// v2\n")
    fifth, n = builds()
    assert n == 5 and fifth not in (first, second, third, fourth)


def test_dense_scan_matches_jax_and_refine_around_zero():
    nby, nbx, bs, rad = 5, 7, 4, 8
    rng = np.random.default_rng(3)
    c = rng.integers(0, 256, (nby * bs, nbx * bs)).astype(np.uint8)
    r = rng.integers(0, 256, (nby * bs, nbx * bs)).astype(np.uint8)
    gy, gx, gs = j_me._dense_scan(jnp.asarray(c), jnp.asarray(r), nby, nbx,
                                  bs, bs, rad)
    ty, tx, ts = t_me._dense_scan(torch.as_tensor(c), torch.as_tensor(r),
                                  nby, nbx, bs, bs, rad)
    _eq(ts, gs)
    _eq(ty, gy)
    _eq(tx, gx)
    # me_search's coarse scan (scale 0) is the same function
    mv, rs = pr.me_search(torch.as_tensor(c), torch.as_tensor(r), None, 0,
                          bs, bs, rad, 24, rad + 16)
    assert torch.equal(rs, ts) and torch.equal(mv[..., 0], ty) \
        and torch.equal(mv[..., 1], tx)


def _mode_case(mode, flat):
    """Planes, field, scale, block size and radius of one me_search mode,
    from a numpy seed; the refine's field is a parent grid of 2x3 whose
    doubled vectors run past the bound."""
    bound, margin = 24, 44          # _refine_case's at radius 2
    modes = {"coarse": (4, 8, 0, None),
             "refine": (4, 2, 2, (2, 3, bound // 2 + 4)),
             "median": (8, 0, 1, (3, 5, bound)),
             "zero": (8, 0, 0, None)}
    bs, rad, scale, field = modes[mode]
    nby, nbx = 3, 5
    rng = np.random.default_rng(list(modes).index(mode) + 100 * flat)
    if flat:
        cur = np.full((nby * bs, nbx * bs), 77, np.uint8)
        ref = np.full((nby * bs, nbx * bs), 90, np.uint8)
    else:
        cur = rng.integers(0, 256, (nby * bs, nbx * bs)).astype(np.uint8)
        ref = rng.integers(0, 256, (nby * bs, nbx * bs)).astype(np.uint8)
    if field is not None:
        hy, hx, lim = field
        field = rng.integers(-lim, lim + 1, (hy, hx, 2)).astype(np.int32)
    return cur, ref, field, scale, nby, nbx, bs, rad, bound, margin


@pytest.mark.parametrize("flat", [False, True], ids=["random", "flat"])
@pytest.mark.parametrize("mode", ["coarse", "refine", "median", "zero"])
def test_me_search_modes_match_jax(mode, flat):
    """me_search (plain, CPU) in each of its four uses equals the piece of
    the JAX ME it replaces; the refine also equals the Pallas kernel."""
    cur, ref, field, scale, nby, nbx, bs, rad, bound, margin = _mode_case(
        mode, flat)
    before = pr.LAUNCHES
    mv, sad = pr.me_search(torch.as_tensor(cur), torch.as_tensor(ref),
                           None if field is None else torch.as_tensor(field),
                           scale, bs, bs, rad, bound, margin)
    assert pr.LAUNCHES == before          # CPU tensors: plain version
    jc, jr = jnp.asarray(cur), jnp.asarray(ref)
    jcb = j_me._to_blocks(jc.astype(jnp.int32), nby, bs, nbx, bs)
    jP = j_me._pad_ref(jr, margin)
    if mode == "coarse":
        want = j_me._dense_scan(jc, jr, nby, nbx, bs, bs, rad)
    elif mode == "refine":
        # me.make_me_body's upsample of the parent's vectors
        hint = jnp.asarray(field) * 2
        hy, hx = hint.shape[0], hint.shape[1]
        ys = jnp.clip((jnp.arange(nby) * hy) // nby, 0, hy - 1)
        xs = jnp.clip((jnp.arange(nbx) * hx) // nbx, 0, hx - 1)
        hint = jnp.clip(hint[ys[:, None], xs[None, :]], -bound, bound)
        want = j_me._patch_refine(jcb, jP, hint[..., 0], hint[..., 1], nby,
                                  nbx, bs, bs, rad, margin)
        fn = _pallas_refine(nby, nbx, bs, rad, bound, margin, *jP.shape)
        got = fn(jcb, jP, hint[..., 0], hint[..., 1])
        for t, g, name in ((mv[..., 0], got[0], "dy"),
                           (mv[..., 1], got[1], "dx"), (sad, got[2], "sad")):
            _eq(t, g, name + " vs the Pallas kernel")
    elif mode == "median":
        # me.make_me_body's sad_at(med)
        pat = j_me._extract_ref_patches(jP, jnp.asarray(field[..., 0]),
                                        jnp.asarray(field[..., 1]), nby, nbx,
                                        bs, bs, 0, margin)
        want = (field[..., 0], field[..., 1], jnp.abs(
            jcb - pat[:, :bs, :bs]).sum((1, 2)).reshape(nby, nbx))
    else:
        # me.make_me_body's sad_zero
        zdiff = jnp.abs(jc.astype(jnp.int32) - jr.astype(jnp.int32))
        zero = np.zeros((nby, nbx), np.int32)
        want = (zero, zero, zdiff.reshape(nby, bs, nbx, bs).sum((1, 3)))
    for t, e, name in ((mv[..., 0], want[0], "dy"),
                       (mv[..., 1], want[1], "dx"), (sad, want[2], "sad")):
        _eq(t, e, name)
    if flat and rad:                      # every candidate ties
        assert torch.equal(mv, torch.as_tensor(np.array(
            jnp.stack(want[:2], -1))))
        assert int(sad.min()) == int(sad.max()) == 13 * bs * bs


def _frame_pair(seed=11, shift=(3, -5), w=W, h=H):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = 128 + 60 * np.sin(xx / 7.0) * np.cos(yy / 5.0)
    ref = (base + rng.normal(0, 3, (h, w))).clip(0, 255).astype(np.uint8)
    cur = (np.roll(base, shift, axis=(0, 1)) + rng.normal(0, 3, (h, w))
           ).clip(0, 255).astype(np.uint8)
    return cur, ref


@pytest.mark.parametrize("levels,w,h", [(5, W, H), (2, W, H), (5, 120, 72)],
                         ids=["5", "2", "cropped-120x72"])
def test_me_body_whole(levels, w, h):
    """The whole ME; 120x72 at 8-px blocks has a 3-level pyramid whose
    coarsest level (18x30 px) is cropped to whole 4-px blocks (16x28)."""
    cur, ref = _frame_pair(w=w, h=h)
    xnb, ynb = w // BSEP, h // BSEP
    # the JAX side runs eagerly: compiling it costs more than it saves here
    jfn = j_me.make_me_body(h, w, BSEP, BSEP, xnb, ynb, levels=levels)
    tfn = t_me.make_me_body(h, w, BSEP, BSEP, xnb, ynb, levels=levels)
    before = pr.LAUNCHES
    jy, jx, js = jfn(jnp.asarray(cur), jnp.asarray(ref))
    ty, tx, ts = tfn(torch.as_tensor(cur), torch.as_tensor(ref))
    assert pr.LAUNCHES == before          # CPU tensors: plain version
    _eq(ty, jy)
    _eq(tx, jx)
    _eq(ts, js)
    assert np.abs(ty.numpy()).max() > 0     # the motion was found


@pytest.mark.parametrize("prec", [1, 2, 3])
def test_subpel_body_whole(prec):
    cur, ref = _frame_pair(seed=12, shift=(-2, 4))
    rng = np.random.default_rng(prec)
    dy = rng.integers(-6, 7, (YNB, XNB)).astype(np.int32)
    dx = rng.integers(-6, 7, (YNB, XNB)).astype(np.int32)
    jup = j_obmc.make_halfpel(j_obmc.upsample_plane(jnp.asarray(ref)))
    tup = t_obmc.make_halfpel(t_obmc.upsample_plane(torch.as_tensor(ref)))
    jfn = j_me.make_subpel_body(H, W, BSEP, BSEP, XNB, YNB, prec)
    tfn = t_me.make_subpel_body(H, W, BSEP, BSEP, XNB, YNB, prec)
    jy, jx, js = jfn(jnp.asarray(cur), jup, jnp.asarray(dy), jnp.asarray(dx))
    ty, tx, ts = tfn(torch.as_tensor(cur), tup, torch.as_tensor(dy),
                     torch.as_tensor(dx))
    _eq(ty, jy)
    _eq(tx, jx)
    _eq(ts, js)
