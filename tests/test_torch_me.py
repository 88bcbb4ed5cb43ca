"""Motion estimation parity: the port's patch-refine (plain version on the
CPU), dense scan, whole hierarchical ME and subpel refine against the JAX
package, bit for bit.  The JAX side of the patch refine runs both as
me._patch_refine and as the Pallas kernel in interpret mode.  The CUDA
kernel itself is checked against its plain version in
tests/test_torch_cuda.py, which runs only where there is a card."""
import functools
import os

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

    tcb = t_me._to_blocks(torch.as_tensor(cur).to(torch.int32), nby, bs,
                          nbx, bs)
    tP = t_me._pad_ref(torch.as_tensor(ref), margin)
    before = pr.LAUNCHES
    ty, tx, ts = pr.patch_refine(tcb, tP, torch.as_tensor(mv_y),
                                 torch.as_tensor(mv_x), nby, nbx, bs, bs,
                                 rad, margin)
    assert pr.LAUNCHES == before          # CPU tensors: plain version
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
    ty, tx, ts = pr.patch_refine(
        t_me._to_blocks(torch.as_tensor(cur).to(torch.int32), nby, bs,
                        nbx, bs),
        t_me._pad_ref(torch.as_tensor(ref), margin), torch.as_tensor(mv_y),
        torch.as_tensor(mv_x), nby, nbx, bs, bs, rad, margin)
    _eq(ts, es)
    _eq(ty, ey)
    _eq(tx, ex)


def test_patch_refine_rejects_other_devices():
    t = torch.zeros((1, 4, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        pr.patch_refine(t, t[0], t[0, :1, :1], t[0, :1, :1], 1, 1, 4, 4, 1,
                        2)


def test_kernel_build_keys_on_flags_and_toolkit(tmp_path, monkeypatch):
    """build() reuses a library only if source, flags and nvcc match."""
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
    margin = rad + 16
    zero = torch.zeros((nby, nbx), dtype=torch.int32)
    ry, rx, rs = pr.patch_refine_plain(
        t_me._to_blocks(torch.as_tensor(c).to(torch.int32), nby, bs, nbx,
                        bs), t_me._pad_ref(torch.as_tensor(r), margin),
        zero, zero, nby, nbx, bs, bs, rad, margin)
    assert torch.equal(rs, ts) and torch.equal(ry, ty) and torch.equal(rx, tx)


def _frame_pair(seed=11, shift=(3, -5)):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W]
    base = 128 + 60 * np.sin(xx / 7.0) * np.cos(yy / 5.0)
    ref = (base + rng.normal(0, 3, (H, W))).clip(0, 255).astype(np.uint8)
    cur = (np.roll(base, shift, axis=(0, 1)) + rng.normal(0, 3, (H, W))
           ).clip(0, 255).astype(np.uint8)
    return cur, ref


@pytest.mark.parametrize("levels", [5, 2])
def test_me_body_whole(levels):
    cur, ref = _frame_pair()
    # the JAX side runs eagerly: compiling it costs more than it saves here
    jfn = j_me.make_me_body(H, W, BSEP, BSEP, XNB, YNB, levels=levels)
    tfn = t_me.make_me_body(H, W, BSEP, BSEP, XNB, YNB, levels=levels)
    jy, jx, js = jfn(jnp.asarray(cur), jnp.asarray(ref))
    ty, tx, ts = tfn(torch.as_tensor(cur), torch.as_tensor(ref))
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
