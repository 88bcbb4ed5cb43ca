"""Motion estimation parity: the port's full-pel search `me_search` (its
plain version on the CPU) in its four modes (coarse scan, hint refine,
median SAD, zero SAD), the whole hierarchical ME and the subpel refine
against the JAX package, bit for bit.  The JAX side of the hint refine
runs both as me._patch_refine and as the Pallas kernel in interpret mode.
The ME's final stage (`ops/me_final.py`): its plain version equals the
composition of the whole ME and the subpel refine (and the JAX
package's), and a numpy model of kernel #4's arithmetic equals the plain
version.  The CUDA kernels themselves are checked against their plain
versions in tests/test_torch_cuda.py, which runs only where there is a
card."""
import functools
import os
import shutil

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tests import jax_cache  # noqa: F401 (turns the disk cache on)
from schroedinger_tpu.encoder import me as j_me
from schroedinger_tpu.ops import obmc as j_obmc
from schroedinger_tpu.ops import pallas_me
from schroedinger_tpu_torch.encoder import me as t_me
from schroedinger_tpu_torch.ops import cuda_build
from schroedinger_tpu_torch.ops import me_final as mf
from schroedinger_tpu_torch.ops import obmc as t_obmc
from schroedinger_tpu_torch.ops import patch_refine as pr
from schroedinger_tpu_torch.ops.pad import pad_edge
from schroedinger_tpu_torch.tools import profile_patch_refine as ppr

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
    before = pr.launches()
    mv, ts = pr.me_search(torch.as_tensor(cur), torch.as_tensor(ref), field,
                          1, bs, bs, rad, bound, margin)
    assert pr.launches() == before          # CPU tensors: plain version
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
    match; it compiles every .cu file of csrc/ into the one library."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    shutil.copy(pr.SOURCE, csrc)
    monkeypatch.setattr(cuda_build, "CSRC", str(csrc))
    nvcc = tmp_path / "nvcc"
    calls = tmp_path / "calls"
    nvcc.write_text('#!/bin/sh\nif [ "$1" = --version ]; then '
                    'cat "$(dirname "$0")/version"; exit 0; fi\n'
                    'echo x >> "$(dirname "$0")/calls"\n'
                    'while [ "$1" != -o ]; do shift; done; touch "$2"\n'
                    'shift 2; echo "$@" > "$(dirname "$0")/units"\n')
    nvcc.chmod(0o755)
    (tmp_path / "version").write_text("release 12.4\n")
    monkeypatch.setattr(cuda_build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(cuda_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(cuda_build, "LIBRARY", None)

    def builds():
        cuda_build.build()
        return cuda_build.LIBRARY, len(calls.read_text().split())

    first, n = builds()
    assert n == 1 and os.path.exists(first)
    assert builds() == (first, 1)                      # up to date
    monkeypatch.setattr(cuda_build, "NVCC_FLAGS",
                        cuda_build.NVCC_FLAGS + ["-lineinfo"])
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
    # a second kernel's source goes into the same library, headers not
    (csrc / "other.cu").write_text("// v1\n")
    sixth, n = builds()
    assert n == 6 and sixth not in (first, second, third, fourth, fifth)
    assert (tmp_path / "units").read_text().split() == [
        str(csrc / "other.cu"), str(csrc / "patch_refine.cu")]


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
    before = pr.launches()
    mv, sad = pr.me_search(torch.as_tensor(cur), torch.as_tensor(ref),
                           None if field is None else torch.as_tensor(field),
                           scale, bs, bs, rad, bound, margin)
    assert pr.launches() == before          # CPU tensors: plain version
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
    before = pr.launches()
    jy, jx, js = jfn(jnp.asarray(cur), jnp.asarray(ref))
    ty, tx, ts = tfn(torch.as_tensor(cur), torch.as_tensor(ref))
    assert pr.launches() == before          # CPU tensors: plain version
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
    jy, jx, js = jfn(jnp.asarray(cur), jup, jnp.asarray(dy), jnp.asarray(dx))
    # the port's subpel refine: the final stage's subpel levels alone (the
    # 128x64 plane is a whole number of blocks, so it needs no padding)
    mv = torch.stack([torch.as_tensor(dy), torch.as_tensor(dx)], -1)
    ty, tx, ts = (o[0] for o in mf.me_final(
        torch.as_tensor(cur)[None], None, tup, mv[None], None, BSEP, BSEP,
        prec, False, False, t_me.ME_BOUND_PEL, 0))
    _eq(ty, jy)
    _eq(tx, jx)
    _eq(ts, js)


@pytest.mark.parametrize("flat", [False, True])
@pytest.mark.parametrize("shape", ppr.REFINE_SHAPES, ids=lambda s: s[0])
def test_library_route_equals_plain_search(shape, flat):
    """The probe's library route (`unfold`, `cdist(p=1)`, `argmin`), timed
    beside the kernel on the card, computes me_search's function: equal
    to the plain version at each launch shape's block size, radius and
    scale, on a cut of its block grid."""
    name, nby, nbx, bs, rad, scale, grid = shape
    cut = (name, min(nby, 5), min(nbx, 6), bs, rad, scale,
           None if grid is None else (min(grid[0], 5), min(grid[1], 6)))
    args = ppr.make_inputs(cut, torch.device("cpu"), seed=3, flat=flat)
    mv, sad = ppr.library_search(*args)
    want_mv, want_sad = pr.me_search_plain(*args)
    assert torch.equal(mv, want_mv) and torch.equal(sad, want_sad)


def _batch_pair(n, w, h, seed):
    """n current pictures (a pan each) and one reference, u8 numpy."""
    cur, ref = _frame_pair(seed=seed, w=w, h=h)
    curs = [cur] + [_frame_pair(seed=seed + k, shift=(k, 2 - 3 * k), w=w,
                                h=h)[0] for k in range(1, n)]
    return np.stack(curs), ref


@pytest.mark.parametrize("n", [1, 3])
@pytest.mark.parametrize("zero_cand", [True, False], ids=["zero", "nozero"])
@pytest.mark.parametrize("prec", [1, 2, 3])
def test_final_plain_equals_me_then_subpel(prec, zero_cand, n):
    """me_final_plain on the pyramid's result (make_me_body without
    candidates) equals make_me_body followed by the final stage's subpel
    levels alone (me_final without the competition), the ME with its
    precision in one body, and the JAX package's composition
    (make_me_body + make_subpel_body) per picture."""
    w, h = 120, 72                   # cropped: 9 x 15 blocks of 8 on 72x120
    xnb, ynb = w // BSEP, h // BSEP
    curs, ref = _batch_pair(n, w, h, seed=20 + prec)
    tcur, tref = torch.as_tensor(curs), torch.as_tensor(ref)
    tup = t_obmc.make_halfpel(t_obmc.upsample_plane(tref))
    kw = dict(levels=5, zero_cand=zero_cand)
    pyr = t_me.make_me_body(h, w, BSEP, BSEP, xnb, ynb, candidates=False,
                            **kw)(tcur, tref)
    c = pad_edge(tcur, 0, ynb * BSEP - h, 0, xnb * BSEP - w)
    r = pad_edge(tref, 0, ynb * BSEP - h, 0, xnb * BSEP - w)
    margin = t_me.ME_BOUND_PEL + 2 * 8 + 16       # coarse radius 8
    got = mf.me_final_plain(c, r, tup, torch.stack(pyr[:2], -1), pyr[2],
                            BSEP, BSEP, prec, True, zero_cand,
                            t_me.ME_BOUND_PEL, margin)
    dy, dx, _ = t_me.make_me_body(h, w, BSEP, BSEP, xnb, ynb, **kw)(tcur,
                                                                   tref)
    want = mf.me_final(c, None, tup, torch.stack([dy, dx], -1), None, BSEP,
                       BSEP, prec, False, False, t_me.ME_BOUND_PEL, 0)
    whole = t_me.make_me_body(h, w, BSEP, BSEP, xnb, ynb, mv_precision=prec,
                              **kw)(tcur, tref, up=tup)
    for g, a, b, name in zip(got, want, whole, ("dy", "dx", "sad")):
        assert torch.equal(g, a) and torch.equal(g, b), name
    jme = j_me.make_me_body(h, w, BSEP, BSEP, xnb, ynb, **kw)
    jsub = j_me.make_subpel_body(h, w, BSEP, BSEP, xnb, ynb, prec)
    jup = j_obmc.make_halfpel(j_obmc.upsample_plane(jnp.asarray(ref)))
    for k in range(n):
        jy, jx, _ = jme(jnp.asarray(curs[k]), jnp.asarray(ref))
        jwant = jsub(jnp.asarray(curs[k]), jup, jy, jx)
        for g, j_, name in zip(got, jwant, ("dy", "dx", "sad")):
            _eq(g[k], j_, f"{name} of picture {k} vs the JAX package")


# csrc/me_final.cu's median of nine and its SUBPEL_LVL functions
_MED9_NET = ((1, 2), (4, 5), (7, 8), (0, 1), (3, 4), (6, 7), (1, 2), (4, 5),
             (7, 8), (0, 3), (5, 8), (4, 7), (3, 6), (1, 4), (2, 5), (4, 7),
             (2, 4), (4, 6), (2, 4))


def _median9(v):
    p = list(v)
    for a, b in _MED9_NET:
        p[a], p[b] = min(p[a], p[b]), max(p[a], p[b])
    return p[4]


def _sp_off(v, d):
    return d if v == 0 else 1 if (v == 3 or d != 0) else 0


def _sp_frac(v, d):
    if v == 0:
        return 0
    if v == 1:
        return 0 if d == 1 else 2
    if v == 2:
        return (3, 0, 1)[d]
    return d + 1


def _round8(v):
    return (v + 7) & ~7


def _kernel_model(c, r, up, mv, sad, bs, prec, compete, zero_cand, bound,
                  margin):
    """Kernel #4's arithmetic as csrc/me_final.cu writes it, block by
    block in numpy: the median network, me_search's radius-0 window
    clamps on the level-0 planes, the patch-origin clamp of the padded
    half-pel plane, the window read from the unpadded plane with
    pad_halfpel's clamp, the bilinear taps vertical first."""
    n, ph, pw = c.shape
    nby, nbx = ph // bs, pw // bs
    c = c.astype(np.int64)
    h2, w2 = up.shape if up is not None else (0, 0)
    spm = mf.subpel_margin(bs, bs, bound)
    rr, cc = np.mgrid[0:bs, 0:bs]
    out = np.zeros((3, n, nby, nbx), np.int64)
    for k in range(n):
        for i in range(nby):
            for j in range(nbx):
                cur = c[k, i * bs + rr, j * bs + cc]
                my, mx = (int(v) for v in mv[k, i, j])
                s = 0
                if compete:
                    taps = [mv[k, min(max(i + a, 0), nby - 1),
                               min(max(j + b, 0), nbx - 1)]
                            for a in (-1, 0, 1) for b in (-1, 0, 1)]
                    med = [_median9([int(t[q]) for t in taps])
                           for q in (0, 1)]
                    lim = ph + 2 * margin - _round8(bs), \
                        pw + 2 * margin - _round8(bs)

                    def window_sad(hy, hx):
                        y0 = min(max(i * bs + margin + hy, 0), lim[0]) \
                            - margin
                        x0 = min(max(j * bs + margin + hx, 0), lim[1]) \
                            - margin
                        pat = r[np.clip(y0 + rr, 0, ph - 1),
                                np.clip(x0 + cc, 0, pw - 1)]
                        return int(np.abs(cur - pat).sum())
                    s_med = window_sad(*(min(max(v, -bound), bound)
                                         for v in med))
                    bias = bs * bs // 16
                    s = key = int(sad[k, i, j])
                    if s_med - bias < key:
                        key, (my, mx), s = s_med - bias, med, s_med
                    if zero_cand:
                        s_zero = window_sad(0, 0)
                        if s_zero - bias < key:
                            my, mx, s = 0, 0, s_zero
                if prec:
                    lim = (h2 + 2 * spm - _round8(2 * bs + 4),
                           w2 + 2 * spm - _round8(2 * bs + 4))
                    my = min(max(my, -bound), bound)
                    mx = min(max(mx, -bound), bound)
                    for level in range(1, prec + 1):
                        my, mx = 2 * my, 2 * mx
                        sh = 3 - level
                        y0 = min(max(2 * i * bs + ((my << sh) >> 2) - 1
                                     + spm, 0), lim[0]) - spm
                        x0 = min(max(2 * j * bs + ((mx << sh) >> 2) - 1
                                     + spm, 0), lim[1]) - spm
                        win = up[np.clip(y0 + np.arange(2 * bs + 2), 0,
                                         h2 - 2)[:, None],
                                 np.clip(x0 + np.arange(2 * bs + 2), 0,
                                         w2 - 2)[None, :]].astype(np.int64)
                        if level < 3:
                            vy = vx = level - 1
                        else:
                            vy = 3 if my & 3 == 2 else 2
                            vx = 3 if mx & 3 == 2 else 2
                        sads = []
                        for a in range(3):
                            oy, ry = _sp_off(vy, a), _sp_frac(vy, a)
                            vert = [(4 - ry) * win[2 * rr + oy, 2 * cc + v]
                                    + ry * win[2 * rr + oy + 1, 2 * cc + v]
                                    for v in range(4)]
                            for b in range(3):
                                ox, rx = _sp_off(vx, b), _sp_frac(vx, b)
                                pred = ((4 - rx) * vert[ox]
                                        + rx * vert[ox + 1] + 8) >> 4
                                sads.append(int(np.abs(cur - pred).sum()))
                        q = int(np.argmin(sads))
                        my, mx, s = my + q // 3 - 1, mx + q % 3 - 1, sads[q]
                out[:, k, i, j] = my, mx, s
    return out


def test_kernel_median_network_selects_the_median():
    """The 19-comparator network of csrc/me_final.cu picks the fifth
    smallest of every 0-1 input, hence (0-1 principle) of every input."""
    for bits in range(512):
        v = [(bits >> q) & 1 for q in range(9)]
        assert _median9(v) == sorted(v)[4]
    rng = np.random.default_rng(0)
    for v in rng.integers(-124, 125, (200, 9)):
        assert _median9(v) == np.sort(v)[4]


def test_kernel_index_division_is_exact():
    """Kernel #4 divides a tile's flat index t by its width d as (t *
    ceil(2^20 / d)) >> 20 in 32 bits: exact for every width and index of
    the tiles it stages, up to a window of the largest block the wrapper
    takes."""
    top = 2 * mf.MAX_BSEP + 2
    for d in range(1, top + 1):
        inv = -(-(1 << 20) // d)
        t = np.arange(top * d, dtype=np.int64)
        assert t[-1] * inv < 2 ** 32
        np.testing.assert_array_equal((t * inv) >> 20, t // d)


def _final_case(n, nby, nbx, bs, seed, flat=False, edge=False):
    """me_final's arguments from a numpy seed: level-0 planes of
    nby x nbx blocks, a half-pel plane of a picture cropped below the
    block grid, vectors of a few pel (all at +-bound with `edge`, where
    every window is clamped), hierarchy SADs in the range the picks turn
    on."""
    rng = np.random.default_rng(seed)
    ph, pw = nby * bs, nbx * bs
    bound = t_me.ME_BOUND_PEL
    if flat:        # every candidate ties
        c = np.full((n, ph, pw), 77, np.uint8)
        r = np.full((ph, pw), 90, np.uint8)
        up = np.full((2 * ph - 6, 2 * pw - 10), 90, np.uint8)
    else:
        c = rng.integers(0, 256, (n, ph, pw)).astype(np.uint8)
        r = rng.integers(0, 256, (ph, pw)).astype(np.uint8)
        up = rng.integers(0, 256, (2 * ph - 6, 2 * pw - 10)).astype(np.uint8)
    if edge:
        mv = rng.choice([-bound, bound], (n, nby, nbx, 2))
    else:
        mv = rng.integers(-3, 4, (n, nby, nbx, 2))
    lo = 13 * bs * bs if flat else 60 * bs * bs
    sad = rng.integers(lo - bs * bs, lo + 40 * bs * bs, (n, nby, nbx))
    margin = bound + 2 * 8 + 16
    return (c, r, up, mv.astype(np.int32), sad.astype(np.int32), bound,
            margin)


@pytest.mark.parametrize("case", [
    # (n, nby, nbx, bs, prec, compete, zero_cand, flat, edge)
    (1, 3, 4, 8, 2, True, True, False, False),
    (3, 3, 4, 8, 2, True, True, False, False),
    (3, 2, 3, 16, 3, True, True, False, False),
    (3, 4, 6, 8, 3, False, False, False, False),
    (1, 3, 2, 12, 1, True, False, False, False),
    (3, 2, 3, 8, 0, True, True, False, False),
    (1, 2, 3, 16, 2, False, False, False, False),
    (3, 3, 3, 8, 3, False, False, False, True),
    (1, 3, 3, 8, 2, True, True, False, True),
    (3, 2, 2, 16, 2, True, True, True, False),
    (1, 2, 3, 12, 3, True, False, True, True)],
    ids=lambda c: "n{}-{}x{}x{}-p{}-{}{}{}{}".format(
        *c[:5], "c" if c[5] else "s", "z" if c[6] else "",
        "-flat" if c[7] else "", "-edge" if c[8] else ""))
def test_kernel_model_equals_plain(case):
    """The numpy model of kernel #4's arithmetic equals me_final_plain:
    the competition, subpel-only and competition-only modes, every
    precision, 8, 12 and 16 px blocks, vectors at the bound (the window
    and patch clamps) and flat planes (first-minimum ties)."""
    n, nby, nbx, bs, prec, compete, zero_cand, flat, edge = case
    c, r, up, mv, sad, bound, margin = _final_case(n, nby, nbx, bs,
                                                   seed=sum(case[:5]),
                                                   flat=flat, edge=edge)
    want = mf.me_final_plain(torch.as_tensor(c), torch.as_tensor(r),
                             torch.as_tensor(up), torch.as_tensor(mv),
                             torch.as_tensor(sad), bs, bs, prec, compete,
                             zero_cand, bound, margin)
    got = _kernel_model(c, r, up, mv, sad, bs, prec, compete, zero_cand,
                        bound, margin)
    for g, w_, name in zip(got, want, ("dy", "dx", "sad")):
        np.testing.assert_array_equal(g, w_.numpy(), err_msg=name)
    # the winners move: not every block keeps the pyramid's vector
    if not flat and compete:
        assert (got[:2] != (mv.transpose(3, 0, 1, 2) << prec)).any()


def test_me_final_on_the_cpu_runs_the_plain_version():
    """me_final on CPU tensors is me_final_plain and launches nothing;
    another device raises."""
    c, r, up, mv, sad, bound, margin = _final_case(1, 2, 3, 8, seed=4)
    args = (torch.as_tensor(c), torch.as_tensor(r), torch.as_tensor(up),
            torch.as_tensor(mv), torch.as_tensor(sad), 8, 8, 2, True, True,
            bound, margin)
    before = mf.launches()
    got = mf.me_final(*args)
    assert mf.launches() == before
    for g, w_ in zip(got, mf.me_final_plain(*args)):
        assert torch.equal(g, w_)
    meta = torch.zeros((1, 16, 24), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError):
        mf.me_final(meta, *args[1:])
