"""Hierarchical block-matching motion estimation (PyTorch port of
`schroedinger_tpu/encoder/me.py`).

Every full-pel search of the pyramid is one call of `me_search`
(`ops/patch_refine.py`), which launches the CUDA kernel for CUDA tensors
and runs its plain version for CPU tensors: the exhaustive scan around
zero at the coarsest level, the refine of the upsampled parent vectors at
each finer level, and, in the final level's candidate competition
(hierarchy vs zero vs 3x3-median 'predicted', plus injected uniform
candidates such as phase correlation's), the SADs at the median field and
at zero, the chroma SADs of every candidate (chroma ME) and the radius-1
rescan around an injected winner.  That is levels + 2 searches per ME
pass without the options.  The luma SADs of the injected candidates are
the JAX package's wrap-around (rolled) SADs, computed as a plain
difference: the kernel clamps at the edges instead.
`make_subpel_body` refines the winners to 1/2^prec pel.  Both take a batch
of current planes (N, H, W) against one reference, the B pictures of a
subgroup against their shared references: every search is then one
launch for the whole batch.
"""
from __future__ import annotations

import torch

from schroedinger_tpu_torch.ops.pad import pad_edge
from schroedinger_tpu_torch.ops.obmc import (_round8, extract_patches,
                                             pad_halfpel)
from schroedinger_tpu_torch.ops.patch_refine import (
    extract_ref_patches, me_search, to_blocks as _to_blocks)

ME_BOUND_PEL = 124
REFINE_RADIUS = 2       # hint-refine search radius below the coarsest level


def _arange32(n, device):
    return torch.arange(n, dtype=torch.int32, device=device)


def downsample2(x):
    """2x box downsample of the last two dims (encoder-side pyramid;
    decision-only)."""
    h, w = x.shape[-2:]
    h2, w2 = h // 2 * 2, w // 2 * 2
    x = x[..., :h2, :w2].to(torch.int32)
    return ((x[..., 0::2, 0::2] + x[..., 0::2, 1::2] + x[..., 1::2, 0::2]
             + x[..., 1::2, 1::2] + 2) >> 2).to(torch.uint8)


def block_sads_at(cb, P, mv_y, mv_x, nby, nbx, bs_y, bs_x, margin):
    """Per-block SAD of the reference patch at each block's own MV (the
    radius-0 case of the patch search: no candidates, no pick).  mv_y,
    mv_x: (..., nby, nbx); cb: the matching (... * nb, bs_y, bs_x)
    blocks."""
    pat = extract_ref_patches(P, mv_y, mv_x, nby, nbx, bs_y, bs_x, 0,
                              margin)
    return (cb - pat[:, :bs_y, :bs_x]).abs().sum(
        (1, 2), dtype=torch.int32).reshape(mv_y.shape)


def _block_sum(d, nby, bs_y, nbx, bs_x):
    return d.reshape(nby, bs_y, nbx, bs_x).sum((1, 3), dtype=torch.int32)


def _dense_scan(c, r, nby, nbx, bs_y, bs_x, rad):
    """Exhaustive (2rad+1)^2 scan around zero displacement as dense
    shifted SADs; bit-identical to me_search's coarse scan (scale 0, same
    edge clamp, same (dy, dx) lexicographic tie order).  The plain
    function the tests hold that mode to; the ME itself calls me_search.

    c, r: (nby*bs_y, nbx*bs_x) images.  Returns (dy, dx, sad)."""
    K = 2 * rad + 1
    H, W = c.shape
    ci = c.to(torch.int32)
    Ppad = pad_edge(r.to(torch.int32), rad, rad, rad, rad)
    sads = [_block_sum((ci - Ppad[a:a + H, b:b + W]).abs(),
                       nby, bs_y, nbx, bs_x)
            for a in range(K) for b in range(K)]
    s = torch.stack(sads)                       # (K*K, nby, nbx)
    best = torch.argmin(s, dim=0)
    dy = torch.div(best, K, rounding_mode="floor") - rad
    dx = best % K - rad
    sad = torch.gather(s, 0, best[None])[0]
    return dy.to(torch.int32), dx.to(torch.int32), sad


def _plane(x):
    """x contiguous and 16-byte aligned, as me_search takes its planes (a
    copy only where a crop or a view needs one)."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _median3x3_field(f):
    """Per-block 3x3 median of an MV component field (edge-clamped) over
    its last two dims."""
    h, w = f.shape[-2:]
    dev = f.device
    taps = []
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            ys = (torch.arange(h, device=dev) + dy).clamp(0, h - 1)
            xs = (torch.arange(w, device=dev) + dx).clamp(0, w - 1)
            taps.append(f[..., ys[:, None], xs[None, :]])
    return torch.sort(torch.stack(taps), dim=0).values[4]


def _take(stacked, best):
    """stacked (K, ...) picked along dim 0 by best (...)."""
    return torch.gather(stacked, 0, best[None])[0]


def _roll_sads(c, r, bs_y, bs_x, cands):
    """Per-block SAD of c against r shifted by each uniform candidate,
    with wrap-around at the plane's edges (the JAX package's roll
    formulation, `me._block_sads`): r is read at ((y + dy) mod h,
    (x + dx) mod w).  c: (N, h, w), r: (h, w), cands: host (dy, dx) int
    pairs.  Returns [(N, h // bs_y, w // bs_x) int32] per candidate."""
    h, w = c.shape[-2:]
    ci = c.to(torch.int32)
    ri = r.to(torch.int32)
    out = []
    for dy, dx in cands:
        d = (ci - torch.roll(ri, (-int(dy), -int(dx)), (0, 1))).abs()
        out.append(d.reshape(-1, h // bs_y, bs_y, w // bs_x, bs_x).sum(
            (2, 4), dtype=torch.int32))
    return out


def pyramid_levels(pad_h, pad_w, levels):
    """The pyramid's depth on a pad_h x pad_w block grid: `levels`, capped
    so that the coarsest level still holds >= 2x2 blocks of >= 4 px
    (downsample_levels setting, schromotionest.h:20).  A pass of the
    default estimation makes this many searches plus two (the median and
    the zero SAD)."""
    while levels > 1 and (min(pad_h, pad_w) >> (levels - 1)) < 16:
        levels -= 1
    return levels


def make_me_body(H, W, xbsep, ybsep, x_num_blocks, y_num_blocks,
                 levels=3, coarse_radius=8, n_extra=0, candidates=True,
                 zero_cand=True, chroma=None):
    """Build the ME: me(cur_y u8, ref_y u8, extra=None, chroma_planes=None)
    -> (dy, dx, sad) per block (pel), all (y_num_blocks, x_num_blocks)
    int32 tensors.  A batch cur_y (N, H, W) against the one ref_y gives
    (N, y_num_blocks, x_num_blocks) and launches each search once for the
    batch.

    The final-level candidate set mirrors the reference's list {scan /
    hierarchy, predicted, zero, global/phasecorr} (schroencoder.h:421-440):
    the hierarchy result competes against the zero vector (with the
    reference's zero bias) and the 3x3-median 'predicted' field, and with
    n_extra > 0 against the n_extra uniform full-pel candidates `extra`
    (a host (n_extra, 2) array of (dy, dx)), after which the winner gets a
    radius-1 rescan.  levels=1 disables the pyramid (the option's cap
    keeps the coarsest level at >= 16 px).  candidates=False (no deep
    estimation) returns the pyramid's result when there are no injected
    candidates; zero_cand=False drops the zero candidate.

    chroma: None, or (cbs_y, cbs_x, ch, cw), the chroma block geometry
    (chroma ME): each candidate's chroma SAD (u + v, sampled at mv >>
    chroma shift) joins the selection metric; the returned SAD stays
    luma.  chroma_planes is then (cur_u, cur_v, ref_u, ref_v)."""
    pad_h = ybsep * y_num_blocks
    pad_w = xbsep * x_num_blocks
    levels = pyramid_levels(pad_h, pad_w, levels)

    margin = ME_BOUND_PEL + 2 * max(coarse_radius, REFINE_RADIUS) + 16

    def me(cur, ref, extra=None, chroma_planes=None):
        batched = cur.ndim == 3
        if not batched:
            cur = cur[None]
        cur = pad_edge(cur, 0, pad_h - H, 0, pad_w - W)
        ref = pad_edge(ref, 0, pad_h - H, 0, pad_w - W)
        dev = cur.device

        pyr_c = [cur]
        pyr_r = [ref]
        for _ in range(levels - 1):
            pyr_c.append(downsample2(pyr_c[-1]))
            pyr_r.append(downsample2(pyr_r[-1]))

        mv = None
        for lev in range(levels - 1, -1, -1):
            bs_y = max(4, ybsep >> lev) if lev else ybsep
            bs_x = max(4, xbsep >> lev) if lev else xbsep
            h, w = pyr_r[lev].shape
            h = h // bs_y * bs_y
            w = w // bs_x * bs_x
            c = _plane(pyr_c[lev][:, :h, :w])
            r = _plane(pyr_r[lev][:h, :w])
            if mv is None:
                # coarsest level: exhaustive (2*coarse_radius+1)^2 scan
                mv, sad = me_search(c, r, None, 0, bs_y, bs_x,
                                    coarse_radius, ME_BOUND_PEL, margin)
            else:
                # hints: the parent's vectors upsampled to this level's
                # grid and scaled x2
                mv, sad = me_search(c, r, mv, 2, bs_y, bs_x, REFINE_RADIUS,
                                    ME_BOUND_PEL, margin)

        mv = mv.clamp(-ME_BOUND_PEL, ME_BOUND_PEL)

        def out(mv, sad):
            if not batched:
                return mv[0, ..., 0], mv[0, ..., 1], sad[0]
            return mv[..., 0], mv[..., 1], sad

        if not candidates and not n_extra:
            return out(mv, sad)

        # final-level candidate competition: hierarchy vs zero vs the
        # median-'predicted' field (schromotionest.c:520-695 analog) and
        # the injected candidates; c, r are level 0 cropped to whole
        # blocks of ybsep x xbsep
        nby, nbx = mv.shape[-3], mv.shape[-2]
        med = torch.stack([_median3x3_field(mv[..., 0]),
                           _median3x3_field(mv[..., 1])], dim=-1)
        _, sad_med = me_search(c, r, med.contiguous(), 1, ybsep, xbsep, 0,
                               ME_BOUND_PEL, margin)

        # the reference biases toward zero/predicted ("gravity",
        # schrometric.c:122)
        bias = ybsep * xbsep // 16
        cand_mvs = [mv, med]
        cand_sads = [sad, sad_med]
        cand_bias = [0, bias]
        if zero_cand:
            _, sad_zero = me_search(c, r, None, 0, ybsep, xbsep, 0,
                                    ME_BOUND_PEL, margin)
            cand_mvs.append(torch.zeros_like(mv))
            cand_sads.append(sad_zero)
            cand_bias.append(bias)
        if n_extra:
            ext = [(max(-ME_BOUND_PEL, min(ME_BOUND_PEL, int(dy))),
                    max(-ME_BOUND_PEL, min(ME_BOUND_PEL, int(dx))))
                   for dy, dx in extra]
            cand_sads += _roll_sads(c, r, ybsep, xbsep, ext)
            cand_mvs += [torch.tensor(e, dtype=torch.int32, device=dev)
                         .expand(mv.shape) for e in ext]
            cand_bias += [0] * len(ext)
        cand_sel = cand_sads
        if chroma is not None:
            cand_sel = [s + sc for s, sc in zip(cand_sads, _chroma_sads(
                chroma, chroma_planes, cand_mvs, ybsep, xbsep, nby, nbx,
                margin, zero_cand, batched))]
        all_sads = torch.stack(cand_sads)
        all_mvs = torch.stack(cand_mvs)
        biased = torch.stack(cand_sel) - torch.as_tensor(
            cand_bias, dtype=torch.int32, device=dev)[:, None, None, None]
        best = torch.argmin(biased, dim=0)                # (N, nby, nbx)
        mv = torch.gather(all_mvs, 0, best[None, ..., None].expand(
            1, *best.shape, 2))[0]
        sad = _take(all_sads, best)
        if n_extra:
            # injected candidates are uniform vectors: a local rescan
            # recovers per-block detail around the winner
            mv, sad = me_search(c, r, mv.contiguous(), 1, ybsep, xbsep, 1,
                                ME_BOUND_PEL, margin)
        return out(mv, sad)

    return me


def _chroma_sads(chroma, chroma_planes, cand_mvs, ybsep, xbsep, nby, nbx,
                 margin, zero_cand, batched):
    """Per candidate MV field, the per-block chroma SAD (u + v) of the
    chroma blocks at the chroma-shifted vector, one me_search at radius 0
    per candidate and plane (the zero candidate's at scale 0)."""
    cbs_y, cbs_x, ch, cw = chroma
    cu, cv, ru, rv = chroma_planes
    if not batched:
        cu, cv = cu[None], cv[None]
    cph, cpw = cbs_y * nby, cbs_x * nbx
    vsh = (ybsep // cbs_y).bit_length() - 1
    hsh = (xbsep // cbs_x).bit_length() - 1
    cmargin = (margin >> min(vsh, hsh)) + 2
    cur = [_plane(pad_edge(x, 0, cph - ch, 0, cpw - cw)) for x in (cu, cv)]
    ref = [_plane(pad_edge(x, 0, cph - ch, 0, cpw - cw)) for x in (ru, rv)]
    out = []
    for k, f in enumerate(cand_mvs):
        if zero_cand and k == 2:
            field, scale = None, 0
        else:
            field = torch.stack([f[..., 0] >> vsh, f[..., 1] >> hsh],
                                dim=-1).contiguous()
            scale = 1
        tot = None
        for c_, r_ in zip(cur, ref):
            _, s = me_search(c_, r_, field, scale, cbs_y, cbs_x, 0,
                             ME_BOUND_PEL, cmargin)
            tot = s if tot is None else tot + s
        out.append(tot)
    return out


# per-level static candidate tables for the patch formulation (see the
# JAX module): d -> (delta, frac) at levels 1, 2; at level 3 two variants
# switched on the quarter parity of the incoming mv.
_SUBPEL_LVL = {
    1: {-1: (0, 0), 0: (1, 0), 1: (2, 0)},
    2: {-1: (0, 2), 0: (1, 0), 1: (1, 2)},
    3: {-1: ((0, 3), (1, 1)), 0: ((1, 0), (1, 2)), 1: ((1, 1), (1, 3))},
}


def make_subpel_body(H, W, xbsep, ybsep, x_num_blocks, y_num_blocks,
                     mv_precision):
    """Sub-pel refinement: full-pel MVs -> 1/2^prec-pel MVs.

    refine(cur u8, up (2h,2w) u8, dy, dx) -> (mv_y, mv_x, best_sad);
    a batch cur (N, H, W) with fields (N, nby, nbx) refines against the
    one up.
    Scales to each precision level and scans the 3x3 sub-pel
    neighbourhood with the renderer's exact fetch semantics
    (schromotionest.c:133-246 analog) on per-block patches of the padded
    half-pel plane."""
    pad_h = ybsep * y_num_blocks
    pad_w = xbsep * x_num_blocks
    nby, nbx = y_num_blocks, x_num_blocks
    ph = _round8(2 * ybsep + 4)
    pw = _round8(2 * xbsep + 4)
    margin = 2 * ME_BOUND_PEL + max(ph, pw) + 16

    def bilerp(pat, dy_off, dx_off, ry, rx, bs_y, bs_x):
        """Block grid from patches at static half-pel offset and static
        fraction (ry, rx)."""
        p00 = pat[:, dy_off:dy_off + 2 * bs_y:2, dx_off:dx_off + 2 * bs_x:2]
        if ry == 0 and rx == 0:
            return p00
        p01 = pat[:, dy_off:dy_off + 2 * bs_y:2,
                  dx_off + 1:dx_off + 1 + 2 * bs_x:2]
        p10 = pat[:, dy_off + 1:dy_off + 1 + 2 * bs_y:2,
                  dx_off:dx_off + 2 * bs_x:2]
        p11 = pat[:, dy_off + 1:dy_off + 1 + 2 * bs_y:2,
                  dx_off + 1:dx_off + 1 + 2 * bs_x:2]
        v = ((4 - ry) * (4 - rx) * p00 + (4 - ry) * rx * p01
             + ry * (4 - rx) * p10 + ry * rx * p11)
        return (v + 8) >> 4

    def refine(cur, up, dy_full, dx_full):
        dev = cur.device
        c = pad_edge(cur, 0, pad_h - H, 0, pad_w - W).to(torch.int32)
        cb = _to_blocks(c, nby, ybsep, nbx, xbsep)
        P = pad_halfpel(up, margin, margin)
        mv_y = dy_full.clamp(-ME_BOUND_PEL, ME_BOUND_PEL)
        mv_x = dx_full.clamp(-ME_BOUND_PEL, ME_BOUND_PEL)
        best_sad = None
        for level in range(1, mv_precision + 1):
            mv_y = mv_y * 2
            mv_x = mv_x * 2
            sh = 3 - level
            # base half-pel origin per block (mv even -> exact)
            oy0 = ((mv_y << sh) >> 2) - 1
            ox0 = ((mv_x << sh) >> 2) - 1
            by = (2 * (_arange32(nby, dev) * ybsep))[:, None] + oy0 + margin
            bx = (2 * (_arange32(nbx, dev) * xbsep))[None, :] + ox0 + margin
            pat = extract_patches(P, by.reshape(-1), bx.reshape(-1),
                                  ph, pw).to(torch.int32)

            if level < 3:
                tab = _SUBPEL_LVL[level]

                def sample(dy_c, dx_c):
                    ofy, ry = tab[dy_c]
                    ofx, rx = tab[dx_c]
                    return bilerp(pat, ofy, ofx, ry, rx, ybsep, xbsep)
            else:
                tab = _SUBPEL_LVL[3]
                py2 = ((mv_y & 3) == 2).reshape(-1)[:, None, None]
                px2 = ((mv_x & 3) == 2).reshape(-1)[:, None, None]

                def sample(dy_c, dx_c):
                    (oy0a, ry0), (oy2a, ry2) = tab[dy_c]
                    (ox0a, rx0), (ox2a, rx2) = tab[dx_c]
                    v00 = bilerp(pat, oy0a, ox0a, ry0, rx0, ybsep, xbsep)
                    v02 = bilerp(pat, oy0a, ox2a, ry0, rx2, ybsep, xbsep)
                    v20 = bilerp(pat, oy2a, ox0a, ry2, rx0, ybsep, xbsep)
                    v22 = bilerp(pat, oy2a, ox2a, ry2, rx2, ybsep, xbsep)
                    v0 = torch.where(px2, v02, v00)
                    v2 = torch.where(px2, v22, v20)
                    return torch.where(py2, v2, v0)

            offs = [(dy_c, dx_c) for dy_c in (-1, 0, 1)
                    for dx_c in (-1, 0, 1)]
            s = torch.stack([(cb - sample(*o)).abs().sum(
                (1, 2), dtype=torch.int32) for o in offs])
            best = torch.argmin(s, dim=0)
            off_t = torch.as_tensor(offs, dtype=torch.int32, device=dev)
            mv_y = mv_y + off_t[best, 0].reshape(mv_y.shape)
            mv_x = mv_x + off_t[best, 1].reshape(mv_x.shape)
            best_sad = _take(s, best).reshape(mv_y.shape)
        return mv_y, mv_x, best_sad

    return refine
