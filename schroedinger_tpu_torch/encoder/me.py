"""Hierarchical block-matching motion estimation (PyTorch port of
`schroedinger_tpu/encoder/me.py`).

Every full-pel search of the pyramid is one call of `me_search`
(`ops/patch_refine.py`), which launches the CUDA kernel for CUDA tensors
and runs its plain version for CPU tensors: the exhaustive scan around
zero at the coarsest level, the refine of the upsampled parent vectors at
each finer level, and, in the final level's candidate competition
(hierarchy vs zero vs 3x3-median 'predicted'), the SADs at the median
field and at zero.  That is levels + 2 searches per ME pass.
`make_subpel_body` refines the winners to 1/2^prec pel.  Both take a batch
of current planes (N, H, W) against one reference, the B pictures of a
subgroup against their shared references: every search is then one
launch for the whole batch.

Not ported yet: injected candidates (n_extra / phase correlation), chroma
ME, the single-level full scan and the estimation switches that turn the
candidate competition or the zero candidate off.
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


def make_me_body(H, W, xbsep, ybsep, x_num_blocks, y_num_blocks,
                 levels=3, coarse_radius=8):
    """Build the ME: me(cur_y u8, ref_y u8) -> (dy, dx, sad) per block
    (pel), all (y_num_blocks, x_num_blocks) int32 tensors.  A batch cur_y
    (N, H, W) against the one ref_y gives (N, y_num_blocks, x_num_blocks)
    and launches each search once for the batch.

    The final-level candidate set mirrors the reference's list {scan /
    hierarchy, predicted, zero} (schroencoder.h:421-440): the hierarchy
    result competes against the zero vector (with the reference's zero
    bias) and the 3x3-median 'predicted' field.  levels=1 disables the
    pyramid."""
    pad_h = ybsep * y_num_blocks
    pad_w = xbsep * x_num_blocks

    # cap pyramid depth so the coarsest level still holds >= 2x2 blocks
    # of >= 4 px (downsample_levels setting, schromotionest.h:20)
    while levels > 1 and (min(pad_h, pad_w) >> (levels - 1)) < 16:
        levels -= 1

    margin = ME_BOUND_PEL + 2 * max(coarse_radius, REFINE_RADIUS) + 16

    def me(cur, ref):
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

        # final-level candidate competition: hierarchy vs zero vs the
        # median-'predicted' field (schromotionest.c:520-695 analog); c, r
        # are level 0 cropped to whole blocks of ybsep x xbsep
        med = torch.stack([_median3x3_field(mv[..., 0]),
                           _median3x3_field(mv[..., 1])], dim=-1)
        _, sad_med = me_search(c, r, med.contiguous(), 1, ybsep, xbsep, 0,
                               ME_BOUND_PEL, margin)
        _, sad_zero = me_search(c, r, None, 0, ybsep, xbsep, 0,
                                ME_BOUND_PEL, margin)
        zero = torch.zeros_like(mv)

        # the reference biases toward zero/predicted ("gravity",
        # schrometric.c:122)
        bias = ybsep * xbsep // 16
        all_sads = torch.stack([sad, sad_med, sad_zero])
        all_mvs = torch.stack([mv, med, zero])
        biased = all_sads - torch.as_tensor(
            [0, bias, bias], dtype=torch.int32,
            device=dev)[:, None, None, None]
        best = torch.argmin(biased, dim=0)                # (N, nby, nbx)
        mv = torch.gather(all_mvs, 0, best[None, ..., None].expand(
            1, *best.shape, 2))[0]
        sad = _take(all_sads, best)
        if not batched:
            return mv[0, ..., 0], mv[0, ..., 1], sad[0]
        return mv[..., 0], mv[..., 1], sad

    return me


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
