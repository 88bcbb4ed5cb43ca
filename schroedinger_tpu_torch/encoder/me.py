"""Hierarchical block-matching motion estimation (PyTorch port of
`schroedinger_tpu/encoder/me.py`).

Every full-pel search of the pyramid is one call of `me_search`
(`ops/patch_refine.py`), which launches CUDA kernel #1 for CUDA tensors
and runs its plain version for CPU tensors: the exhaustive scan around
zero at the coarsest level and the refine of the upsampled parent vectors
at each finer level, `levels` searches a pass.  The final stage, the
final level's candidate competition (hierarchy vs zero vs 3x3-median
'predicted') and the subpel refine of the winners to 1/2^prec pel, is one
call of `me_final` (`ops/me_final.py`: CUDA kernel #4, or its plain
version on the CPU).  With injected uniform candidates (phase
correlation's) or chroma ME the competition stays here in PyTorch: the
SADs at the median field and at zero, the chroma SADs of every candidate
and the radius-1 rescan around an injected winner are me_search calls,
the injected candidates' luma SADs the JAX package's wrap-around (rolled)
SADs, computed as a plain difference; `me_final` then runs the subpel
levels alone.  Every search and the final stage take a batch of current
planes (N, H, W) against one reference, the B pictures of a subgroup
against their shared references: each is then one launch for the whole
batch.
"""
from __future__ import annotations

import torch

from schroedinger_tpu_torch.ops.me_final import (final_candidates, me_final,
                                                 pick)
from schroedinger_tpu_torch.ops.pad import pad_edge
from schroedinger_tpu_torch.ops.patch_refine import (
    extract_ref_patches, me_search, to_blocks as _to_blocks)
from schroedinger_tpu_torch.utils.telemetry import counters

ME_BOUND_PEL = 124
REFINE_RADIUS = 2       # hint-refine search radius below the coarsest level


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
                 zero_cand=True, chroma=None, mv_precision=0):
    """Build the ME: me(cur_y u8, ref_y u8, extra=None, chroma_planes=None,
    up=None) -> (dy, dx, sad) per block, all (y_num_blocks, x_num_blocks)
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
    candidates; zero_cand=False drops the zero candidate.  With
    candidates and mv_precision > 0 the winners are refined to
    1/2^mv_precision pel against `up`, the reference's (2H, 2W) half-pel
    plane, and dy, dx come in those units; else in pel.

    chroma: None, or (cbs_y, cbs_x, ch, cw), the chroma block geometry
    (chroma ME): each candidate's chroma SAD (u + v, sampled at mv >>
    chroma shift) joins the selection metric; the returned SAD stays
    luma.  chroma_planes is then (cur_u, cur_v, ref_u, ref_v).

    The competition without injected or chroma candidates and the subpel
    refine are one `me_final` call (kernel #4 on the card); otherwise the
    competition runs here and `me_final` refines alone.  The counter
    `me_compete_plain` counts the passes on the card whose competition
    ran here."""
    pad_h = ybsep * y_num_blocks
    pad_w = xbsep * x_num_blocks
    levels = pyramid_levels(pad_h, pad_w, levels)
    prec = mv_precision if candidates else 0
    fused = candidates and not n_extra and chroma is None

    margin = ME_BOUND_PEL + 2 * max(coarse_radius, REFINE_RADIUS) + 16

    def pyramid(cur, ref):
        """The full-pel search, coarsest level first: (mv (N, nby, nbx,
        2) clamped to the bound, sad, and level 0's current planes and
        reference cropped to the block grid)."""
        cur = pad_edge(cur, 0, pad_h - H, 0, pad_w - W)
        ref = pad_edge(ref, 0, pad_h - H, 0, pad_w - W)
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
        return mv.clamp(-ME_BOUND_PEL, ME_BOUND_PEL), sad, c, r

    def compete(c, r, mv, sad, extra, chroma_planes, batched):
        """The competition with injected or chroma candidates (me_search
        for every SAD of the current and reference planes)."""
        if c.device.type == "cuda":
            counters.add("me_compete_plain")
        cand_mvs, cand_sads, cand_bias = final_candidates(
            c, r, mv, sad, ybsep, xbsep, zero_cand, ME_BOUND_PEL, margin,
            me_search)
        if n_extra:
            ext = [(max(-ME_BOUND_PEL, min(ME_BOUND_PEL, int(dy))),
                    max(-ME_BOUND_PEL, min(ME_BOUND_PEL, int(dx))))
                   for dy, dx in extra]
            cand_sads += _roll_sads(c, r, ybsep, xbsep, ext)
            cand_mvs += [torch.tensor(e, dtype=torch.int32, device=c.device)
                         .expand(mv.shape) for e in ext]
            cand_bias += [0] * len(ext)
        cand_sel = cand_sads
        if chroma is not None:
            nby, nbx = mv.shape[-3], mv.shape[-2]
            cand_sel = [s + sc for s, sc in zip(cand_sads, _chroma_sads(
                chroma, chroma_planes, cand_mvs, ybsep, xbsep, nby, nbx,
                margin, zero_cand, batched))]
        mv, sad = pick(cand_mvs, cand_sads, cand_sel, cand_bias)
        if n_extra:
            # injected candidates are uniform vectors: a local rescan
            # recovers per-block detail around the winner
            mv, sad = me_search(c, r, mv.contiguous(), 1, ybsep, xbsep, 1,
                                ME_BOUND_PEL, margin)
        return mv, sad

    def me(cur, ref, extra=None, chroma_planes=None, up=None):
        batched = cur.ndim == 3
        if not batched:
            cur = cur[None]
        mv, sad, c, r = pyramid(cur, ref)
        if (candidates or n_extra) and not fused:
            mv, sad = compete(c, r, mv, sad, extra, chroma_planes, batched)
        if fused or prec:
            dy, dx, sad = me_final(c, r, up, mv.contiguous(), sad, ybsep,
                                   xbsep, prec, fused, zero_cand,
                                   ME_BOUND_PEL, margin)
        else:
            dy, dx = mv[..., 0], mv[..., 1]
        if not batched:
            return dy[0], dx[0], sad[0]
        return dy, dx, sad

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

