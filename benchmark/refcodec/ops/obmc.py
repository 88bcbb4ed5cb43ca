"""OBMC motion compensation + half-pel upsampling (patch render path).

A frozen copy of the port's `ops/obmc.py`, bit-exact with the reference's
scalar renderer (schromotionref.c) and upsampler (schroframe.c:1514-1680,
2001-2029):

- upsample: 8-tap {-1,3,-7,21,21,-7,3,-1}, (x+16)>>5, clamp 0..255, edge
  clamped taps; half-pel planes H0 (orig), H1 (horiz), H2 (vert),
  H3 (horiz of vert); last row/col copy rules per mc_edgeextend usage.
- pixel fetch at precision p: prec 0 nearest with clamp; prec 1 half-pel
  plane select with clamp to [0, 2w-2]; prec 2/3 bilinear between
  half-pel samples with /16 round.
- OBMC: per-pixel sum of up to 4 block contributions weighted by the
  raised-ramp wx*wy (6-bit), ROUND_SHIFT 6; DC blocks contribute dc+128;
  reference blocks weighted by the picture weights.

Two renders compute the prediction.  The patch render: every block reads
a contiguous patch of the half-pel plane (Dirac MVs are block-constant),
the bilinear taps are strided views of the patch, and the OBMC accumulate
splits blocks into 2x2 parity phases that tile a canvas disjointly; it is
exact for |mv| <= MV_BOUND_PEL, no global motion and blen <= 2 bsep.  The
gather render (`render_component`): per pixel, in each of the four parity
phases, the one block that covers it, its vector (or the per-pixel global
motion vector) and one (or four) whole-plane gathers; it serves every
stream.  `make_render_body` takes the patch render where it applies.
"""
from __future__ import annotations

import numpy as np
import torch

from refcodec.ops.pad import pad_edge

UP_TAPS = (-1, 3, -7, 21, 21, -7, 3, -1)
MV_BOUND_PEL = 128


def _conv8_edge(x, axis):
    """8-tap filter at half positions along axis with clamped taps:
    out[i] = clamp((sum_j taps[j] * x[clamp(i + j - 3)] + 16) >> 5, 0, 255)
    """
    n = x.shape[axis]
    pads = (3, 4, 0, 0) if axis == 0 else (0, 0, 3, 4)
    xp = pad_edge(x, *pads).to(torch.int32)
    acc = None
    for j, tap in enumerate(UP_TAPS):
        part = xp.narrow(axis, j, n) * tap
        acc = part if acc is None else acc + part
    return ((acc + 16) >> 5).clamp(0, 255).to(torch.uint8)


def upsample_plane(p):
    """u8 plane -> (H0, H1, H2, H3) half-pel planes (reference semantics)."""
    h, w = p.shape
    h0 = p
    # vertical half: rows 0..h-2 filtered, last row = source last row
    h2 = _conv8_edge(p, 0)
    h2[h - 1, :] = p[h - 1, :]
    # horizontal half of H0: last col = source last col
    h1 = _conv8_edge(p, 1)
    h1[:, w - 1] = p[:, w - 1]
    # horizontal half of H2; last col = H2 last col; last row = H1 last row
    h3 = _conv8_edge(h2, 1)
    h3[:, w - 1] = h2[:, w - 1]
    h3[h - 1, :] = h1[h - 1, :]
    return h0, h1, h2, h3


def make_halfpel(planes):
    """Interleave the 4 half-pel planes into one (2h, 2w) array:
    up[2y + (i>>1), 2x + (i&1)] = plane_i[y, x]."""
    h0, h1, h2, h3 = planes
    h, w = h0.shape
    top = torch.stack([h0, h1], dim=2).reshape(h, 2 * w)
    bot = torch.stack([h2, h3], dim=2).reshape(h, 2 * w)
    return torch.stack([top, bot], dim=1).reshape(2 * h, 2 * w)


def upsample_frame_np(p):
    """numpy u8 plane -> its (2h, 2w) interleaved half-pel plane, as
    numpy (the host form of `make_halfpel(upsample_plane(p))`)."""
    return make_halfpel(upsample_plane(torch.from_numpy(
        np.ascontiguousarray(p)))).numpy()


def _ramp_weights(blen, offset):
    """1-D OBMC ramp weights for one block (length blen), 6-bit half
    (schromotionref.c:160-168, 185-209)."""
    def get_ramp(x, off):
        if off == 1:
            return 3 if x == 0 else 5
        return 1 + (6 * x + off - 1) // (2 * off - 1)

    w = np.full(blen, 8, np.int32)
    if offset > 0:
        for x in range(2 * offset):
            w[x] = get_ramp(x, offset)
            w[blen - 1 - x] = get_ramp(x, offset)
    return w


def pad_halfpel(up, margin_y, margin_x):
    """Padded half-pel plane with the reference's per-sample clamp baked in:
    out[my + k, mx + l] == up[clip(k, 0, h2-2), clip(l, 0, w2-2)].
    (Row h2-1 / col w2-1 are never read by any fetch precision, so
    replacing them is exact.)"""
    h2, w2 = up.shape
    core = up.clone()
    core[h2 - 1, :] = core[h2 - 2, :]
    core[:, w2 - 1] = core[:, w2 - 2]
    return pad_edge(core, margin_y, margin_y, margin_x, margin_x)


def fetch_block(up, mv_precision, px0, py0, blen_y, blen_x):
    """Sample a (blen_y, blen_x) patch from the interleaved half-pel plane
    `up` at the sub-pel origin (px0, py0), in units of 1/2^prec pel
    (schro_upsampled_frame_get_pixel_precN): prec 0 nearest (clamp),
    prec 1 half-pel (clamp to 2w - 2), prec 2 and 3 bilinear between
    half-pel samples.  Returns int32."""
    dev = up.device
    ys = py0 + torch.arange(blen_y, device=dev) * (1 << mv_precision)
    xs = px0 + torch.arange(blen_x, device=dev) * (1 << mv_precision)
    return _fetch_pixels(up, mv_precision, xs[None, :], ys[:, None])


def _fetch_pixels(up, mv_precision, px, py):
    """Per-pixel sub-pel fetch from an interleaved half-pel plane: px, py
    are integer tensors of coordinates in units of 1/2^prec pel (any
    broadcastable shapes); one or four whole-plane gathers.  Returns
    int32."""
    h2, w2 = up.shape
    px = px.to(torch.int64)
    py = py.to(torch.int64)
    if mv_precision == 0:
        yy = py.clamp(0, h2 // 2 - 1)
        xx = px.clamp(0, w2 // 2 - 1)
        return up[2 * yy, 2 * xx].to(torch.int32)
    if mv_precision == 1:
        return up[py.clamp(0, h2 - 2), px.clamp(0, w2 - 2)].to(torch.int32)
    if mv_precision == 2:
        px = px << 1
        py = py << 1
    hy = py >> 2
    hx = px >> 2
    ry = (py & 3).to(torch.int32)
    rx = (px & 3).to(torch.int32)
    c_y0 = hy.clamp(0, h2 - 2)
    c_x0 = hx.clamp(0, w2 - 2)
    c_y1 = (hy + 1).clamp(0, h2 - 2)
    c_x1 = (hx + 1).clamp(0, w2 - 2)
    p00 = up[c_y0, c_x0].to(torch.int32)
    p01 = up[c_y0, c_x1].to(torch.int32)
    p10 = up[c_y1, c_x0].to(torch.int32)
    p11 = up[c_y1, c_x1].to(torch.int32)
    v = ((4 - ry) * (4 - rx) * p00 + (4 - ry) * rx * p01
         + ry * (4 - rx) * p10 + ry * rx * p11)
    return (v + 8) >> 4


def global_vectors(gm, xs, ys):
    """Per-pixel global (affine) motion vectors in 1/2^prec-pel units
    (schromotionref.c schro_motion_get_global_vector), in int32 with its
    wraparound: gm = (b0, b1, a_exp, a00, a01, a10, a11, c_exp, c0, c1),
    xs (w,), ys (h,) pixel coordinates.  Returns (dx, dy), each (h, w)
    int32."""
    b0, b1, a_exp, a00, a01, a10, a11, c_exp, c0, c1 = (int(v) for v in gm)
    x = xs[None, :].to(torch.int32)
    y = ys[:, None].to(torch.int32)
    scale = (1 << c_exp) - (c0 * x + c1 * y)
    dx = (scale * (a00 * x + a01 * y + (1 << a_exp) * b0)) >> (a_exp + c_exp)
    dy = (scale * (a10 * x + a11 * y + (1 << a_exp) * b1)) >> (a_exp + c_exp)
    return dx, dy


def render_component(mv_dx, mv_dy, mv_dx2, mv_dy2, pred_mode, dc,
                     up1, up2, xblen, yblen, xbsep, ybsep, mv_precision,
                     ref1_weight, ref2_weight, ref_weight_precision,
                     out_h, out_w, h_shift=0, v_shift=0,
                     using_global=None, gm1=None, gm2=None, row0=0):
    """One component's OBMC prediction by the per-pixel gather (int32,
    clamp(pred, 0, 255) - 128), for every geometry, vector size and
    global motion.

    Blocks split into 2x2 parity phases; in each phase every pixel is
    covered by at most one block, so its contribution is per-pixel index
    math and one (or four) gathers.  mv_*: (yb, xb) int32 per-block
    luma-scaled MVs (the chroma shift is applied here); pred_mode: (yb,
    xb); dc: (yb, xb) per-component DC values; up1/up2: interleaved
    half-pel reference planes ((2h, 2w) u8) or None; using_global with
    gm1/gm2 (GlobalMotion tuples):
    blocks flagged there take the per-pixel global vector.  row0: the
    global row of the first output row, for a renderer of a band of
    rows.  Fields (N, yb, xb) render N pictures and give (N, out_h,
    out_w)."""
    if pred_mode.ndim > 2:
        def row(t, i):
            return None if t is None else t[i]
        return torch.stack([render_component(
            mv_dx[i], mv_dy[i], mv_dx2[i], mv_dy2[i], pred_mode[i], dc[i],
            up1, up2, xblen, yblen, xbsep, ybsep, mv_precision,
            ref1_weight, ref2_weight, ref_weight_precision, out_h, out_w,
            h_shift, v_shift, row(using_global, i), gm1, gm2, row0)
            for i in range(pred_mode.shape[0])])
    yb, xb = pred_mode.shape
    dev = pred_mode.device
    xoffset = (xblen - xbsep) // 2
    yoffset = (yblen - ybsep) // 2
    full_w = xbsep * xb
    full_h = ybsep * yb

    dx1 = mv_dx >> h_shift if h_shift else mv_dx
    dy1 = mv_dy >> v_shift if v_shift else mv_dy
    dx2 = mv_dx2 >> h_shift if h_shift else mv_dx2
    dy2 = mv_dy2 >> v_shift if v_shift else mv_dy2

    # 1-D ramp profiles within a block + picture-edge overrides
    wx_prof = torch.as_tensor(_ramp_weights(xblen, xoffset), device=dev)
    wy_prof = torch.as_tensor(_ramp_weights(yblen, yoffset), device=dev)
    ys = row0 + torch.arange(out_h, dtype=torch.int32, device=dev)
    xs = torch.arange(out_w, dtype=torch.int32, device=dev)
    eight_y = torch.full((out_h,), 8, dtype=torch.int32, device=dev)
    eight_x = torch.full((out_w,), 8, dtype=torch.int32, device=dev)
    wsum = ref1_weight + ref2_weight
    half = (1 << ref_weight_precision) >> 1
    gv = [None, None]
    for k, gm in enumerate((gm1, gm2)):
        if using_global is not None and gm is not None:
            gdx, gdy = global_vectors(gm, xs, ys)
            gv[k] = (gdx >> h_shift if h_shift else gdx,
                     gdy >> v_shift if v_shift else gdy)

    def vectors(bdx, bdy, g, J, I):
        bdx, bdy = bdx[J, I], bdy[J, I]
        if g is not None:
            ug = using_global[J, I] != 0
            bdx = torch.where(ug, g[0], bdx)
            bdy = torch.where(ug, g[1], bdy)
        return ((xs[None, :] << mv_precision) + bdx,
                (ys[:, None] << mv_precision) + bdy)

    acc = torch.zeros((out_h, out_w), dtype=torch.int32, device=dev)
    for pj in range(2):
        for pi in range(2):
            # the phase block covering each pixel (parity pj / pi)
            jj = torch.div(ys + yoffset - pj * ybsep, 2 * ybsep,
                           rounding_mode="floor") * 2 + pj
            ii = torch.div(xs + xoffset - pi * xbsep, 2 * xbsep,
                           rounding_mode="floor") * 2 + pi
            ty = ys - (jj * ybsep - yoffset)       # offset within block
            tx = xs - (ii * xbsep - xoffset)
            vy = (ty >= 0) & (ty < yblen) & (jj >= 0) & (jj < yb)
            vx = (tx >= 0) & (tx < xblen) & (ii >= 0) & (ii < xb)
            jjc = jj.clamp(0, yb - 1).to(torch.int64)
            iic = ii.clamp(0, xb - 1).to(torch.int64)
            tyc = ty.clamp(0, yblen - 1).to(torch.int64)
            txc = tx.clamp(0, xblen - 1).to(torch.int64)

            # per-pixel weights with the picture-edge overrides
            if yoffset == 0:
                wy = eight_y
            else:
                wy = torch.where((ys < yoffset) | (ys >= full_h - yoffset),
                                 eight_y, wy_prof[tyc])
            if xoffset == 0:
                wx = eight_x
            else:
                wx = torch.where((xs < xoffset) | (xs >= full_w - xoffset),
                                 eight_x, wx_prof[txc])
            wgt = (wy * vy)[:, None] * (wx * vx)[None, :]

            J = jjc[:, None]
            I = iic[None, :]
            mode = pred_mode[J, I]
            v = (dc[J, I] + 128) * (mode == 0)
            if up1 is not None:
                px, py = vectors(dx1, dy1, gv[0], J, I)
                p1 = _fetch_pixels(up1, mv_precision, px, py)
                v = v + (((wsum * p1 + half) >> ref_weight_precision)
                         * (mode == 1))
            if up2 is not None:
                px, py = vectors(dx2, dy2, gv[1], J, I)
                p2 = _fetch_pixels(up2, mv_precision, px, py)
                v = v + (((wsum * p2 + half) >> ref_weight_precision)
                         * (mode == 2))
                if up1 is not None:
                    v = v + (((ref1_weight * p1 + ref2_weight * p2 + half)
                              >> ref_weight_precision) * (mode == 3))
            acc = acc + v * wgt
    pred = (acc + 32) >> 6
    return pred.clamp(0, 255) - 128


def _round8(n):
    return (n + 7) // 8 * 8


def extract_patches(P, oy, ox, ph, pw):
    """Batched clamped dynamic slice: (nb,) origins -> (nb, ph, pw).

    The origins are clamped into the plane as jax.lax.dynamic_slice
    clamps its start indices (a torch index would raise instead)."""
    Ph, Pw = P.shape
    oyc = oy.to(torch.int64).clamp(0, Ph - ph)
    oxc = ox.to(torch.int64).clamp(0, Pw - pw)
    rows = oyc[:, None] + torch.arange(ph, device=P.device)
    cols = oxc[:, None] + torch.arange(pw, device=P.device)
    return P[rows[:, :, None], cols[:, None, :]]


def _weight_rows(nblocks, blen, bsep, offset):
    """(nblocks, blen) per-block-row 1-D OBMC weights with the
    picture-edge overrides."""
    prof = _ramp_weights(blen, offset)
    W = np.tile(prof, (nblocks, 1)).astype(np.int32)
    if offset > 0:
        W[0, :2 * offset] = 8
        W[nblocks - 1, bsep:] = 8
    else:
        W[:] = 8
    return W


def _sample_blocks(up, dy8, dx8, yb, xb, yblen, xblen, ybsep, xbsep,
                   yoffset, xoffset, margin_y, margin_x):
    """Per-block sub-pel sample grids.

    dy8/dx8: (..., yb, xb) eighth-pel MVs (= mv << (3 - prec),
    chroma-shifted).  Returns (... * nb, yblen, xblen) int32 samples — the
    exact value schro_upsampled_frame_get_pixel_prec{0,1,3} would fetch per
    pixel."""
    dev = up.device
    P = pad_halfpel(up, margin_y, margin_x)
    oy = dy8 >> 2
    ox = dx8 >> 2
    ry = (dy8 & 3).reshape(-1, 1, 1)
    rx = (dx8 & 3).reshape(-1, 1, 1)
    ar_y = torch.arange(yb, dtype=torch.int32, device=dev)
    ar_x = torch.arange(xb, dtype=torch.int32, device=dev)
    base_y = (2 * (ar_y * ybsep - yoffset))[:, None] + margin_y
    base_x = (2 * (ar_x * xbsep - xoffset))[None, :] + margin_x
    ph = _round8(2 * yblen)
    pw = _round8(2 * xblen)
    pat = extract_patches(P, (base_y + oy).reshape(-1),
                          (base_x + ox).reshape(-1), ph, pw)
    q = pat.to(torch.int32)
    p00 = q[:, 0:2 * yblen:2, 0:2 * xblen:2]
    p01 = q[:, 0:2 * yblen:2, 1:2 * xblen:2]
    p10 = q[:, 1:2 * yblen:2, 0:2 * xblen:2]
    p11 = q[:, 1:2 * yblen:2, 1:2 * xblen:2]
    v = ((4 - ry) * (4 - rx) * p00 + (4 - ry) * rx * p01
         + ry * (4 - rx) * p10 + ry * rx * p11)
    return (v + 8) >> 4


def recompose_phases(contrib, yb, xb, yblen, xblen, ybsep, xbsep,
                     yoffset, xoffset, out_h, out_w):
    """Dense OBMC accumulate: (..., yb, xb, yblen, xblen) weighted block
    contributions -> (..., out_h, out_w) sum.  Blocks split into 2x2
    parity phases; within a phase the (padded) blocks tile a canvas
    disjointly, so placement is pad/transpose/reshape — no scatter."""
    assert yblen <= 2 * ybsep and xblen <= 2 * xbsep
    lead = tuple(contrib.shape[:-4])
    ybe = yb + (yb & 1)
    xbe = xb + (xb & 1)
    c = torch.zeros(lead + (ybe, xbe, 2 * ybsep, 2 * xbsep),
                    dtype=contrib.dtype, device=contrib.device)
    c[..., :yb, :xb, :yblen, :xblen] = contrib
    acc = torch.zeros(lead + (out_h, out_w), dtype=torch.int32,
                      device=contrib.device)
    for pj in range(2):
        for pi in range(2):
            sub = c[..., pj::2, pi::2, :, :]
            A, B = sub.shape[-4], sub.shape[-3]
            canvas = sub.transpose(-3, -2).reshape(
                lead + (A * 2 * ybsep, B * 2 * xbsep))
            oy = pj * ybsep - yoffset
            ox = pi * xbsep - xoffset
            sy, cy = max(0, oy), max(0, -oy)
            sx, cx = max(0, ox), max(0, -ox)
            hh = min(out_h - sy, canvas.shape[-2] - cy)
            ww = min(out_w - sx, canvas.shape[-1] - cx)
            if hh <= 0 or ww <= 0:
                continue
            acc[..., sy:sy + hh, sx:sx + ww] += canvas[..., cy:cy + hh,
                                                       cx:cx + ww]
    return acc


def render_component_patches(mv_dx, mv_dy, mv_dx2, mv_dy2, pred_mode, dc,
                             up1, up2, xblen, yblen, xbsep, ybsep,
                             mv_precision, ref1_weight, ref2_weight,
                             ref_weight_precision, out_h, out_w,
                             h_shift=0, v_shift=0):
    """One component's OBMC prediction (int32, clamp(pred, 0, 255) - 128).

    mv_*: (yb, xb) int32 per-block luma-scaled MVs (chroma shift applied
    here); pred_mode: (yb, xb); dc: (yb, xb) per-component dc values;
    up1/up2: interleaved half-pel reference planes ((2h, 2w) u8) or None.
    Fields (N, yb, xb) render N pictures from the same references and give
    (N, out_h, out_w)."""
    yb, xb = pred_mode.shape[-2:]
    lead = tuple(pred_mode.shape[:-2])
    dev = pred_mode.device
    xoffset = (xblen - xbsep) // 2
    yoffset = (yblen - ybsep) // 2
    sh = 3 - mv_precision

    def to8(d, shift):
        d = d >> shift if shift else d
        return d << sh

    # margins: worst |mv| in half-pel + block reach + patch size
    margin_y = (MV_BOUND_PEL * 2 + 8) + 2 * yoffset + _round8(2 * yblen)
    margin_x = (MV_BOUND_PEL * 2 + 8) + 2 * xoffset + _round8(2 * xblen)

    mode = pred_mode.reshape(-1, 1, 1)
    wsum = ref1_weight + ref2_weight
    half = (1 << ref_weight_precision) >> 1

    val = (dc.reshape(-1, 1, 1) + 128) * (mode == 0)
    if up1 is not None:
        v1 = _sample_blocks(up1, to8(mv_dy, v_shift), to8(mv_dx, h_shift),
                            yb, xb, yblen, xblen, ybsep, xbsep,
                            yoffset, xoffset, margin_y, margin_x)
        val = val + (((wsum * v1 + half) >> ref_weight_precision)
                     * (mode == 1))
    if up2 is not None:
        v2 = _sample_blocks(up2, to8(mv_dy2, v_shift), to8(mv_dx2, h_shift),
                            yb, xb, yblen, xblen, ybsep, xbsep,
                            yoffset, xoffset, margin_y, margin_x)
        val = val + (((wsum * v2 + half) >> ref_weight_precision)
                     * (mode == 2))
        if up1 is not None:
            val = val + (((ref1_weight * v1 + ref2_weight * v2 + half)
                          >> ref_weight_precision) * (mode == 3))

    wy = torch.as_tensor(_weight_rows(yb, yblen, ybsep, yoffset), device=dev)
    wx = torch.as_tensor(_weight_rows(xb, xblen, xbsep, xoffset), device=dev)
    contrib = (val.reshape(lead + (yb, xb, yblen, xblen))
               * wy[:, None, :, None] * wx[None, :, None, :])
    acc = recompose_phases(contrib.to(torch.int32), yb, xb, yblen, xblen,
                           ybsep, xbsep, yoffset, xoffset, out_h, out_w)
    pred = (acc + 32) >> 6
    return pred.clamp(0, 255) - 128


def make_render_body(p, num_refs: int, use_patches=None):
    """Whole-picture render: body(mv, up1, up2) -> (pred_y, pred_u, pred_v)
    int32 tensors.  mv: dict of (yb, xb) int32 tensors, or (N, yb, xb) for
    N pictures that share their references (with `using_global` where the
    picture has global motion); up1/up2: tuples of the three interleaved
    half-pel planes (up2 None for one reference).

    use_patches: None takes the patch render unless the picture has
    global motion or blen > 2 bsep, which the gather render takes; False
    forces the gather render (a decoder's choice for vectors beyond
    MV_BOUND_PEL)."""
    if use_patches is None:
        use_patches = (not p.have_global_motion
                       and p.yblen_luma <= 2 * p.ybsep_luma
                       and p.xblen_luma <= 2 * p.xbsep_luma)
    have_gm = p.have_global_motion
    gms = [(g.b0, g.b1, g.a_exp, g.a00, g.a01, g.a10, g.a11, g.c_exp, g.c0,
            g.c1) for g in p.global_motion[:num_refs]] if have_gm else []
    gm1 = gms[0] if gms else None
    gm2 = gms[1] if len(gms) > 1 else None
    vf = p.video_format
    h_shift = vf.chroma_format.h_shift
    v_shift = vf.chroma_format.v_shift
    pic_sizes = [vf.picture_luma_size(), vf.picture_chroma_size(),
                 vf.picture_chroma_size()]
    geo = [(p.xblen_luma, p.yblen_luma, p.xbsep_luma, p.ybsep_luma, 0, 0)]
    for _ in range(2):
        geo.append((p.xblen_luma >> h_shift, p.yblen_luma >> v_shift,
                    p.xbsep_luma >> h_shift, p.ybsep_luma >> v_shift,
                    h_shift, v_shift))

    def render(mv, up1, up2):
        preds = []
        for k in range(3):
            xblen, yblen, xbsep, ybsep, hs, vs = geo[k]
            (w_pic, h_pic) = pic_sizes[k]
            dc = (mv["dc0"], mv["dc1"], mv["dc2"])[k]
            if use_patches:
                preds.append(render_component_patches(
                    mv["dx1"], mv["dy1"], mv["dx2"], mv["dy2"],
                    mv["pred_mode"], dc,
                    up1[k], up2[k] if up2 is not None else None,
                    xblen, yblen, xbsep, ybsep, p.mv_precision,
                    p.picture_weight_1, p.picture_weight_2,
                    p.picture_weight_bits, h_pic, w_pic, hs, vs))
                continue
            preds.append(render_component(
                mv["dx1"], mv["dy1"], mv["dx2"], mv["dy2"],
                mv["pred_mode"], dc,
                up1[k], up2[k] if up2 is not None else None,
                xblen, yblen, xbsep, ybsep, p.mv_precision,
                p.picture_weight_1, p.picture_weight_2,
                p.picture_weight_bits, h_pic, w_pic, hs, vs,
                using_global=mv.get("using_global") if have_gm else None,
                gm1=gm1, gm2=gm2))
        return tuple(preds)

    return render
