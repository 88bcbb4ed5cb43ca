"""Decoder telemetry overlay: draw the decoded motion field onto output.

Analog of the reference's SCHRO_TELEMETRY overlay (schrodecoder.c:107
schro_decoder_x_combine -> schro_motion_render_overlay): when enabled,
each inter picture's luma gets the superblock/block grid (brightness
encodes the split level), an MV needle per block, and intra-DC blocks
marked with a cross.  Drawing happens on a copy of the output plane only;
reference frames stay pristine (strictly safer than the reference, which
draws on the frame before it is kept as a ref).

Enable via StreamDecoder(telemetry=True) or SCHRO_TPU_TELEMETRY=1.

Whole copy of `schroedinger_tpu/decoder/overlay.py` (host numpy): the port
imports nothing of the JAX package.
"""
from __future__ import annotations

import numpy as np

_GRID_SB = 235   # superblock boundary brightness
_GRID_BLK = 180  # block boundary (split>0)
_NEEDLE = 16     # MV needle (dark)
_CROSS = 255     # intra cross


def _draw_line(y, r0, c0, r1, c1, value):
    """Integer line segment by dense sampling (debug path, host numpy)."""
    h, w = y.shape
    n = int(max(abs(r1 - r0), abs(c1 - c0), 1)) + 1
    rr = np.rint(np.linspace(r0, r1, n)).astype(np.int64)
    cc = np.rint(np.linspace(c0, c1, n)).astype(np.int64)
    keep = (rr >= 0) & (rr < h) & (cc >= 0) & (cc < w)
    y[rr[keep], cc[keep]] = value


def overlay_motion(y_plane: np.ndarray, mv: dict, p) -> np.ndarray:
    """Return a copy of y_plane with the motion telemetry drawn in.

    mv: block-granularity dict from motion_decode (split, pred_mode,
    dx1/dy1 in subpel units of 1 << p.mv_precision).
    """
    y = np.array(y_plane, dtype=np.uint8, copy=True)
    h, w = y.shape
    xsep, ysep = p.xbsep_luma, p.ybsep_luma
    yb, xb = mv["pred_mode"].shape
    split = mv.get("split")
    prec = p.mv_precision

    # grid: superblock boundaries always; block boundaries where the
    # superblock is split (split level > 0)
    for bj in range(yb):
        r = bj * ysep
        if r >= h:
            break
        row_is_sb = (bj % 4 == 0)
        for bi in range(xb):
            c0 = bi * xsep
            if c0 >= w:
                break
            c1 = min(c0 + xsep, w)
            sb_split = int(split[(bj // 4) * 4, (bi // 4) * 4]) \
                if split is not None else 2
            if row_is_sb:
                y[r, c0:c1] = _GRID_SB
            elif sb_split > 0:
                y[r, c0:c1] = _GRID_BLK
    for bi in range(xb):
        c = bi * xsep
        if c >= w:
            break
        col_is_sb = (bi % 4 == 0)
        for bj in range(yb):
            r0 = bj * ysep
            if r0 >= h:
                break
            r1 = min(r0 + ysep, h)
            sb_split = int(split[(bj // 4) * 4, (bi // 4) * 4]) \
                if split is not None else 2
            if col_is_sb:
                y[r0:r1, c] = _GRID_SB
            elif sb_split > 0:
                y[r0:r1, c] = _GRID_BLK

    # per-block needles / intra crosses
    dx = mv["dx1"].astype(np.float64) / (1 << prec)
    dy = mv["dy1"].astype(np.float64) / (1 << prec)
    mode = mv["pred_mode"]
    for bj in range(yb):
        rc = bj * ysep + ysep // 2
        if rc >= h:
            break
        for bi in range(xb):
            cc = bi * xsep + xsep // 2
            if cc >= w:
                break
            if mode[bj, bi] == 0:       # intra DC block: small cross
                _draw_line(y, rc - 2, cc, rc + 2, cc, _CROSS)
                _draw_line(y, rc, cc - 2, rc, cc + 2, _CROSS)
            else:                        # MV needle from block centre
                _draw_line(y, rc, cc, rc + dy[bj, bi], cc + dx[bj, bi],
                           _NEEDLE)
                y[rc, cc] = _CROSS       # anchor dot
    return y
