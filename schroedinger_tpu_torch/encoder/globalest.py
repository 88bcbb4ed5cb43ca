"""Global (affine) motion estimation from a block MV field (port of
`schroedinger_tpu/encoder/globalest.py`).

The reference's schro_encoder_global_estimation (schroglobalest.c:65-221)
iterates scalar accumulation loops with outlier rejection over 4 rounds
(and is disabled as broken, schroencoder.c:649-650).  Here each round is
one weighted least-squares solve in float32 -- design matrix [1, x, y]
against each MV component -- with the same residual-variance outlier gate
(r^2 < 16 var).  As in the JAX package nothing in the encoder calls it:
`enable_global_motion` is read nowhere.

The Dirac parameters follow the renderer's fixed-point model
(`ops/obmc.global_vectors`, schromotionref.c
schro_motion_get_global_vector):

    v_prec(x, y) = (a . p + (1 << a_exp) * b) >> a_exp      (c == 0)

with v in 1/2^prec-pel units, so a = rint(M * 2^a_exp) for a fitted
affine M in those units per pel, and b = rint(pan + 0.5).
"""
from __future__ import annotations

import numpy as np
import torch

from schroedinger_tpu_torch.params import GlobalMotion, Params

A_EXP = 16


def fit_affine_mv_field(dy, dx, xs, ys, n_rounds: int = 4):
    """Least-squares fit of (dx, dy) ~ b + M (x, y) with outlier rejection,
    in float32 on the host.

    dy, dx: (N,) MV components (any consistent unit); xs, ys: (N,) block
    centre coordinates in pixels.  Returns (b0, b1, m00, m01, m10, m11,
    inlier_mask) in the units of dx/dy (per pixel for M)."""
    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32).ravel())

    dy, dx, xs, ys = f32(dy), f32(dx), f32(xs), f32(ys)
    n = dx.shape[0]
    A = torch.stack([torch.ones(n), xs, ys], dim=1)
    w = torch.ones(n)
    sol_x = sol_y = None
    for _ in range(n_rounds):
        Aw = A * w[:, None]
        # weighted normal equations (3x3 solve of the masked rows)
        G = Aw.T @ A
        sol_x = torch.linalg.solve(G, Aw.T @ dx)
        sol_y = torch.linalg.solve(G, Aw.T @ dy)
        rx = dx - A @ sol_x
        ry = dy - A @ sol_y
        r2 = rx * rx + ry * ry
        var = torch.clamp((r2 * w).sum() / torch.clamp(w.sum(), min=1.0),
                          min=1.0)
        w = (r2 < 16.0 * var).to(torch.float32)
    b0, m00, m01 = (float(sol_x[0]), float(sol_x[1]), float(sol_x[2]))
    b1, m10, m11 = (float(sol_y[0]), float(sol_y[1]), float(sol_y[2]))
    return b0, b1, m00, m01, m10, m11, w.numpy() > 0


def estimate_global_motion(mv_fields, p: Params, ref: int = 1) -> GlobalMotion:
    """A GlobalMotion fitted to an MV field dict (dy1/dx1 or dy2/dx2 in
    1/2^prec-pel units on the (ynb, xnb) block grid, and pred_mode).  Only
    the MC blocks predicting from `ref` take part; a degenerate field
    (fewer than 8 such blocks, or fewer than 3 inliers or a non-finite
    fit) gives the identity."""
    xnb, ynb = p.x_num_blocks, p.y_num_blocks
    sfx = str(ref)
    dxf = np.asarray(mv_fields["dx" + sfx], np.float32)
    dyf = np.asarray(mv_fields["dy" + sfx], np.float32)
    mode = np.asarray(mv_fields["pred_mode"], np.int32)
    use = (mode & ref) != 0
    ii, jj = np.meshgrid(np.arange(xnb), np.arange(ynb))
    xs = (ii * p.xbsep_luma + p.xbsep_luma // 2).astype(np.float32)
    ys = (jj * p.ybsep_luma + p.ybsep_luma // 2).astype(np.float32)
    if use.sum() < 8:
        return GlobalMotion()
    b0, b1, m00, m01, m10, m11, inliers = fit_affine_mv_field(
        dyf[use], dxf[use], xs[use], ys[use])
    sol = (b0, b1, m00, m01, m10, m11)
    if inliers.sum() < 3 or not all(np.isfinite(v) for v in sol):
        return GlobalMotion()
    gm = GlobalMotion()
    # +0.5 turns the renderer's floor shift (>> a_exp) into rounding to
    # nearest
    gm.b0 = int(np.rint(b0 + 0.5))
    gm.b1 = int(np.rint(b1 + 0.5))
    gm.a_exp = A_EXP
    gm.a00 = int(np.rint(m00 * (1 << A_EXP)))
    gm.a01 = int(np.rint(m01 * (1 << A_EXP)))
    gm.a10 = int(np.rint(m10 * (1 << A_EXP)))
    gm.a11 = int(np.rint(m11 * (1 << A_EXP)))
    gm.c_exp = 0
    gm.c0 = 0
    gm.c1 = 0
    return gm
