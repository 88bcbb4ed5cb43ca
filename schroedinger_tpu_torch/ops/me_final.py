"""The ME pass's final stage: the candidate competition and the subpel
refine, after the pyramid's last full-pel search.

`me_final` is the entry point.  On CUDA tensors it launches the
hand-written kernel `csrc/me_final.cu` (kernel #4, built and bound by
`ops/cuda_build.py`), once for the whole stage and the whole batch.  On
CPU tensors it runs `me_final_plain`, the plain PyTorch version, which is
the ME's own code for this stage (`encoder/me.py` builds on its pieces):

  competition  per ME block, the pyramid's vector against the 3x3
               edge-clamped median of the vector field and (with
               `zero_cand`) the zero vector, each of the last two scored
               by its full-pel SAD (me_search's radius-0 read, window
               clamp included) less the reference's zero/predicted bias
               ybsep * xbsep // 16; the first minimum in the order
               hierarchy, median, zero wins
  subpel       at each precision level 1..prec, the winner doubled and
               the nine offsets (dy, dx) in -1..1 scored against the
               bilinear half-pel fetch of the renderer (SUBPEL_LVL); the
               first minimum in (dy, dx) order wins

A CUDA tensor never takes the plain path: the wrapper launches or raises.
`compete=False` runs the subpel levels alone (the ME's competition with
injected or chroma candidates stays in PyTorch); `prec=0` the competition
alone.  The counter `me_final_launches` (`utils.telemetry.counters`)
counts the kernel's launches and nothing else.
"""
from __future__ import annotations

import torch

from schroedinger_tpu_torch.ops import cuda_build
from schroedinger_tpu_torch.ops.obmc import (_round8, extract_patches,
                                             pad_halfpel)
from schroedinger_tpu_torch.ops.patch_refine import me_search_plain, to_blocks
from schroedinger_tpu_torch.utils.telemetry import counters

# per-level static candidate tables of the subpel refine: offset d in
# -1..1 -> (half-pel delta, quarter fraction) at levels 1, 2; at level 3
# two variants switched on the quarter parity of the incoming mv (the
# JAX package's encoder/me.py holds the same tables)
SUBPEL_LVL = {
    1: {-1: (0, 0), 0: (1, 0), 1: (2, 0)},
    2: {-1: (0, 2), 0: (1, 0), 1: (1, 2)},
    3: {-1: ((0, 3), (1, 1)), 0: ((1, 0), (1, 2)), 1: ((1, 1), (1, 3))},
}
_OFFS = [(dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]


def median3x3_field(f):
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


def final_candidates(c, r, mv, sad, bs_y, bs_x, zero_cand, bound, margin,
                     search):
    """The final level's own candidates: the hierarchy's mv (N, nby, nbx,
    2), the median field and (zero_cand) the zero vector, with their SADs
    from `search` (me_search or me_search_plain) and their biases.
    Returns the lists (mvs, sads, biases)."""
    med = torch.stack([median3x3_field(mv[..., 0]),
                       median3x3_field(mv[..., 1])], dim=-1)
    _, sad_med = search(c, r, med.contiguous(), 1, bs_y, bs_x, 0, bound,
                        margin)
    # the reference biases toward zero/predicted ("gravity",
    # schrometric.c:122)
    bias = bs_y * bs_x // 16
    mvs, sads, biases = [mv, med], [sad, sad_med], [0, bias]
    if zero_cand:
        _, sad_zero = search(c, r, None, 0, bs_y, bs_x, 0, bound, margin)
        mvs.append(torch.zeros_like(mv))
        sads.append(sad_zero)
        biases.append(bias)
    return mvs, sads, biases


def pick(mvs, sads, sel, biases):
    """The first minimum of sel - bias over the candidates (torch.argmin's
    first index): its mv (N, nby, nbx, 2) and its SAD from `sads`."""
    dev = mvs[0].device
    biased = torch.stack(sel) - torch.as_tensor(
        biases, dtype=torch.int32, device=dev)[:, None, None, None]
    best = torch.argmin(biased, dim=0)                # (N, nby, nbx)
    mv = torch.gather(torch.stack(mvs), 0, best[None, ..., None].expand(
        1, *best.shape, 2))[0]
    sad = torch.gather(torch.stack(sads), 0, best[None])[0]
    return mv, sad


def subpel_margin(bs_y, bs_x, bound):
    """The margin of the padded half-pel plane the plain refine reads its
    patches from: room for every vector within +-bound."""
    return 2 * bound + max(_round8(2 * bs_y + 4), _round8(2 * bs_x + 4)) + 16


def _bilerp(pat, dy_off, dx_off, ry, rx, bs_y, bs_x):
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


def subpel_plain(c, up, mv_y, mv_x, bs_y, bs_x, prec, bound):
    """The subpel refine of full-pel vectors (mv_y, mv_x) (N, nby, nbx)
    to 1/2^prec pel against the half-pel plane `up` (2h, 2w) on per-block
    patches of its padded copy (schromotionest.c:133-246 analog); c: the
    current planes (N, nby * bs_y, nbx * bs_x) u8.  Returns (mv_y, mv_x,
    sad)."""
    dev = c.device
    nby, nbx = mv_y.shape[-2:]
    cb = to_blocks(c.to(torch.int32), nby, bs_y, nbx, bs_x)
    margin = subpel_margin(bs_y, bs_x, bound)
    ph, pw = _round8(2 * bs_y + 4), _round8(2 * bs_x + 4)
    P = pad_halfpel(up, margin, margin)
    mv_y = mv_y.clamp(-bound, bound)
    mv_x = mv_x.clamp(-bound, bound)
    best_sad = None
    for level in range(1, prec + 1):
        mv_y = mv_y * 2
        mv_x = mv_x * 2
        sh = 3 - level
        # base half-pel origin per block (mv even -> exact)
        oy0 = ((mv_y << sh) >> 2) - 1
        ox0 = ((mv_x << sh) >> 2) - 1
        ar_y = torch.arange(nby, dtype=torch.int32, device=dev)
        ar_x = torch.arange(nbx, dtype=torch.int32, device=dev)
        by = (2 * ar_y * bs_y)[:, None] + oy0 + margin
        bx = (2 * ar_x * bs_x)[None, :] + ox0 + margin
        pat = extract_patches(P, by.reshape(-1), bx.reshape(-1),
                              ph, pw).to(torch.int32)

        if level < 3:
            tab = SUBPEL_LVL[level]

            def sample(dy_c, dx_c):
                ofy, ry = tab[dy_c]
                ofx, rx = tab[dx_c]
                return _bilerp(pat, ofy, ofx, ry, rx, bs_y, bs_x)
        else:
            tab = SUBPEL_LVL[3]
            py2 = ((mv_y & 3) == 2).reshape(-1)[:, None, None]
            px2 = ((mv_x & 3) == 2).reshape(-1)[:, None, None]

            def sample(dy_c, dx_c):
                (oy0a, ry0), (oy2a, ry2) = tab[dy_c]
                (ox0a, rx0), (ox2a, rx2) = tab[dx_c]
                v00 = _bilerp(pat, oy0a, ox0a, ry0, rx0, bs_y, bs_x)
                v02 = _bilerp(pat, oy0a, ox2a, ry0, rx2, bs_y, bs_x)
                v20 = _bilerp(pat, oy2a, ox0a, ry2, rx0, bs_y, bs_x)
                v22 = _bilerp(pat, oy2a, ox2a, ry2, rx2, bs_y, bs_x)
                v0 = torch.where(px2, v02, v00)
                v2 = torch.where(px2, v22, v20)
                return torch.where(py2, v2, v0)

        s = torch.stack([(cb - sample(*o)).abs().sum(
            (1, 2), dtype=torch.int32) for o in _OFFS])
        best = torch.argmin(s, dim=0)
        off_t = torch.as_tensor(_OFFS, dtype=torch.int32, device=dev)
        mv_y = mv_y + off_t[best, 0].reshape(mv_y.shape)
        mv_x = mv_x + off_t[best, 1].reshape(mv_x.shape)
        best_sad = torch.gather(s, 0, best[None])[0].reshape(mv_y.shape)
    return mv_y, mv_x, best_sad


def me_final_plain(c, r, up, mv, sad, bs_y, bs_x, prec, compete, zero_cand,
                   bound, margin):
    """me_final in plain PyTorch (any device): the competition
    (`final_candidates` with me_search_plain, `pick`) where `compete`,
    then `subpel_plain` where prec > 0.  Returns (dy, dx, sad), each (N,
    nby, nbx) int32."""
    if compete:
        mvs, sads, biases = final_candidates(c, r, mv, sad, bs_y, bs_x,
                                             zero_cand, bound, margin,
                                             me_search_plain)
        mv, sad = pick(mvs, sads, sads, biases)
    if prec == 0:
        return mv[..., 0], mv[..., 1], sad
    return subpel_plain(c, up, mv[..., 0], mv[..., 1], bs_y, bs_x, prec,
                        bound)


def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"me_final: {name} on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"me_final: {name} is {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"me_final: {name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"me_final: {name} is not contiguous")
    if t.data_ptr() % t.element_size():
        raise ValueError(f"me_final: {name} is not aligned to its elements")


# the largest block the kernel's shared-memory windows take
MAX_BSEP = 32


def _launch(c, r, up, mv, sad, bs_y, bs_x, prec, compete, zero_cand, bound,
            margin):
    """Check the arguments and launch the kernel on the batch c (N, h,
    w).  Returns (dy, dx, sad), views of one buffer."""
    dev = c.device
    if dev.type != "cuda":
        raise ValueError(f"me_final: tensors on {dev}, expected cuda")
    if c.ndim != 3:
        raise ValueError(f"me_final: c must be (N, h, w), got "
                         f"{tuple(c.shape)}")
    n, h, w = c.shape
    if not (1 <= bs_y <= MAX_BSEP and 1 <= bs_x <= MAX_BSEP):
        raise ValueError(f"me_final: block {bs_y}x{bs_x} outside "
                         f"1..{MAX_BSEP}")
    if h % bs_y or w % bs_x or h == 0 or w == 0 or n == 0 or n > 65535:
        raise ValueError(f"me_final: {n} planes {h}x{w} are not a whole grid "
                         f"of {bs_y}x{bs_x} blocks")
    if prec not in (0, 1, 2, 3) or (prec == 0 and not compete):
        raise ValueError(f"me_final: precision {prec}, compete {compete}: "
                         "nothing to do or an unknown precision")
    if bound < 0 or margin < 0:
        raise ValueError(f"me_final: bound {bound}, margin {margin}")
    nby, nbx = h // bs_y, w // bs_x
    _check("c", c, torch.uint8, (n, h, w), dev)
    _check("mv", mv, torch.int32, (n, nby, nbx, 2), dev)
    h2 = w2 = 0
    if compete:
        _check("r", r, torch.uint8, (h, w), dev)
        _check("sad", sad, torch.int32, (n, nby, nbx), dev)
        if h + 2 * margin < _round8(bs_y) or w + 2 * margin < _round8(bs_x):
            raise ValueError("me_final: padded plane smaller than a block")
    if prec:
        if up.ndim != 2 or min(up.shape) < 2:
            raise ValueError(f"me_final: up must be (2h, 2w), got "
                             f"{tuple(up.shape)}")
        h2, w2 = up.shape
        _check("up", up, torch.uint8, (h2, w2), dev)
    nb = nby * nbx
    out = torch.empty(3 * n * nb, dtype=torch.int32, device=dev)
    err = cuda_build.load().me_final_launch(
        n, c.data_ptr(), r.data_ptr() if compete else None,
        up.data_ptr() if prec else None, mv.data_ptr(),
        sad.data_ptr() if compete else None, out.data_ptr(), nby, nbx,
        bs_y, bs_x, h2, w2, prec, int(bool(compete)), int(bool(zero_cand)),
        bound, margin, subpel_margin(bs_y, bs_x, bound),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"me_final kernel launch failed: error {err}")
    out = out.view(3, n, nby, nbx)
    return out[0], out[1], out[2]


def me_final(c, r, up, mv, sad, bs_y, bs_x, prec, compete, zero_cand, bound,
             margin):
    """The ME pass's final stage (see the module's head) on the current
    planes c (N, nby * bs_y, nbx * bs_x) u8 and the reference r (nby *
    bs_y, nbx * bs_x) u8 of the pyramid's level 0, the reference's
    half-pel plane up (2h, 2w) u8 (read where prec > 0), and the
    pyramid's mv (N, nby, nbx, 2) and sad (N, nby, nbx) int32 (mv
    clamped to +-bound; r and sad are read where `compete`).  margin is
    the pyramid's: the median and zero SADs read r as me_search does at
    radius 0.  Returns (dy, dx, sad), each (N, nby, nbx) int32, dy and dx
    in 1/2^prec pel.

    CUDA tensors launch the kernel once (no plain fallback); CPU tensors
    run me_final_plain."""
    if c.device.type == "cuda":
        outs = _launch(c, r, up, mv, sad, bs_y, bs_x, prec, compete,
                       zero_cand, bound, margin)
        counters.add("me_final_launches")
        return outs
    if c.device.type != "cpu":
        raise ValueError(f"me_final: unsupported device {c.device}")
    return me_final_plain(c, r, up, mv, sad, bs_y, bs_x, prec, compete,
                          zero_cand, bound, margin)


def launches() -> int:
    """me_final's kernel launches so far in this process (the counter
    `me_final_launches`)."""
    return counters.snapshot().get("me_final_launches", 0)
