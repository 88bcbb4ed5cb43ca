"""Rank functions of the port's multi-device tests: each runs on every
rank of a world that `parallel.group.run_world` starts, and returns this
rank's pieces as numpy arrays for the test to assemble.  The module
imports no JAX, so the ranks start on PyTorch alone."""
import torch

from schroedinger_tpu_torch.graft_entry import inter_params
from schroedinger_tpu_torch.parallel import tiles
from schroedinger_tpu_torch.wavelets import Wavelet


def _np(t):
    return t.cpu().numpy()


def tiles_rank(rank, world, dev, x, depth, plane, mv, ups, pic):
    """This rank's rows of: every wavelet's sharded forward of x at
    `depth` and the sharded inverse of it, the sharded upsample of
    `plane`, the banded two-reference render of pic = (W, H, blen, bsep)
    with fields `mv` and half-pel references `ups`; and the ValueErrors
    of a tile shorter than Fidelity's halo and of a render whose height
    does not split over the ranks."""
    xt = tiles.shard_rows(torch.from_numpy(x).to(dev), rank, world)
    out = {"forward": {}, "inverse": {}}
    for wavelet in Wavelet:
        pyr = tiles.sharded_forward(xt, depth, wavelet)
        out["forward"][wavelet] = {
            "ll": _np(pyr["ll"]),
            "levels": [{k: _np(v) for k, v in lev.items()}
                       for lev in pyr["levels"]]}
        out["inverse"][wavelet] = _np(tiles.sharded_inverse(pyr, wavelet))
    pt = tiles.shard_rows(torch.from_numpy(plane).to(dev), rank, world)
    out["upsample"] = _np(tiles.sharded_upsample(pt))
    mvt = {k: torch.from_numpy(v).to(dev) for k, v in mv.items()}
    upt = [torch.from_numpy(u).to(dev) for u in ups]
    out["render"] = _np(tiles.sharded_render(mvt, *upt, inter_params(*pic),
                                             2))
    try:
        tiles.sharded_forward(xt[:2 * (1 << depth)], depth, Wavelet.FIDELITY)
    except ValueError as e:
        out["short"] = str(e)
    W, H, blen, bsep = pic
    try:
        tiles.sharded_render(mvt, *upt, inter_params(W, H + 2, blen, bsep),
                             2)
    except ValueError as e:
        out["uneven"] = str(e)
    return out
