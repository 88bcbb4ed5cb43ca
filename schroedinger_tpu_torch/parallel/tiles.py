"""Tile sharding within a frame: the wavelet transforms, the half-pel
upsample and the OBMC render with the frame's rows split over the ranks
of a world (`parallel/group.py`).

Port of `schroedinger_tpu/parallel/tiles.py`.  Each rank holds a band of
rows of the frame (`shard_rows`).  Horizontal lifting is local (rows are
whole); a vertical lifting step reads rows past its tile's edge, which
come from the neighbouring ranks, so the sharded transform is
bit-identical to the unsharded one: a tap x[clamp(i + off)] on the whole
array becomes the tile's rows plus its neighbours' edge rows, clamped at
the whole frame's first and last row.

Where the JAX package composes single-row `ppermute` shifts (up to four
collectives per tap), a step here exchanges once, on the first tap of
each lifting input, every row any step of the wavelet reads past an edge
(`halo_rows`: 4 above and 4 below for Fidelity), and the step's taps
then slice the extended tile.  That is exact while each half-tile holds
at least the halo; a shorter tile raises ValueError with the height it
needs (the sharded forms never gather the frame).  The upsample's 8-tap
vertical filter takes a 3-row / 4-row halo; the OBMC render reads
replicated references and renders each rank's band of output rows.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from schroedinger_tpu_torch.ops import obmc
from schroedinger_tpu_torch.ops import wavelet as wv
from schroedinger_tpu_torch.parallel import group
from schroedinger_tpu_torch.wavelets import HAS_SHIFT, Wavelet


def shard_rows(x, rank: int, world: int):
    """Rank `rank`'s band of rows (axis -2) of x, split evenly."""
    h = x.shape[-2]
    if h % world:
        raise ValueError(f"{h} rows do not split evenly over {world} ranks")
    band = h // world
    return x[..., rank * band:(rank + 1) * band, :]


def halo_rows(wavelet: Wavelet):
    """(above, below): the most rows any lifting step of `wavelet` reads
    above and below a row of its input, found by running the steps with a
    tap that records its offsets."""
    offs = [0]

    def record(x, off, axis):
        offs.append(off)
        return wv._shift_edge(x, off, axis)

    z = torch.zeros((8, 1), dtype=torch.int32)
    wv._lift_fwd(z, z, Wavelet(wavelet), -2, tap=record)
    return -min(offs), max(offs)


class _HaloTap:
    """wv._shift_edge over the whole row-sharded array, for the taps of one
    lifting step: the first tap of each input tensor exchanges `above` /
    `below` rows with the neighbours; its other taps slice that."""

    def __init__(self, above: int, below: int):
        self.above, self.below = above, below
        self._x = self._ext = None

    def __call__(self, x, off: int, axis: int):
        if off == 0:
            return x
        if axis % x.ndim != x.ndim - 2:
            return wv._shift_edge(x, off, axis)
        if x is not self._x:
            head, tail = group.exchange_rows(x, self.above, self.below)
            self._x, self._ext = x, torch.cat([head, x, tail], -2)
        return self._ext.narrow(-2, self.above + off, x.shape[-2])


def _check_tile(h: int, depth: int, wavelet: Wavelet) -> None:
    """Raise unless a tile of h rows stays whole down `depth` levels with
    every half-tile at least the wavelet's halo."""
    need = max(halo_rows(wavelet))
    least = max(need, 1) * 2 << (depth - 1)
    if dist.get_world_size() > 1 and (h < least or h % (1 << depth)):
        raise ValueError(
            f"{Wavelet(wavelet).name} reads {need} rows past a tile's edge:"
            f" at depth {depth} each rank's tile needs a multiple of "
            f"{1 << depth} rows, at least {least}, and has {h}; the frame "
            f"needs at least {least * dist.get_world_size()} rows")


def fwd_level_sharded(x, wavelet: Wavelet):
    """One 2-D analysis level on this rank's row-sharded tile x (..., h,
    w); bit-identical to wv.fwd_level's rows of the whole array.  Returns
    this rank's (LL, HL, LH, HH) rows."""
    wavelet = Wavelet(wavelet)
    above, below = halo_rows(wavelet)
    if HAS_SHIFT[wavelet]:
        x = x + x
    e, o = wv._split(x, -1)
    lo_, hi_ = wv._lift_fwd(e, o, wavelet, -1)
    out = []
    for half in (lo_, hi_):
        ev, od = wv._split(half, -2)
        out.append(wv._lift_fwd(ev, od, wavelet, -2,
                                tap=_HaloTap(above, below)))
    (ll, lh), (hl, hh) = out
    return ll, hl, lh, hh


def inv_level_sharded(ll, hl, lh, hh, wavelet: Wavelet):
    """The inverse of fwd_level_sharded on this rank's rows."""
    wavelet = Wavelet(wavelet)
    above, below = halo_rows(wavelet)
    halves = []
    for ev, od in ((ll, lh), (hl, hh)):
        ev, od = wv._lift_inv(ev, od, wavelet, -2,
                              tap=_HaloTap(above, below))
        halves.append(wv._interleave(ev, od, -2))
    lo_, hi_ = halves
    e, o = wv._lift_inv(lo_, hi_, wavelet, -1)
    x = wv._interleave(e, o, -1)
    if HAS_SHIFT[wavelet]:
        x = (x + 1) >> 1
    return x


def sharded_forward(tile, depth: int, wavelet: Wavelet):
    """wv.forward on the frame whose rows the ranks hold: this rank's tile
    -> this rank's rows of every band ({'ll', 'levels'})."""
    _check_tile(tile.shape[-2], depth, wavelet)
    levels = []
    cur = tile
    for _ in range(depth):
        ll, hl, lh, hh = fwd_level_sharded(cur, wavelet)
        levels.append({"hl": hl, "lh": lh, "hh": hh})
        cur = ll
    return {"ll": cur, "levels": levels}


def sharded_inverse(pyr, wavelet: Wavelet):
    """wv.inverse on a pyramid whose bands' rows the ranks hold."""
    depth = len(pyr["levels"])
    _check_tile(pyr["ll"].shape[-2] << depth, depth, wavelet)
    cur = pyr["ll"]
    for lev in reversed(pyr["levels"]):
        cur = inv_level_sharded(cur, lev["hl"], lev["lh"], lev["hh"],
                                wavelet)
    return cur


def sharded_upsample(tile):
    """This rank's rows of obmc.make_halfpel(obmc.upsample_plane(frame))
    from its u8 tile (h, w) -> (2h, 2w).  The vertical 8-tap filter (taps
    at rows -3..+4) takes a 3-row / 4-row halo; the horizontal passes are
    local, and the reference's last-row overrides apply on the last rank
    alone."""
    h, w = tile.shape
    last = dist.get_rank() == dist.get_world_size() - 1
    head, tail = group.exchange_rows(tile, 3, 4)
    h2 = obmc._conv8_edge(torch.cat([head, tile, tail], 0), 0)[3:3 + h]
    if last:
        h2[h - 1] = tile[h - 1]
    h1 = obmc._conv8_edge(tile, 1)
    h1[:, w - 1] = tile[:, w - 1]
    h3 = obmc._conv8_edge(h2, 1)
    h3[:, w - 1] = h2[:, w - 1]
    if last:
        h3[h - 1] = h1[h - 1]
    return obmc.make_halfpel((tile, h1, h2, h3))


def sharded_render(mv, up1, up2, p, num_refs: int):
    """This rank's band of the OBMC luma prediction (int16): the half-pel
    references `up1` / `up2` and the MV fields `mv` (dx1, dy1, dx2, dy2,
    pred_mode, dc0) are replicated, as a codec's reference pictures are,
    and each rank renders out_h / world rows at their place in the frame
    (obmc.render_component's row0).  Bit-identical to the unsharded
    render's rows."""
    out_w, out_h = p.video_format.picture_luma_size()
    world = dist.get_world_size()
    if out_h % world:
        raise ValueError(f"{out_h} luma rows do not split evenly over "
                         f"{world} ranks")
    band = out_h // world
    pred = obmc.render_component(
        mv["dx1"], mv["dy1"], mv["dx2"], mv["dy2"], mv["pred_mode"],
        mv["dc0"], up1, up2 if num_refs == 2 else None, p.xblen_luma,
        p.yblen_luma, p.xbsep_luma, p.ybsep_luma, p.mv_precision,
        p.picture_weight_1, p.picture_weight_2, p.picture_weight_bits,
        band, out_w, row0=dist.get_rank() * band)
    return pred.to(torch.int16)
