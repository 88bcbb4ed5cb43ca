"""Carry codec state between the JAX package and the port.

A codec has no weights: the state that crosses a picture boundary is the
reference buffer and, under rate control, the controller.
`ref_frame_from_numpy` builds the port's RefFrame from numpy planes (for
example a JAX `RefFrame`'s planes and, optionally, its interleaved
half-pel planes), and `ref_frame_to_numpy` returns them.
`load_encoder_state` puts a port `GopEncoder` into the state of another
encoder object with the same attributes (a JAX `GopEncoder`): controller,
arith-correction tables, overhead EMAs, reference buffer and its model.
Nothing here imports the JAX package: the caller hands the object over.
"""
from __future__ import annotations

import copy

import numpy as np
import torch

from schroedinger_tpu_torch.decoder.core import RefFrame
from schroedinger_tpu_torch.devices import resolve_device


def ref_frame_from_numpy(planes, upsampled=None, device=None) -> RefFrame:
    """(y, u, v) u8 planes [+ their three (2h, 2w) half-pel planes] ->
    RefFrame of u8 tensors on `device` (None: the card)."""
    device = resolve_device(device)
    def dev(a):
        return torch.tensor(np.asarray(a, np.uint8), device=device)

    ups = None if upsampled is None else [dev(u) for u in upsampled]
    return RefFrame(tuple(dev(pl) for pl in planes), upsampled=ups)


def ref_frame_to_numpy(ref: RefFrame):
    """RefFrame -> ((y, u, v) numpy u8 planes, half-pel planes or None)."""
    planes = tuple(pl.cpu().numpy() for pl in ref.planes)
    ups = (None if ref.upsampled is None
           else [u.cpu().numpy() for u in ref.upsampled])
    return planes, ups


# attributes of a GopEncoder that cross a picture boundary besides the
# reference planes (plain Python and numpy values)
_ENCODER_STATE = ("frame_number", "last_ref", "prev_ref", "_prev_mad",
                  "_refbuf", "_enc_last_ref", "_au_frame", "_last_max_qi",
                  "_last_badblock", "_last_stats", "_stats_by_kind",
                  "_sent_stream_aux", "_oh_inter", "_oh_intra")


def load_encoder_state(enc, other, device=None) -> None:
    """Put the port's GopEncoder `enc` into the state of `other`, an
    encoder with the same attributes whose pending pictures are finished:
    the controller's fields (`rc`), the quantiser engine's stat tables,
    `acorr.intra/inter`, the overhead EMAs, `_last_max_qi`, the lagged
    picks' tables and badblock ratio, the reference-buffer model and the
    reference planes (as tensors on `device`; None: the card).  Both
    encoders must have been built with the same options."""
    device = resolve_device(device)
    if (enc.rc is None) != (other.rc is None):
        raise ValueError("one encoder has a rate controller, the other none")
    for name in _ENCODER_STATE:
        setattr(enc, name, copy.deepcopy(getattr(other, name, None)))
    if enc.rc is not None:
        for name, value in vars(other.rc).items():
            setattr(enc.rc, name, copy.deepcopy(value))
    if enc.qengine is not None and other.qengine is not None:
        enc.qengine._stats = copy.deepcopy(other.qengine._stats)
    enc.acorr.intra[:] = np.asarray(other.acorr.intra, np.float64)
    enc.acorr.inter[:] = np.asarray(other.acorr.inter, np.float64)
    enc._prev_input = (None if other._prev_input is None
                       else np.array(other._prev_input))
    enc._chain.prev = other._chain.prev
    enc.ref_frames = {
        num: ref_frame_from_numpy([np.asarray(pl) for pl in ref.planes],
                                  device=device)
        for num, ref in other.ref_frames.items() if ref is not None}
