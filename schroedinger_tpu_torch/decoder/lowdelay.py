"""Decoder-side helpers shared by the intra and inter decoders (port of
`schroedinger_tpu/decoder/lowdelay.py` `_inverse`, `_to_u8` and
`dc_predict_integrate`; the VC-2 low-delay picture decoder itself is not
ported yet)."""
from __future__ import annotations

import numpy as np
import torch

from schroedinger_tpu_torch.coding import native as _native
from schroedinger_tpu_torch.ops import wavelet as wv


def dc_predict_integrate(band: np.ndarray, deep: bool = False) -> np.ndarray:
    """DC prediction integration of an intra band 0 (host, native C++;
    schro_decoder_subband_dc_predict, schrodecoder.c:3250-3275)."""
    return _native.dc_predict_integrate(band, deep=deep)


def _inverse(pyr, wavelet):
    return wv.inverse(pyr, wavelet)


def _to_u8(plane_s16, h: int, w: int):
    x = plane_s16[:h, :w] + 128
    return x.clamp(0, 255).to(torch.uint8)
