"""Wavelet filter identifiers (Dirac / VC-2 wavelet index space).

Index values follow the bitstream encoding (reference: schrobitstream.h:124-132).

A frozen copy of the port's `wavelets.py`.
"""
import enum


class Wavelet(enum.IntEnum):
    DESLAURIERS_DUBUC_9_7 = 0
    LE_GALL_5_3 = 1
    DESLAURIERS_DUBUC_13_7 = 2
    HAAR_0 = 3
    HAAR_1 = 4
    FIDELITY = 5
    DAUBECHIES_9_7 = 6


# Maximum safe transform depth per wavelet for 8-bit (S16) encoding, used by
# the encoder to avoid 16-bit overflow (reference: schroencoder.c:806-814).
MAX_DEPTH_S16 = {
    Wavelet.DESLAURIERS_DUBUC_9_7: 5,
    Wavelet.LE_GALL_5_3: 4,
    Wavelet.DESLAURIERS_DUBUC_13_7: 5,
    Wavelet.HAAR_0: 4,
    Wavelet.HAAR_1: 4,
    Wavelet.FIDELITY: 3,
    Wavelet.DAUBECHIES_9_7: 4,
}

# Wavelets whose lifting pre-shifts the input left by 1 (and the inverse
# applies a rounded right shift by 1 at the end). Haar-0 and Fidelity do not
# shift (reference: schrowaveletorc.c wavelet_iwt_*_horiz deinterleave choice).
HAS_SHIFT = {
    Wavelet.DESLAURIERS_DUBUC_9_7: True,
    Wavelet.LE_GALL_5_3: True,
    Wavelet.DESLAURIERS_DUBUC_13_7: True,
    Wavelet.HAAR_0: False,
    Wavelet.HAAR_1: True,
    Wavelet.FIDELITY: False,
    Wavelet.DAUBECHIES_9_7: True,
}
