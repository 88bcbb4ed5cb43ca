"""Rate-control state the fixed-quantiser GOP encoder carries (port of
`schroedinger_tpu/encoder/ratecontrol.py` `ArithCorrection`; the stat
tables, CBR controllers and quantiser engines are not ported yet)."""
from __future__ import annotations

import numpy as np


class ArithCorrection:
    """Per-(component, band) x {intra, inter} arith-vs-estimate bit-ratio
    tables (schroencoder.c:2548-2590, init 1.0, EMA 0.9/0.1 guarded by
    est > 200), EMA'd against the raw estimate and clamped to [0.5, 2]."""

    def __init__(self, ncol: int):
        self.intra = np.ones(ncol, np.float64)
        self.inter = np.ones(ncol, np.float64)

    def get(self, intra: bool) -> np.ndarray:
        return self.intra if intra else self.inter

    def update(self, intra: bool, actual_bits, est_bits) -> None:
        tab = self.get(intra)
        a = np.asarray(actual_bits, np.float64)
        e = np.asarray(est_bits, np.float64)
        ok = e > 200.0
        tab[ok] = np.clip(0.9 * tab[ok] + 0.1 * (a[ok] / e[ok]), 0.5, 2.0)
