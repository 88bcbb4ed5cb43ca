"""Coding parameters (SchroParams equivalent) + shape calculators.

Mirrors the semantics of schroparams.c: IWT padded sizes (round up to
2^depth), MC block grid sizes, subband positions and geometry, default
codeblock splits and quant matrices.

Whole copy of `schroedinger_tpu/params.py`: the port imports nothing of
the JAX package, and later slices find their entry points here.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

from schroedinger_tpu_torch.tables import LOWDELAY_QUANTS
from schroedinger_tpu_torch.video_format import VideoFormat
from schroedinger_tpu_torch.wavelets import Wavelet

MAX_TRANSFORM_DEPTH = 6


def round_up_pow2(x: int, depth: int) -> int:
    m = (1 << depth) - 1
    return (x + m) & ~m


@dataclasses.dataclass
class GlobalMotion:
    """Dirac global (affine) motion parameters (schroparams.h:17-28)."""
    b0: int = 0
    b1: int = 0
    a_exp: int = 0
    a00: int = 1
    a01: int = 0
    a10: int = 0
    a11: int = 1
    c_exp: int = 0
    c0: int = 0
    c1: int = 0


@dataclasses.dataclass
class Params:
    video_format: Optional[VideoFormat] = None
    is_noarith: bool = False

    # transform parameters
    wavelet_filter_index: Wavelet = Wavelet.LE_GALL_5_3
    transform_depth: int = 4
    horiz_codeblocks: List[int] = dataclasses.field(
        default_factory=lambda: [1] * (MAX_TRANSFORM_DEPTH + 1))
    vert_codeblocks: List[int] = dataclasses.field(
        default_factory=lambda: [1] * (MAX_TRANSFORM_DEPTH + 1))
    codeblock_mode_index: int = 1

    # motion prediction parameters
    num_refs: int = 0
    have_global_motion: bool = False
    xblen_luma: int = 12
    yblen_luma: int = 12
    xbsep_luma: int = 8
    ybsep_luma: int = 8
    mv_precision: int = 2
    global_motion: Tuple[GlobalMotion, GlobalMotion] = dataclasses.field(
        default_factory=lambda: (GlobalMotion(), GlobalMotion()))
    picture_pred_mode: int = 0
    picture_weight_bits: int = 1
    picture_weight_1: int = 1
    picture_weight_2: int = 1

    # low-delay (VC-2) parameters
    is_lowdelay: bool = False
    n_horiz_slices: int = 0
    n_vert_slices: int = 0
    slice_bytes_num: int = 0
    slice_bytes_denom: int = 1
    quant_matrix: List[int] = dataclasses.field(
        default_factory=lambda: [0] * (3 * MAX_TRANSFORM_DEPTH + 1))

    # ---- derived sizes (schroparams.c:123-180) ----
    @property
    def iwt_luma_width(self) -> int:
        w, _ = self.video_format.picture_luma_size()
        return round_up_pow2(w, self.transform_depth)

    @property
    def iwt_luma_height(self) -> int:
        _, h = self.video_format.picture_luma_size()
        return round_up_pow2(h, self.transform_depth)

    @property
    def iwt_chroma_width(self) -> int:
        w, _ = self.video_format.picture_chroma_size()
        return round_up_pow2(w, self.transform_depth)

    @property
    def iwt_chroma_height(self) -> int:
        _, h = self.video_format.picture_chroma_size()
        return round_up_pow2(h, self.transform_depth)

    @property
    def x_num_blocks(self) -> int:
        w, _ = self.video_format.picture_luma_size()
        return 4 * -(-w // (4 * self.xbsep_luma))

    @property
    def y_num_blocks(self) -> int:
        _, h = self.video_format.picture_luma_size()
        return 4 * -(-h // (4 * self.ybsep_luma))

    @property
    def x_offset(self) -> int:
        return (self.xblen_luma - self.xbsep_luma) // 2

    @property
    def y_offset(self) -> int:
        return (self.yblen_luma - self.ybsep_luma) // 2

    def set_default_codeblocks(self) -> None:
        """Encoder default codeblock splits (schroparams.c:85-105)."""
        if self.num_refs == 0:
            for i in range(3):
                self.horiz_codeblocks[i] = 1
                self.vert_codeblocks[i] = 1
            for i in range(3, MAX_TRANSFORM_DEPTH + 1):
                self.horiz_codeblocks[i] = 4
                self.vert_codeblocks[i] = 3
        else:
            for i in range(2):
                self.horiz_codeblocks[i] = 1
                self.vert_codeblocks[i] = 1
            self.horiz_codeblocks[2] = 8
            self.vert_codeblocks[2] = 6
            for i in range(3, MAX_TRANSFORM_DEPTH + 1):
                self.horiz_codeblocks[i] = 12
                self.vert_codeblocks[i] = 8

    def set_default_quant_matrix(self) -> None:
        """schroparams.c schro_params_set_default_quant_matrix."""
        table = LOWDELAY_QUANTS[int(self.wavelet_filter_index)][
            max(0, self.transform_depth - 1)]
        self.quant_matrix[0] = table[0]
        for i in range(self.transform_depth):
            self.quant_matrix[1 + 3 * i + 0] = table[1 + 2 * i + 0]
            self.quant_matrix[1 + 3 * i + 1] = table[1 + 2 * i + 0]
            self.quant_matrix[1 + 3 * i + 2] = table[1 + 2 * i + 1]

    def is_default_quant_matrix(self) -> bool:
        if not (1 <= self.transform_depth <= 4):
            return False
        table = LOWDELAY_QUANTS[int(self.wavelet_filter_index)][
            self.transform_depth - 1]
        if self.quant_matrix[0] != table[0]:
            return False
        for i in range(self.transform_depth):
            if (self.quant_matrix[1 + 3 * i + 0] != table[1 + 2 * i + 0]
                    or self.quant_matrix[1 + 3 * i + 1] != table[1 + 2 * i + 0]
                    or self.quant_matrix[1 + 3 * i + 2] != table[1 + 2 * i + 1]):
                return False
        return True


# ---------------------------------------------------------------------------
# Subband indexing.
#
# Dirac numbers subbands 0..3*depth with "positions" (schroparams.c:358-370):
# position = 4*shift_from_finest + orientation, orientation 0=LL 1=HL 2=LH 3=HH.
# Index order: 0 (DC/LL), then per level coarse->fine: HL, LH, HH.

def subband_position(index: int) -> int:
    positions = [0, 1, 2, 3, 5, 6, 7, 9, 10, 11, 13, 14, 15,
                 17, 18, 19, 21, 22, 23, 25, 26, 27]
    return positions[index]


def subband_count(depth: int) -> int:
    return 1 + 3 * depth


def subband_info(index: int, depth: int):
    """(pyramid_level, band_name) for our Mallat pyramid.

    pyramid levels list is ordered finest-first (levels[0] = first transform
    level). Subband index 0 is the LL band; others map to levels[depth-1-l]
    where l counts coarse-to-fine groups.
    """
    if index == 0:
        return None, "ll"
    group = (index - 1) // 3       # 0 = coarsest detail level
    orient = (index - 1) % 3       # 0=HL, 1=LH, 2=HH
    level = depth - 1 - group      # index into pyramid['levels']
    return level, ("hl", "lh", "hh")[orient]


def subband_quant_matrix_index(index: int) -> int:
    """Map subband index -> quant_matrix entry (same ordering)."""
    return index
