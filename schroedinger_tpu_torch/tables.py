"""Dirac/VC-2 specification data tables.

These are fixed spec-defined tables (values from the Dirac/VC-2 standards;
reference copies: schrotables.c, schroparams.c schro_tables_lowdelay_quants).

quant factor: QF(i) ~= 4 * 2^(i/4) in x4 fixed point; dead-zone offsets are
3/8 (inter) and 1/2 (intra) of the factor, with spec rounding.

Whole copy of `schroedinger_tpu/tables.py`: the port imports nothing of
the JAX package, and later slices find their entry points here.
"""
import numpy as np

# Quantisation factors for quant index 0..60 (schrotables.c schro_table_quant).
QUANT_FACTOR = np.array([
    4, 5, 6, 7,
    8, 10, 11, 13,
    16, 19, 23, 27,
    32, 38, 45, 54,
    64, 76, 91, 108,
    128, 152, 181, 215,
    256, 304, 362, 431,
    512, 609, 724, 861,
    1024, 1218, 1448, 1722,
    2048, 2435, 2896, 3444,
    4096, 4871, 5793, 6889,
    8192, 9742, 11585, 13777,
    16384, 19484, 23170, 27554,
    32768, 38968, 46341, 55109,
    65536, 77936, 92682, 110218,
    131072,
], dtype=np.int64)

# Dead-zone offset ~ 3/8 * QF (used for inter / predicted subbands).
QUANT_OFFSET_3_8 = np.array([
    1, 2, 2, 3,
    3, 4, 4, 5,
    6, 7, 9, 10,
    12, 14, 17, 20,
    24, 29, 34, 41,
    48, 57, 68, 81,
    96, 114, 136, 162,
    192, 228, 272, 323,
    384, 457, 543, 646,
    768, 913, 1086, 1292,
    1536, 1827, 2172, 2583,
    3072, 3653, 4344, 5166,
    6144, 7307, 8689, 10333,
    12288, 14613, 17378, 20666,
    24576, 29226, 34756, 41332,
    49152,
], dtype=np.int64)

# Dead-zone offset ~ 1/2 * QF (used for intra subbands and VC-2 low delay).
QUANT_OFFSET_1_2 = np.array([
    1, 2, 3, 4,
    4, 5, 6, 7,
    8, 10, 12, 14,
    16, 19, 23, 27,
    32, 38, 46, 54,
    64, 76, 91, 108,
    128, 152, 181, 216,
    256, 305, 362, 431,
    512, 609, 724, 861,
    1024, 1218, 1448, 1722,
    2048, 2436, 2897, 3445,
    4096, 4871, 5793, 6889,
    8192, 9742, 11585, 13777,
    16384, 19484, 23171, 27555,
    32768, 38968, 46341, 55109,
    65536,
], dtype=np.int64)

# Default per-subband quant matrices for low-delay coding, indexed
# [wavelet][depth-1], entries: dc, then (horiz/vert, diag) per level
# coarse-to-fine (schroparams.c schro_tables_lowdelay_quants).
LOWDELAY_QUANTS = [
    [  # wavelet 0: Deslauriers-Dubuc 9,7
        [5, 3, 0], [5, 3, 0, 4, 1], [5, 3, 0, 4, 1, 5, 2],
        [5, 3, 0, 4, 1, 5, 2, 6, 3]],
    [  # wavelet 1: LeGall 5,3
        [4, 2, 0], [4, 2, 0, 4, 2], [4, 2, 0, 4, 2, 5, 3],
        [4, 2, 0, 4, 2, 5, 3, 7, 5]],
    [  # wavelet 2: Deslauriers-Dubuc 13,7
        [5, 3, 0], [5, 3, 0, 4, 1], [5, 3, 0, 4, 1, 5, 2],
        [5, 3, 0, 4, 1, 5, 2, 6, 3]],
    [  # wavelet 3: Haar 0
        [8, 4, 0], [12, 8, 4, 4, 0], [16, 12, 8, 8, 4, 4, 0],
        [20, 16, 12, 12, 8, 8, 4, 4, 0]],
    [  # wavelet 4: Haar 1
        [8, 4, 0], [8, 4, 0, 4, 0], [8, 4, 0, 4, 0, 4, 0],
        [8, 4, 0, 4, 0, 4, 0, 4, 0]],
    [  # wavelet 5: Fidelity
        [0, 4, 8], [0, 4, 8, 8, 10], [0, 4, 8, 8, 12, 13, 17],
        [0, 4, 8, 8, 12, 13, 17, 17, 21]],
    [  # wavelet 6: Daubechies 9,7
        [3, 1, 0], [3, 1, 0, 4, 2], [3, 1, 0, 4, 2, 6, 5],
        [3, 1, 0, 4, 2, 6, 5, 9, 7]],
]
