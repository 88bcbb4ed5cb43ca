"""The low-delay analysis's share of its roofline, in percent: the least
time the card could take for the analysis of the window's pictures, over
the device time under the `ld_analysis` spans.

The work is counted from the configuration (1920x1080 4:2:2 10-bit, the
LeGall 5,3 at depth 4, 60 x 68 slices), not from what the program
launches.  The transform pads the planes to 1920x1088 luma and two
960x1088 chroma planes; their non-DC coefficients (all but the depth-4
LL band: 2,080,800 + 2 x 1,040,400 = 4,161,600) are evaluated at each of
the 61 base quant indices.  One evaluation is counted as 8 operations:
the dead-zone test, the offset subtracted, the division by the quant
factor, the nonzero flag, the bit length, the length doubled with the
flag added, the sum into the slice's bits and the last-nonzero maximum.
That is 2.03 G operations a picture over 67 TFLOP/s (NVIDIA H100 SXM
data sheet, float32 outside the tensor cores: the sheet gives no integer
rate).  The bytes are the 10-bit source in (8,294,400), the int32 slices
(16,711,680) and the 61-base tables (5,973,120) out, once, over 3.35 TB/s.
The bound is the larger of the two, 0.0303 ms a picture.

The denominator is all device time under `ld_analysis`, the upload and
the worker's fetch of the picture before included (see
`ld_analysis_device_ms`), so the share is a lower bound of the analysis's
own, and a faster analysis can never lift it past 100%.
"""

HBM_BYTES_PER_S = 3.35e12
ALU_OPS_PER_S = 67e12
DEPTH = 4
BASES = 61
OPS_PER_EVALUATION = 8
SPAN = "ld_analysis"
# (rows, columns) of the padded planes: luma, then each chroma plane
PLANES = ((1088, 1920), (1088, 960), (1088, 960))
SOURCE_BYTES = 1920 * 1080 * 2 + 2 * 960 * 1080 * 2
SLICES = 68 * 60


def picture_bound_s():
    """Least seconds of one picture's analysis."""
    coeffs = sum(h * w for h, w in PLANES)
    non_dc = sum(h * w - (h >> DEPTH) * (w >> DEPTH) for h, w in PLANES)
    ops = OPS_PER_EVALUATION * BASES * non_dc
    nbytes = SOURCE_BYTES + 4 * coeffs + BASES * SLICES * 2 * 3 * 4
    return max(ops / ALU_OPS_PER_S, nbytes / HBM_BYTES_PER_S)


def read(trace):
    row = trace["spans"].get(SPAN)
    if row is None or row["device_s"] <= 0 or not trace["frames"]:
        return None
    return 100.0 * trace["frames"] * picture_bound_s() / row["device_s"]
