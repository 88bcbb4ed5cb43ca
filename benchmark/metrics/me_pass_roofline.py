"""The ME pass's share of its roofline, in percent: the least time the
card could take for the ME's full-pel searches of the window's pictures,
over the device time of all kernels under the `me_pass` spans.

The work is counted from the configuration, not from what the program
launches: one 1080p reference of one picture takes the seven full-pel
searches below (pyramid level, block size, radius, the hint field read;
`encoder/me.py`'s pass at 1920x1080, `tools/profile_patch_refine.py`'s
REFINE_SHAPES), each bounded as `chip_smoke.refine_bound_ms` bounds kernel
#1: the bytes the search needs once (the current plane, of the reference
plane the smaller of the plane and the blocks' windows, the int32 hint
field where it is read, the int32 vectors and SADs out) over 3.35 TB/s,
against three operations per absolute difference over 67 TFLOP/s (NVIDIA
H100 SXM data sheet, float32 outside the tensor cores: the sheet gives no
integer rate), the larger of the two.  It is multiplied by the references
the window's pictures use, read from the streams' parse codes.

The denominator is the whole pass (the pyramid's downsampling, the
searches, the subpel refine), so the share is a lower bound of the
searches' own share, and a faster search can never lift it past 100%.
"""

HBM_BYTES_PER_S = 3.35e12
ALU_OPS_PER_S = 67e12

# (blocks down, blocks across, block size, radius, hint field read as
# (rows, cols) or None) of the seven searches of one 1080p reference
SEARCHES_1080P = (
    (17, 30, 4, 8, None),           # level 4, the coarse scan
    (34, 60, 4, 2, (17, 30)),       # level 3 refine
    (68, 120, 4, 2, (34, 60)),      # level 2 refine
    (68, 120, 8, 2, (68, 120)),     # level 1 refine
    (68, 120, 16, 2, (68, 120)),    # level 0 refine
    (68, 120, 16, 0, (68, 120)),    # level 0 median SAD
    (68, 120, 16, 0, None),         # level 0 zero SAD
)


def search_bound_s(nby, nbx, bs, rad, grid, n=1):
    """Least seconds of one search over n current planes and one shared
    reference."""
    h, w = nby * bs, nbx * bs
    nb = nby * nbx
    windows = n * nb * (bs + 2 * rad) ** 2
    nbytes = (n * h * w + min(h * w, windows) + 3 * n * nb * 4
              + (grid[0] * grid[1] * 2 * 4 if grid else 0))
    ops = 3 * n * nb * (2 * rad + 1) ** 2 * bs * bs
    return max(nbytes / HBM_BYTES_PER_S, ops / ALU_OPS_PER_S)


def reference_bound_s():
    """Least seconds of the seven searches of one reference."""
    return sum(search_bound_s(*s) for s in SEARCHES_1080P)


def read(trace):
    row = trace["spans"].get("me_pass")
    refs = trace.get("refs_used")
    if not refs or row is None or row["device_s"] <= 0:
        return None
    return 100.0 * refs * reference_bound_s() / row["device_s"]
