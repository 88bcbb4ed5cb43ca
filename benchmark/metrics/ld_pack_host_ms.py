"""Milliseconds a frame of host time in which the low-delay encode's
worker thread searches each slice's quant index and packs the slices in
the native coder (`ld_pack`, `coding/native` `ld_encode_tab`).  The
profiler records the thread that starts it alone, so the worker's span
has no row; the program sums the span's time in the counter
`ld_pack_ns`, read here over the window."""

COUNTER = "ld_pack_ns"


def read(trace):
    ns = trace.get("counters", {}).get(COUNTER, 0)
    if not ns or not trace["frames"]:
        return None
    return ns / 1e6 / trace["frames"]
