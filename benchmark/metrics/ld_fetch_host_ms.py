"""Milliseconds a frame of host time in which the low-delay encode's
worker thread fetches a picture's analysis from the card (`ld_fetch`,
`encoder/lowdelay.fetch_analysis`: on the card, the wait on the worker's
stream for the picture's analysis to end, then one copy down of the
slices and the 61-base tables).  The profiler records the thread that starts it alone,
so the worker's span has no row; the program sums the span's time in the
counter `ld_fetch_ns`, read here over the window."""

COUNTER = "ld_fetch_ns"


def read(trace):
    ns = trace.get("counters", {}).get(COUNTER, 0)
    if not ns or not trace["frames"]:
        return None
    return ns / 1e6 / trace["frames"]
