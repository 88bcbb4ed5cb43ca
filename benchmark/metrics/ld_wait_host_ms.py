"""Milliseconds a frame in which the low-delay encode's main thread waits
for the worker thread's packed picture (span `ld_wait`,
`api.Encoder._emit_lowdelay`): host time, on the host clock.  Near 0
where the main thread's queueing of the analysis sets the pace, the
worker's fetch and packing less the queueing where the worker does."""

SPAN = "ld_wait"


def read(trace):
    row = trace["spans"].get(SPAN)
    if row is None or row["count"] == 0 or not trace["frames"]:
        return None
    return row["host_s"] * 1e3 / trace["frames"]
