"""Milliseconds a frame of host time in the rate controller's arithmetic
(span `rate_control`, `encoder/gop.py` over `encoder/ratecontrol.py`: the
quantiser arguments, the commit after each picture, TM5's intra frame
lambda), on the host clock."""

SPAN = "rate_control"


def read(trace):
    row = trace["spans"].get(SPAN)
    if row is None or row["count"] == 0 or not trace["frames"]:
        return None
    return row["host_s"] * 1e3 / trace["frames"]
