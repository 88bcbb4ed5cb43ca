"""Milliseconds a frame of host time in the native arithmetic coder's
subband encode (span `encode_subband_arith`, `coding/native`): host
work, timed on the host clock."""

SPAN = "encode_subband_arith"


def read(trace):
    row = trace["spans"].get(SPAN)
    if row is None or row["count"] == 0 or not trace["frames"]:
        return None
    return row["host_s"] * 1e3 / trace["frames"]
