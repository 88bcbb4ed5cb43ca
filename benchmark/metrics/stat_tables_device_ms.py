"""Milliseconds a frame of device time of the kernels launched under the
inter step's stat-table spans (`stat_tables`: the 61-way per-band bits and
error tables, `encoder/inter.py`, `encoder/gop.py`)."""

SPAN = "stat_tables"


def read(trace):
    row = trace["spans"].get(SPAN)
    if row is None or row["count"] == 0 or not trace["frames"]:
        return None
    return row["device_s"] * 1e3 / trace["frames"]
