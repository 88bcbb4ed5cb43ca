"""Milliseconds a frame of device time of the kernels launched under the
ME passes (`me_pass`, `encoder/inter.py` over `encoder/me.py`: the
pyramid, kernel #1's full-pel searches and the subpel refine)."""

SPAN = "me_pass"


def read(trace):
    row = trace["spans"].get(SPAN)
    if row is None or row["count"] == 0 or not trace["frames"]:
        return None
    return row["device_s"] * 1e3 / trace["frames"]
