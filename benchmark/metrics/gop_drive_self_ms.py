"""Milliseconds a frame of the long-GOP driver's own host time: the self
time of span `gop_drive` (`encoder/gop.py`: `encode_frame`, `flush`, each
picture of the backref loop), its time outside the spans opened inside
it on its thread, on the host clock."""

SPAN = "gop_drive"


def read(trace):
    row = trace["spans"].get(SPAN)
    if row is None or row["count"] == 0 or not trace["frames"]:
        return None
    return row["self_s"] * 1e3 / trace["frames"]
