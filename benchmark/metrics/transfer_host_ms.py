"""Milliseconds a frame in which the host stands in a copy between host
and card: the union on the host clock of the spans `picture_upload`
(`pipeline.upload_picture`, every source upload of the long-GOP encoder),
`p_transfer` (an inter picture's coded data down, `encoder/inter.py`) and
`i_transfer` (an intra picture's, `encoder/intra.py`)."""

from harness.trace import host_union_s

SPANS = ("picture_upload", "p_transfer", "i_transfer")


def read(trace):
    if not trace["frames"] or not any(n in trace["spans"] for n in SPANS):
        return None
    return host_union_s(trace, SPANS) * 1e3 / trace["frames"]
