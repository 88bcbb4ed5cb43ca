"""Milliseconds a frame of device time of the kernels and copies under the
low-delay analysis (`ld_analysis`, `api.Encoder._encode_stream_lowdelay`
over `pipeline.make_lowdelay_analyze`: the source's upload, the offset,
the forward LeGall 5,3, the slice reorder and the 61-base quantise and
bit count).

The harness gives a device op to the span whose device-side mirror it
starts in, so the worker thread's fetch of picture N (its `cat` and the
copy down), which runs on the card while the main thread queues the
analysis of picture N + 1, counts here too: about 1.5 ms of the 17.2 ms a
1080p 4:2:2 frame on an H100."""

SPAN = "ld_analysis"


def read(trace):
    row = trace["spans"].get(SPAN)
    if row is None or row["count"] == 0 or row["device_s"] <= 0 \
            or not trace["frames"]:
        return None
    return row["device_s"] * 1e3 / trace["frames"]
