"""Megabytes a frame copied between host and card by the long-GOP
encoder over the window: the change of the program's counters
`upload_bytes` (`pipeline.upload_picture`) and `fetch_bytes`
(`pipeline.to_host`: the coded wires, the stat tables, the MD5 and PSNR
pictures) over the window, in 10^6 bytes."""

COUNTERS = ("upload_bytes", "fetch_bytes")


def read(trace):
    counted = trace.get("counters", {})
    total = sum(counted.get(n, 0) for n in COUNTERS)
    if not total or not trace["frames"]:
        return None
    return total / 1e6 / trace["frames"]
