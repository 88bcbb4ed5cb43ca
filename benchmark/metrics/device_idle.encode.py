"""Share of the encode window in which no operation ran on the device:
1 - busy / window, busy being the union of the kernels' and copies'
intervals in the profiler's trace (`profile_slice._device_busy_us`)."""


def read(trace):
    if trace["direction"] != "encode" or trace["window_s"] <= 0:
        return None
    return 1.0 - trace["busy_s"] / trace["window_s"]
