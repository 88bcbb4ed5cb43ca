"""Share of the device's idle time in which no span of the program was
open on the host: the idle under the harness's own `bench.*` spans or
under none, over all the idle between the window's first span and its
last (`idle_by_span`, by the innermost span open)."""

from harness.trace import NO_SPAN

HARNESS = "bench."


def read(trace):
    idle = trace.get("idle_by_span") or []
    total = sum(s for _, s in idle)
    if total <= 0:
        return None
    return sum(s for n, s in idle
               if n == NO_SPAN or n.startswith(HARNESS)) / total
