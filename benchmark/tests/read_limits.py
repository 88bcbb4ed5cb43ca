"""The readings the limits of `benchmark/limits/<cell>.json` are set from,
in one process per cell on the card:

    python3 benchmark/tests/read_limits.py --workload <cell>
        --seeds 1,2,... [--control-seeds ...] [--fault token:1,2,3 ...]
        [--seconds S]

prints one line per run: the kind of run (sound, control, or the fault),
its seed, `correct`, and every number the cell compares.  Sound runs give
the lower readings, the control and the faults the upper ones
(`PERF.md` gives both and the limit set between them).  The window of
each run is `--seconds` at the cell's own load and size; a fault is
planted with `faults.plant`.  The fault "lowbit" codes the source with
its lowest bit cleared (seven-bit samples in the eight-bit format): it
is read to show what a lower sample precision moves, and is no fault
the cell's limits are held to.
"""
import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.dirname(HERE))

import run  # noqa: E402  (puts the repository on the path)
import faults  # noqa: E402
from harness import codec as hc  # noqa: E402


class _LowBit:
    def __init__(self, enc):
        self._enc = enc

    def encode_stream(self, frames):
        return self._enc.encode_stream(
            [tuple((p >> 1) << 1 for p in f) for f in frames])


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault", action="append", default=[],
                    help="name:seed,seed,...")
    ap.add_argument("--seconds", type=float, default=5.0)
    a = ap.parse_args()
    jobs = [("sound", None, s) for s in a.seeds.split(",") if s]
    jobs += [("control", None, s) for s in a.control_seeds.split(",") if s]
    for f in a.fault:
        name, seeds = f.split(":")
        jobs += [(name, name, s) for s in seeds.split(",")]
    real = hc.Codec.new_encoder
    for kind, fault, seed in jobs:
        hc.Codec.new_encoder = real
        if fault == "lowbit":
            hc.Codec.new_encoder = lambda self: _LowBit(real(self))
        elif fault:
            faults.plant(fault, a.workload)
        result, compared = run.run(a.workload, int(seed), a.seconds, False,
                                   "cuda", control=kind == "control")
        print(json.dumps({"kind": kind, "seed": int(seed),
                          "correct": result["correct"],
                          "attempted": result["attempted"],
                          "failed": result["failed"],
                          "numbers": {k: v for k, v, _ in compared}}),
              flush=True)


if __name__ == "__main__":
    main()
