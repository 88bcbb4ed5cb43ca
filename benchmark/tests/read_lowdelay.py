"""Readings of the low-delay check (`check.check_lowdelay`) at the
configuration's own size, for the limits of a low-delay cell:

    python3 benchmark/tests/read_lowdelay.py --seeds 1,2,3
        [--kinds eight,ten,control,slice,stale,drop,pad,depth3,offset]
        [--seconds S] [--device cuda] [--size WxH]

Each run drives `lowdelay_cell`'s cell through `run.run`: "eight" is the
program's 8-bit path against the 8-bit form of the format (the sound
case), "ten" its 10-bit streams as the configuration states them,
"control" the configuration's control (twice the budget) in the 8-bit
path, "offset" `faults.py`'s offset fault in the 10-bit path, and the
others are `faults.py`'s low-delay faults planted in the 8-bit path.
One JSON line per kind and seed gives every number the check compares,
`attempted`, `failed`, the streams of the window and the check's seconds.
No limit is set here: `tile_mse_worst` is held to none.
"""
import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.dirname(HERE))

import run  # noqa: E402  (puts the repository on the path)
import faults  # noqa: E402
import lowdelay_cell as lc  # noqa: E402
from harness import check  # noqa: E402
from harness import codec as hc  # noqa: E402

KINDS = ("eight", "ten", "control") + faults.FAULTS[lc.CELL]
TEN_BIT = ("ten", "offset")
LIMITS = {"lost": 0, "misnumbered": 0, "header": 0, "budget_off": 0,
          "tile_mse_worst": float("inf")}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--kinds", default=",".join(KINDS))
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--size", default=None)
    a = ap.parse_args()
    size = tuple(int(x) for x in a.size.split("x")) if a.size else None
    real_encoder, real_check = hc.Codec.new_encoder, check.CHECKS["lowdelay"]
    seen = {}

    def timed(cfg, clips, outputs, *rest):
        t = time.perf_counter()
        out = real_check(cfg, clips, outputs, *rest)
        seen.update(check_s=time.perf_counter() - t, streams=len(outputs))
        return out
    check.CHECKS["lowdelay"] = timed
    for kind in a.kinds.split(","):
        for seed in a.seeds.split(","):
            hc.Codec.new_encoder = real_encoder
            lc.install(10 if kind in TEN_BIT else 8, LIMITS)
            if kind in faults.FAULTS[lc.CELL]:
                faults.plant(kind, lc.CELL)
            result, compared = run.run(lc.CELL, int(seed), a.seconds, False,
                                       a.device, size=size,
                                       control=kind == "control")
            print(json.dumps({"kind": kind, "seed": int(seed),
                              "numbers": {k: v for k, v, _ in compared},
                              "attempted": result["attempted"],
                              "failed": result["failed"], **seen}),
                  flush=True)


if __name__ == "__main__":
    main()
