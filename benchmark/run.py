"""Run one benchmark cell of the port once, on the card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1>

The cell (`BENCHMARK.json`'s `workloads`) names a configuration
(`benchmark/configs/<config>.json`: the format and the encoder settings)
and a traffic mix (`benchmark/traffic/<mix>.json`: the content, the
clips' length and number, and how the window drives the encoder).
Set-up makes the clips from the seed on the card and runs one warm-up
pass of the window's own loop; then the window runs for `--seconds`
(`harness/drive.py`).  With `--trace 1` the window runs under
`torch.profiler` and the cell's per-layer metrics
(`benchmark/metrics/<metric>.py`) read the reduced trace, which has a
row for every span, and the change of the program's counters over the
window (`info["counters"]`); with `--trace 0` the end-to-end metrics are
reported.  After the window the outputs are judged by the
configuration's check (`harness/check.py`) and the limits of
`benchmark/limits/<cell>.json`.  The last lines on standard error are the
numbers compared with their limits; the last line on standard output is
the result as one JSON object.

Exits 2 without a result where there is no CUDA device, 3 where the
process has loaded JAX or the JAX package.  `--control` runs
the cell's control (the configuration's `control`: a setting that breaks
a guarantee the configuration states), which has to come out not
correct; the benchmark's own runs never pass it.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
for _p in (REPO, HERE):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import numpy as np  # noqa: E402
import torch  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "schroedinger_tpu")


def forbidden_modules():
    """Top-level names of loaded modules that are JAX or the JAX package,
    compared whole (the port's name begins with the JAX package's)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def load_cell(name):
    """(cell, configuration, traffic, limits, per-layer and end-to-end
    metric entries of the cell) by the cell's name."""
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        spec = json.load(f)
    cell = next((w for w in spec["workloads"] if w["name"] == name), None)
    if cell is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in spec["configs"] if c["name"] == cell["config"])
    with open(os.path.join(REPO, conf["file"])) as f:
        cfg = json.load(f)
    with open(os.path.join(HERE, "traffic", cell["traffic"] + ".json")) as f:
        traffic = json.load(f)
    with open(os.path.join(HERE, "limits", name + ".json")) as f:
        limits = json.load(f)

    def mine(m):
        return name in m.get("workloads", [name])
    return (cell, cfg, traffic, limits,
            [m for m in spec["per_layer"] if mine(m)],
            [m for m in spec["end_to_end"] if mine(m)])


def load_reader(metric):
    """The `read(trace)` function of `benchmark/metrics/<metric>.py`."""
    path = os.path.join(HERE, "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location(
        "metric_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class GcClock:
    """Collections of Python's garbage collector, and the seconds they
    took, while `on` (the window): a stall that shows in the items'
    seconds can be told from the collector's."""

    def __init__(self):
        self.on, self.count, self.full, self.seconds = False, 0, 0, 0.0
        self._t = 0.0
        gc.callbacks.append(self._cb)

    def _cb(self, phase, info):
        if not self.on:
            return
        if phase == "start":
            self._t = time.perf_counter()
        else:
            self.count += 1
            self.full += info["generation"] == 2
            self.seconds += time.perf_counter() - self._t

    def close(self):
        gc.callbacks.remove(self._cb)


def run(workload, seed, seconds, trace, device, size=None, control=False,
        frames=None):
    """One run of a cell; returns (result dict, [(name, value, limit)]).
    `control` runs the configuration's control in the program's place.
    `size` (width, height) and `frames` replace the configuration's
    picture size and the mix's clip length, for tests on the CPU only."""
    from harness import check, content, drive, trace as tr
    from harness.codec import Codec

    cell, cfg, traffic, limits, per_layer, end_to_end = load_cell(workload)
    fmt = cfg["format"] = dict(cfg["format"])
    if size is not None:
        # the bit rate, and a low-delay picture's budget, scale with the
        # pictures' area
        area, full = size[0] * size[1], fmt["width"] * fmt["height"]

        def scaled(enc):
            return dict(enc, bitrate=enc["bitrate"] * area // full)
        cfg["encoder"] = scaled(cfg["encoder"])
        if "budget_bytes" in fmt:
            fmt["budget_bytes"] = fmt["budget_bytes"] * area // full
            # a low-delay control's rate is read against the budget, so
            # it stays twice the scaled budget; a long-GOP control keeps
            # its stated rate, since at 128x64 the encoder cannot come
            # down to the scaled rate or to twice it (the same pictures)
            if "bitrate" in cfg["control"]["encoder"]:
                cfg["control"] = dict(cfg["control"], encoder=scaled(
                    cfg["control"]["encoder"]))
        fmt["width"], fmt["height"] = size
    if frames is not None:
        traffic["frames"] = frames
    api = traffic["api"]
    clips = content.make_clips(traffic, fmt["width"], fmt["height"],
                               fmt["chroma"], fmt["bit_depth"], seed, device)
    run_cfg = cfg
    if control:
        # the configuration's control in the program's place: encoder
        # settings that break a guarantee the configuration states
        run_cfg = dict(cfg, encoder=dict(cfg["encoder"],
                                         **cfg["control"]["encoder"]))
    codec = Codec(run_cfg, device)
    loop = drive.LOOPS[api]
    # the warm-up pass codes the last clip; the window starts at the first
    loop(codec, clips, 0.0, device, min_items=len(clips[0]),
         first=len(clips) - 1)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - T_START
    gcc = GcClock()
    before = codec.counters()
    with tr.window_profile(trace) as win:
        gcc.on = True
        # two passes at least: each pass is judged against the one before
        items, window_s, lat, outputs = loop(codec, clips, seconds, device,
                                             min_items=2 * len(clips[0]))
        gcc.on = False
    gcc.close()
    # the program's counters over the window alone: set-up counts too
    counted = {k: v - before.get(k, 0) for k, v in codec.counters().items()}
    print(f"window {window_s:.3f} s, {items} items, set-up {setup_s:.3f} s"
          + (f", item seconds min {min(lat):.4f} median "
             f"{float(np.median(lat)):.4f} max {max(lat):.4f} (item "
             f"{int(np.argmax(lat))})" if lat else "")
          + f"; garbage collector in the window: {gcc.count} collections "
          f"({gcc.full} full), {gcc.seconds:.4f} s", file=sys.stderr)
    found = forbidden_modules()
    if found:
        print(f"loaded after the window: {', '.join(found)}",
              file=sys.stderr)
        raise SystemExit(3)
    cuda = torch.device(device).type == "cuda"
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": 1,
           "memory_peak_bytes": (int(torch.cuda.max_memory_allocated())
                                 if cuda else 0)}
    reduced = None
    if win.prof is not None:
        reduced = tr.reduce(win.prof, win.window_s)
        win.prof = None
        dev["busy_s"] = reduced["busy_s"]
        dev["window_s"] = reduced["window_s"]
    del codec
    if cuda:
        torch.cuda.empty_cache()

    # judge the window's outputs: the last stream and others drawn from
    # the seed
    t_check = time.perf_counter()
    k = min(int(traffic.get("check_passes", 1)), len(outputs))
    rest = np.random.default_rng(seed).permutation(len(outputs) - 1)
    sample = sorted(rest[:k - 1].tolist() + [len(outputs) - 1])
    nums, attempted, failed = check.CHECKS[cfg.get("check", "longgop")](
        cfg, clips, outputs, device, sample, traffic, seed)
    print(f"check of {len(sample)} of {len(outputs)} streams "
          f"{time.perf_counter() - t_check:.3f} s", file=sys.stderr)
    compared = [(k, nums[k], limits[k]) for k in nums]
    missing = sorted(set(limits) - set(nums))
    if missing:
        raise ValueError(f"limits without a number: {missing}")
    correct = all(v <= lim for _, v, lim in compared) and failed == 0

    metrics = {}
    if trace:
        info = dict(reduced, frames=items, direction="encode",
                    refs_used=_refs_used(s for _, s in outputs),
                    counters=counted)
        for m in per_layer:
            v = load_reader(m["name"])(info)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in end_to_end:
            n = m["name"]
            if n == "setup_s":
                v = setup_s
            elif n == "encode_fps":
                v = items / window_s
            else:
                raise ValueError(f"no way to measure {n}")
            metrics[n] = {"value": v, "unit": m["unit"]}
    result = {"correct": bool(correct), "attempted": int(attempted),
              "failed": int(failed), "metrics": metrics, "device": dev}
    if reduced is not None:
        result["breakdown"] = {"device_ops": reduced["device_ops"],
                               "idle_gaps": reduced["idle_gaps"]}
    result["check"] = {k: {"value": v, "limit": lim}
                       for k, v, lim in compared}
    return result, compared


def _refs_used(streams):
    """References the pictures of the window's streams use, read from
    their parse codes."""
    from refcodec import bitstream as rbs
    return sum(rbs.num_refs(code) for s in streams
               for code, _ in rbs.split_units(s) if rbs.is_picture(code))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true",
                    help="run the configuration's control, which has to "
                    "come out not correct")
    a = ap.parse_args(argv)
    chips = load_cell(a.workload)[0]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result, compared = run(a.workload, a.seed, a.seconds, bool(a.trace),
                           "cuda", control=a.control)
    found = forbidden_modules()
    if found:
        print(f"loaded: {', '.join(found)}", file=sys.stderr)
        return 3
    for k, v, lim in compared:
        print(f"check {k} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
