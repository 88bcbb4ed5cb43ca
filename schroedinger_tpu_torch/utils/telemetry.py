"""Telemetry: frame stats, per-topic dump streams, event counters.

Mirrors two of the reference's observability mechanisms:
  - frame stats API (21 per-frame metrics, schroencoder.c:1234-1258)
    -> FrameStats JSONL
  - SCHRO_DUMP per-topic data files (schrodebug.h:24-37, the dump
    dispatcher schrodebug.c:78-96) -> dump(topic, ...) writing
    schro_tpu_dump_<topic>.log, gated by SCHRO_TPU_DUMP ("all", "1",
    or a comma list of topic names); SCHRO_TPU_DUMP_DIR picks the dir.

and adds the port's event counters (`counters`), which the profiler's
spans do not give: counts of bytes and launches, read before and after
a run.  The frame stats and dumps are copies of
`schroedinger_tpu/utils/telemetry.py`'s: the port imports nothing of the
JAX package.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, Optional

# schrodebug.h:24-37 topic list, snake_cased
DUMP_TOPICS = ("subband_curve", "subband_est", "picture", "psnr", "ssim",
               "lambda_curve", "lambda_op", "hist_test", "scene_change",
               "phase_corr", "motionest")


class FrameStats:
    """Collects per-frame encoder metrics; optionally streams JSONL."""

    def __init__(self, path: Optional[str] = None):
        if path is None and os.environ.get("SCHRO_TPU_DUMP"):
            path = os.environ.get("SCHRO_TPU_DUMP_PATH",
                                  "schro_tpu_stats.jsonl")
        self._path = path
        self._f = open(path, "a") if path else None
        self.frames = []

    def record(self, **fields) -> None:
        fields.setdefault("t", time.time())
        self.frames.append(fields)
        if self._f:
            self._f.write(json.dumps(fields) + "\n")
            self._f.flush()
        if _dumps.enabled("picture"):
            dump("picture", json.dumps(fields))
        for topic in ("psnr", "ssim", "scene_change"):
            key = "sc_score" if topic == "scene_change" else topic
            if key in fields and _dumps.enabled(topic):
                dump(topic, "%s %s %s", fields.get("frame", -1), key,
                     fields[key])

    def last(self):
        return self.frames[-1] if self.frames else None


class _DumpManager:
    """Per-topic dump files, opened lazily on first write."""

    def __init__(self):
        self._files: Dict[str, object] = {}
        self._enabled: Optional[set] = None  # parsed lazily from env

    def _topics(self) -> set:
        if self._enabled is None:
            raw = os.environ.get("SCHRO_TPU_DUMP", "").strip().lower()
            if raw in ("", "0"):
                self._enabled = set()
            elif raw in ("1", "all"):
                self._enabled = set(DUMP_TOPICS)
            else:
                self._enabled = {t.strip() for t in raw.split(",")}
        return self._enabled

    def enabled(self, topic: str) -> bool:
        return topic in self._topics()

    def write(self, topic: str, line: str) -> None:
        if topic not in self._topics():
            return
        f = self._files.get(topic)
        if f is None:
            d = os.environ.get("SCHRO_TPU_DUMP_DIR", ".")
            f = open(os.path.join(d, "schro_tpu_dump_%s.log" % topic), "a")
            self._files[topic] = f
        f.write(line.rstrip("\n") + "\n")
        f.flush()


_dumps = _DumpManager()


def dump_enabled(topic: str) -> bool:
    return _dumps.enabled(topic)


def dump(topic: str, fmt: str, *args) -> None:
    """schro_dump(topic, fmt, ...) analog — one line per call."""
    _dumps.write(topic, fmt % args if args else fmt)


class Counters:
    """Process-wide event counts by name: the bytes the long-GOP encoder
    copies to and from the card and the hand-written kernels' launches.
    Always on; each event is one add under the lock, since GOP shards
    encode on several threads.

    counters.add("upload_bytes", n)      adds n to the count
    counters.snapshot()                  {name: count}, a copy
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._counts: Dict[str, int] = {}

    def add(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counts[name] = self._counts.get(name, 0) + n

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counts)


# upload_bytes: the encoders' source pictures copied to the card
# (`pipeline.upload_picture`); fetch_bytes: what their coding fetches back
# (`pipeline.to_host`: the coded wire, the stat tables, the MD5 and PSNR
# pictures, the low-delay slices and tables); the prefilter's round trip
# is not counted.  The low-delay encoder's ld_pictures, ld_slices and
# ld_analysis_passes (pictures packed, their slices, the chunks of the
# 61-base loop) and ld_fetch_ns and ld_pack_ns (its worker's fetch and
# packing time, in nanoseconds) are read by the benchmark's readers.  Read by
# `profile_slice`, which prints both and me_search_launches per frame;
# me_search_launches and me_probe_launches (`ops/patch_refine`) also by
# chip_smoke's and bench.py's launch gates.  stat_table_launches: the
# calls of the stat tables kernel (`ops/stat_tables`), which
# `profile_slice` prints beside the `stat_tables` spans and chip_smoke
# reports.
counters = Counters()
