"""Telemetry: frame stats, per-topic dump streams, stage timers.

Mirrors the reference's three observability mechanisms:
  - frame stats API (21 per-frame metrics, schroencoder.c:1234-1258)
    -> FrameStats JSONL
  - SCHRO_DUMP per-topic data files (schrodebug.h:24-37, the dump
    dispatcher schrodebug.c:78-96) -> dump(topic, ...) writing
    schro_tpu_dump_<topic>.log, gated by SCHRO_TPU_DUMP ("all", "1",
    or a comma list of topic names); SCHRO_TPU_DUMP_DIR picks the dir.
  - orc-profile style timing (testsuite/perf) -> Timers accumulating
    wall time per named stage, used by tools/profile_* and the
    entropy-share measurement (PROFILE.md).

Whole copy of `schroedinger_tpu/utils/telemetry.py`: the port imports nothing of
the JAX package, and later slices find their entry points here.
"""
from __future__ import annotations

import json
import os
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

    def reset(self) -> None:
        """Re-read the env on next write (tests toggle SCHRO_TPU_DUMP)."""
        for f in self._files.values():
            f.close()
        self._files.clear()
        self._enabled = None

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


def reset_dumps() -> None:
    _dumps.reset()


class Timers:
    """Accumulating wall-clock timers keyed by stage name.

    with timers.span("entropy"): ...    accumulates into totals["entropy"]
    """

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    def add(self, name: str, seconds: float) -> None:
        self.totals[name] = self.totals.get(name, 0.0) + seconds
        self.counts[name] = self.counts.get(name, 0) + 1

    def span(self, name: str):
        return _Span(self, name)

    def reset(self) -> None:
        self.totals.clear()
        self.counts.clear()

    def report(self) -> str:
        return " ".join("%s=%.3fs/%d" % (k, v, self.counts[k])
                        for k, v in sorted(self.totals.items()))


class _Span:
    def __init__(self, timers: Timers, name: str):
        self._t = timers
        self._name = name

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._t.add(self._name, time.perf_counter() - self._t0)
        return False


# process-wide stage timers used by the encoder hot path; cheap enough to
# stay always-on (two perf_counter calls per frame per stage)
timers = Timers()
