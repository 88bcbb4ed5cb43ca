"""Leveled logging with a pluggable sink (schrodebug.h:39-75 analog).

The reference exposes SCHRO_LEVEL_ERROR..SCHRO_LEVEL_LOG, an env-var
override (SCHRO_DEBUG, schro.c:74-82) and a replaceable log function
(schro_debug_set_log_function).  Same surface here:

    SCHRO_TPU_DEBUG=3            (or a level name, e.g. "info")
    log.set_level(log.DEBUG)
    log.set_log_handler(fn)      fn(level:int, tag:str, message:str)

Messages below the active level cost one integer compare.

Whole copy of `schroedinger_tpu/utils/log.py` (host only): the port
imports nothing of the JAX package.
"""
from __future__ import annotations

import os
import sys
import time
from typing import Callable, Optional

NONE, ERROR, WARNING, INFO, DEBUG, LOG = 0, 1, 2, 3, 4, 5
_NAMES = {ERROR: "ERROR", WARNING: "WARNING", INFO: "INFO",
          DEBUG: "DEBUG", LOG: "LOG"}
_BY_NAME = {v.lower(): k for k, v in _NAMES.items()}


def _env_level() -> int:
    raw = os.environ.get("SCHRO_TPU_DEBUG", "").strip().lower()
    if not raw:
        return ERROR
    if raw in _BY_NAME:
        return _BY_NAME[raw]
    try:
        return max(NONE, min(LOG, int(raw)))
    except ValueError:
        return ERROR


_level = _env_level()
_handler: Optional[Callable[[int, str, str], None]] = None


def set_level(level: int) -> None:
    global _level
    _level = int(level)


def get_level() -> int:
    return _level


def set_log_handler(fn: Optional[Callable[[int, str, str], None]]) -> None:
    """Replace the sink (None restores stderr), like
    schro_debug_set_log_function."""
    global _handler
    _handler = fn


def _emit(level: int, tag: str, msg: str, args) -> None:
    if level > _level:
        return
    if args:
        msg = msg % args
    if _handler is not None:
        _handler(level, tag, msg)
        return
    print("SCHRO-TPU %s: %s: %s" % (_NAMES.get(level, str(level)), tag, msg),
          file=sys.stderr, flush=True)


def error(tag: str, msg: str, *args) -> None:
    _emit(ERROR, tag, msg, args)


def warning(tag: str, msg: str, *args) -> None:
    _emit(WARNING, tag, msg, args)


def info(tag: str, msg: str, *args) -> None:
    _emit(INFO, tag, msg, args)


def debug(tag: str, msg: str, *args) -> None:
    _emit(DEBUG, tag, msg, args)


def log(tag: str, msg: str, *args) -> None:
    _emit(LOG, tag, msg, args)
