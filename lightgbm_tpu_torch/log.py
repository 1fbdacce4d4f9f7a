"""Leveled logging with a registerable callback.

Counterpart of the reference's `include/LightGBM/utils/log.h:1-104`:
four levels gated by a global verbosity, `fatal` raises instead of aborting,
and an optional callback hook (used by language bindings).
"""
from __future__ import annotations

import sys
from typing import Callable, Optional

FATAL = -1
WARNING = 0
INFO = 1
DEBUG = 2

_level = INFO
_callback: Optional[Callable[[str], None]] = None


class LightGBMError(Exception):
    """Raised on unrecoverable errors (reference: Log::Fatal throws, log.h:83)."""


def set_level(level: int) -> None:
    global _level
    _level = level


def get_level() -> int:
    return _level


def register_callback(cb: Optional[Callable[[str], None]]) -> None:
    global _callback
    _callback = cb


def _emit(tag: str, msg: str) -> None:
    line = f"[LightGBM-TPU] [{tag}] {msg}"
    if _callback is not None:
        _callback(line + "\n")
    else:
        print(line, file=sys.stderr, flush=True)


def debug(msg: str, *args) -> None:
    if _level >= DEBUG:
        _emit("Debug", msg % args if args else msg)


def info(msg: str, *args) -> None:
    if _level >= INFO:
        _emit("Info", msg % args if args else msg)


def warning(msg: str, *args) -> None:
    if _level >= WARNING:
        _emit("Warning", msg % args if args else msg)


def fatal(msg: str, *args) -> None:
    raise LightGBMError(msg % args if args else msg)
