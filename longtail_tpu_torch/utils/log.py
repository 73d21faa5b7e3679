"""Structured logging with hierarchical typed field contexts.

The reference builds chained log contexts with typed fields via macros
(src/longtail.h:860-926) dispatched through a pluggable sink with a global
level (Longtail_CallLogger src/longtail.c:906, Longtail_SetLog/SetLogLevel
:848-869); the CLI renders the field chain JSON-ish (cmd/main.c:54).  This
is the Python re-expression: a contextvar chain of field dicts plus a
module-global sink/level, so hot paths pay one integer compare when the
level is off.
"""

from __future__ import annotations

import contextlib
import contextvars
import sys
import time
from typing import Callable

DEBUG, INFO, WARNING, ERROR, OFF = 0, 1, 2, 3, 4

_LEVEL_NAMES = {"debug": DEBUG, "info": INFO, "warn": WARNING,
                "warning": WARNING, "error": ERROR, "off": OFF}
_NAMES = {DEBUG: "DEBUG", INFO: "INFO", WARNING: "WARN", ERROR: "ERROR"}

_level = WARNING
_sink: Callable | None = None

_ctx: contextvars.ContextVar[tuple] = contextvars.ContextVar(
    "longtail_log_ctx", default=())


def set_level(level) -> None:
    """Accepts a numeric level or a name ('debug'/'info'/'warn'/'error'/'off')
    like the reference CLI's --log-level (cmd/main.c:3028)."""
    global _level
    if isinstance(level, str):
        try:
            level = _LEVEL_NAMES[level.lower()]
        except KeyError:
            raise ValueError(f"unknown log level {level!r}") from None
    _level = level


def get_level() -> int:
    return _level


def set_sink(sink: Callable | None) -> None:
    """sink(level:int, fields:dict, message:str); None restores stderr."""
    global _sink
    _sink = sink


@contextlib.contextmanager
def log_context(**fields):
    """Push a typed-field frame onto the context chain for the scope
    (the analog of LONGTAIL_LOG_CONTEXT_WITH_FIELDS)."""
    token = _ctx.set(_ctx.get() + (fields,))
    try:
        yield
    finally:
        _ctx.reset(token)


def _emit(level: int, message: str, fields: dict) -> None:
    merged: dict = {}
    for frame in _ctx.get():
        merged.update(frame)
    merged.update(fields)
    if _sink is not None:
        _sink(level, merged, message)
        return
    ts = time.strftime("%H:%M:%S")
    ctx = "".join(f" {k}={v}" for k, v in merged.items())
    sys.stderr.write(f"[{ts}] {_NAMES[level]} {message}{ctx}\n")


def debug(message: str, **fields) -> None:
    if _level <= DEBUG:
        _emit(DEBUG, message, fields)


def info(message: str, **fields) -> None:
    if _level <= INFO:
        _emit(INFO, message, fields)


def warn(message: str, **fields) -> None:
    if _level <= WARNING:
        _emit(WARNING, message, fields)


def error(message: str, **fields) -> None:
    if _level <= ERROR:
        _emit(ERROR, message, fields)
