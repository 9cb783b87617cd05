"""Leveled logging with call-site capture and one-shot dedup.

Equivalent capability to lucille's `src/base/log.{c,h}`: five levels,
``__FILE__:__LINE__`` capture (log.h:65-69), ``ri_log_once`` dedup
(log.h:96-101), and a runtime debug toggle (main.c:328-341).  Implemented
on top of the stdlib logging module rather than hand-rolled macros.

The port's copy of lucille_tpu/base/log.py: the same code, except that
its logger is named "lucille_tpu_torch" and prefixes that name, so that
a process importing both packages keeps two loggers and the port's lines
say which package wrote them.
"""

from __future__ import annotations

import inspect
import logging
import os
import sys

LOG_DEBUG = logging.DEBUG
LOG_INFO = logging.INFO
LOG_WARN = logging.WARNING
LOG_ERROR = logging.ERROR
LOG_FATAL = logging.CRITICAL

_LOGGER_NAME = "lucille_tpu_torch"
_seen_once: set[tuple[str, int, str]] = set()


def get_logger() -> logging.Logger:
    logger = logging.getLogger(_LOGGER_NAME)
    if not logger.handlers:
        # stdout, not stderr: the reference's RIB regression harness
        # (tests/ribparse/test_runner.py:10-33) fails a scene on ANY stderr
        # output and applies its `#|` oracles to stdout, so diagnostics have
        # to go to stdout to preserve those harness semantics.
        handler = logging.StreamHandler(sys.stdout)
        handler.setFormatter(
            logging.Formatter(f"[{_LOGGER_NAME}] %(levelname)s %(message)s")
        )
        logger.addHandler(handler)
        logger.setLevel(
            logging.DEBUG if os.environ.get("LUCILLE_DEBUG") else logging.INFO
        )
        logger.propagate = False
    return logger


def set_debug(enabled: bool) -> None:
    """CLI ``--debug`` toggle (reference src/lsh/main.c:328-341)."""
    get_logger().setLevel(logging.DEBUG if enabled else logging.INFO)


def _callsite() -> tuple[str, int]:
    frame = inspect.currentframe()
    # walk out of this module
    while frame is not None and frame.f_globals.get("__name__") == __name__:
        frame = frame.f_back
    if frame is None:
        return ("?", 0)
    return (os.path.basename(frame.f_code.co_filename), frame.f_lineno)


def log(level: int, msg: str, *args) -> None:
    """Log with file:line capture like lucille's ri_log macro (log.h:65-69)."""
    fname, lineno = _callsite()
    get_logger().log(level, "%s:%d  %s", fname, lineno, msg % args if args else msg)


def log_once(level: int, msg: str, *args) -> None:
    """Log a message at most once per call site (ri_log_once, log.h:96-101)."""
    fname, lineno = _callsite()
    key = (fname, lineno, msg)
    if key in _seen_once:
        return
    _seen_once.add(key)
    get_logger().log(level, "%s:%d  %s", fname, lineno, msg % args if args else msg)
