"""Logging with levels and a pluggable callback.

Capability parity with the reference's ``include/LightGBM/utils/log.h``
(levels Debug/Info/Warning/Fatal where Fatal raises, and a user-pluggable
output callback used by the language bindings).
"""
from __future__ import annotations

import sys
from typing import Callable, Optional


class LightGBMError(Exception):
    """Error raised by the framework (Fatal log level)."""


# Numeric levels match the reference semantics: higher = more verbose.
LOG_FATAL = -1
LOG_WARNING = 0
LOG_INFO = 1
LOG_DEBUG = 2


class Log:
    """Static logger. ``Log.fatal`` raises :class:`LightGBMError`."""

    _level: int = LOG_INFO
    _callback: Optional[Callable[[str], None]] = None

    @classmethod
    def reset_level(cls, level: int) -> None:
        cls._level = level

    @classmethod
    def reset_callback(cls, callback: Optional[Callable[[str], None]]) -> None:
        cls._callback = callback

    @classmethod
    def _write(cls, level: int, tag: str, msg: str) -> None:
        if level <= cls._level:
            text = f"[LightGBM-Torch] [{tag}] {msg}"
            if cls._callback is not None:
                cls._callback(text + "\n")
            else:
                print(text, file=sys.stderr, flush=True)

    @classmethod
    def debug(cls, msg: str, *args) -> None:
        cls._write(LOG_DEBUG, "Debug", msg % args if args else msg)

    @classmethod
    def info(cls, msg: str, *args) -> None:
        cls._write(LOG_INFO, "Info", msg % args if args else msg)

    @classmethod
    def warning(cls, msg: str, *args) -> None:
        cls._write(LOG_WARNING, "Warning", msg % args if args else msg)

    @classmethod
    def fatal(cls, msg: str, *args) -> None:
        text = msg % args if args else msg
        cls._write(LOG_FATAL, "Fatal", text)
        raise LightGBMError(text)
