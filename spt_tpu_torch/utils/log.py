"""Leveled, callback-routed logger.

Mirrors the reference renderer's ``render::Log`` (its Log.h and Log.cpp):
five levels Trace..Error, a user-installable sink callback
with stdout fallback, and a level filter.  The reference app installs a
``[RENDER] [LEVEL]`` console sink (App.cpp:86-95) — ``install_console_sink``
reproduces that format.
"""

from __future__ import annotations

import sys
from enum import IntEnum
from typing import Callable, Optional


class Level(IntEnum):
    TRACE = 0
    DEBUG = 1
    INFO = 2
    WARN = 3
    ERROR = 4


class Log:
    _level: Level = Level.INFO
    _callback: Optional[Callable[[Level, str], None]] = None

    @classmethod
    def set_level(cls, level: Level) -> None:
        cls._level = Level(level)

    @classmethod
    def get_level(cls) -> Level:
        return cls._level

    @classmethod
    def set_callback(cls, callback: Optional[Callable[[Level, str], None]]) -> None:
        cls._callback = callback

    @classmethod
    def _emit(cls, level: Level, msg: str) -> None:
        if level < cls._level:
            return
        if cls._callback is not None:
            cls._callback(level, msg)
        else:
            print(msg, file=sys.stdout)

    @classmethod
    def trace(cls, msg: str) -> None:
        cls._emit(Level.TRACE, msg)

    @classmethod
    def debug(cls, msg: str) -> None:
        cls._emit(Level.DEBUG, msg)

    @classmethod
    def info(cls, msg: str) -> None:
        cls._emit(Level.INFO, msg)

    @classmethod
    def warn(cls, msg: str) -> None:
        cls._emit(Level.WARN, msg)

    @classmethod
    def error(cls, msg: str) -> None:
        cls._emit(Level.ERROR, msg)


def install_console_sink() -> None:
    """The reference app's '[RENDER] [LEVEL] message' sink (App.cpp:86-95)."""
    def sink(level: Level, msg: str) -> None:
        print(f"[RENDER] [{level.name}] {msg}")
    Log.set_callback(sink)
