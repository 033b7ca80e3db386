"""Leveled stderr logger, mirroring the reference Debug levels.

Reference behavior: src/commons/Debug.h:46-49 (NOTHING=0, ERROR=1, WARNING=2, INFO=3).
"""

import sys
import time

NOTHING = 0
ERROR = 1
WARNING = 2
INFO = 3

_level = INFO


def set_level(level: int) -> None:
    global _level
    _level = level


def get_level() -> int:
    return _level


def error(msg: str) -> None:
    if _level >= ERROR:
        sys.stderr.write(msg if msg.endswith("\n") else msg + "\n")


def warning(msg: str) -> None:
    if _level >= WARNING:
        sys.stderr.write(msg if msg.endswith("\n") else msg + "\n")


def info(msg: str) -> None:
    if _level >= INFO:
        sys.stderr.write(msg if msg.endswith("\n") else msg + "\n")


class Timer:
    """Wall-clock timer; reference src/commons/Timer.h."""

    def __init__(self):
        self.start = time.monotonic()

    def elapsed(self) -> float:
        return time.monotonic() - self.start

    def __str__(self) -> str:
        t = self.elapsed()
        h = int(t // 3600)
        m = int((t % 3600) // 60)
        s = t % 60
        return f"{h}h {m}m {s:.3f}s"


def die(msg: str, code: int = 1) -> "NoReturn":  # noqa: F821
    error(msg)
    sys.exit(code)
