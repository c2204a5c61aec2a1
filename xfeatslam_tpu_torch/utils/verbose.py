"""Leveled logging (role of the Verbose class of ORB-SLAM3's System.h:
five levels, one static threshold).

A copy of ``xfeatslam_tpu/utils/verbose.py``; the port keeps its own."""

from __future__ import annotations

import enum
import sys
import time


class Level(enum.IntEnum):
    QUIET = 0
    NORMAL = 1
    VERBOSE = 2
    VERY_VERBOSE = 3
    DEBUG = 4


_threshold = Level.NORMAL
_t0 = time.time()


def set_level(level: Level):
    global _threshold
    _threshold = Level(level)


def print_mess(msg: str, level: Level = Level.NORMAL, file=sys.stderr):
    if level <= _threshold and _threshold > Level.QUIET:
        file.write(f"[{time.time() - _t0:8.2f}s] {msg}\n")
