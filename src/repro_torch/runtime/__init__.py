"""Runtime containment of the port: the part of the guard layer that the
plan cache and the measured tuner use (``runtime/guard.py``)."""
from .guard import (CacheCorruptError, EmitError, GuardError, PoisonList,
                    RaceTimeoutError, RUNG_ANCHORED, RUNG_BASELINE,
                    RUNG_PATTERNS, RUNG_STITCHED, RUNGS, race_timeout_s,
                    watchdog_cancelled, watchdog_sleep, with_watchdog)

__all__ = [
    "CacheCorruptError", "EmitError", "GuardError", "PoisonList",
    "RaceTimeoutError", "RUNG_ANCHORED", "RUNG_BASELINE", "RUNG_PATTERNS",
    "RUNG_STITCHED", "RUNGS", "race_timeout_s", "watchdog_cancelled",
    "watchdog_sleep", "with_watchdog",
]
