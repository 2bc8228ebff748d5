"""The one wall-clock seam for determinism-critical code.

Results must never depend on when they were computed, so library code in the
determinism-critical modules (searchers, engine, the tuning session) never
calls ``time.time()`` / ``time.perf_counter()`` directly.  Wall-clock readings
that are *legitimate* (run-record provenance, stage clocks, the measurement
timer) all route through this module instead: one injectable monotonic timer.
A copy of ``repro.core.clock``: the port imports nothing of the reference.

``set_timer`` swaps the clock for tests (fake time, zero time, recorded
ticks) and restores the default on ``set_timer(None)``.
"""

from __future__ import annotations

import time
from typing import Callable

__all__ = ["default_timer", "monotonic", "set_timer"]

#: the process-default monotonic clock.  The sole sanctioned direct wall-clock
#: reference in determinism-critical code; everything else calls monotonic().
default_timer: Callable[[], float] = time.perf_counter

_timer: Callable[[], float] = default_timer


def monotonic() -> float:
    """Seconds from the injectable monotonic clock (durations only — the
    epoch is arbitrary, so readings are only meaningful as differences)."""
    return _timer()


def set_timer(timer: Callable[[], float] | None) -> Callable[[], float]:
    """Swap the clock; ``None`` restores the default.  Returns the previous
    timer so tests can restore it in a ``finally``."""
    global _timer
    prev = _timer
    _timer = default_timer if timer is None else timer
    return prev
