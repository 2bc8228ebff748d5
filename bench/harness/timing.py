"""The benchmark's own kernel timer: CUDA events around back-to-back
launches.  A copy of ``chip_smoke.py``'s phase-5 timer; the program's
timers are never the yardstick."""

from __future__ import annotations

import statistics


def event_ms(fn, n: int, warmup: int = 2) -> float:
    """Mean device time of one call over ``n`` back-to-back calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def kernel_ms(fn, n: int = 30, reps: int = 3) -> float:
    """Median of ``reps`` event timings of ``n`` launches each."""
    return statistics.median(event_ms(fn, n) for _ in range(reps))
