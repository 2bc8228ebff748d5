"""Device time of a callable on the card, read from CUDA events.

The tuner's own timer (``measure.py``) reads the host clock around a launch
and a synchronisation, as the reference's does; this one brackets ``n``
back-to-back calls with two CUDA events, so it reads what the card spent.
The benchmark rows and the card's smoke script share it.
"""

from __future__ import annotations

import torch


def time_ms(fn, n: int, warmup: int = 2) -> float:
    """Mean device time of one call over ``n`` back-to-back calls."""
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
