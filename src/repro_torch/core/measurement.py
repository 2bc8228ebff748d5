"""Measurement functions — the objective an autotuner minimizes.

The paper measures kernel wall-clock on GPUs (timer started after H2D copy,
stopped before D2H).  The port keeps the reference's measurement protocol
(``repro.core.measurement``): every measurement counts the *samples* it has
served, so searchers can be budget-audited, and ``measure_final`` re-runs the
winning config ``final_repeats`` times (paper: 10) and returns the median.

* :class:`CallableMeasurement` — wraps any ``f(config) -> seconds``.
* :func:`fence` — waits for a kernel's output inside the timed region.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Callable, Sequence

import numpy as np
import torch

from .clock import monotonic
from .space import Config


class StageClock:
    """Accumulates wall-clock per named pipeline stage (screen -> compile ->
    time -> record), so provenance can split a search's cost into compiling
    and measuring.  Adds are thread-safe."""

    def __init__(self) -> None:
        self._acc: dict[str, float] = {}
        self._lock = threading.Lock()

    @contextmanager
    def stage(self, name: str):
        t0 = monotonic()
        try:
            yield
        finally:
            self.add(name, monotonic() - t0)

    def add(self, name: str, seconds: float) -> None:
        with self._lock:
            self._acc[name] = self._acc.get(name, 0.0) + float(seconds)

    def times(self) -> dict[str, float]:
        with self._lock:
            return dict(self._acc)

    def reset(self) -> None:
        with self._lock:
            self._acc.clear()


def fence(out) -> None:
    """Block until the device work behind ``out`` retires.

    A CUDA launch returns once the kernel is *enqueued*, so timing backends
    call this INSIDE the timed region (and on warmup results, so leftover
    work never leaks into the first timed call).  A CUDA tensor synchronises
    its own device and is never copied to the host — a ``.cpu()`` here would
    time the copy.  A CPU tensor is already computed; ``None`` means the
    runner blocked on its own.
    """
    if out is None:
        return
    if isinstance(out, torch.Tensor):
        if out.is_cuda:
            torch.cuda.synchronize(out.device)
        return
    raise TypeError(f"fence: cannot wait on a {type(out).__name__}")


class BaseMeasurement:
    """Common bookkeeping: sample + dispatch counting, final-config repetition.

    ``n_samples`` audits the search budget (one per config served).
    ``n_dispatches`` counts Python-level entries into the backend: a
    batch-aware backend serves a whole batch in ONE dispatch.
    """

    def __init__(self) -> None:
        self.n_samples = 0
        self.n_dispatches = 0

    def _measure_one(self, config: Config) -> float:  # pragma: no cover
        raise NotImplementedError

    def measure(self, config: Config) -> float:
        self.n_samples += 1
        self.n_dispatches += 1
        return float(self._measure_one(config))

    def measure_batch(self, configs: Sequence[Config]) -> np.ndarray:
        return np.array([self.measure(c) for c in configs], dtype=np.float64)

    def skip_samples(self, n: int) -> None:
        """Advance any per-sample state WITHOUT measuring — called by caching
        layers when serving hits.  Default: nothing to advance."""

    def measure_final(self, config: Config, repeats: int = 10) -> float:
        """Re-measure the chosen config ``repeats`` times; return the median.

        Per the paper (section VI.A): 'When the autotuning algorithm has
        terminated, we test the final sample 10 times to compensate for
        runtime variance.'  These repeats are NOT counted against the search
        budget.
        """
        vals = [float(self._measure_one(config)) for _ in range(repeats)]
        return float(np.median(vals))

    def reset(self) -> None:
        self.n_samples = 0
        self.n_dispatches = 0

    # -- introspection hooks (wrappers delegate; defaults are inert) ----------
    def provenance(self) -> dict:
        """How this backend produced its numbers (timer, device, repeats...).
        Recorded into the RunRecord; ``{}`` means nothing to say."""
        return {}

    def reason_for(self, config: Config) -> str | None:
        """Why ``config`` was penalized (``inf``), if this backend knows."""
        return None

    def repeats_for(self, config: Config) -> list | None:
        """Raw per-repeat timings behind the last aggregate for ``config``."""
        return None

    def stage_times(self) -> dict[str, float]:
        """Per-stage wall-clock accumulated since the last reset; ``{}``
        means the backend is unstaged."""
        return {}


class CallableMeasurement(BaseMeasurement):
    def __init__(self, fn: Callable[[Config], float],
                 batch_fn: Callable[[Sequence[Config]], np.ndarray] | None = None):
        super().__init__()
        self._fn = fn
        self._batch_fn = batch_fn

    def _measure_one(self, config: Config) -> float:
        return self._fn(config)

    def measure_batch(self, configs: Sequence[Config]) -> np.ndarray:
        if self._batch_fn is None:
            return super().measure_batch(configs)
        self.n_samples += len(configs)
        self.n_dispatches += 1
        return np.asarray(self._batch_fn(configs), dtype=np.float64)
