"""Measurement functions — the objective an autotuner minimizes.

The paper measures kernel wall-clock on GPUs (timer started after H2D copy,
stopped before D2H).  The port keeps the reference's measurement protocol
(``repro.core.measurement``): every measurement counts the *samples* it has
served, so searchers can be budget-audited, and ``measure_final`` re-runs the
winning config ``final_repeats`` times (paper: 10) and returns the median.

* :class:`CallableMeasurement` — wraps any ``f(config) -> seconds``.
* :class:`TimingMeasurement`  — wall-clock of a real callable, fenced.
* :class:`CachedMeasurement`  — memoizes another measurement (the paper runs
  a config once during search; re-measuring during search would leak budget).
* :func:`fence` — waits for a kernel's output inside the timed region.
"""

from __future__ import annotations

import threading
from typing import Callable, Sequence

import numpy as np
import torch

from ..telemetry.null import NULL_TELEMETRY
from .clock import monotonic
from .space import Config


class StageClock:
    """Accumulates wall-clock per named pipeline stage (screen -> compile ->
    time -> record), so provenance can split a search's cost into compiling
    and measuring.  Adds are thread-safe."""

    def __init__(self) -> None:
        self._acc: dict[str, float] = {}
        self._lock = threading.Lock()

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
        #: telemetry sink (observability only — never feeds values); the
        #: no-op default keeps the disabled path the plain code path
        self.telemetry = NULL_TELEMETRY

    def set_telemetry(self, telemetry) -> None:
        """Attach a telemetry sink (``None`` resets to the no-op default).
        Wrapper measurements forward to their inner backend so stage events
        and counters come from the layer that actually does the work."""
        self.telemetry = telemetry if telemetry is not None else NULL_TELEMETRY

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


class TimingMeasurement(BaseMeasurement):
    """Times ``runner(config)`` with a monotonic clock.

    At least one warmup call runs per distinct config before timing (more
    with ``warmup > 1``), so first-call cost (a build, a lazy load) is
    always excluded — the analogue of the paper starting the timer only
    after host->device transfer.  Warmup results AND the timed result are
    fenced (:func:`fence`): a CUDA launch retires inside the timed region,
    never before it or after it.  The clock is :mod:`repro_torch.core.clock`'s.
    """

    def __init__(self, runner: Callable[[Config], None], warmup: int = 1):
        super().__init__()
        self._runner = runner
        self._warmup = max(1, warmup)
        self._warmed: set = set()

    def _key(self, config: Config):
        return tuple(sorted(config.items()))

    def _measure_one(self, config: Config) -> float:
        k = self._key(config)
        if k not in self._warmed:
            for _ in range(self._warmup):
                fence(self._runner(config))
            self._warmed.add(k)
        t0 = monotonic()
        fence(self._runner(config))
        return monotonic() - t0


class CachedMeasurement(BaseMeasurement):
    """Memoizes an inner measurement by config.

    During search the paper evaluates each configuration once ('We only run
    the sample once during the training and sampling process').  Searchers
    that revisit a config (GA elites, SA plateaus) therefore see the *same*
    noisy observation rather than a fresh draw, and the revisit does not
    consume extra budget.
    """

    def __init__(self, inner: BaseMeasurement):
        super().__init__()
        self._inner = inner
        self._cache: dict = {}

    def _key(self, config: Config):
        return tuple(sorted(config.items()))

    def measure(self, config: Config) -> float:
        self.n_dispatches += 1
        k = self._key(config)
        if k not in self._cache:
            self._cache[k] = self._inner.measure(config)
            self.n_samples += 1
        return self._cache[k]

    def measure_batch(self, configs: Sequence[Config]) -> np.ndarray:
        """Batch-aware memoization: only uncached configs reach the inner
        backend, in ONE dispatch (duplicates within the batch collapse)."""
        self.n_dispatches += 1
        keys = [self._key(c) for c in configs]
        fresh_keys: list = []
        fresh_cfgs: list = []
        seen_fresh: set = set()
        for k, c in zip(keys, configs, strict=True):
            if k not in self._cache and k not in seen_fresh:
                seen_fresh.add(k)
                fresh_keys.append(k)
                fresh_cfgs.append(c)
        if fresh_cfgs:
            vals = self._inner.measure_batch(fresh_cfgs)
            self.n_samples += len(fresh_cfgs)
            self._cache.update(zip(fresh_keys, (float(v) for v in vals), strict=True))
        return np.array([self._cache[k] for k in keys], dtype=np.float64)

    def _measure_one(self, config: Config) -> float:
        return self._inner._measure_one(config)

    def measure_final(self, config: Config, repeats: int = 10) -> float:
        return self._inner.measure_final(config, repeats)

    def skip_samples(self, n: int) -> None:
        self._inner.skip_samples(n)

    def provenance(self) -> dict:
        return self._inner.provenance()

    def reason_for(self, config: Config) -> str | None:
        return self._inner.reason_for(config)

    def repeats_for(self, config: Config) -> list | None:
        return self._inner.repeats_for(config)

    def stage_times(self) -> dict[str, float]:
        return self._inner.stage_times()

    def reset(self) -> None:
        super().reset()
        self._cache.clear()
        self._inner.reset()

    def set_telemetry(self, telemetry) -> None:
        super().set_telemetry(telemetry)
        self._inner.set_telemetry(telemetry)
