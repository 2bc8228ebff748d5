"""Searcher interface + registry: the batched ask/tell evaluation protocol.

A searcher minimizes a (noisy) measurement over a :class:`SearchSpace` with a
fixed *sample budget* — the paper's central experimental axis.  Searchers are
written as *proposal generators* (:meth:`Searcher._propose`): they yield
batches of configurations and receive the measured values back, so one
algorithm definition serves three consumers:

* the **ask/tell protocol** — ``start(budget)``, ``ask(n) -> list[Config]``,
  ``tell(configs, values)``, ``finish() -> TuningResult`` — for callers that
  own the evaluation loop (distributed/sharded matrix runs),
* the **batched loop** ``engine.drive(searcher, measurement, budget)``
  which routes every proposal batch through ``measure_batch`` (one
  Python-level dispatch per batch),
* the **sequential loop** ``drive(..., dispatch="one")`` which measures
  one config at a time — same proposals, same history, used for parity.

``drive`` returns a :class:`TuningResult` containing the best configuration the
searcher chose, the value observed for it during the search, and the full
sample history (used by the statistics layer and the benchmark figures).
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from dataclasses import dataclass, field
from typing import Generator, Sequence

import numpy as np

from ..space import Config, SearchSpace

#: type of the proposal generators: yields batches of configs, receives the
#: corresponding measured values (np.ndarray) via ``send``.
ProposalGen = Generator[list, np.ndarray, None]


@dataclass
class TuningResult:
    algo: str
    best_config: Config
    best_value: float               # value observed during search
    final_value: float | None = None  # median of 10 re-measurements (runner fills)
    history_configs: list = field(default_factory=list)
    history_values: list = field(default_factory=list)
    n_samples: int = 0


class Searcher(ABC):
    """Budgeted minimizer.  Subclasses set ``name`` and implement ``_propose``."""

    name: str = "base"
    #: whether this searcher receives the constrained space (paper: SMBO
    #: methods could not use constraint specification).
    uses_constraints: bool = True

    def __init__(self, space: SearchSpace, seed: int = 0, **kwargs):
        self.space = space if self.uses_constraints else space.unconstrained()
        self.seed = seed
        self.rng = np.random.default_rng(seed)
        self._session = None

    # -- ask/tell protocol ----------------------------------------------------
    def start(self, budget: int) -> TuningResult:
        """Begin an ask/tell session; returns the live (mutating) result."""
        if budget < 1:
            raise ValueError("budget must be >= 1")
        result = TuningResult(algo=self.name, best_config={}, best_value=np.inf)
        self._session = _Session(
            budget=budget,
            remaining=budget,
            result=result,
            gen=self._propose(budget, result),
        )
        self._pull_next_batch()
        return result

    def ask(self, n: int | None = None) -> list:
        """Up to ``n`` configs to evaluate next (all pending ones if None).

        Returns ``[]`` when the search is finished.  The returned configs
        must be answered with :meth:`tell` before the next :meth:`ask`.
        """
        s = self._require_session()
        if s.outstanding:
            raise RuntimeError("tell() the previous ask() before asking again")
        if s.done:
            return []
        k = len(s.queue) if n is None else max(0, min(int(n), len(s.queue)))
        out, s.queue = s.queue[:k], s.queue[k:]
        s.outstanding = list(out)
        return list(out)

    def tell(self, configs: Sequence[Config], values) -> None:
        """Report measured ``values`` for the configs of the last ask()."""
        s = self._require_session()
        values = np.asarray(values, dtype=np.float64).reshape(-1)
        configs = list(configs)
        if not configs:
            raise ValueError("tell() with no configs (ask() returned empty?)")
        if len(configs) != len(values):
            raise ValueError(f"{len(configs)} configs vs {len(values)} values")
        if configs != s.outstanding:
            raise ValueError("tell() configs must match the last ask() exactly")
        r = s.result
        for c, v in zip(configs, values, strict=True):
            r.history_configs.append(c)
            r.history_values.append(float(v))
            if v < r.best_value:
                r.best_value = float(v)
                r.best_config = c
        s.remaining -= len(configs)
        s.batch_values.extend(float(v) for v in values)
        s.outstanding = []
        if s.queue:
            return                      # current proposal batch not fully asked yet
        if s.batch_trimmed:
            s.done = True               # generator expected more slots than budget
            s.gen.close()
            return
        self._pull_next_batch(np.asarray(s.batch_values, dtype=np.float64))

    @property
    def done(self) -> bool:
        s = self._require_session()
        return s.done and not s.queue and not s.outstanding

    def finish(self) -> TuningResult:
        """End the session and return the (budget-audited) result.

        The pure ask/tell path never re-measures the winner, so
        ``final_value`` is always ``None`` here; callers that apply the
        paper's 10x final re-measurement (``repro_torch.tune``) fill it
        afterwards.
        """
        s = self._require_session()
        result = s.result
        result.final_value = None
        result.n_samples = len(result.history_values)
        if result.n_samples > s.budget:
            raise RuntimeError(
                f"{self.name} exceeded budget: {result.n_samples} > {s.budget}"
            )
        self._session = None
        return result

    # -- internals ------------------------------------------------------------
    def _require_session(self) -> "_Session":
        if self._session is None:
            raise RuntimeError("no active session; call start(budget) first")
        return self._session

    def _pull_next_batch(self, values: np.ndarray | None = None) -> None:
        s = self._require_session()
        if s.remaining <= 0:
            # resume once more so the generator can finalize (e.g. RF picks
            # its best *prediction*); any further proposals are discarded.
            try:
                if values is not None:
                    s.gen.send(values)
            except StopIteration:
                pass
            s.gen.close()
            s.done = True
            return
        try:
            batch = s.gen.send(values) if values is not None else next(s.gen)
        except StopIteration:
            s.done = True
            return
        batch = list(batch)
        if not batch:
            s.done = True
            s.gen.close()
            return
        s.batch_trimmed = len(batch) > s.remaining
        s.queue = batch[: s.remaining]
        s.batch_values = []

    @abstractmethod
    def _propose(self, budget: int, result: TuningResult) -> ProposalGen:
        """Yield batches of configs; receive their measured values via send().

        The engine trims a batch that would exceed the remaining budget and
        never resumes the generator afterwards, so implementations may yield
        full population-sized batches without budget arithmetic.
        """


@dataclass
class _Session:
    budget: int
    remaining: int
    result: TuningResult
    gen: ProposalGen
    queue: list = field(default_factory=list)        # proposed, not yet asked
    outstanding: list = field(default_factory=list)  # asked, awaiting tell
    batch_values: list = field(default_factory=list)
    batch_trimmed: bool = False
    done: bool = False


SEARCHERS: dict[str, type[Searcher]] = {}


def register(cls: type[Searcher]) -> type[Searcher]:
    SEARCHERS[cls.name] = cls
    return cls


def make_searcher(name: str, space: SearchSpace, seed: int = 0, **kw) -> Searcher:
    if name not in SEARCHERS:
        raise KeyError(f"unknown searcher {name!r}; have {sorted(SEARCHERS)}")
    return SEARCHERS[name](space, seed=seed, **kw)
