"""Work-unit layer: a matrix run decomposed into serializable experiment
units (a copy of ``repro.core.workunits``).

The paper's experiment matrix is a grid of (algorithm x sample-size) cells,
each holding E independent experiments.  A monolithic per-cell loop cannot
fan a single big-E row (S=25 has E=800 in the paper design) across workers,
and an interrupted multi-million-sample run had to rely on the measurement
cache alone to catch up.  This module makes the *unit of scheduling* explicit:

* :class:`ExperimentUnit` — a contiguous experiment range ``[exp_lo, exp_hi)``
  of one cell, JSON-serializable, with a stable :attr:`ExperimentUnit.key`.
  Experiment seeds derive from ``stable_seed(spec.seed, algo, S, e)`` with
  the *global* experiment index ``e``, so any split of a cell into units
  yields bit-identical results to the monolithic loop.
* :func:`build_units` — the deterministic decomposition policy: one unit per
  cell, then the largest units split in half until there are at least
  ``min_units`` (so N workers stay busy even on a single-cell matrix), with
  an optional hard cap ``max_unit_experiments`` for checkpoint granularity.
* :func:`merge_unit_results` — folds executor-returned fragments back into
  per-cell :class:`~repro_torch.core.runner.CellResult` arrays, deterministically
  by unit key, verifying full contiguous coverage of every cell.
* :class:`UnitJournal` — the checkpoint layer: completed units are recorded
  as JSON payloads in the measurement store's metadata side-channel, so a
  resumed run (``run_matrix(resume=True)``) serves finished units straight
  from the journal — zero re-measurements, not even cache hits.

Executors (:mod:`repro_torch.core.executors`) consume units and return
:class:`UnitResult` fragments; the session merges them.
"""

from __future__ import annotations

import json
import zlib
from dataclasses import dataclass, field

import numpy as np

from .clock import monotonic
from .runner import CellResult

__all__ = [
    "ExperimentUnit",
    "UnitJournal",
    "UnitResult",
    "build_units",
    "merge_unit_results",
    "unit_digest",
]


def unit_digest(unit_key: str) -> str:
    """Filesystem-safe 8-hex digest of a unit key (keys carry ``/`` + ``:``).

    The unit's cross-host identity: the serving fleet names claim and done
    marker files ``<job>.u<digest>.*`` with it, so every worker — sharing
    nothing but the queue directory — derives the same name for the same
    unit.  crc32 over the stable :attr:`ExperimentUnit.key`, as the
    reference computes it.
    """
    return f"{zlib.crc32(unit_key.encode('utf-8')) & 0xFFFFFFFF:08x}"


@dataclass(frozen=True)
class ExperimentUnit:
    """A contiguous slice of one matrix cell's experiments.

    ``n_exp`` is the parent cell's TOTAL experiment count — part of the
    identity, so a journal entry from one design never masquerades as a unit
    of another, and the RF batched path can regenerate the full-cell
    bootstrap stream and slice its rows.
    """

    algo: str
    sample_size: int
    exp_lo: int
    exp_hi: int
    n_exp: int

    def __post_init__(self):
        if not (0 <= self.exp_lo < self.exp_hi <= self.n_exp):
            raise ValueError(
                f"invalid experiment range [{self.exp_lo}, {self.exp_hi}) "
                f"for a cell of {self.n_exp} experiments"
            )

    @property
    def n_unit_exp(self) -> int:
        return self.exp_hi - self.exp_lo

    @property
    def cell(self) -> tuple[str, int]:
        return (self.algo, self.sample_size)

    @property
    def key(self) -> str:
        """Stable id used for journaling and deterministic merging."""
        return (
            f"{self.algo}/S{self.sample_size}/E{self.n_exp}"
            f"/e{self.exp_lo}:{self.exp_hi}"
        )

    def to_dict(self) -> dict:
        return {
            "algo": self.algo,
            "sample_size": self.sample_size,
            "exp_lo": self.exp_lo,
            "exp_hi": self.exp_hi,
            "n_exp": self.n_exp,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "ExperimentUnit":
        return cls(
            algo=str(d["algo"]),
            sample_size=int(d["sample_size"]),
            exp_lo=int(d["exp_lo"]),
            exp_hi=int(d["exp_hi"]),
            n_exp=int(d["n_exp"]),
        )


@dataclass
class UnitResult:
    """One executed unit's arrays + its wall-clock cost.

    The arrays cover experiments ``[unit.exp_lo, unit.exp_hi)`` in order.
    JSON-serializable both ways — the remote-executor seam ships these back
    as plain dicts.  ``stage_s`` is the unit's per-stage wall-clock breakdown
    (``{"screen": ..., "compile": ..., "time": ...}``) when the backend is a
    staged pipeline; ``{}`` for unstaged backends and pre-breakdown journal
    entries.  ``counters`` is the unit's telemetry counter delta (compiles,
    store hits, invalid configs...) — observability only, ``{}`` when
    telemetry is disabled, never part of the unit's scientific identity.
    ``best_indices`` is the port's own: each experiment's winner as an index
    vector of the space, ``(n_unit_exp, n_params)``, a row of -1 where every
    sample of the experiment was a penalty; ``None`` for a payload
    written without it (the reference's, or an older journal entry), never
    made up.
    """

    unit: ExperimentUnit
    final_values: np.ndarray
    search_best_values: np.ndarray
    n_samples_used: np.ndarray
    wall_s: float = 0.0
    stage_s: dict = field(default_factory=dict)
    counters: dict = field(default_factory=dict)
    best_indices: np.ndarray | None = None

    def __post_init__(self):
        n = self.unit.n_unit_exp
        for name in ("final_values", "search_best_values", "n_samples_used"):
            arr = np.asarray(getattr(self, name))
            if arr.shape != (n,):
                raise ValueError(
                    f"{name} has shape {arr.shape}, expected ({n},) for "
                    f"unit {self.unit.key}"
                )
            setattr(self, name, arr)
        if self.best_indices is not None:
            best = np.asarray(self.best_indices, dtype=np.int64)
            if best.ndim != 2 or best.shape[0] != n:
                raise ValueError(
                    f"best_indices has shape {best.shape}, expected ({n}, "
                    f"n_params) for unit {self.unit.key}"
                )
            self.best_indices = best

    def to_dict(self) -> dict:
        d = {
            "unit": self.unit.to_dict(),
            "final_values": [float(v) for v in self.final_values],
            "search_best_values": [float(v) for v in self.search_best_values],
            "n_samples_used": [int(v) for v in self.n_samples_used],
            "wall_s": float(self.wall_s),
            "stage_s": {k: float(v) for k, v in self.stage_s.items()},
            "counters": {k: float(v) for k, v in self.counters.items()},
        }
        if self.best_indices is not None:
            d["best_indices"] = self.best_indices.tolist()
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "UnitResult":
        best = d.get("best_indices")
        return cls(
            unit=ExperimentUnit.from_dict(d["unit"]),
            final_values=np.array(d["final_values"], dtype=np.float64),
            search_best_values=np.array(
                d["search_best_values"], dtype=np.float64
            ),
            n_samples_used=np.array(d["n_samples_used"], dtype=np.int64),
            wall_s=float(d.get("wall_s", 0.0)),
            stage_s={
                str(k): float(v) for k, v in d.get("stage_s", {}).items()
            },
            counters={
                str(k): float(v) for k, v in d.get("counters", {}).items()
            },
            best_indices=None if best is None else np.array(best, dtype=np.int64),
        )


def _concat_best(parts) -> np.ndarray | None:
    """Fragments' winners in order; ``None`` if any fragment lacks them."""
    parts = list(parts)
    if any(p is None for p in parts):
        return None
    return np.concatenate(parts)


def _sum_stage_s(weighted) -> dict[str, float]:
    """Weighted sum of per-stage breakdowns (fragment pro-rating)."""
    acc: dict[str, float] = {}
    for stage_s, frac in weighted:
        for k, v in stage_s.items():
            acc[k] = acc.get(k, 0.0) + float(v) * frac
    return acc


# ------------------------------------------------------------- decomposition


def build_units(
    cells: list[tuple[str, int, int]],
    *,
    min_units: int = 1,
    max_unit_experiments: int | None = None,
    cost=None,
) -> list[ExperimentUnit]:
    """Decompose ``(algo, sample_size, n_experiments)`` cells into units.

    Deterministic policy: start with one unit per cell (monolithic, exactly
    today's per-cell loop); if ``max_unit_experiments`` is set, chunk every
    cell to at most that many experiments per unit (checkpoint granularity
    for big-E rows); then, while there are fewer than ``min_units`` units,
    split the most expensive splittable unit at its experiment midpoint
    (first-in-order on ties), so a request for N workers produces at least N
    units whenever the matrix holds that many experiments — including a
    single-cell matrix.

    ``cost`` is the unit-duration predictor driving that split order — a
    pure function ``ExperimentUnit -> float`` (e.g. samples x the cost
    model's mean per-sample runtime, see
    :func:`repro_torch.costmodel.mean_runtime_estimate`).  It must be
    deterministic in the unit alone: the decomposition is part of the
    journaled plan, and two runs of the same spec must split identically.
    Without one, a unit's experiment count is its cost — the widest unit
    splits first.

    The returned order is canonical: cells in their given order, units by
    ascending ``exp_lo`` within each cell.
    """
    if cost is None:
        def cost(u):
            return u.n_unit_exp
    units: list[ExperimentUnit] = []
    for algo, s, e in cells:
        if e < 1:
            raise ValueError(f"cell ({algo}, {s}) has {e} experiments")
        step = e if max_unit_experiments is None else max(1, max_unit_experiments)
        for lo in range(0, e, step):
            units.append(
                ExperimentUnit(
                    algo=algo,
                    sample_size=s,
                    exp_lo=lo,
                    exp_hi=min(lo + step, e),
                    n_exp=e,
                )
            )
    while len(units) < min_units:
        best_i = -1
        best_cost = float("-inf")
        for i, u in enumerate(units):
            if u.n_unit_exp <= 1:
                continue  # single-experiment units cannot split further
            c = float(cost(u))
            if c > best_cost:
                best_i, best_cost = i, c
        if best_i < 0:
            break
        u = units[best_i]
        mid = u.exp_lo + u.n_unit_exp // 2
        units[best_i : best_i + 1] = [
            ExperimentUnit(u.algo, u.sample_size, u.exp_lo, mid, u.n_exp),
            ExperimentUnit(u.algo, u.sample_size, mid, u.exp_hi, u.n_exp),
        ]
    cell_order = {(algo, s): i for i, (algo, s, _) in enumerate(cells)}
    units.sort(key=lambda u: (cell_order[u.cell], u.exp_lo))
    return units


def merge_unit_results(
    cells: list[tuple[str, int, int]],
    results: list[UnitResult],
) -> tuple[list[CellResult], dict[tuple[str, int], dict[str, float]]]:
    """Fold unit fragments into full per-cell results, in ``cells`` order.

    Fragments merge deterministically by unit key regardless of the order an
    executor returned them in (a cell's ``best_indices`` is ``None`` if any
    of its fragments lacks them); every cell must be covered contiguously from
    0 to its experiment count or a ``ValueError`` names the gap.  Returns
    the cell results plus per-cell cost breakdowns ``{"wall_s", "compile_s",
    "measure_s"}`` (the sum of unit walls — aggregate *search cost*,
    meaningful even when units ran in parallel; ``compile_s`` charges the
    staged pipeline's screen + inputs + compile stages (the reference's
    screen + compile: it stages its inputs inside compile), ``measure_s``
    its timing stage — both 0.0 for unstaged backends).
    """
    by_key: dict[str, UnitResult] = {}
    for r in results:
        if r.unit.key in by_key:
            raise ValueError(f"duplicate unit result {r.unit.key!r}")
        by_key[r.unit.key] = r
    grouped: dict[tuple[str, int], list[UnitResult]] = {}
    for r in by_key.values():
        grouped.setdefault(r.unit.cell, []).append(r)
    out: list[CellResult] = []
    walls: dict[tuple[str, int], dict[str, float]] = {}
    for algo, s, e in cells:
        frags = sorted(grouped.get((algo, s), []), key=lambda r: r.unit.exp_lo)
        covered = 0
        for f in frags:
            if f.unit.exp_lo != covered or f.unit.n_exp != e:
                raise ValueError(
                    f"cell ({algo}, S={s}) has a unit-coverage gap at "
                    f"experiment {covered}: got {f.unit.key!r}"
                )
            covered = f.unit.exp_hi
        if covered != e:
            raise ValueError(
                f"cell ({algo}, S={s}) covered only {covered}/{e} experiments"
            )
        out.append(
            CellResult(
                algo=algo,
                sample_size=s,
                final_values=np.concatenate([f.final_values for f in frags]),
                search_best_values=np.concatenate(
                    [f.search_best_values for f in frags]
                ),
                n_samples_used=np.concatenate(
                    [f.n_samples_used for f in frags]
                ),
                best_indices=_concat_best(f.best_indices for f in frags),
            )
        )
        walls[(algo, s)] = {
            "wall_s": float(sum(f.wall_s for f in frags)),
            "compile_s": float(
                sum(
                    f.stage_s.get("screen", 0.0) + f.stage_s.get("inputs", 0.0)
                    + f.stage_s.get("compile", 0.0)
                    for f in frags
                )
            ),
            "measure_s": float(
                sum(f.stage_s.get("time", 0.0) for f in frags)
            ),
        }
    return out, walls


# ------------------------------------------------------------- checkpointing


class UnitJournal:
    """Completed-unit checkpoint journal over a measurement store's metadata.

    Entries live in the store's per-key string metadata side-channel (both
    the JSON and sqlite stores carry one) under
    ``__unit__|{namespace}|{unit.key}``, where the namespace binds the spec
    identity (cache key, root seed, final-repeats, dispatch).  The payload
    is the full :class:`UnitResult` as JSON, so a resumed matrix run
    rehydrates finished units without touching the measurement layer at all.

    ``put`` flushes the store — a journal that only exists in memory
    protects nothing from a kill — but throttled to once per
    ``min_flush_s`` seconds: the JSON store rewrites its whole file per
    flush, and a matrix of many cheap units would otherwise spend its
    wall-clock checkpointing.  The loss window on a kill is bounded by the
    throttle (and anything lost re-runs as pure measurement-cache hits);
    the caller's end-of-run ``save_store`` flushes the tail.
    """

    PREFIX = "__unit__"

    def __init__(self, store, namespace: str, min_flush_s: float = 5.0):
        if not hasattr(store, "put_meta") or not hasattr(store, "get_meta"):
            raise TypeError(
                f"store {type(store).__name__} has no metadata side-channel; "
                "unit journaling needs get_meta/put_meta"
            )
        self.store = store
        self.namespace = namespace
        self.min_flush_s = min_flush_s
        self._last_flush = float("-inf")   # first put always flushes

    def key(self, unit: ExperimentUnit) -> str:
        return f"{self.PREFIX}|{self.namespace}|{unit.key}"

    def get(self, unit: ExperimentUnit) -> UnitResult | None:
        raw = self.store.get_meta(self.key(unit))
        if raw is None:
            return None
        try:
            payload = json.loads(raw)
        except json.JSONDecodeError:
            return None  # a corrupt entry degrades to a re-run, never a crash
        if payload.get("unit") != unit.to_dict():
            return None
        return UnitResult.from_dict(payload)

    def put(self, result: UnitResult) -> None:
        self.store.put_meta(self.key(result.unit), json.dumps(result.to_dict()))
        now = monotonic()
        if now - self._last_flush >= self.min_flush_s:
            self.store.save()
            self._last_flush = now

    def _cell_fragments(self, unit: ExperimentUnit) -> list[UnitResult]:
        """Every journaled fragment of ``unit``'s cell (any range)."""
        if not hasattr(self.store, "meta_items"):
            return []
        prefix = (
            f"{self.PREFIX}|{self.namespace}|"
            f"{unit.algo}/S{unit.sample_size}/E{unit.n_exp}/e"
        )
        out = []
        for _, raw in self.store.meta_items(prefix=prefix):
            try:
                r = UnitResult.from_dict(json.loads(raw))
            except (json.JSONDecodeError, KeyError, ValueError, TypeError):
                continue
            if r.unit.cell == unit.cell and r.unit.n_exp == unit.n_exp:
                out.append(r)
        return out

    def cover(self, unit: ExperimentUnit) -> UnitResult | None:
        """The journaled result for ``unit`` — exact, or assembled from
        fragments journaled under DIFFERENT unit boundaries (a run resumed
        with a different ``max_workers`` re-splits its cells; per-experiment
        results are positional, so fragments slice and concatenate).
        ``wall_s`` and ``stage_s`` of partially-used fragments are
        pro-rated."""
        exact = self.get(unit)
        if exact is not None:
            return exact
        frags = self._cell_fragments(unit)
        if not frags:
            return None
        pieces: list[tuple[UnitResult, slice, float]] = []
        p = unit.exp_lo
        while p < unit.exp_hi:
            best = None
            for f in frags:
                if f.unit.exp_lo <= p < f.unit.exp_hi and (
                    best is None or f.unit.exp_hi > best.unit.exp_hi
                ):
                    best = f
            if best is None:
                return None
            hi = min(best.unit.exp_hi, unit.exp_hi)
            sl = slice(p - best.unit.exp_lo, hi - best.unit.exp_lo)
            pieces.append((best, sl, (hi - p) / best.unit.n_unit_exp))
            p = hi
        return UnitResult(
            unit=unit,
            final_values=np.concatenate(
                [b.final_values[s] for b, s, _ in pieces]
            ),
            search_best_values=np.concatenate(
                [b.search_best_values[s] for b, s, _ in pieces]
            ),
            n_samples_used=np.concatenate(
                [b.n_samples_used[s] for b, s, _ in pieces]
            ),
            wall_s=float(sum(b.wall_s * frac for b, _, frac in pieces)),
            stage_s=_sum_stage_s(
                (b.stage_s, frac) for b, _, frac in pieces
            ),
            counters=_sum_stage_s(
                (b.counters, frac) for b, _, frac in pieces
            ),
            best_indices=_concat_best(
                None if b.best_indices is None else b.best_indices[s]
                for b, s, _ in pieces
            ),
        )

    def partition(
        self, units: list[ExperimentUnit]
    ) -> tuple[list[UnitResult], list[ExperimentUnit]]:
        """Split ``units`` into (journaled results, still-pending units)."""
        done: list[UnitResult] = []
        pending: list[ExperimentUnit] = []
        for u in units:
            r = self.cover(u)
            (done.append(r) if r is not None else pending.append(u))
        return done, pending

    def entries(self) -> list[str]:
        """All journal keys in this namespace (diagnostics)."""
        prefix = f"{self.PREFIX}|{self.namespace}|"
        if not hasattr(self.store, "meta_items"):
            return []
        return sorted(
            k for k, _ in self.store.meta_items(prefix=prefix)
        )
