"""The public tuning facade: ``repro_torch.tune(spec)`` and
``repro_torch.tune_matrix(spec)`` (a port of ``repro.core.api``).

* :class:`TuningSpec` — a frozen, JSON-serializable description of a tuning
  run: kernel id, search space, searcher name + kwargs, measurement backend
  name + kwargs (resolved via :mod:`repro_torch.core.backends`), a sample
  budget or an :class:`~repro_torch.core.experiment.ExperimentDesign`, seed,
  and store settings.
* :class:`TuningSession` — the object that owns evaluation: it runs the
  ask/tell loop through the engine's ``drive``, re-measures winners per the
  paper's final-repeats protocol, and runs full experiment matrices.  Matrix
  runs decompose into serializable
  :class:`~repro_torch.core.workunits.ExperimentUnit` work units executed
  through the ``EXECUTORS`` registry (``serial`` / ``process`` / ``futures``
  / ``device``), with completed units journaled through the measurement
  store for ``resume=True``.  Experiment seeds derive from the spec alone,
  so every executor — and every split of a cell into units — is
  bit-identical to the serial loop.
* :class:`RunRecord` — a versioned JSON record (spec + result summary +
  provenance, including the backend's: device, timer, build).

Example::

    import repro_torch
    from repro_torch import ExperimentDesign, TuningSpec

    result = repro_torch.tune(TuningSpec(kernel="harris", backend="cuda", budget=100))
    print(result.best_config, result.final_value)

    matrix = repro_torch.tune_matrix(
        TuningSpec(kernel="harris", backend="cuda", algorithms=("rs", "ga"),
                   design=ExperimentDesign(sample_sizes=(25, 50), n_experiments=(4, 2))),
        executor="device",
    )
"""

from __future__ import annotations

import json
import os
import platform
import socket
import warnings
from dataclasses import dataclass, field, replace
from datetime import datetime, timezone
from typing import Callable

import numpy as np
import torch

from .backends import BACKENDS, make_measurement
from .clock import monotonic
from .dataset import SampleDataset
from .engine import DISPATCH_MODES, DiskCachedMeasurement, drive
from .executors import EXECUTORS, ExecutionPlan, recover_shard_stores, run_units
from .experiment import ExperimentDesign
from .measurement import BaseMeasurement
from .runner import CellResult, MatrixResults, stable_seed
from .searchers import SEARCHERS, make_searcher
from .searchers.base import TuningResult
from .space import Config, Param, SearchSpace, _paper_wg256
from .stores import STORES, make_store
from .surrogates.forest_batched import BatchedForest
from .workunits import (
    ExperimentUnit,
    UnitJournal,
    UnitResult,
    build_units,
    merge_unit_results,
)

SPEC_VERSION = 1
RUN_RECORD_VERSION = 1

#: units per worker the stealing scheduler aims for — enough queue slack to
#: rebalance around a straggler cell without shrinking units so far that
#: per-unit dispatch overhead dominates
STEAL_OVERSPLIT = 4

__all__ = [
    "RUN_RECORD_VERSION",
    "SPEC_VERSION",
    "RunRecord",
    "TuningSession",
    "TuningSpec",
    "register_constraint",
    "tune",
    "tune_matrix",
]


# ------------------------------------------------------- space serialization

#: named constraints a serialized spec can refer to
CONSTRAINTS: dict[str, Callable[[Config], bool]] = {
    "paper_wg256": _paper_wg256,
}


def register_constraint(name: str, fn: Callable[[Config], bool]):
    """Register a constraint predicate under a stable id so spaces using it
    survive TuningSpec JSON round-trips."""
    fn.constraint_id = name
    CONSTRAINTS[name] = fn
    return fn


def _resolve_constraint(cid: str | None) -> Callable[[Config], bool] | None:
    if cid is None:
        return None
    if cid in CONSTRAINTS:
        return CONSTRAINTS[cid]
    if cid.startswith("vmem:"):
        from ..costmodel import CHIPS, WORKLOADS, is_executable

        _, kernel, chip = cid.split(":")
        w, c = WORKLOADS[kernel], CHIPS[chip]

        def fn(cfg: Config) -> bool:
            return is_executable(w, c, cfg)

        fn.constraint_id = cid
        return fn
    if cid.startswith("cuda_fit:"):
        # cuda_fit:<kernel>:<x>:<y>:<smem_limit>:<max_grid> — the measurement
        # backend's validity pre-screen as a named constraint; the limits are
        # the card's fixed figures, so an id naming others cannot be rebuilt
        from ..cuda_bench import fit_constraint, make_workload

        _, kernel, x, y, *_limits = cid.split(":")
        fn = fit_constraint(make_workload(kernel, x=int(x), y=int(y)))
        if fn.constraint_id != cid:
            raise KeyError(f"constraint {cid!r} names other limits than "
                           f"{fn.constraint_id!r}")
        return fn
    raise KeyError(
        f"unknown constraint id {cid!r}; register it with "
        f"repro_torch.core.api.register_constraint(name, fn)"
    )


def space_to_dict(space: SearchSpace) -> dict:
    cid = getattr(space.constraint, "constraint_id", None)
    if space.constraint is not None and cid is None:
        raise ValueError(
            "SearchSpace constraint is not serializable: give the predicate a "
            "stable id via register_constraint(name, fn), or leave "
            "TuningSpec.space=None so the backend derives the space"
        )
    return {
        "params": [{"name": p.name, "values": list(p.values)} for p in space.params],
        "constraint": cid,
    }


def space_from_dict(d: dict) -> SearchSpace:
    params = [Param(p["name"], tuple(p["values"])) for p in d["params"]]
    return SearchSpace(params, constraint=_resolve_constraint(d.get("constraint")))


# ---------------------------------------------------------------- TuningSpec


@dataclass(frozen=True)
class TuningSpec:
    """Declarative description of a tuning run (frozen, JSON-serializable).

    ``budget`` drives a single :func:`tune`; ``design`` (+ ``algorithms``)
    drives a :func:`tune_matrix`.  ``space=None`` derives the search space
    from the backend (the cuda backend yields the paper's space constrained
    by ``cuda_fit``, the costmodel backend the executable configs for
    ``kernel`` x ``chip``).  ``store``/``store_path`` select the persistent
    measurement cache.  ``searcher_kwargs`` apply to the named ``searcher``
    only — other algorithms on a matrix axis run with their own defaults.
    ``dataset_size`` serves the matrix's ``rs`` and ``rf`` experiments from
    one pre-measured sample dataset (paper section VI.B), cached at
    ``dataset_cache`` when given.
    """

    kernel: str
    searcher: str = "ga"
    searcher_kwargs: dict = field(default_factory=dict)
    backend: str = "cuda"
    backend_kwargs: dict = field(default_factory=dict)
    space: SearchSpace | None = None
    budget: int | None = None
    design: ExperimentDesign | None = None
    algorithms: tuple[str, ...] | None = None
    seed: int = 0
    dispatch: str = "batch"
    final_repeats: int = 10
    store: str | None = None
    store_path: str | None = None
    cache_key: str | None = None
    dataset_size: int | None = None
    dataset_seed: int = 7
    dataset_gen_seed: int = 999
    dataset_cache: str | None = None

    def __post_init__(self):
        if not self.kernel or not isinstance(self.kernel, str):
            raise ValueError("TuningSpec.kernel must be a non-empty string id")
        if self.searcher not in SEARCHERS:
            raise KeyError(
                f"unknown searcher {self.searcher!r}; have {sorted(SEARCHERS)}"
            )
        if self.backend not in BACKENDS:
            raise KeyError(
                f"unknown backend {self.backend!r}; have {sorted(BACKENDS)}"
            )
        if self.dispatch not in DISPATCH_MODES:
            raise ValueError(f"dispatch must be one of {DISPATCH_MODES}")
        if self.store is not None and self.store not in STORES:
            raise KeyError(f"unknown store {self.store!r}; have {sorted(STORES)}")
        if self.budget is not None and self.budget < 1:
            raise ValueError("budget must be >= 1")
        if isinstance(self.design, dict):
            object.__setattr__(self, "design", ExperimentDesign.from_dict(self.design))
        if self.algorithms is not None:
            algos = tuple(self.algorithms)
            unknown = [a for a in algos if a not in SEARCHERS]
            if unknown:
                raise KeyError(f"unknown algorithms {unknown}; have {sorted(SEARCHERS)}")
            object.__setattr__(self, "algorithms", algos)
        object.__setattr__(self, "searcher_kwargs", dict(self.searcher_kwargs))
        object.__setattr__(self, "backend_kwargs", dict(self.backend_kwargs))

    # -- derived --------------------------------------------------------------
    @property
    def matrix_algorithms(self) -> tuple[str, ...]:
        return self.algorithms if self.algorithms is not None else (self.searcher,)

    def default_cache_key(self) -> str:
        """Store namespace: kernel, backend and every backend kwarg that
        changes what a measurement MEANS (problem size, repeats, device...).
        Non-scalar kwargs collapse to a type token.  The reference's speed
        knobs change how fast measurements happen, never what they are, so
        they stay out, as they do in the reference."""
        kwargs = {
            k: v
            for k, v in self.backend_kwargs.items()
            if k not in ("pipeline_workers", "compile_cache")
        }
        # the common costmodel case keeps the reference's compact form
        if set(kwargs) == {"chip"}:
            return f"{self.kernel}/{kwargs['chip']}"
        if kwargs:
            def stable(v):
                return v if isinstance(v, (str, int, float, bool, type(None))) \
                    else f"<{type(v).__name__}>"

            kw = ",".join(f"{k}={stable(kwargs[k])}" for k in sorted(kwargs))
            return f"{self.kernel}/{self.backend}/{kw}"
        return f"{self.kernel}/{self.backend}"

    def replace(self, **changes) -> "TuningSpec":
        return replace(self, **changes)

    # -- serialization --------------------------------------------------------
    def to_dict(self) -> dict:
        return {
            "spec_version": SPEC_VERSION,
            "kernel": self.kernel,
            "searcher": self.searcher,
            "searcher_kwargs": dict(self.searcher_kwargs),
            "backend": self.backend,
            "backend_kwargs": dict(self.backend_kwargs),
            "space": None if self.space is None else space_to_dict(self.space),
            "budget": self.budget,
            "design": None if self.design is None else self.design.to_dict(),
            "algorithms": None if self.algorithms is None else list(self.algorithms),
            "seed": self.seed,
            "dispatch": self.dispatch,
            "final_repeats": self.final_repeats,
            "store": self.store,
            "store_path": self.store_path,
            "cache_key": self.cache_key,
            "dataset_size": self.dataset_size,
            "dataset_seed": self.dataset_seed,
            "dataset_gen_seed": self.dataset_gen_seed,
            "dataset_cache": self.dataset_cache,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "TuningSpec":
        d = dict(d)
        version = d.pop("spec_version", SPEC_VERSION)
        if version > SPEC_VERSION:
            raise ValueError(
                f"spec_version {version} is newer than supported {SPEC_VERSION}"
            )
        if d.get("space") is not None:
            d["space"] = space_from_dict(d["space"])
        if d.get("design") is not None:
            d["design"] = ExperimentDesign.from_dict(d["design"])
        if d.get("algorithms") is not None:
            d["algorithms"] = tuple(d["algorithms"])
        return cls(**d)

    def to_json(self, **kwargs) -> str:
        try:
            return json.dumps(self.to_dict(), **kwargs)
        except TypeError as e:
            raise TypeError(
                f"TuningSpec is not JSON-serializable ({e}). Backends wired "
                "with in-process callables cannot be serialized or sharded — "
                "name the backend and pass plain kwargs instead."
            ) from e

    @classmethod
    def from_json(cls, s: str) -> "TuningSpec":
        return cls.from_dict(json.loads(s))


# ----------------------------------------------------------------- RunRecord


def _provenance(wall_s: float | None = None) -> dict:
    p = {
        # a provenance timestamp SHOULD be the real wall clock; results never
        # read it back
        "created_at": datetime.now(timezone.utc).isoformat(  # repro: allow[DET001]
            timespec="seconds"
        ),
        "hostname": socket.gethostname(),
        "platform": platform.platform(),
        "python": platform.python_version(),
        "numpy": np.__version__,
        "torch": torch.__version__,
    }
    if wall_s is not None:
        p["wall_s"] = round(float(wall_s), 3)
    return p


@dataclass
class RunRecord:
    """Versioned provenance record of one run: the spec, a JSON summary of
    the result (the best config, final value and raw final repeats of a
    single run; per-cell medians of a matrix, plus ``artifact``, the
    relative path of the full ``.npz`` when one was saved), and how the
    numbers were produced (``extra["backend_provenance"]``; a matrix also
    carries ``extra["cell_wall_s"]``)."""

    kind: str                      # "tune" | "tune_matrix"
    spec: dict
    result: dict
    provenance: dict
    extra: dict = field(default_factory=dict)
    version: int = RUN_RECORD_VERSION

    def to_dict(self) -> dict:
        return {
            "run_record_version": self.version,
            "kind": self.kind,
            "spec": self.spec,
            "result": self.result,
            "provenance": self.provenance,
            "extra": self.extra,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "RunRecord":
        return cls(
            kind=d["kind"],
            spec=d["spec"],
            result=d["result"],
            provenance=d.get("provenance", {}),
            extra=d.get("extra", {}),
            version=d.get("run_record_version", RUN_RECORD_VERSION),
        )

    def save(self, path: str) -> None:
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2)

    @classmethod
    def load(cls, path: str) -> "RunRecord":
        with open(path) as f:
            return cls.from_dict(json.load(f))


# -------------------------------------------------------------- TuningSession


class TuningSession:
    """Drives tuning runs described by a :class:`TuningSpec`.

    The session owns evaluation end to end: it builds searchers and
    measurement backends from the registries, drives the ask/tell loop,
    wraps measurements in the persistent store when configured, re-measures
    winners per the paper's final-repeats protocol, and — for matrix runs —
    decomposes the matrix into work units executed through the
    ``EXECUTORS`` registry (:meth:`run_matrix` with ``executor=...`` /
    ``max_workers=N``; ``shards=N`` is the legacy spelling of the process
    executor).

    Keyword overrides (``space`` / ``measurement_factory`` / ``dataset`` /
    ``store``) exist for in-process callers that hold live objects; a
    session with overrides only runs under the ``serial`` executor because
    parallel workers rebuild everything from the serialized spec.
    """

    def __init__(
        self,
        spec: TuningSpec,
        *,
        space: SearchSpace | None = None,
        measurement_factory: Callable[[int], BaseMeasurement] | None = None,
        dataset: SampleDataset | None = None,
        store=None,
        store_path: str | None = None,
        verbose: bool = False,
    ):
        if not isinstance(spec, TuningSpec):
            raise TypeError(f"spec must be a TuningSpec, got {type(spec).__name__}")
        self.spec = spec
        self.verbose = verbose
        self._backend = BACKENDS[spec.backend]
        self._has_overrides = any(
            x is not None for x in (space, measurement_factory, dataset, store)
        )
        self.space = space if space is not None else spec.space
        if self.space is None and self._backend.default_space is not None:
            self.space = self._backend.default_space(
                kernel=spec.kernel, **spec.backend_kwargs
            )
        if self.space is None:
            raise ValueError(
                f"backend {spec.backend!r} has no default space; set "
                "TuningSpec.space explicitly"
            )
        self._factory = measurement_factory or (
            lambda s: make_measurement(
                self.spec.backend,
                kernel=self.spec.kernel,
                seed=s,
                **self.spec.backend_kwargs,
            )
        )
        self._store_path = store_path if store_path is not None else spec.store_path
        if store is not None:
            self.store = store
        elif spec.store is not None:
            self.store = make_store(spec.store, self._store_path)
        else:
            self.store = None
        self.cache_key = spec.cache_key or spec.default_cache_key()
        self._dataset = dataset
        self.measurement: BaseMeasurement | None = None  # last single-run backend
        self.last_record: RunRecord | None = None
        self.last_unit_plan: list[ExperimentUnit] = []
        self._last_cell_walls: dict[tuple[str, int], dict[str, float]] = {}

    # -- wiring ---------------------------------------------------------------
    def _make_measurement(self, exp_seed: int) -> BaseMeasurement:
        m = self._factory(exp_seed)
        if self.store is not None:
            m = DiskCachedMeasurement(
                m, self.store, prefix=f"{self.cache_key}/seed={exp_seed}"
            )
        return m

    def _get_dataset(self) -> SampleDataset | None:
        """The matrix's sample dataset, measured through the raw factory (not
        the store): a warm replay measures it again unless
        ``spec.dataset_cache`` holds it."""
        if self._dataset is None and self.spec.dataset_size:
            self._dataset = SampleDataset.generate(
                self.space,
                self._factory(self.spec.dataset_gen_seed),
                n=self.spec.dataset_size,
                seed=self.spec.dataset_seed,
                cache_path=self.spec.dataset_cache,
            )
        return self._dataset

    def save_store(self) -> None:
        if self.store is not None:
            self.store.save()

    # -- single run -----------------------------------------------------------
    def run(self) -> TuningResult:
        """One budgeted search + the paper's final re-measurement."""
        spec = self.spec
        if spec.budget is None:
            raise ValueError("TuningSpec.budget is required for tune(); "
                             "use tune_matrix() for design-driven runs")
        t0 = monotonic()
        searcher = make_searcher(
            spec.searcher, self.space, seed=spec.seed, **spec.searcher_kwargs
        )
        measurement = self.measurement = self._make_measurement(spec.seed)
        result = drive(searcher, measurement, spec.budget, dispatch=spec.dispatch)
        result.final_value = measurement.measure_final(
            result.best_config, spec.final_repeats
        )
        self.save_store()
        res = {
            "best_config": result.best_config,
            "best_value": result.best_value,
            "final_value": result.final_value,
            "n_samples": result.n_samples,
        }
        reason = measurement.reason_for(result.best_config)
        if reason is not None:
            res["invalid_reason"] = reason
        repeats = measurement.repeats_for(result.best_config)
        if repeats is not None:
            # raw per-repeat seconds behind final_value's median
            res["final_repeat_times"] = [float(v) for v in repeats]
        self.last_record = RunRecord(
            kind="tune",
            spec=self._spec_dict_or_repr(),
            result=res,
            provenance=_provenance(monotonic() - t0),
            extra=self._backend_extra(measurement),
        )
        return result

    def _backend_extra(self, measurement: BaseMeasurement | None) -> dict:
        """Backend provenance (device, timer, build, repeats...) for the run
        record — how the numbers were produced."""
        prov = measurement.provenance() if measurement is not None else {}
        return {"backend_provenance": prov} if prov else {}

    # -- matrix runs ----------------------------------------------------------
    def cells(self) -> list[tuple[str, int, int]]:
        """Canonical cell order: ``(algo, sample_size, n_experiments)``."""
        if self.spec.design is None:
            raise ValueError("TuningSpec.design is required for matrix runs")
        return [
            (algo, s, e)
            for algo in self.spec.matrix_algorithms
            for s, e in self.spec.design.rows()
        ]

    def run_matrix(
        self,
        shards: int = 1,
        *,
        executor: str | None = None,
        max_workers: int | None = None,
        resume: bool = False,
        unit_experiments: int | None = None,
        futures_pool=None,
        pipeline_workers: int | None = None,
        scheduler: str = "steal",
        compile_cache: str | None = None,
    ) -> MatrixResults:
        """Run the experiment matrix through the executor layer.

        The matrix decomposes into :class:`ExperimentUnit` work units —
        whole cells by default, within-cell experiment ranges when
        ``max_workers`` exceeds the cell count or ``unit_experiments`` caps
        the unit size — executed through ``EXECUTORS[executor]`` and merged
        deterministically by unit key, so every executor (and every split)
        is bit-identical to the serial loop.

        ``shards=N`` is the legacy spelling of ``executor="process",
        max_workers=N``.  ``resume=True`` replays completed units from the
        store's unit journal (zero re-measurements) and first absorbs any
        shard stores a killed parallel run left behind.  ``scheduler``
        picks how parallel executors hand units to workers: ``"steal"``
        (default) over-splits cells by predicted duration and lets workers
        pull units from a shared queue; ``"static"`` is the
        one-partition-per-worker schedule.  ``pipeline_workers`` and
        ``compile_cache`` are the reference's speed knobs for staged
        backends (``Backend.pipeline``); no port backend has them yet, so
        they raise ``ValueError``.
        """
        t0 = monotonic()
        if scheduler not in ("steal", "static"):
            raise ValueError(
                f"unknown scheduler {scheduler!r}; use 'steal' or 'static'"
            )
        if pipeline_workers is not None:
            if not self._backend.pipeline:
                raise ValueError(
                    f"backend {self.spec.backend!r} has no compile pipeline; "
                    "pipeline_workers applies to staged backends only "
                    "(BACKENDS[...].pipeline)"
                )
            self.spec = self.spec.replace(
                backend_kwargs={
                    **self.spec.backend_kwargs,
                    "pipeline_workers": int(pipeline_workers),
                }
            )
        if compile_cache is not None:
            if not self._backend.pipeline:
                raise ValueError(
                    f"backend {self.spec.backend!r} has no compile stage; "
                    "compile_cache applies to staged backends only "
                    "(BACKENDS[...].pipeline)"
                )
            self.spec = self.spec.replace(
                backend_kwargs={
                    **self.spec.backend_kwargs,
                    "compile_cache": os.path.abspath(compile_cache),
                }
            )
        cells = self.cells()
        name = executor
        if name is None:
            name = "futures" if futures_pool is not None else None
        if futures_pool is not None and name != "futures":
            raise ValueError(
                f"futures_pool only applies to executor='futures', not {name!r}"
            )
        if max_workers is None and futures_pool is not None:
            # a supplied pool IS the parallelism request; size from the pool
            max_workers = getattr(futures_pool, "_max_workers", None) or 2
        workers = int(max_workers if max_workers is not None else shards)
        if workers < 1:
            raise ValueError("max_workers must be >= 1")
        if name is None:
            name = "process" if workers > 1 else "serial"
        if name not in EXECUTORS:
            raise KeyError(f"unknown executor {name!r}; have {sorted(EXECUTORS)}")
        # the stealing scheduler wants more units than workers so the queue
        # can rebalance around stragglers; the static schedule keeps the
        # one-unit-per-worker floor
        oversplit = (
            STEAL_OVERSPLIT
            if scheduler == "steal" and EXECUTORS[name].parallel and workers > 1
            else 1
        )
        units = build_units(
            cells,
            min_units=(workers * oversplit) if EXECUTORS[name].parallel else 1,
            max_unit_experiments=unit_experiments,
            cost=self._unit_cost(),
        )
        self.last_unit_plan = units
        journal = self.unit_journal()
        if resume and journal is None:
            warnings.warn(
                "resume=True needs a spec-described persistent store "
                "(TuningSpec.store, no in-process overrides); running "
                "everything fresh"
            )
        done: list[UnitResult] = []
        pending = units
        if resume and journal is not None:
            recover_shard_stores(self)
            done, pending = journal.partition(units)
            if self.verbose and done:
                print(
                    f"[session] resume: {len(done)}/{len(units)} units served "
                    "from the journal"
                )
        fresh: list[UnitResult] = []
        if pending:
            run_name = name
            if EXECUTORS[name].parallel and (workers <= 1 or len(pending) <= 1):
                if workers > 1:
                    warnings.warn(
                        f"executor {name!r} degrades to serial: only "
                        f"{len(pending)} pending unit(s) for {workers} workers"
                    )
                run_name = "serial"
            plan = ExecutionPlan(
                session=self,
                units=pending,
                max_workers=min(workers, len(pending)),
                futures_pool=futures_pool,
                scheduler=scheduler,
            )
            fresh = run_units(run_name, plan)
        cell_results, self._last_cell_walls = merge_unit_results(
            cells, done + fresh
        )
        results = MatrixResults()
        for cell in cell_results:
            results.add(cell)
        self.save_store()
        self.last_record = self.make_record(results, wall_s=monotonic() - t0)
        return results

    # -- the work-unit layer --------------------------------------------------
    def _unit_cost(self) -> Callable[[ExperimentUnit], float]:
        """Predicted unit duration driving the stealing scheduler's initial
        split: experiments x samples, scaled by the cost model's mean
        per-measurement runtime for this spec's kernel/chip (``v5e`` when
        the spec names no chip, as for the cuda backend).  A scheduling
        weight only, never a reported time: it MUST be a pure deterministic
        function of the unit, because the decomposition is part of the
        journaled plan, and it gives the reference's unit plans.  Unknown
        kernels (a ``callable`` objective) weigh each sample 1.0."""
        from ..costmodel import CHIPS, WORKLOADS, mean_runtime_estimate

        try:
            workload = WORKLOADS[self.spec.kernel]
            chip = CHIPS[self.spec.backend_kwargs.get("chip", "v5e")]
        except (KeyError, TypeError):   # an unknown kernel or chip
            per_measure = 1.0
        else:
            per_measure = float(mean_runtime_estimate(workload, chip))

        def cost(u: ExperimentUnit) -> float:
            return float(u.n_unit_exp) * float(u.sample_size) * per_measure

        return cost

    def journal_namespace(self) -> str | None:
        """Binds unit-journal entries to everything that changes a unit's
        numbers: the cache key plus a fingerprint of the FULL spec minus the
        storage fields — pointing the same experiment at a different store
        must not orphan its journal, but changing anything that alters a
        result must.  ``None`` for specs with no stable fingerprint (live
        callables stringify with memory addresses)."""
        d = dict(self._spec_dict_or_repr())
        for k in ("store", "store_path"):
            d.pop(k, None)
        if isinstance(d.get("backend_kwargs"), dict):
            # speed knobs change execution speed, never results
            bk = dict(d["backend_kwargs"])
            bk.pop("pipeline_workers", None)
            bk.pop("compile_cache", None)
            d["backend_kwargs"] = bk
        try:
            fp = stable_seed(json.dumps(d, sort_keys=True))
        except (TypeError, ValueError):
            return None
        return f"{self.cache_key}|{fp:08x}"

    def unit_journal(self) -> UnitJournal | None:
        # sessions with live in-process overrides are not spec-described, so
        # a journal entry's validity could never be re-established on resume
        if self.store is None or self._has_overrides:
            return None
        ns = self.journal_namespace()
        if ns is None:
            return None
        return UnitJournal(self.store, ns)

    def run_cell(self, algo: str, sample_size: int, n_exp: int) -> CellResult:
        """All experiments of one (algorithm, sample-size) cell — one
        whole-cell unit through :meth:`run_unit`."""
        unit = ExperimentUnit(
            algo=algo, sample_size=sample_size, exp_lo=0, exp_hi=n_exp,
            n_exp=n_exp,
        )
        r = self.run_unit(unit)
        return CellResult(
            algo=algo,
            sample_size=sample_size,
            final_values=r.final_values,
            search_best_values=r.search_best_values,
            n_samples_used=r.n_samples_used,
        )

    def run_unit(self, unit: ExperimentUnit) -> UnitResult:
        """Experiments ``[unit.exp_lo, unit.exp_hi)`` of one cell.

        Experiment seeds derive from ``(spec.seed, algo, sample_size, e)``
        with the GLOBAL experiment index ``e``, so any process can run any
        unit — and any split of a cell into units — and get results
        bit-identical to the monolithic per-cell loop.  Each experiment
        builds a fresh measurement (on the card: inputs drawn and copied
        anew, as the reference materialises them per measurement).
        """
        spec = self.spec
        t0 = monotonic()
        dataset = self._get_dataset()
        n = unit.n_unit_exp
        finals = np.empty(n)
        search_best = np.empty(n)
        n_used = np.empty(n, dtype=np.int64)
        rf_batch = (
            self._rf_unit_batched(unit)
            if (dataset is not None and unit.algo == "rf")
            else None
        )
        stage_acc: dict[str, float] = {}
        for i, e in enumerate(range(unit.exp_lo, unit.exp_hi)):
            exp_seed = stable_seed(spec.seed, unit.algo, unit.sample_size, e)
            measurement = self.measurement = self._make_measurement(exp_seed)
            if rf_batch is not None:
                tr = rf_batch[i]
            elif dataset is not None and unit.algo == "rs":
                tr = self._rs_from_dataset(e, unit.sample_size)
            else:
                # searcher_kwargs belong to the spec's named searcher; other
                # algorithms on the matrix axis use their own defaults
                kwargs = spec.searcher_kwargs if unit.algo == spec.searcher else {}
                searcher = make_searcher(
                    unit.algo, self.space, seed=exp_seed, **kwargs
                )
                tr = searcher.run(
                    measurement, unit.sample_size, dispatch=spec.dispatch
                )
            finals[i] = measurement.measure_final(
                tr.best_config, spec.design.final_repeats
            )
            search_best[i] = tr.best_value
            n_used[i] = tr.n_samples
            # staged backends (cuda) report per-stage clocks; unstaged ones
            # report {} and the unit carries no breakdown
            for k, v in measurement.stage_times().items():
                stage_acc[k] = stage_acc.get(k, 0.0) + float(v)
        wall = monotonic() - t0
        if self.verbose:
            print(
                f"[session] {unit.algo:7s} S={unit.sample_size:4d} "
                f"e[{unit.exp_lo}:{unit.exp_hi})/{unit.n_exp:4d} "
                f"median={np.median(finals):.6g} best={finals.min():.6g} "
                f"wall={wall:.2f}s"
            )
        return UnitResult(
            unit=unit,
            final_values=finals,
            search_best_values=search_best,
            n_samples_used=n_used,
            wall_s=wall,
            stage_s=stage_acc,
        )

    # -- dataset-served paths (paper section VI.B) ---------------------------
    def _rs_from_dataset(self, experiment: int, budget: int) -> TuningResult:
        dataset = self._get_dataset()
        idx, vals = dataset.chunk(experiment, budget)
        j = int(np.argmin(vals))
        return TuningResult(
            algo="rs",
            best_config=self.space.decode(idx[j]),
            best_value=float(vals[j]),
            history_values=list(vals),
            history_configs=[],
            n_samples=budget,
        )

    def _rf_unit_batched(self, unit: ExperimentUnit, rf_pool: int = 2048
                         ) -> list[TuningResult]:
        """The unit's RF experiments, fit in ONE vectorized histogram-forest
        pass.  Per experiment, as the paper: train on a disjoint S-10 dataset
        chunk, measure the model's top-10 predictions over a candidate pool,
        keep the best prediction.

        Bootstrap draws come from the FULL cell's stream (one
        ``(E_total * trees, n_train)`` draw from ``spec.seed``), sliced to
        this unit's rows — experiment ``e`` resamples identically however
        the cell is split.
        """
        spec = self.spec
        dataset = self._get_dataset()
        sample_size = unit.sample_size
        top_k = min(10, max(1, sample_size // 2))
        n_train = sample_size - top_k
        chunks = [dataset.chunk(e, n_train) for e in range(unit.exp_lo, unit.exp_hi)]
        Xc = np.stack([c[0] for c in chunks])
        yc = np.stack([c[1] for c in chunks])
        n_trees = 100
        # bounded `integers` draws consume the stream sequentially with
        # data-dependent rejection, so rows can be skipped only by generating
        # everything before them; the prefix up to exp_hi suffices
        boot = np.random.default_rng(spec.seed).integers(
            0, n_train, size=(unit.exp_hi * n_trees, n_train)
        )
        forest = BatchedForest(
            self.space.cardinalities, n_estimators=n_trees, seed=spec.seed
        )
        forest.fit(Xc, yc, bootstrap_idx=boot[unit.exp_lo * n_trees :])
        pool_rng = np.random.default_rng(spec.seed + 7)
        pool = self.space.sample_indices(pool_rng, rf_pool)
        preds = forest.predict(pool)                    # (unit E, P)
        results = []
        for i, e in enumerate(range(unit.exp_lo, unit.exp_hi)):
            exp_seed = stable_seed(spec.seed, "rf", sample_size, e)
            measurement = self._make_measurement(exp_seed)
            best = np.argsort(preds[i], kind="stable")[:top_k]
            run_vals = measurement.measure_batch(self.space.decode_batch(pool[best]))
            j = int(np.argmin(run_vals))
            results.append(
                TuningResult(
                    algo="rf",
                    best_config=self.space.decode(pool[best][j]),
                    best_value=float(run_vals[j]),
                    history_values=list(yc[i]) + list(run_vals),
                    history_configs=[],
                    n_samples=sample_size,
                )
            )
        return results

    # -- records --------------------------------------------------------------
    def _spec_dict_or_repr(self) -> dict:
        try:
            return self.spec.to_dict()
        except (TypeError, ValueError):
            return {"repr": repr(self.spec)}

    def make_record(
        self,
        results: MatrixResults,
        wall_s: float | None = None,
        artifact: str | None = None,
        extra: dict | None = None,
        with_optimum: bool = False,
    ) -> RunRecord:
        result = {
            "best_observed": float(results.optimum),
            "cells": [
                {
                    "algo": algo,
                    "sample_size": s,
                    "n_experiments": int(len(cell.final_values)),
                    "median_final": float(np.median(cell.final_values)),
                    "best_final": float(cell.final_values.min()),
                }
                for (algo, s), cell in sorted(results.cells.items())
            ],
        }
        if artifact is not None:
            result["artifact"] = artifact
        if (
            with_optimum
            and self._backend.true_optimum is not None
            and not self._has_overrides
        ):
            cfg, opt = self._backend.true_optimum(
                kernel=self.spec.kernel, **self.spec.backend_kwargs
            )
            result["true_optimum"] = float(opt)
            result["true_optimum_config"] = cfg
        dataset = self._dataset
        if dataset is not None:
            result["dataset_best"] = float(dataset.optimum)
        extra_out = {**self._backend_extra(self.measurement), **dict(extra or {})}
        if self._last_cell_walls:
            # per-cell search cost (sum of unit wall-clocks, parallel or
            # not), with the staged pipeline's compile-vs-measure split
            extra_out["cell_wall_s"] = [
                {
                    "algo": algo,
                    "sample_size": s,
                    "wall_s": round(w["wall_s"], 3),
                    "compile_s": round(w.get("compile_s", 0.0), 3),
                    "measure_s": round(w.get("measure_s", 0.0), 3),
                }
                for (algo, s), w in sorted(self._last_cell_walls.items())
            ]
        return RunRecord(
            kind="tune_matrix",
            spec=self._spec_dict_or_repr(),
            result=result,
            provenance=_provenance(wall_s),
            # backend provenance from the last in-process unit measurement
            # (parallel-run parents hold none — workers own the measurements)
            extra=extra_out,
        )


# -------------------------------------------------------------------- facade


def tune(
    spec: TuningSpec, *, record_path: str | None = None, verbose: bool = False
) -> TuningResult:
    """Run one budgeted search described by ``spec``.

    Returns the budget-audited :class:`TuningResult` with ``final_value``
    filled by the paper's median-of-``final_repeats`` re-measurement.  When
    ``record_path`` is given, a :class:`RunRecord` JSON lands there.
    """
    session = TuningSession(spec, verbose=verbose)
    result = session.run()
    if record_path is not None:
        session.last_record.save(record_path)
    return result


def tune_matrix(
    spec: TuningSpec,
    *,
    shards: int = 1,
    executor: str | None = None,
    max_workers: int | None = None,
    resume: bool = False,
    unit_experiments: int | None = None,
    futures_pool=None,
    pipeline_workers: int | None = None,
    scheduler: str = "steal",
    compile_cache: str | None = None,
    out_dir: str | None = None,
    verbose: bool = False,
    extra: dict | None = None,
) -> MatrixResults:
    """Run the (algorithms x design) experiment matrix described by ``spec``.

    The matrix decomposes into serializable work units run through the
    ``EXECUTORS`` registry: ``executor="process", max_workers=N`` fans units
    (including within-cell splits of big-E rows) across N spawned workers;
    ``executor="futures"`` submits the same payloads to any
    ``concurrent.futures.Executor`` (``futures_pool=...``);
    ``executor="device"`` runs one thread per CUDA card.  ``shards=N`` is the
    legacy spelling of the process executor.  Experiment seeds derive from
    the spec, so every executor is bit-identical to the serial loop.
    ``resume=True`` skips units already journaled in the measurement store.
    When ``out_dir`` is given, the full results land in
    ``<cache_key>.npz`` with a versioned :class:`RunRecord` JSON (including
    the backend's true optimum, when it can compute one) next to it.
    """
    session = TuningSession(spec, verbose=verbose)
    t0 = monotonic()
    results = session.run_matrix(
        shards=shards,
        executor=executor,
        max_workers=max_workers,
        resume=resume,
        unit_experiments=unit_experiments,
        futures_pool=futures_pool,
        pipeline_workers=pipeline_workers,
        scheduler=scheduler,
        compile_cache=compile_cache,
    )
    if out_dir is not None:
        name = (spec.cache_key or spec.default_cache_key()).replace("/", "_")
        os.makedirs(out_dir, exist_ok=True)
        artifact = f"{name}.npz"
        results.save(os.path.join(out_dir, artifact))
        record = session.make_record(
            results,
            wall_s=monotonic() - t0,
            artifact=artifact,
            extra=extra,
            with_optimum=True,
        )
        record.save(os.path.join(out_dir, f"{name}.json"))
        session.last_record = record
    return results
