"""The public tuning facade: ``repro_torch.tune(spec)`` (a port of the
single-run part of ``repro.core.api``).

* :class:`TuningSpec` — a frozen, JSON-serializable description of one
  tuning run: kernel id, search space, searcher name + kwargs, measurement
  backend name + kwargs (resolved via :mod:`repro_torch.core.backends`), a
  sample budget, seed, and store settings.
* :class:`TuningSession` — the object that owns evaluation: it runs the
  ask/tell loop through the engine's ``drive``, re-measures the winner per
  the paper's final-repeats protocol, and writes a :class:`RunRecord`.
* :class:`RunRecord` — a versioned JSON record (spec + result summary +
  provenance, including the backend's: device, timer, build).

Example::

    import repro_torch
    from repro_torch import TuningSpec

    result = repro_torch.tune(TuningSpec(kernel="harris", backend="cuda", budget=100))
    print(result.best_config, result.final_value)
"""

from __future__ import annotations

import json
import os
import platform
import socket
from dataclasses import dataclass, field
from datetime import datetime, timezone
from typing import Callable

import numpy as np
import torch

from .backends import BACKENDS, make_measurement
from .clock import monotonic
from .engine import DISPATCH_MODES, DiskCachedMeasurement, MeasurementStore, drive
from .measurement import BaseMeasurement
from .searchers import SEARCHERS, make_searcher
from .searchers.base import TuningResult
from .space import Config, Param, SearchSpace, _paper_wg256

SPEC_VERSION = 1
RUN_RECORD_VERSION = 1

#: measurement stores by name (the sqlite store is not ported yet)
STORES = {"json": MeasurementStore}

__all__ = [
    "RUN_RECORD_VERSION",
    "SPEC_VERSION",
    "STORES",
    "RunRecord",
    "TuningSession",
    "TuningSpec",
    "make_store",
    "register_constraint",
    "tune",
]


def make_store(name: str, path: str | None):
    if name not in STORES:
        raise KeyError(f"unknown store {name!r}; have {sorted(STORES)}")
    return STORES[name](path)


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
    """Declarative description of one tuning run (frozen, JSON-serializable).

    ``space=None`` derives the search space from the backend (the cuda
    backend yields the paper's space constrained by ``cuda_fit``).
    ``store``/``store_path`` select the persistent measurement cache.
    """

    kernel: str
    searcher: str = "ga"
    searcher_kwargs: dict = field(default_factory=dict)
    backend: str = "cuda"
    backend_kwargs: dict = field(default_factory=dict)
    space: SearchSpace | None = None
    budget: int | None = None
    seed: int = 0
    dispatch: str = "batch"
    final_repeats: int = 10
    store: str | None = None
    store_path: str | None = None
    cache_key: str | None = None

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
        object.__setattr__(self, "searcher_kwargs", dict(self.searcher_kwargs))
        object.__setattr__(self, "backend_kwargs", dict(self.backend_kwargs))

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
        if kwargs:
            def stable(v):
                return v if isinstance(v, (str, int, float, bool, type(None))) \
                    else f"<{type(v).__name__}>"

            kw = ",".join(f"{k}={stable(kwargs[k])}" for k in sorted(kwargs))
            return f"{self.kernel}/{self.backend}/{kw}"
        return f"{self.kernel}/{self.backend}"

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
            "seed": self.seed,
            "dispatch": self.dispatch,
            "final_repeats": self.final_repeats,
            "store": self.store,
            "store_path": self.store_path,
            "cache_key": self.cache_key,
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
        return cls(**d)

    def to_json(self, **kwargs) -> str:
        try:
            return json.dumps(self.to_dict(), **kwargs)
        except TypeError as e:
            raise TypeError(
                f"TuningSpec is not JSON-serializable ({e}). Backends wired "
                "with in-process callables cannot be serialized — name the "
                "backend and pass plain kwargs instead."
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
    the result (best config, final value, raw final repeats), and how the
    numbers were produced (``extra["backend_provenance"]``)."""

    kind: str                      # "tune"
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
    """Drives one tuning run described by a :class:`TuningSpec`: builds the
    searcher and the measurement from the registries, wraps the measurement
    in the persistent store when configured, drives the ask/tell loop, and
    re-measures the winner."""

    def __init__(self, spec: TuningSpec):
        if not isinstance(spec, TuningSpec):
            raise TypeError(f"spec must be a TuningSpec, got {type(spec).__name__}")
        self.spec = spec
        self._backend = BACKENDS[spec.backend]
        self.space = spec.space
        if self.space is None and self._backend.default_space is not None:
            self.space = self._backend.default_space(
                kernel=spec.kernel, **spec.backend_kwargs
            )
        if self.space is None:
            raise ValueError(
                f"backend {spec.backend!r} has no default space; set "
                "TuningSpec.space explicitly"
            )
        self.store = (
            make_store(spec.store, spec.store_path) if spec.store is not None else None
        )
        self.cache_key = spec.cache_key or spec.default_cache_key()
        self.measurement: BaseMeasurement | None = None
        self.last_record: RunRecord | None = None

    def _make_measurement(self, seed: int) -> BaseMeasurement:
        m = make_measurement(
            self.spec.backend, kernel=self.spec.kernel, seed=seed,
            **self.spec.backend_kwargs,
        )
        if self.store is not None:
            m = DiskCachedMeasurement(m, self.store, prefix=f"{self.cache_key}/seed={seed}")
        return m

    def run(self) -> TuningResult:
        """One budgeted search + the paper's final re-measurement."""
        spec = self.spec
        if spec.budget is None:
            raise ValueError("TuningSpec.budget is required for tune()")
        t0 = monotonic()
        searcher = make_searcher(
            spec.searcher, self.space, seed=spec.seed, **spec.searcher_kwargs
        )
        measurement = self.measurement = self._make_measurement(spec.seed)
        result = drive(searcher, measurement, spec.budget, dispatch=spec.dispatch)
        result.final_value = measurement.measure_final(
            result.best_config, spec.final_repeats
        )
        if self.store is not None:
            self.store.save()
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
        prov = measurement.provenance()
        self.last_record = RunRecord(
            kind="tune",
            spec=self._spec_dict_or_repr(),
            result=res,
            provenance=_provenance(monotonic() - t0),
            extra={"backend_provenance": prov} if prov else {},
        )
        return result

    def _spec_dict_or_repr(self) -> dict:
        try:
            return self.spec.to_dict()
        except (TypeError, ValueError):
            return {"repr": repr(self.spec)}


# -------------------------------------------------------------------- facade


def tune(spec: TuningSpec, *, record_path: str | None = None) -> TuningResult:
    """Run one budgeted search described by ``spec``.

    Returns the budget-audited :class:`TuningResult` with ``final_value``
    filled by the paper's median-of-``final_repeats`` re-measurement.  When
    ``record_path`` is given, a :class:`RunRecord` JSON lands there.
    """
    session = TuningSession(spec)
    result = session.run()
    if record_path is not None:
        session.last_record.save(record_path)
    return result
