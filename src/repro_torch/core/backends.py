"""Measurement-backend registry: ``make_measurement(name, **kwargs)`` (a port
of ``repro.core.backends``).

* ``"cuda"``     — the port's hand-written CUDA kernels timed on the card
  through :mod:`repro_torch.cuda_bench`; the counterpart of the reference's
  ``"pallas"`` backend.  ``device="cpu"`` runs the plain versions instead.
* ``"costmodel"`` — the reference's analytic TPU cost model with
  counter-based noise (``kernel=..., chip=..., seed=..., noise=...``); also
  provides the default space (executable configs) and the noise-free true
  optimum.  Its values are modelled TPU seconds, never a time of the card.
* ``"callable"`` — wraps any ``f(config) -> seconds`` objective.
* ``"timing"``   — wall-clock of a real callable (``runner=..., warmup=...``),
  fenced, for custom objectives the ``cuda`` backend doesn't cover.
* ``"cached"``   — in-memory memoization of an ``inner`` backend (paper: a
  config is measured once during search).
* ``"disk"``     — persistent memoization of an ``inner`` backend through a
  measurement store (``store="json"|"sqlite"``, ``store_path=...``).

``inner`` is either a backend *name* (resolved recursively, with
``inner_kwargs``) or an already-built measurement instance.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, ContextManager

from .engine import DiskCachedMeasurement
from .measurement import (
    BaseMeasurement,
    CachedMeasurement,
    CallableMeasurement,
    TimingMeasurement,
)
from .space import SearchSpace


@dataclass(frozen=True)
class Backend:
    """A named measurement backend.

    ``make(kernel=..., seed=..., **kwargs)`` builds a measurement; backends
    that don't need the kernel id / seed accept and ignore them.
    ``default_space`` lets a spec omit its space; ``true_optimum`` lets a
    matrix record carry the exact optimum (the cost model's).
    ``serializable`` marks whether specs using this backend can round-trip
    through JSON and so be rebuilt in a parallel executor's workers.
    ``shared_inputs``, where set, opens a scope in
    which the backend's measurements share their staged inputs (``cuda``:
    one device copy per workload and card); a matrix call runs inside one.
    """

    name: str
    make: Callable[..., BaseMeasurement]
    default_space: Callable[..., SearchSpace] | None = None
    true_optimum: Callable[..., tuple[dict, float]] | None = None
    serializable: bool = True
    shared_inputs: Callable[[], ContextManager] | None = None


BACKENDS: dict[str, Backend] = {}


def register_backend(backend: Backend) -> Backend:
    BACKENDS[backend.name] = backend
    return backend


def make_measurement(name: str, **kwargs) -> BaseMeasurement:
    """Build a measurement backend by registry name."""
    if name not in BACKENDS:
        raise KeyError(f"unknown backend {name!r}; have {sorted(BACKENDS)}")
    return BACKENDS[name].make(**kwargs)


# --------------------------------------------------------------- costmodel


def _costmodel_parts(kernel: str, chip: str):
    # lazy import: core stays importable without the costmodel package
    from ..costmodel import CHIPS, WORKLOADS

    if kernel not in WORKLOADS:
        raise KeyError(f"unknown kernel {kernel!r}; have {sorted(WORKLOADS)}")
    if chip not in CHIPS:
        raise KeyError(f"unknown chip {chip!r}; have {sorted(CHIPS)}")
    return WORKLOADS[kernel], CHIPS[chip]


def _make_costmodel(
    kernel: str = "harris", chip: str = "v5e", seed: int = 0, noise: bool = True
) -> BaseMeasurement:
    from ..costmodel import CostModelMeasurement

    w, c = _costmodel_parts(kernel, chip)
    return CostModelMeasurement(w, c, seed=seed, noise=noise)


def _costmodel_space(kernel: str = "harris", chip: str = "v5e", **_) -> SearchSpace:
    from ..costmodel import executable_space

    w, c = _costmodel_parts(kernel, chip)
    return executable_space(w, c)


def _costmodel_optimum(kernel: str = "harris", chip: str = "v5e", **_):
    from ..costmodel import true_optimum

    w, c = _costmodel_parts(kernel, chip)
    return true_optimum(w, c)


# -------------------------------------------------------------------- cuda


def _make_cuda(
    kernel: str = "add",
    seed: int = 0,
    *,
    x: int | None = None,
    y: int | None = None,
    input_seed: int = 0,
    repeats: int = 5,
    warmup: int = 1,
    device: str = "cuda",
) -> BaseMeasurement:
    # lazy import: core stays importable without the kernel packages
    from ..cuda_bench import DEFAULT_X, DEFAULT_Y, CudaMeasurement, make_workload

    workload = make_workload(
        kernel,
        x=x if x is not None else DEFAULT_X,
        y=y if y is not None else DEFAULT_Y,
        input_seed=input_seed,
    )
    return CudaMeasurement(workload, repeats=repeats, warmup=warmup, device=device)


def _cuda_shared_inputs() -> ContextManager:
    from ..cuda_bench.workloads import shared_inputs

    return shared_inputs()


def _cuda_space(kernel: str = "add", **kwargs) -> SearchSpace:
    from ..cuda_bench import DEFAULT_X, DEFAULT_Y, default_space

    return default_space(
        kernel, x=kwargs.get("x") or DEFAULT_X, y=kwargs.get("y") or DEFAULT_Y
    )


# --------------------------------------------------------------- wrappers


def _make_timing(
    kernel: str | None = None,
    seed: int = 0,
    *,
    runner: Callable,
    warmup: int = 1,
) -> BaseMeasurement:
    return TimingMeasurement(runner, warmup=warmup)


def _make_callable(
    kernel: str | None = None,
    seed: int = 0,
    *,
    fn: Callable,
    batch_fn: Callable | None = None,
) -> BaseMeasurement:
    return CallableMeasurement(fn, batch_fn=batch_fn)


def _resolve_inner(inner, inner_kwargs, kernel, seed) -> BaseMeasurement:
    if isinstance(inner, str):
        return make_measurement(inner, kernel=kernel, seed=seed, **(inner_kwargs or {}))
    if isinstance(inner, BaseMeasurement):
        return inner
    raise TypeError(
        f"inner must be a backend name or a BaseMeasurement, got {type(inner).__name__}"
    )


def _make_cached(
    kernel: str | None = None,
    seed: int = 0,
    *,
    inner,
    inner_kwargs: dict | None = None,
) -> BaseMeasurement:
    return CachedMeasurement(_resolve_inner(inner, inner_kwargs, kernel, seed))


def _make_disk(
    kernel: str | None = None,
    seed: int = 0,
    *,
    inner,
    inner_kwargs: dict | None = None,
    store="json",
    store_path: str | None = None,
    prefix: str | None = None,
) -> BaseMeasurement:
    from .stores import make_store

    if isinstance(store, str):
        store = make_store(store, store_path)
    if prefix is None:
        prefix = f"{kernel or 'objective'}/seed={seed}"
    return DiskCachedMeasurement(
        _resolve_inner(inner, inner_kwargs, kernel, seed), store, prefix
    )


register_backend(
    Backend(
        name="costmodel",
        make=_make_costmodel,
        default_space=_costmodel_space,
        true_optimum=_costmodel_optimum,
    )
)
register_backend(
    Backend(name="cuda", make=_make_cuda, default_space=_cuda_space,
            shared_inputs=_cuda_shared_inputs)
)
register_backend(Backend(name="timing", make=_make_timing, serializable=False))
register_backend(Backend(name="callable", make=_make_callable, serializable=False))
register_backend(Backend(name="cached", make=_make_cached))
register_backend(Backend(name="disk", make=_make_disk))
