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
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

from .measurement import BaseMeasurement, CallableMeasurement
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
    ``pipeline`` marks whether ``make`` accepts ``pipeline_workers=`` and
    ``compile_cache=`` (no port backend does yet); the session refuses the
    knobs on backends without it.
    """

    name: str
    make: Callable[..., BaseMeasurement]
    default_space: Callable[..., SearchSpace] | None = None
    true_optimum: Callable[..., tuple[dict, float]] | None = None
    serializable: bool = True
    pipeline: bool = False


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


def _cuda_space(kernel: str = "add", **kwargs) -> SearchSpace:
    from ..cuda_bench import DEFAULT_X, DEFAULT_Y, default_space

    return default_space(
        kernel, x=kwargs.get("x") or DEFAULT_X, y=kwargs.get("y") or DEFAULT_Y
    )


# ---------------------------------------------------------------- callable


def _make_callable(
    kernel: str | None = None,
    seed: int = 0,
    *,
    fn: Callable,
    batch_fn: Callable | None = None,
) -> BaseMeasurement:
    return CallableMeasurement(fn, batch_fn=batch_fn)


register_backend(
    Backend(
        name="costmodel",
        make=_make_costmodel,
        default_space=_costmodel_space,
        true_optimum=_costmodel_optimum,
    )
)
register_backend(Backend(name="cuda", make=_make_cuda, default_space=_cuda_space))
register_backend(Backend(name="callable", make=_make_callable, serializable=False))
