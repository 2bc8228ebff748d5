"""Measurement-backend registry: ``make_measurement(name, **kwargs)`` (a port
of ``repro.core.backends``).

* ``"cuda"``     — the port's hand-written CUDA kernels timed on the card
  through :mod:`repro_torch.cuda_bench`; the counterpart of the reference's
  ``"pallas"`` backend.  ``device="cpu"`` runs the plain versions instead.
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
    ``default_space`` lets a spec omit its space.
    """

    name: str
    make: Callable[..., BaseMeasurement]
    default_space: Callable[..., SearchSpace] | None = None


BACKENDS: dict[str, Backend] = {}


def register_backend(backend: Backend) -> Backend:
    BACKENDS[backend.name] = backend
    return backend


def make_measurement(name: str, **kwargs) -> BaseMeasurement:
    """Build a measurement backend by registry name."""
    if name not in BACKENDS:
        raise KeyError(f"unknown backend {name!r}; have {sorted(BACKENDS)}")
    return BACKENDS[name].make(**kwargs)


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


register_backend(Backend(name="cuda", make=_make_cuda, default_space=_cuda_space))
register_backend(Backend(name="callable", make=_make_callable))
