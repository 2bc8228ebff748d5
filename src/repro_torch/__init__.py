"""repro_torch — the autotuner of ``repro`` ported to PyTorch and hand-written
CUDA kernels for an NVIDIA H100 (sm_90a).

The front door is the same declarative facade as the reference's::

    import repro_torch
    from repro_torch import TuningSpec

    result = repro_torch.tune(TuningSpec(kernel="harris", backend="cuda", budget=40))

Each proposed config is timed on one of three CUDA kernels
(``kernels/csrc/{add,harris,mandelbrot}.cu``), built with ``nvcc`` at first
use.  The package imports ``torch`` and never ``jax`` or anything of
``repro``: the reference stays the oracle the tests hold the port against.
"""

__version__ = "0.1.0"

from .core.api import RunRecord, TuningSession, TuningSpec, register_constraint, tune
from .core.backends import BACKENDS, Backend, make_measurement, register_backend

__all__ = [
    "__version__",
    "BACKENDS",
    "Backend",
    "RunRecord",
    "TuningSession",
    "TuningSpec",
    "make_measurement",
    "register_backend",
    "register_constraint",
    "tune",
]
