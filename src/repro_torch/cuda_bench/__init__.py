"""repro_torch.cuda_bench — the real-measurement backend on the card.

Times the port's hand-written CUDA kernels behind the batched
``measure_batch`` protocol; registered as ``BACKENDS["cuda"]``, so

    repro_torch.tune(TuningSpec(kernel="harris", backend="cuda", budget=100))

tunes a kernel on the card.  A port of ``repro.pallas_bench``.

Layout:
    workloads.py  deterministic problem materialization from spec kwargs
    validity.py   geometry pre-screen + structured InvalidMeasurement penalty
    measure.py    CudaMeasurement: warm cache, warmup, N-repeat timing
"""

from ..core.space import Param, SearchSpace
from .measure import CudaMeasurement
from .validity import InvalidMeasurement, fit_constraint, validate_config
from .workloads import DEFAULT_X, DEFAULT_Y, CudaWorkload, make_workload

__all__ = [
    "CudaMeasurement",
    "CudaWorkload",
    "DEFAULT_X",
    "DEFAULT_Y",
    "InvalidMeasurement",
    "default_space",
    "fit_constraint",
    "make_workload",
    "validate_config",
]


def default_space(
    kernel: str = "add",
    x: int = DEFAULT_X,
    y: int = DEFAULT_Y,
    **_,
) -> SearchSpace:
    """The paper's 6-parameter space constrained to runnable geometries
    (the reference's ``pallas_bench.default_space``, with ``cuda_fit``)."""
    workload = make_workload(kernel, x=x, y=y)
    params = [
        Param.int_range("t_x", 1, 16),
        Param.int_range("t_y", 1, 16),
        Param.int_range("t_z", 1, 16),
        Param.int_range("w_x", 1, 8),
        Param.int_range("w_y", 1, 8),
        Param.int_range("w_z", 1, 8),
    ]
    return SearchSpace(params, constraint=fit_constraint(workload))
