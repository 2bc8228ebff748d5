"""The reference's analytic TPU cost model (a copy of ``repro.costmodel``).

Registered as the ``costmodel`` backend: deterministic, serializable and
fast, it runs the experiment matrix on a machine without a card and weights
the work units.  Its values are modelled TPU seconds; none is a time of the
card.
"""

from .kernel_cost import (
    ADD,
    FAILURE_RUNTIME,
    HARRIS,
    MANDELBROT,
    WORKLOADS,
    CostModelMeasurement,
    KernelWorkload,
    executable_space,
    is_executable,
    mean_runtime_estimate,
    runtime_model,
    runtime_model_batch,
    true_optimum,
    vmem_bytes,
)
from .tpu import CHIPS, V3, V4, V5E, ChipModel

__all__ = [
    "CHIPS",
    "V3",
    "V4",
    "V5E",
    "ChipModel",
    "ADD",
    "HARRIS",
    "MANDELBROT",
    "WORKLOADS",
    "FAILURE_RUNTIME",
    "CostModelMeasurement",
    "KernelWorkload",
    "executable_space",
    "is_executable",
    "mean_runtime_estimate",
    "runtime_model",
    "runtime_model_batch",
    "true_optimum",
    "vmem_bytes",
]
