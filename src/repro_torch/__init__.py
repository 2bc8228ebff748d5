"""repro_torch — the autotuner of ``repro`` ported to PyTorch and hand-written
CUDA kernels for an NVIDIA H100 (sm_90a).

The front door is the same declarative facade as the reference's::

    import repro_torch
    from repro_torch import ExperimentDesign, TuningSpec

    result = repro_torch.tune(TuningSpec(kernel="harris", backend="cuda", budget=40))
    matrix = repro_torch.tune_matrix(
        TuningSpec(kernel="harris", backend="cuda", algorithms=("rs", "ga"),
                   design=ExperimentDesign(sample_sizes=(25, 50), n_experiments=(4, 2))),
        executor="device",
    )

Each proposed config is timed on one of three CUDA kernels
(``kernels/csrc/{add,harris,mandelbrot}.cu``), built with ``nvcc`` at first
use.  The package imports ``torch`` and never ``jax`` or anything of
``repro``: the reference stays the oracle the tests hold the port against.
"""

__version__ = "0.1.0"

from .core.api import (
    RunRecord,
    TuningSession,
    TuningSpec,
    register_constraint,
    tune,
    tune_matrix,
)
from .core.backends import BACKENDS, Backend, make_measurement, register_backend
from .core.dataset import SampleDataset
from .core.executors import EXECUTORS, Executor, register_executor
from .core.experiment import ExperimentDesign
from .core.runner import CellResult, MatrixResults
from .core.searchers import EXTRA_ALGORITHMS, PAPER_ALGORITHMS
from .core.stores import STORES, make_store
from .core.workunits import (
    ExperimentUnit,
    UnitJournal,
    UnitResult,
    build_units,
    merge_unit_results,
)

__all__ = [
    "__version__",
    "BACKENDS",
    "Backend",
    "CellResult",
    "EXECUTORS",
    "EXTRA_ALGORITHMS",
    "Executor",
    "ExperimentDesign",
    "ExperimentUnit",
    "MatrixResults",
    "PAPER_ALGORITHMS",
    "RunRecord",
    "STORES",
    "SampleDataset",
    "TuningSession",
    "TuningSpec",
    "UnitJournal",
    "UnitResult",
    "build_units",
    "make_measurement",
    "make_store",
    "merge_unit_results",
    "register_backend",
    "register_constraint",
    "register_executor",
    "tune",
    "tune_matrix",
]
