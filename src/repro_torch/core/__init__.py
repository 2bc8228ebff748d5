"""The port's tuning core: search space, searchers, engine, measurement
protocol, backends, the experiment matrix (work units, executors, sample
dataset) and the ``tune`` / ``tune_matrix`` facade — copies of
``repro.core``'s pure-Python modules, so one seed proposes one config
sequence, and one spec gives one matrix, in both packages."""

from .api import (
    RunRecord,
    TuningSession,
    TuningSpec,
    register_constraint,
    tune,
    tune_matrix,
)
from .backends import BACKENDS, Backend, make_measurement, register_backend
from .dataset import SampleDataset
from .engine import DiskCachedMeasurement, MeasurementStore, config_key, drive
from .executors import EXECUTORS, Executor, register_executor
from .experiment import ExperimentDesign
from .measurement import BaseMeasurement, CallableMeasurement, StageClock, fence
from .runner import CellResult, MatrixResults, stable_seed
from .searchers import (
    EXTRA_ALGORITHMS,
    PAPER_ALGORITHMS,
    SEARCHERS,
    Searcher,
    TuningResult,
    make_searcher,
)
from .space import Param, SearchSpace, paper_space
from .stores import STORES, make_store
from .workunits import (
    ExperimentUnit,
    UnitJournal,
    UnitResult,
    build_units,
    merge_unit_results,
)

__all__ = [
    "BACKENDS",
    "Backend",
    "BaseMeasurement",
    "CallableMeasurement",
    "CellResult",
    "DiskCachedMeasurement",
    "EXECUTORS",
    "EXTRA_ALGORITHMS",
    "Executor",
    "ExperimentDesign",
    "ExperimentUnit",
    "MatrixResults",
    "MeasurementStore",
    "PAPER_ALGORITHMS",
    "Param",
    "RunRecord",
    "SEARCHERS",
    "STORES",
    "SampleDataset",
    "SearchSpace",
    "Searcher",
    "StageClock",
    "TuningResult",
    "TuningSession",
    "TuningSpec",
    "UnitJournal",
    "UnitResult",
    "build_units",
    "config_key",
    "drive",
    "fence",
    "make_measurement",
    "make_searcher",
    "make_store",
    "merge_unit_results",
    "paper_space",
    "register_backend",
    "register_constraint",
    "register_executor",
    "stable_seed",
    "tune",
    "tune_matrix",
]
