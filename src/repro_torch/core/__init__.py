"""The port's tuning core: search space, searchers, engine, measurement
protocol, backends and the ``tune`` facade — copies of ``repro.core``'s
pure-Python modules, so one seed proposes one config sequence in both
packages."""

from .api import RunRecord, TuningSession, TuningSpec, register_constraint, tune
from .backends import BACKENDS, Backend, make_measurement, register_backend
from .engine import DiskCachedMeasurement, MeasurementStore, config_key, drive
from .measurement import BaseMeasurement, CallableMeasurement, StageClock, fence
from .searchers import SEARCHERS, TuningResult, make_searcher
from .space import Param, SearchSpace, paper_space

__all__ = [
    "BACKENDS",
    "Backend",
    "BaseMeasurement",
    "CallableMeasurement",
    "DiskCachedMeasurement",
    "MeasurementStore",
    "Param",
    "RunRecord",
    "SEARCHERS",
    "SearchSpace",
    "StageClock",
    "TuningResult",
    "TuningSession",
    "TuningSpec",
    "config_key",
    "drive",
    "fence",
    "make_measurement",
    "make_searcher",
    "paper_space",
    "register_backend",
    "register_constraint",
    "tune",
]
