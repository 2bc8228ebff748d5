from .elastic import degraded_mesh, reshard
from .fault_tolerance import (
    InjectedFailure,
    RunnerConfig,
    RunnerReport,
    StragglerEvent,
    TrainingRunner,
)

__all__ = [
    "InjectedFailure",
    "RunnerConfig",
    "RunnerReport",
    "StragglerEvent",
    "TrainingRunner",
    "degraded_mesh",
    "reshard",
]
