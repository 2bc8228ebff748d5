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
]
