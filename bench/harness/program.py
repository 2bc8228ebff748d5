"""The system under test, as the benchmark reaches it: the port's public
tuning entry, its kernels' launch call and its trace sink.

This is the one module of the harness that imports ``repro_torch`` (the
entry drivers reach the program through it too); ``bench/reference/``
never does.  Imports happen inside the functions, so loading the harness
costs nothing and a checkout without ``src/`` fails only when a run starts.
"""

from __future__ import annotations


def tuning():
    """``(TuningSpec, TuningSession)`` of the port's public API."""
    from repro_torch import TuningSession, TuningSpec

    return TuningSpec, TuningSession


def build_kernels() -> float:
    """Build (first run of a checkout) or load the port's kernel library;
    returns the seconds this process spent building."""
    from repro_torch.kernels import _build

    return float(_build.library().build_s)


def run_kernel(kernel: str, inputs: tuple, config: dict, x: int, y: int, device):
    """One launch of ``kernel`` on ``inputs`` at ``config``: the call the
    tuner's runner makes (``CudaWorkload.run``; ``w_z`` is out of the
    program, as there)."""
    from repro_torch.kernels import KERNEL_BENCHES

    return KERNEL_BENCHES[kernel].run(inputs, {**config, "w_z": 1}, x, y, device)


def telemetry(path: str):
    """The port's trace writer, appending JSONL events to ``path``."""
    from repro_torch.telemetry import Telemetry

    return Telemetry(path)
