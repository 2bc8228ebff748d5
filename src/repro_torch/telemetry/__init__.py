"""repro_torch.telemetry — span tracing, metrics, and live progress for runs
(a port of ``repro.telemetry``).

The observability layer: a :class:`Telemetry` writer emits append-only
JSONL trace events (spans over the fixed hierarchy matrix > cell > unit >
ask/tell round > experiment > pipeline stage, plus counters and gauges);
:data:`NULL_TELEMETRY` is the no-op default so the disabled path stays the
current code path.  Workers write ``trace.shard<k>.jsonl`` beside their
shard stores and the parent merges them deterministically at join
(:mod:`.merge`).  Consumers: ``python -m repro_torch.telemetry`` (summarize
/ tail / export), :mod:`.progress`, ``python -m
repro_torch.telemetry.assert_counters`` (counter assertions as a gate), and
the report's Telemetry section.

On the card a pipeline stage is timed around the CUDA kernel's launch and
``torch.cuda.synchronize()`` (``CudaMeasurement``); its ``stage`` events
carry the exact duration its stage clock was charged, so per-stage trace
totals reconcile with the units' ``stage_s``.  The port traces more stages
than the reference: ``inputs`` (the inputs' draw and copy, split out of
``compile``) among the measurement's, and the trace-only host stages
``propose`` (the searcher's steps in the engine's ``drive``) and
``session`` (``TuningSession.run``'s own work) — see
:data:`.events.HOST_STAGES`.  Every event is stamped on the
``repro_torch.core.clock`` seam, ``time.perf_counter`` by default.

Telemetry is a pure observability knob — never part of cache keys, journal
namespaces, or spec fingerprints — and a telemetry-enabled run produces
bit-identical measurement stores to a disabled one.

Enable it per run::

    import repro_torch
    from repro_torch import ExperimentDesign, TuningSpec

    spec = TuningSpec(kernel="harris", backend="cuda", algorithms=("rs", "ga"),
                      design=ExperimentDesign.smoke())
    repro_torch.tune_matrix(spec, out_dir="results/demo",
                            telemetry_dir="results/demo")
    # then: python -m repro_torch.telemetry summarize results/demo
"""

from __future__ import annotations

from .events import TRACE_FILE, read_events, read_run, trace_paths
from .export import chrome_trace, export_chrome
from .null import NULL_TELEMETRY, NullTelemetry
from .progress import ProgressReporter, ProgressState, format_progress, scan_progress
from .summarize import render_summary, stage_percentiles, summarize
from .tracer import Telemetry, for_run_dir

__all__ = [
    "NULL_TELEMETRY",
    "TRACE_FILE",
    "NullTelemetry",
    "ProgressReporter",
    "ProgressState",
    "Telemetry",
    "chrome_trace",
    "export_chrome",
    "for_run_dir",
    "format_progress",
    "read_events",
    "read_run",
    "render_summary",
    "scan_progress",
    "stage_percentiles",
    "summarize",
    "trace_paths",
]
