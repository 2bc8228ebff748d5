"""The trace event schema + the tolerant JSONL reader every consumer shares
(a copy of ``repro.telemetry.events``; each package reads the other's traces).

A trace is an append-only JSONL file: one JSON object per line, written by
one :class:`~repro_torch.telemetry.tracer.Telemetry` writer per process (the
parent writes ``trace.jsonl``, worker *k* writes ``trace.shard<k>.jsonl``
beside its shard store; the parent appends the shard files into the main
trace at join — see :mod:`.merge`).

Common fields on every event:

``t``    timestamp from the injectable ``repro_torch.core.clock`` seam
         (monotonic seconds; epochs are per-process, so timestamps are only
         comparable WITHIN one ``src``)
``seq``  per-writer sequence number (total order within a ``src``)
``src``  writer id: ``"main"`` or ``"shard<k>"``
``ev``   event type (below)

Event types:

``begin`` / ``end``  span boundaries; ``span`` names the level of the fixed
                     hierarchy matrix > cell > unit > round > experiment >
                     stage.  ``end`` carries ``dur`` (seconds) and ``ok:
                     false`` when the span died on an exception.  ``cell``
                     spans are not emitted live (a cell's units may run on
                     several workers); consumers derive them by grouping
                     unit spans, and the parent emits aggregate ``cell``
                     events at merge time.
``stage``            a completed pipeline-stage interval (screen / compile /
                     time / record) with ``dur`` and an optional config
                     ``key`` — the high-frequency complete-span form.  Its
                     ``dur`` is the exact duration the stage clock was
                     charged (not rounded), so per-stage trace totals
                     reconcile with ``stage_s``.
``plan``             emitted once by the parent when the unit plan is fixed:
                     ``units`` (keys), ``units_total``,
                     ``experiments_total``, and on resume
                     ``units_done_resume`` / ``experiments_done_resume``.
``counters``         a cumulative counter snapshot for this writer (the
                     final one is emitted on ``close()``).
``totals``           the parent's merged counter totals across all writers.
``gauge``            an instantaneous value (e.g. the scheduler's queue depth).
``cell``             per-cell aggregate (wall/compile/measure seconds).
"""

from __future__ import annotations

import json
import os
import re

#: file names (the run directory is the unit of discovery for the CLI)
TRACE_FILE = "trace.jsonl"
SHARD_RE = re.compile(r"^trace\.shard(\d+)\.jsonl$")

#: the fixed span hierarchy, outermost first ("cell" is derived, "stage"
#: events are the innermost level in complete-span form)
SPAN_LEVELS = ("matrix", "cell", "unit", "round", "experiment", "stage")

PIPELINE_STAGES = ("screen", "compile", "time", "record")


def shard_file(trace_path: str, shard: int) -> str:
    """``trace.shard<k>.jsonl`` beside ``trace_path``."""
    d = os.path.dirname(trace_path)
    return os.path.join(d, f"trace.shard{int(shard)}.jsonl")


def trace_paths(run_dir: str) -> list[str]:
    """Every trace file of a run dir: the merged trace first, then any
    unmerged shard traces in shard order (a live run's workers are still
    writing theirs)."""
    out = []
    main = os.path.join(run_dir, TRACE_FILE)
    if os.path.exists(main):
        out.append(main)
    shards = []
    try:
        names = os.listdir(run_dir)
    except OSError:
        names = []
    for name in names:
        m = SHARD_RE.match(name)
        if m:
            shards.append((int(m.group(1)), os.path.join(run_dir, name)))
    out.extend(p for _, p in sorted(shards))
    return out


def read_events(path: str) -> list[dict]:
    """Parse one trace file, skipping malformed lines (a killed writer may
    leave a torn final line — a trace is diagnostics, never a source of
    truth, so it degrades instead of raising)."""
    events: list[dict] = []
    try:
        with open(path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    ev = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if isinstance(ev, dict):
                    events.append(ev)
    except OSError:
        return []
    return events


def read_run(run_dir: str) -> list[dict]:
    """All events of a run dir (merged trace + leftover shard traces)."""
    events: list[dict] = []
    for path in trace_paths(run_dir):
        events.extend(read_events(path))
    return events
