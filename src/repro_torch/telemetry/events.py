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
``stage``            a completed stage interval with ``dur`` — the
                     high-frequency complete-span form.  A measurement
                     stage (:data:`PIPELINE_STAGES`) carries an optional
                     config ``key``, and its ``dur`` is the exact duration
                     the stage clock was charged (not rounded), so
                     per-stage trace totals reconcile with ``stage_s``.
                     A host stage (:data:`HOST_STAGES`) is trace-only: no
                     ``stage_s`` counterpart.  A matrix stage
                     (:data:`MATRIX_STAGES`) is charged to its unit's
                     ``stage_s`` with the same duration.  Every stage interval
                     (``t - dur``, ``t``) of one writer's thread is
                     disjoint from the others.
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

#: the measurement's stages, each charged to its stage clock (``stage_s``).
#: ``inputs`` (the workload's inputs, cached on the host, copied to the card
#: once a measurement, or once a matrix call where its shared copy serves,
#: with ``bytes``, ``draw_s``, ``copy_s``, ``cache_hit`` and
#: ``device_reuse``) is the port's: the reference stages its inputs inside
#: ``compile``
PIPELINE_STAGES = ("screen", "inputs", "compile", "time", "record")

#: the port's host stages, trace-only (no ``stage_s`` counterpart):
#: ``propose`` — the searcher's ``start``, each ``tell`` (its next proposal)
#: and ``finish`` in the engine's ``drive``, with ``algo`` (and ``fit_s`` /
#: ``acquire_s`` where the searcher has a surrogate); ``session`` —
#: ``TuningSession.run``'s own work before the search loop
#: (``part="setup"``) and after the final re-measurement (``part="record"``),
#: and ``run_matrix``'s before its units run (``part="setup"``: the unit
#: plan, the journal) and after (``part="record"``: the merge, the store,
#: the winners index, the record), with ``executor``.
#: The searchers take their ``fit_s`` / ``acquire_s`` clock reads with the
#: sink off too: a searcher is built without a sink and its proposal runs
#: inside ``tell``, so gating them would thread the sink through the
#: ``Searcher`` protocol the reference shares; two ``perf_counter`` reads
#: (~0.1 µs) against a step of 0.3–10 ms is below any metric's noise
HOST_STAGES = ("propose", "session")

#: the port's matrix stages, each charged to the unit that ran it
#: (``UnitResult.stage_s``) and absent from the reference's trace:
#: ``dataset`` — ``TuningSession`` generating the matrix's sample dataset
#: (paper section VI.B) in the first unit a session runs (under a parallel
#: executor, in the parent before it ships the dataset: no unit), with ``n``,
#: ``cache_hit`` and ``stage_s`` (the inner measurement's own stage split;
#: that measurement emits no stage events of its own)
MATRIX_STAGES = ("dataset",)

#: the port's own counters, which the reference's trace lacks:
#: ``inputs.cache_hits`` / ``inputs.cache_misses`` count the lookups of the
#: process's input cache (``cuda_bench/workloads.py``; the reference draws a
#: measurement's inputs anew every time); ``inputs.device_reuses`` counts
#: the stagings served by a matrix call's shared device copy
#: (``shared_inputs``); ``dataset.samples_measured`` counts the configs
#: measured to generate a matrix's dataset (0 where its cache file served
#: it)
PORT_COUNTERS = ("inputs.cache_hits", "inputs.cache_misses", "inputs.device_reuses",
                 "dataset.samples_measured")


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
