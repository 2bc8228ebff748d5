"""The port's telemetry against the reference's, on the CPU.

Each case of ``tests/test_telemetry.py``, run through both packages on the
same input wherever both can take it:

* the null sink and the tracer: the same calls on the same ticking clock
  write the same trace bytes;
* the readers, ``summarize``, ``render_summary``, ``chrome_trace``,
  progress and the CLIs give equal output for one trace file;
* telemetry is observability only: the cost-model matrix's store values are
  byte-identical with it on and off on the ``serial``, ``process``,
  ``futures`` and ``device`` executors (two CPU devices patched in for the
  cards), and the counter totals and each unit's counters equal the
  reference's;
* shard traces merge deterministically and a killed run's are recovered;
* on the ``cuda`` backend (plain versions on the CPU, clocks ticking 1.0 a
  reading) the trace's per-stage totals equal the units' ``stage_s``.

The port traces more than the reference: its host stages (``propose``
around each searcher step of the engine's loop; ``session`` in single tune
calls, ``tests/test_torch_host_stages.py``) and its matrix stage
(``dataset``: generating the matrix's sample dataset, charged to the
generating unit's ``stage_s``) are set apart before a trace is compared
with the reference's, and counted; so are its own counters
(``PORT_COUNTERS``: the input cache's hits and misses, the stagings a
matrix call's shared device copy served, the dataset's measured samples).

Tolerance is exact everywhere: these paths do no floating-point work the
two packages could round apart.
"""

import itertools
import json
import os
import subprocess
import sys
from dataclasses import asdict

import numpy as np
import pytest
import torch

from repro.core import ExperimentDesign as RefDesign
from repro.core import TuningSession as RefSession
from repro.core import TuningSpec as RefSpec
from repro.core.workunits import UnitJournal as RefJournal
from repro.telemetry import NULL_TELEMETRY as REF_NULL
from repro.telemetry import Telemetry as RefTelemetry
from repro.telemetry import chrome_trace as ref_chrome_trace
from repro.telemetry import for_run_dir as ref_for_run_dir
from repro.telemetry import format_progress as ref_format_progress
from repro.telemetry import read_events as ref_read_events
from repro.telemetry import read_run as ref_read_run
from repro.telemetry import render_summary as ref_render_summary
from repro.telemetry import summarize as ref_summarize
from repro.telemetry.__main__ import main as ref_cli
from repro.telemetry.progress import scan_events as ref_scan_events
from repro_torch import ExperimentDesign, TuningSession, TuningSpec
from repro_torch.core import MeasurementStore, executors
from repro_torch.core import clock as port_clock
from repro_torch.cuda_bench.workloads import clear_input_cache
from repro_torch.telemetry import (
    NULL_TELEMETRY,
    TRACE_FILE,
    Telemetry,
    chrome_trace,
    export_chrome,
    for_run_dir,
    format_progress,
    read_events,
    read_run,
    render_summary,
    scan_progress,
    stage_percentiles,
    summarize,
)
from repro_torch.telemetry.__main__ import main as port_cli
from repro_torch.telemetry.events import (
    HOST_STAGES,
    MATRIX_STAGES,
    PIPELINE_STAGES,
    PORT_COUNTERS,
)
from repro_torch.telemetry.assert_counters import main as port_assert_counters
from repro_torch.telemetry.null import _NULL_SPAN
from repro_torch.telemetry.progress import scan_events

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPEC_KW = dict(kernel="harris", backend="costmodel", backend_kwargs={"chip": "v5e"},
               algorithms=("rs", "ga"), seed=11, dataset_size=200)
DESIGN_KW = dict(sample_sizes=(25,), n_experiments=(4,), final_repeats=3)
SPEC = TuningSpec(**SPEC_KW, design=ExperimentDesign(**DESIGN_KW))
REF_SPEC = RefSpec(**SPEC_KW, design=RefDesign(**DESIGN_KW))
#: event fields that vary run to run: clocks, writer identity, wall-clocks
VOLATILE = {"t", "dur", "seq", "src", "wall_s", "compile_s", "measure_s"}
#: the port's own stage events, which the reference's trace lacks
PORT_STAGES = (*HOST_STAGES, *MATRIX_STAGES)


def counter_clock():
    ticks = itertools.count()
    return lambda: float(next(ticks))


def store_values_bytes(path: str) -> bytes:
    """Canonical bytes of a store's measurement VALUES (journal metadata
    carries wall-clocks, which legitimately vary run to run)."""
    return json.dumps(sorted(MeasurementStore(path).items()), sort_keys=True).encode()


def assert_same_cells(a, b):
    assert set(a.cells) == set(b.cells)
    for key in a.cells:
        for name in ("final_values", "search_best_values", "n_samples_used"):
            np.testing.assert_array_equal(getattr(a.cells[key], name),
                                          getattr(b.cells[key], name))


def stable_events(events: list[dict]) -> list[dict]:
    return [{k: v for k, v in e.items() if k not in VOLATILE} for e in events]


def totals_of(events: list[dict]) -> dict:
    return [e for e in events if e["ev"] == "totals"][-1]["counters"]


def split_port_counters(counters: dict) -> tuple[dict, dict]:
    """``(shared, port)``: the port's own counters (:data:`PORT_COUNTERS`),
    which count the input cache's lookups, a cache the reference does not
    have, apart from the counters both packages keep."""
    port = {k: v for k, v in counters.items() if k in PORT_COUNTERS}
    return {k: v for k, v in counters.items() if k not in PORT_COUNTERS}, port


def split_host_stages(events: list[dict]) -> tuple[list[dict], list[dict]]:
    """``(shared, port)``: the port's own ``stage`` events (the host stages
    ``propose`` and ``session``, the matrix stage ``dataset``), which the
    reference's trace lacks, apart from the rest; the rest's counter
    snapshots and totals without the port's own counters."""
    port = [e for e in events if e["ev"] == "stage" and e["stage"] in PORT_STAGES]
    shared = []
    for e in events:
        if e["ev"] == "stage" and e["stage"] in PORT_STAGES:
            continue
        if e["ev"] in ("counters", "totals"):
            e = {**e, "counters": split_port_counters(e["counters"])[0]}
        shared.append(e)
    return shared, port


def assert_one_propose_per_searcher_step(events: list[dict], n_drives: int) -> None:
    """The host stages of a cost-model matrix: a ``propose`` event for each
    searcher step of the engine's loop (``start``, one ``tell`` a round,
    ``finish``), the parent session's own work before and after its units
    (``session``, ``part="setup"`` then ``part="record"``), and nothing
    else."""
    host = [e for e in split_host_stages(events)[1] if e["stage"] in HOST_STAGES]
    propose = [e for e in host if e["stage"] == "propose"]
    rounds = [e for e in events if e["ev"] == "end" and e.get("span") == "round"]
    assert {e["stage"] for e in host} == {"propose", "session"}
    assert len(propose) == len(rounds) + 2 * n_drives
    assert sorted({e["algo"] for e in propose}) == sorted({e["algo"] for e in rounds})
    session = [(e["src"], e["part"]) for e in host if e["stage"] == "session"]
    assert session == [("main", "setup"), ("main", "record")]


@pytest.fixture
def two_cpu_devices(monkeypatch):
    monkeypatch.setattr(executors, "cuda_devices",
                        lambda: [torch.device("cpu", 0), torch.device("cpu", 1)])


# ------------------------------------------------------------- null telemetry


def test_null_telemetry_is_the_default_and_allocation_free():
    """The disabled path must not pay for telemetry: ``span()`` hands back
    one shared context manager regardless of arguments, every other method
    answers as the reference's null sink does, and the session wires the
    singleton by default."""
    for tel in (NULL_TELEMETRY, REF_NULL):
        assert tel.enabled is False
        with tel.span("round"):
            pass
        tel.inc("compiles")
        tel.gauge("depth", 4)
        tel.event("plan", units_total=8)
        tel.stage("compile", 0.5, key="g")
        tel.emit_counters()
        tel.close()
    assert NULL_TELEMETRY.span("unit", unit="x") is _NULL_SPAN
    assert NULL_TELEMETRY.span("matrix") is NULL_TELEMETRY.span("experiment", experiment=3)
    for name, args in (("counters_snapshot", ()), ("shard_path", (0,)), ("shard_src", (0,)),
                       ("absorb", (["anything"],)), ("recover", ())):
        assert getattr(NULL_TELEMETRY, name)(*args) == getattr(REF_NULL, name)(*args)
    assert (NULL_TELEMETRY.path, NULL_TELEMETRY.src) == (REF_NULL.path, REF_NULL.src)
    assert TuningSession(SPEC).telemetry is NULL_TELEMETRY


# ------------------------------------------------------------------- tracer


def write_trace(cls, path):
    tel = cls(path, clock=counter_clock())
    with tel.span("unit", unit="ga/S25"):
        tel.stage("compile", 0.5, key="g1")
        tel.inc("compiles")
        tel.inc("compiles")
    with pytest.raises(RuntimeError, match="boom"):
        with tel.span("unit", unit="bad"):
            raise RuntimeError("boom")
    tel.gauge("scheduler.queue_depth", 3)
    tel.close()


def test_tracer_spans_counters_and_failed_span(tmp_path):
    """The same calls on the same ticking clock: the port's trace file is
    the reference's byte for byte."""
    ours, ref = str(tmp_path / "ours" / TRACE_FILE), str(tmp_path / "ref" / TRACE_FILE)
    write_trace(Telemetry, ours)
    write_trace(RefTelemetry, ref)
    with open(ours, "rb") as a, open(ref, "rb") as b:
        assert a.read() == b.read()

    events = read_events(ours)
    assert events == ref_read_events(ours)
    assert [e["seq"] for e in events] == list(range(len(events)))
    assert {e["src"] for e in events} == {"main"}
    begin, stage, end = events[0], events[1], events[2]
    assert begin["ev"] == "begin" and begin["unit"] == "ga/S25"
    assert stage["ev"] == "stage" and stage["dur"] == 0.5 and stage["key"] == "g1"
    assert end["ev"] == "end" and end["dur"] > 0 and "ok" not in end
    bad = [e for e in events if e.get("unit") == "bad" and e["ev"] == "end"]
    assert bad and bad[0]["ok"] is False
    assert [e for e in events if e["ev"] == "counters"][-1]["counters"] == {"compiles": 2}


def test_stage_events_keep_the_exact_duration(tmp_path):
    """A divergence kept on purpose: the port's ``stage`` events carry the
    duration unrounded (the reference rounds to 1 µs), so per-stage trace
    totals add up to the stage clocks however many stages ran."""
    tel = Telemetry(str(tmp_path / TRACE_FILE), clock=counter_clock())
    durs = [1e-7 * (k + 1) / 3 for k in range(1000)]
    for d in durs:
        tel.stage("time", d)
    tel.close()
    got = [e["dur"] for e in read_events(tel.path) if e["ev"] == "stage"]
    assert got == durs
    assert stage_percentiles(read_events(tel.path))["time"]["total_s"] == float(
        np.asarray(durs, dtype=np.float64).sum())


def test_reader_skips_torn_and_malformed_lines(tmp_path):
    path = str(tmp_path / TRACE_FILE)
    with open(path, "w") as f:
        f.write('{"ev": "plan", "seq": 0}\n')
        f.write("not json\n")
        f.write('{"ev": "end", "seq": 1, "span": "unit"')   # torn tail
    assert read_events(path) == ref_read_events(path)
    assert [e["ev"] for e in read_events(path)] == ["plan"]
    missing = str(tmp_path / "missing.jsonl")
    assert read_events(missing) == ref_read_events(missing) == []


# ------------------------------------------ on/off identity across executors


def run_pair(tmp_path, run_dir, **matrix_kwargs):
    """The port's matrix with telemetry off and on; returns both results,
    the traced session and the store paths."""
    off_path, on_path = str(tmp_path / "off.json"), str(tmp_path / "on.json")
    res_off = TuningSession(SPEC.replace(store="json", store_path=off_path)
                            ).run_matrix(**matrix_kwargs)
    tel = for_run_dir(str(run_dir))
    on = TuningSession(SPEC.replace(store="json", store_path=on_path), telemetry=tel)
    res_on = on.run_matrix(**matrix_kwargs)
    tel.close()
    return res_off, res_on, on, off_path, on_path


def ref_run(tmp_path, **matrix_kwargs):
    """The reference's traced run of the same matrix; its session, trace."""
    run_dir = str(tmp_path / "ref_run")
    tel = ref_for_run_dir(run_dir)
    session = RefSession(REF_SPEC.replace(store="json", store_path=str(tmp_path / "ref.json")),
                         telemetry=tel)
    session.run_matrix(**matrix_kwargs)
    tel.close()
    return session, ref_read_run(run_dir)


def unit_counters(journal, units) -> dict:
    """Each unit's journaled counters, the port's own set apart."""
    return {u.key: split_port_counters(journal.get(u).counters)[0] for u in units}


def assert_one_dataset(events: list[dict]) -> None:
    """The matrix stage of a cost-model matrix: one uncached ``dataset``
    event of the spec's 200 samples, written by the parent (serial: in the
    first unit; parallel: before the dataset is shipped to the workers,
    which measure none), and its counter in the totals."""
    data = [e for e in split_host_stages(events)[1] if e["stage"] in MATRIX_STAGES]
    assert len(data) == 1 and data[0]["stage"] == "dataset" and data[0]["src"] == "main"
    assert data[0]["n"] == 200 and data[0]["cache_hit"] is False and data[0]["stage_s"] == {}
    assert split_port_counters(totals_of(events))[1] == {"dataset.samples_measured": 200}


def test_serial_identical_store_and_trace_covers_every_unit(tmp_path):
    run_dir = tmp_path / "run"
    res_off, res_on, session, off_path, on_path = run_pair(tmp_path, run_dir)
    assert store_values_bytes(off_path) == store_values_bytes(on_path)
    assert_same_cells(res_off, res_on)

    events = read_run(str(run_dir))
    n_units = len(session.last_unit_plan)
    unit_ends = [e for e in events if e["ev"] == "end" and e.get("span") == "unit"]
    assert len(unit_ends) == n_units > 0
    plan = [e for e in events if e["ev"] == "plan"][0]
    assert plan["units_total"] == n_units
    assert plan["experiments_total"] == 8          # 2 algos x 4 experiments
    totals = totals_of(events)
    assert totals["units_completed"] == n_units
    assert totals["experiments_completed"] == 8
    assert session.last_record.extra["telemetry"]["counters"] == totals
    assert "repro_version" in session.last_record.provenance

    # the reference's run of the same matrix: the same events in the same
    # order (clocks and wall-clocks aside; the port's host stages, which the
    # reference does not trace, apart), the same totals and unit counters
    ref_session, ref_events = ref_run(tmp_path)
    shared, _ = split_host_stages(events)
    assert stable_events(shared) == stable_events(ref_events)
    assert_one_propose_per_searcher_step(events, n_drives=4)   # ga's 4 experiments
    assert_one_dataset(events)
    counters, port = split_port_counters(totals)
    assert counters == totals_of(ref_events)
    # the cost model stages no inputs; the dataset is measured once
    assert port == {"dataset.samples_measured": 200}
    assert unit_counters(session.unit_journal(), session.last_unit_plan) == unit_counters(
        RefJournal(ref_session.store, ref_session.journal_namespace()),
        ref_session.last_unit_plan)


@pytest.mark.parametrize("scheduler", ["steal", "static"])
def test_process_executor_identical_store_and_merged_shards(tmp_path, scheduler):
    """Worker traces are absorbed and deleted; totals equal the reference's
    (``scheduler.steals`` depends on which worker pulled which unit, so the
    stealing schedule compares it only against its bound)."""
    kwargs = dict(executor="process", max_workers=3, scheduler=scheduler)
    run_dir = tmp_path / "run"
    res_off, res_on, session, off_path, on_path = run_pair(tmp_path, run_dir, **kwargs)
    assert store_values_bytes(off_path) == store_values_bytes(on_path)
    assert_same_cells(res_off, res_on)
    assert os.listdir(run_dir) == [TRACE_FILE]
    events = read_run(str(run_dir))
    srcs = {e["src"] for e in events}
    assert "main" in srcs and any(s.startswith("shard") for s in srcs)
    unit_ends = [e for e in events if e["ev"] == "end" and e.get("span") == "unit"]
    assert len(unit_ends) == len(session.last_unit_plan)
    totals = totals_of(events)
    assert totals["units_completed"] == len(session.last_unit_plan)

    ref_session, ref_events = ref_run(tmp_path, **kwargs)
    ref_totals = totals_of(ref_events)
    steals = totals.pop("scheduler.steals", 0)
    ref_totals.pop("scheduler.steals", None)
    counters, port = split_port_counters(totals)
    assert counters == ref_totals
    assert port == {"dataset.samples_measured": 200}
    assert_one_dataset(events)
    assert 0 <= steals <= len(session.last_unit_plan)
    assert unit_counters(session.unit_journal(), session.last_unit_plan) == unit_counters(
        RefJournal(ref_session.store, ref_session.journal_namespace()),
        ref_session.last_unit_plan)
    # the same spans and events, in an order that depends on which worker ran
    # what (each worker's lifetime counter snapshot too, so those are left to
    # the totals above)
    def span_events(evs):
        return sorted(stable_events(e for e in evs if e["ev"] not in ("gauge", "counters")),
                      key=json.dumps)

    assert span_events(split_host_stages(events)[0]) == span_events(ref_events)
    assert_one_propose_per_searcher_step(events, n_drives=4)


def test_futures_executor_identical_store(tmp_path):
    from concurrent.futures import ThreadPoolExecutor

    kwargs = dict(executor="futures", max_workers=2)
    res_off, res_on, session, off_path, on_path = run_pair(
        tmp_path, tmp_path / "run", futures_pool=ThreadPoolExecutor(max_workers=2), **kwargs)
    assert store_values_bytes(off_path) == store_values_bytes(on_path)
    assert_same_cells(res_off, res_on)
    assert os.listdir(tmp_path / "run") == [TRACE_FILE]
    events = read_run(str(tmp_path / "run"))
    _, ref_events = ref_run(tmp_path, futures_pool=ThreadPoolExecutor(max_workers=2), **kwargs)
    counters, port = split_port_counters(totals_of(events))
    assert counters == totals_of(ref_events)
    assert port == {"dataset.samples_measured": 200}
    assert_one_dataset(events)
    gauges = [e["value"] for e in events if e.get("gauge") == "scheduler.queue_depth"]
    assert sorted(gauges, reverse=True) == list(range(len(gauges) - 1, -1, -1))


@pytest.mark.parametrize("scheduler", ["steal", "static"])
def test_device_executor_identical_store(tmp_path, two_cpu_devices, scheduler):
    """Two card threads (CPU devices patched in); the reference's device
    executor runs on its one host device with the same unit plan."""
    run_dir = tmp_path / "run"
    kwargs = dict(executor="device", max_workers=2, scheduler=scheduler)
    res_off, res_on, session, off_path, on_path = run_pair(tmp_path, run_dir, **kwargs)
    assert store_values_bytes(off_path) == store_values_bytes(on_path)
    assert_same_cells(res_off, res_on)
    assert os.listdir(run_dir) == [TRACE_FILE]
    events = read_run(str(run_dir))
    assert {e["src"] for e in events} == {"main", "shard0", "shard1"}
    with pytest.warns(UserWarning):      # the reference's host has one device
        ref_session, ref_events = ref_run(tmp_path, **kwargs)
    totals, ref_totals = totals_of(events), totals_of(ref_events)
    totals.pop("scheduler.steals", None)
    ref_totals.pop("scheduler.steals", None)
    counters, port = split_port_counters(totals)
    assert counters == ref_totals
    assert port == {"dataset.samples_measured": 200}
    assert_one_dataset(events)
    cards = {d["device"] for d in session.last_unit_devices.values()}
    # static hands each card a payload; under steal a card's thread may
    # find the queue empty
    assert cards == {"cpu:0", "cpu:1"} if scheduler == "static" else cards <= {"cpu:0", "cpu:1"}
    assert set(session.last_unit_devices) == {u.key for u in session.last_unit_plan}


# --------------------------------------------------- shard merge + recovery


def shard_lines(run_dir, shard, lines):
    path = os.path.join(run_dir, f"trace.shard{shard}.jsonl")
    with open(path, "w") as f:
        f.write("\n".join(lines))
    return path


def test_absorb_is_deterministic_and_preserves_order(tmp_path):
    def build(cls, run_dir):
        os.makedirs(run_dir)
        tel = cls(os.path.join(run_dir, TRACE_FILE), clock=counter_clock())
        tel.event("plan", units_total=2)
        shard_lines(run_dir, 1, ['{"src": "shard1", "seq": 0, "ev": "x"}\n'])
        shard_lines(run_dir, 0, [
            '{"src": "shard0", "seq": 0, "ev": "a"}',
            '{"src": "shard0", "seq": 1, "ev": "b"}\n',
        ])
        assert tel.recover() == 2
        tel.close()
        with open(os.path.join(run_dir, TRACE_FILE), "rb") as f:
            return f.read()

    a = build(Telemetry, str(tmp_path / "a"))
    assert a == build(Telemetry, str(tmp_path / "b")) == build(RefTelemetry, str(tmp_path / "r"))
    events = read_events(str(tmp_path / "a" / TRACE_FILE))
    assert [e.get("src", "main") for e in events[-3:]] == ["shard0", "shard0", "shard1"]
    assert not [n for n in os.listdir(tmp_path / "a") if "shard" in n]


def test_absorb_pads_torn_shard_tail(tmp_path):
    run_dir = str(tmp_path)
    tel = for_run_dir(run_dir)
    tel.event("plan")
    shard_lines(run_dir, 0, ['{"ev": "stage", "src": "shard0"'])   # torn
    shard_lines(run_dir, 1, ['{"ev": "gauge", "src": "shard1", "value": 1}\n'])
    assert tel.recover() == 2
    tel.close()
    events = read_events(os.path.join(run_dir, TRACE_FILE))
    assert [e["ev"] for e in events] == ["plan", "gauge"]


def test_matrix_resume_recovers_orphan_shard_traces(tmp_path):
    """A killed parallel run leaves ``trace.shard<k>.jsonl`` beside the
    trace; the resumed run absorbs them before its own plan, so pre-kill
    spans never inflate the resumed session's progress."""
    run_dir = tmp_path / "run"
    os.makedirs(run_dir)
    orphan = shard_lines(
        str(run_dir), 0,
        ['{"src": "shard0", "seq": 0, "ev": "end", "span": "experiment"}\n'],
    )
    tel = for_run_dir(str(run_dir))
    spec = SPEC.replace(store="json", store_path=str(tmp_path / "s.json"))
    TuningSession(spec, telemetry=tel).run_matrix(resume=True, executor="process",
                                                  max_workers=2)
    tel.close()
    assert not os.path.exists(orphan)
    events = read_run(str(run_dir))
    plan_idx = max(i for i, e in enumerate(events) if e["ev"] == "plan")
    orphan_idx = [i for i, e in enumerate(events)
                  if e.get("src") == "shard0" and e.get("seq") == 0]
    assert orphan_idx and orphan_idx[0] < plan_idx
    state = scan_events(events)
    assert state.complete and state.experiments_done == 8
    assert asdict(state) == asdict(ref_scan_events(events))

    # resumed again: every unit from the journal, counted as skipped
    tel = for_run_dir(str(run_dir))
    TuningSession(spec, telemetry=tel).run_matrix(resume=True)
    tel.close()
    events = read_run(str(run_dir))
    assert totals_of(events)["units_skipped_resume"] == 2
    assert scan_progress(str(run_dir)).complete


# ------------------------------------------------------------------ progress


def test_scan_events_is_positional_after_the_last_plan():
    events = [
        {"ev": "end", "span": "experiment"},       # stale pre-plan activity
        {"ev": "plan", "units_total": 4, "experiments_total": 8,
         "units_done_resume": 1, "experiments_done_resume": 2},
        {"ev": "end", "span": "unit"},
        {"ev": "end", "span": "experiment"},
        {"ev": "end", "span": "experiment"},
        {"ev": "begin", "span": "unit"},           # dangling begin: not done
    ]
    state = scan_events(events)
    assert asdict(state) == asdict(ref_scan_events(events))
    assert (state.units_done, state.units_total) == (2, 4)
    assert (state.experiments_done, state.experiments_total) == (4, 8)
    assert not state.complete
    line = format_progress(state, eta_s=90.0)
    assert line == ref_format_progress(state, eta_s=90.0)
    assert "units 2/4" in line and "experiments 4/8 (50%)" in line and "ETA 90s" in line


# ------------------------------------------------- summarize / export / CLI


@pytest.fixture(scope="module")
def traced_run(tmp_path_factory):
    """One serial run of the port through ``tune_matrix(telemetry_dir=...)``
    into a results directory, shared by the consumer tests."""
    from repro_torch import tune_matrix

    tmp = tmp_path_factory.mktemp("traced")
    run_dir = str(tmp / "run")
    tune_matrix(SPEC.replace(store="json", store_path=str(tmp / "s.json")),
                out_dir=run_dir, telemetry_dir=run_dir)
    return run_dir


def test_summarize_counts_and_progress(traced_run):
    s = summarize(traced_run)
    assert s == ref_summarize(traced_run)
    assert render_summary(s) == ref_render_summary(s)
    assert s["units_done"] == 2 and s["experiments_done"] == 8
    assert s["counters"]["experiments_completed"] == 8
    assert s["counters"]["store_misses"] > 0
    assert scan_progress(traced_run).complete
    cells = {(c["algo"], c["sample_size"]): c for c in s["cells"]}
    assert set(cells) == {("rs", 25), ("ga", 25)}
    assert all(c["n_experiments"] == 4 for c in cells.values())


def test_report_telemetry_section_is_the_references(traced_run):
    """The report's Telemetry section of a traced results directory: the
    record's counter totals and the trace's stage table, as the reference
    renders them from the same directory."""
    from repro.analysis.records import load_all as ref_load_all
    from repro.analysis.report import _telemetry_section as ref_section
    from repro_torch.analysis.records import load_all
    from repro_torch.analysis.report import _telemetry_section

    text = _telemetry_section(load_all(traced_run), traced_run)
    assert text == ref_section(ref_load_all(traced_run), traced_run)
    assert "### Counter totals" in text and "experiments_completed" in text


def test_chrome_export_schema(traced_run):
    events = read_run(traced_run)
    assert chrome_trace(events) == ref_chrome_trace(events)
    path = export_chrome(traced_run)
    assert path == os.path.join(traced_run, "trace_chrome.json")
    with open(path) as f:
        doc = json.load(f)
    events = doc["traceEvents"]
    assert events and {e["ph"] for e in events} <= {"B", "E", "X", "C", "i", "M"}
    for e in events:
        assert isinstance(e["name"], str) and "pid" in e
        if e["ph"] != "M":
            assert e["ts"] >= 0
        if e["ph"] == "X":
            assert e["dur"] >= 0
    assert sum(e["ph"] == "B" for e in events) == sum(e["ph"] == "E" for e in events)
    assert {m["args"]["name"] for m in events if m["ph"] == "M"} == {"main"}


def test_chrome_export_normalizes_per_writer_epochs():
    events = [
        {"t": 100.0, "seq": 0, "src": "main", "ev": "begin", "span": "matrix"},
        {"t": 5.0, "seq": 0, "src": "shard0", "ev": "stage",
         "stage": "compile", "dur": 0.25},
        {"t": 101.0, "seq": 1, "src": "main", "ev": "end", "span": "matrix", "dur": 1.0},
    ]
    doc = chrome_trace(events)
    assert doc == ref_chrome_trace(events)
    by = {(e["ph"], e.get("name")): e for e in doc["traceEvents"]}
    assert by[("B", "matrix")]["ts"] == 0.0 and by[("X", "compile")]["ts"] == 0.0
    assert by[("X", "compile")]["dur"] == 0.25e6
    assert by[("B", "matrix")]["pid"] != by[("X", "compile")]["pid"]


def test_cli_summarize_tail_export(traced_run, tmp_path, capsys):
    outs = []
    for cli in (port_cli, ref_cli):
        assert cli([traced_run]) == 0                # bare run dir summarizes
        summary = capsys.readouterr().out
        assert cli(["tail", traced_run]) == 0
        outs.append((summary, capsys.readouterr().out))
    assert outs[0] == outs[1]
    summary, tail = outs[0]
    assert "counter totals" in summary and "per-cell stage breakdown" in summary
    assert "units 2/2" in tail and "experiments 8/8 (100%)" in tail
    dest = str(tmp_path / "chrome.json")
    assert port_cli(["export", traced_run, "-o", dest]) == 0
    with open(dest) as f:
        assert json.load(f)["traceEvents"]
    # the CLI in a process of its own, as a user runs it
    out = subprocess.run([sys.executable, "-m", "repro_torch.telemetry", traced_run],
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")})
    assert out.returncode == 0 and out.stdout == summary


def test_assert_counters_agrees_with_the_reference_tool(traced_run, capsys):
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    try:
        import assert_counters as ref_tool
    finally:
        sys.path.remove(os.path.join(ROOT, "tools"))
    cases = (["experiments_completed==8", "units_completed>=2", "--plan", "executor=serial"],
             ["experiments_completed==9"], ["store_misses<1", "nonsense"],
             ["--plan", "scheduler=static"])
    for args in cases:
        got = port_assert_counters([traced_run, *args]), capsys.readouterr().out
        want = ref_tool.main([traced_run, *args]), capsys.readouterr().out
        assert got == want
    assert port_assert_counters([traced_run, "experiments_completed==8"]) == 0
    assert port_assert_counters([traced_run, "experiments_completed==9"]) == 1


# ------------------------------------------------- stage totals on the cuda backend


def _cuda_matrix(tmp_path, name: str, telemetry=None):
    """A small ``cuda``-backend matrix on the plain versions with the clock
    ticking 1.0 a reading; returns the session and its results."""
    spec = TuningSpec(kernel="harris", backend="cuda",
                      backend_kwargs={"x": 64, "y": 128, "device": "cpu", "repeats": 1},
                      algorithms=("rs", "rf", "ga"), dataset_size=40,
                      design=ExperimentDesign(sample_sizes=(12,), n_experiments=(2,),
                                              final_repeats=2),
                      store="json", store_path=str(tmp_path / f"{name}.json"))
    ticks = itertools.count()
    port_clock.set_timer(lambda: float(next(ticks)))
    clear_input_cache()
    try:
        session = TuningSession(spec, telemetry=telemetry)
        results = session.run_matrix()
    finally:
        port_clock.set_timer(None)
    return session, results


def test_cuda_stage_totals_equal_stage_s(tmp_path):
    """The cuda backend (plain versions on the CPU, the clock ticking 1.0 a
    reading): each measurement stage's trace total, and the matrix's
    ``dataset`` stage's, equals the units' summed ``stage_s`` exactly — rf's
    prediction measurements included — the only other stage is the
    trace-only ``propose``; the port's counters are exactly the stagings'
    input-cache lookups and shared-copy reuses and the dataset's samples; the dataset stage lies in the first unit,
    disjoint from every other stage, its inner measurement tracing nothing;
    results, winners and store values are the same untraced; and the
    report's stage table is the reference's for the same directory."""
    from repro.analysis.report import _telemetry_section as ref_section
    from repro_torch.analysis.report import _telemetry_section

    tel = for_run_dir(str(tmp_path / "run"))
    session, results = _cuda_matrix(tmp_path, "s", telemetry=tel)
    tel.close()
    events = read_run(str(tmp_path / "run"))
    journal = session.unit_journal()
    stage_s: dict[str, float] = {}
    for u in session.last_unit_plan:
        for k, v in journal.get(u).stage_s.items():
            stage_s[k] = stage_s.get(k, 0.0) + v
    totals = {k: v["total_s"] for k, v in stage_percentiles(events).items()}
    measured = {k: v for k, v in totals.items() if k in (*PIPELINE_STAGES, *MATRIX_STAGES)}
    assert set(measured) == {"screen", "inputs", "compile", "time", "record", "dataset"}
    assert measured == stage_s
    assert set(totals) - set(measured) == {"propose", "session"}
    first = session.last_unit_results[0]
    assert first.unit == session.last_unit_plan[0]
    assert [set(r.stage_s) >= {"dataset"} for r in session.last_unit_results] == [True, False, False]
    assert first.stage_s == journal.get(first.unit).stage_s
    stages = sorted((e["t"] - e["dur"], e["t"], e["stage"]) for e in events if e["ev"] == "stage")
    assert all(a[1] <= b[0] for a, b in zip(stages, stages[1:]))     # disjoint
    (data,) = [e for e in events if e["ev"] == "stage" and e["stage"] == "dataset"]
    assert data["dur"] == first.stage_s["dataset"] and data["n"] == 40
    assert data["cache_hit"] is False
    assert set(data["stage_s"]) == {"screen", "inputs", "compile", "time", "record"}
    counters, port = split_port_counters(totals_of(events))
    assert counters["compiles"] > 0 and counters["experiments_completed"] == 6
    assert counters["store_misses"] > 0
    # one lookup of the input cache a staging, and one draw in the process
    # at most (the dataset's untraced measurement may make it)
    stagings = [e for e in events if e["ev"] == "stage" and e["stage"] == "inputs"]
    hits = sum(e["cache_hit"] for e in stagings)
    assert len(stagings) > 0 and len(stagings) - hits <= 1
    # one copy to the device a matrix call: the dataset's untraced
    # measurement makes it, and every traced staging takes that copy
    reuses = sum(e["device_reuse"] for e in stagings)
    assert reuses == len(stagings)
    assert port == {k: v for k, v in (("inputs.cache_hits", hits),
                                      ("inputs.cache_misses", len(stagings) - hits),
                                      ("inputs.device_reuses", reuses),
                                      ("dataset.samples_measured", 40)) if v}
    off_session, off = _cuda_matrix(tmp_path, "off")
    assert_same_cells(results, off)
    for key, cell in results.cells.items():
        np.testing.assert_array_equal(cell.best_indices, off.cells[key].best_indices)
    assert store_values_bytes(str(tmp_path / "s.json")) == \
        store_values_bytes(str(tmp_path / "off.json"))
    assert set(off_session.last_unit_results[0].stage_s) == set(first.stage_s)
    assert _telemetry_section({}, str(tmp_path / "run")) == ref_section(
        {}, str(tmp_path / "run"))
    assert "### Pipeline stage durations" in _telemetry_section({}, str(tmp_path / "run"))
