"""The readers of the program's host stages on synthetic runs:
``inputs_ms_per_sample`` from the calls' ``stage_s``, and
``propose_idle_ms_per_sample`` / ``session_idle_ms_per_sample`` from the
traced window's idle gaps labelled by those stages."""

from __future__ import annotations

import pytest

from bench.harness import layout, runner, trace

CELL = layout.cell("harris.ga-200")
HOST = ("propose_idle_ms_per_sample", "session_idle_ms_per_sample")


def read(metric: str, run) -> float | None:
    return layout.reader(metric).read(run)


def a_run(stage_s: list[dict], samples: int = 200, trace_summary=None) -> runner.Run:
    calls = [{"samples": samples, "stage_s": s, "wall_s": 1.0} for s in stage_s]
    return runner.Run(cell=CELL, setup_s=1.0, start=0.0, calls=calls, trace=trace_summary)


def test_inputs_ms_per_sample_sums_the_calls_stage():
    run = a_run([{"inputs": 0.5, "compile": 0.1}, {"inputs": 0.25, "compile": 0.2}])
    assert read("inputs_ms_per_sample", run) == pytest.approx(0.75 / 400 * 1e3)
    # a call that staged nothing counts 0
    run = a_run([{"inputs": 0.5}, {"compile": 0.2}])
    assert read("inputs_ms_per_sample", run) == pytest.approx(0.5 / 400 * 1e3)
    run = a_run([{"inputs": 0.0}])
    assert read("inputs_ms_per_sample", run) == 0.0


def test_inputs_ms_per_sample_is_absent_without_the_stage():
    """A program that stages its inputs inside ``compile`` reports nothing."""
    assert read("inputs_ms_per_sample", a_run([{"compile": 0.5}, {"time": 0.1}])) is None
    assert read("inputs_ms_per_sample", a_run([])) is None


def summary(gaps: dict) -> dict:
    return {"busy_s": 1.0, "window_s": 10.0, "idle_gaps": [[k, v] for k, v in gaps.items()]}


@pytest.mark.parametrize("metric,label", [(HOST[0], "propose stage"),
                                          (HOST[1], "session stage")])
def test_idle_readers_divide_the_labelled_seconds(metric, label):
    gaps = {"compile stage": 3.0, "propose stage": 2.0, "session stage": 0.5,
            "search (in a call, outside every stage)": 0.25}
    run = a_run([{"time": 1.0}, {"time": 1.0}], samples=250, trace_summary=summary(gaps))
    assert read(metric, run) == pytest.approx(gaps[label] / 500 * 1e3)


@pytest.mark.parametrize("metric", HOST)
def test_idle_readers_are_absent_untraced_or_without_the_label(metric):
    assert read(metric, a_run([{"time": 1.0}])) is None
    traced = a_run([{"time": 1.0}], trace_summary=summary(
        {"compile stage": 3.0, "search (in a call, outside every stage)": 2.0}))
    assert read(metric, traced) is None
    assert read(metric, a_run([], trace_summary=summary({"propose stage": 1.0,
                                                         "session stage": 1.0}))) is None


def test_host_stage_labels_come_from_the_trace_summary():
    """The harness labels idle gaps with any stage the program traces: a
    ``propose`` and a ``session`` interval inside a call become their
    readers' labels, and the residual keeps what neither covers."""
    us = 1e6
    events = [
        {"ph": "X", "cat": "user_annotation", "name": trace.MARKER, "ts": 100 * us, "dur": 6 * us},
        {"ph": "X", "cat": "kernel", "name": "k", "ts": 102 * us, "dur": 1 * us},
    ]
    s = trace.summarize(events, 50.0, [(50.0, 56.0)],
                        [(50.0, 50.5, "session"), (50.5, 52.0, "propose"),
                         (52.0, 53.0, "time"), (53.0, 55.0, "propose"),
                         (55.5, 56.0, "session")])
    gaps = dict(s["idle_gaps"])
    assert gaps["propose stage"] == pytest.approx(3.5)
    assert gaps["session stage"] == pytest.approx(1.0)
    assert gaps["search (in a call, outside every stage)"] == pytest.approx(0.5)
    run = a_run([{"time": 1.0}], samples=100, trace_summary=s)
    assert read(HOST[0], run) == pytest.approx(35.0)
    assert read(HOST[1], run) == pytest.approx(10.0)


def test_the_readers_are_listed_where_they_find_something():
    per_layer = {m["name"]: m for m in layout.load_benchmark()["per_layer"]}
    assert per_layer["inputs_ms_per_sample"]["workloads"] == ["harris.ga-200", "harris.rf-100"]
    cells = [w["name"] for w in layout.load_benchmark()["workloads"]]
    for metric in HOST:
        assert per_layer[metric]["workloads"] == cells
        assert per_layer[metric]["moves"] == "samples_per_s"
