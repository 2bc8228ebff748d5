"""The port's trace of a tune call's host time, on the CPU.

The measurement stages the workload's inputs in an ``inputs`` stage of its
own (charged to its stage clock, once a measurement); the engine's ``drive``
emits a ``propose`` stage event around each searcher step and
``TuningSession.run`` two ``session`` stage events around its own work, both
trace-only.  Held here, on the ``cuda`` backend's plain versions
(``device="cpu"``) with the clock seam ticking 1.0 a reading:

* ``stage_s["inputs"]`` exists, is charged on the first fill only, equals
  the trace's ``inputs`` total, and its event carries the inputs' bytes and
  the draw's and copy's seconds;
* every ``propose`` and ``session`` interval is disjoint from every
  measurement stage's and from each other, and ``bo_gp``'s and ``rf``'s
  propose events carry their surrogate's ``fit_s`` and ``acquire_s``;
* without a sink, ``drive`` reads the clock no more than the bare ask/tell
  loop does; results and stores are identical with the sink on and off;
* the sink stamps events on ``time.perf_counter``, the clock the
  benchmark's profiler reader maps onto the device's.
"""

from __future__ import annotations

import itertools
import json
import time

import pytest

from repro_torch import TuningSession, TuningSpec
from repro_torch.core import clock as port_clock
from repro_torch.core.engine import drive
from repro_torch.core.measurement import CallableMeasurement
from repro_torch.core.searchers import make_searcher
from repro_torch.core.space import paper_space
from repro_torch.cuda_bench.measure import CudaMeasurement
from repro_torch.cuda_bench.workloads import make_workload
from repro_torch.telemetry import NULL_TELEMETRY, Telemetry, read_events
from repro_torch.telemetry.events import HOST_STAGES, PIPELINE_STAGES

X, Y = 64, 128
CONFIGS = [dict(t_x=1, t_y=1, t_z=z, w_x=1, w_y=1, w_z=1) for z in (1, 2)]
BUDGETS = {"ga": 24, "bo_gp": 12, "rf": 20}
#: the forest's candidate pool, cut to what the 64x128 space's constraints
#: let rejection sampling draw
KWARGS = {"rf": {"pool_size": 256}}


class CountingClock:
    """A clock seam that ticks 1.0 a reading and counts its readings."""

    def __init__(self):
        self.n = 0

    def __call__(self) -> float:
        self.n += 1
        return float(self.n)


@pytest.fixture
def ticking():
    clock = CountingClock()
    port_clock.set_timer(clock)
    try:
        yield clock
    finally:
        port_clock.set_timer(None)


def stage_events(path, names=None) -> list[dict]:
    return [e for e in read_events(str(path))
            if e["ev"] == "stage" and (names is None or e["stage"] in names)]


def interval(e: dict) -> tuple[float, float]:
    return e["t"] - e["dur"], e["t"]


# ------------------------------------------------------------ the inputs stage


@pytest.mark.parametrize("kernel,n_bytes", [("harris", 4 * X * Y), ("mandelbrot", 0)])
def test_inputs_stage_is_charged_once_a_measurement(tmp_path, ticking, kernel, n_bytes):
    tel = Telemetry(str(tmp_path / "trace.jsonl"))
    m = CudaMeasurement(make_workload(kernel, X, Y), repeats=1, device="cpu")
    m.set_telemetry(tel)
    m.measure_batch(CONFIGS)                    # two geometries: two fills
    m.measure_batch([{**CONFIGS[0], "t_x": 2}])  # a third fill
    first = m.stage_times()
    m.reset()
    m.measure_final(dict(CONFIGS[0], t_x=4), repeats=2)   # a fill after reset
    after_reset = m.stage_times()
    tel.close()

    assert m.n_compiles == 4
    events = stage_events(tmp_path / "trace.jsonl", {"inputs"})
    assert len(events) == 1
    (ev,) = events
    assert first["inputs"] == ev["dur"] > 0
    assert "inputs" not in after_reset and after_reset["compile"] > 0
    assert ev["bytes"] == n_bytes
    assert ev["draw_s"] > 0 and ev["copy_s"] > 0
    assert ev["draw_s"] + ev["copy_s"] < ev["dur"]
    # the inputs stage closes before the first compile stage opens
    compiles = stage_events(tmp_path / "trace.jsonl", {"compile"})
    assert interval(ev)[1] < min(interval(e)[0] for e in compiles)


def test_inputs_stage_leaves_the_tensors_unchanged():
    w = make_workload("harris", X, Y, input_seed=3)
    timings: dict = {}
    timed = w.materialize("cpu", timings)
    plain = w.materialize("cpu")
    assert set(timings) == {"draw_s", "copy_s"}
    assert len(timed) == len(plain) == 1
    assert timed[0].dtype == plain[0].dtype and timed[0].shape == (X, Y)
    assert timed[0].numpy().tobytes() == plain[0].numpy().tobytes()
    assert timed[0].numpy().tobytes() == w.arrays()[0].tobytes()


# ---------------------------------------------------- propose and session stages


def traced_run(tmp_path, algo: str):
    spec = TuningSpec(kernel="harris", backend="cuda",
                      backend_kwargs={"x": X, "y": Y, "device": "cpu", "repeats": 1},
                      searcher=algo, searcher_kwargs=KWARGS.get(algo, {}),
                      budget=BUDGETS[algo], seed=5, final_repeats=2)
    tel = Telemetry(str(tmp_path / f"{algo}.jsonl"))
    TuningSession(spec, telemetry=tel).run()
    tel.close()


@pytest.mark.parametrize("algo", sorted(BUDGETS))
def test_host_stages_are_disjoint_from_the_measurement(tmp_path, ticking, algo):
    traced_run(tmp_path, algo)
    path = tmp_path / f"{algo}.jsonl"
    events = stage_events(path)
    assert {e["stage"] for e in events} == {*PIPELINE_STAGES, *HOST_STAGES}
    host = [e for e in events if e["stage"] in HOST_STAGES]
    spans = sorted(interval(e) for e in events)
    for (s0, e0), (s1, e1) in zip(spans, spans[1:]):
        assert e0 <= s1, ((s0, e0), (s1, e1))
    # every host interval against every other interval, pairwise
    for h in host:
        a0, a1 = interval(h)
        for e in events:
            if e is not h:
                b0, b1 = interval(e)
                assert a1 <= b0 or b1 <= a0, (h, e)

    sessions = [e for e in host if e["stage"] == "session"]
    assert [e["part"] for e in sessions] == ["setup", "record"]
    proposes = [e for e in host if e["stage"] == "propose"]
    rounds = [e for e in read_events(str(path))
              if e["ev"] == "end" and e.get("span") == "round"]
    assert len(proposes) == len(rounds) + 2 and {e["algo"] for e in proposes} == {algo}
    # the session's setup opens the call, its record closes it
    assert interval(sessions[0])[1] <= min(interval(e)[0] for e in events if e is not sessions[0])
    assert interval(sessions[1])[0] >= max(interval(e)[1] for e in events
                                           if e is not sessions[1])
    split = {"fit_s", "acquire_s"}
    for e in proposes:
        if algo in ("bo_gp", "rf"):
            assert split <= set(e) and e["fit_s"] + e["acquire_s"] <= e["dur"]
        else:
            assert not split & set(e)
    if algo in ("bo_gp", "rf"):
        assert sum(e["fit_s"] for e in proposes) > 0
        assert sum(e["acquire_s"] for e in proposes) > 0


def test_host_stages_are_not_charged_to_the_stage_clock(tmp_path, ticking):
    session = TuningSession(
        TuningSpec(kernel="harris", backend="cuda",
                   backend_kwargs={"x": X, "y": Y, "device": "cpu", "repeats": 1},
                   searcher="ga", budget=BUDGETS["ga"], seed=5, final_repeats=2),
        telemetry=Telemetry(str(tmp_path / "t.jsonl")))
    session.run()
    session.telemetry.close()
    stage_s = session.last_record.extra["backend_provenance"]["stage_s"]
    assert set(stage_s) == set(PIPELINE_STAGES)
    totals: dict[str, float] = {}
    for e in stage_events(tmp_path / "t.jsonl", PIPELINE_STAGES):
        totals[e["stage"]] = totals.get(e["stage"], 0.0) + e["dur"]
    assert {k: round(v, 6) for k, v in totals.items()} == stage_s


# ------------------------------------------------------------ off means off


def objective(cfg) -> float:
    return float(sum((i + 1) * v for i, v in enumerate(sorted(cfg.values())))) / 7.0


@pytest.mark.parametrize("algo", ["ga", "bo_gp", "rf"])
def test_drive_reads_no_clock_without_a_sink(tmp_path, ticking, algo):
    """Without a sink, ``drive`` adds no clock reading to the bare ask/tell
    loop (the searcher's own ``fit_s``/``acquire_s`` reads are the loop's);
    with one, each ``propose`` event costs two."""
    space, budget = paper_space(), BUDGETS[algo]

    def bare_loop() -> int:
        searcher = make_searcher(algo, space, seed=3)
        m = CallableMeasurement(objective)
        n0 = ticking.n
        searcher.start(budget)
        while configs := searcher.ask():
            searcher.tell(configs, m.measure_batch(configs))
        searcher.finish()
        return ticking.n - n0

    def driven(tel) -> tuple[int, object]:
        searcher = make_searcher(algo, space, seed=3)
        n0 = ticking.n
        result = drive(searcher, CallableMeasurement(objective), budget, telemetry=tel)
        return ticking.n - n0, result

    bare = bare_loop()
    off, r_off = driven(NULL_TELEMETRY)
    assert off == bare
    assert (bare == 0) == (algo == "ga")
    ticks = itertools.count()
    tel = Telemetry(str(tmp_path / "d.jsonl"), clock=lambda: float(next(ticks)))
    on, r_on = driven(tel)
    tel.close()
    n_propose = len(stage_events(tmp_path / "d.jsonl", {"propose"}))
    assert on - off == 2 * n_propose > 0
    assert r_on.history_values == r_off.history_values
    assert r_on.history_configs == r_off.history_configs


@pytest.mark.parametrize("algo", ["ga", "bo_gp", "rf"])
def test_results_and_stores_identical_with_tracing_on_and_off(tmp_path, algo):
    out = {}
    for mode in ("off", "on"):
        spec = TuningSpec(kernel="harris", backend="costmodel", backend_kwargs={"chip": "v5e"},
                          searcher=algo, budget=BUDGETS[algo], seed=9, final_repeats=3,
                          store="json", store_path=str(tmp_path / f"{mode}.json"))
        tel = Telemetry(str(tmp_path / f"{mode}.jsonl")) if mode == "on" else None
        session = TuningSession(spec, telemetry=tel)
        r = session.run()
        if tel is not None:
            tel.close()
        with open(tmp_path / f"{mode}.json") as f:
            store = json.load(f)
        # a winners index entry carries the wall-clock time it was written
        winners = {k: {f: v for f, v in json.loads(w).items() if f != "fresh"}
                   for k, w in store.pop("winners").items()}
        out[mode] = (r.best_config, r.best_value, r.final_value, r.history_values,
                     r.history_configs, store, winners, session.cache_key)
    assert out["on"] == out["off"]
    hosts = {e["stage"] for e in stage_events(tmp_path / "on.jsonl", HOST_STAGES)}
    assert hosts == {"propose", "session"}


# ------------------------------------------------------------ the clock


def test_trace_stamps_come_from_perf_counter(tmp_path):
    """The benchmark's trace reader maps the program's event stamps onto the
    profiler's clock through a ``time.perf_counter`` reading: the sink's
    default stamps must be that clock's."""
    port_clock.set_timer(None)
    assert port_clock.default_timer is time.perf_counter
    tel = Telemetry(str(tmp_path / "c.jsonl"))
    before = time.perf_counter()
    tel.stage("propose", 0.0, algo="ga")
    after = time.perf_counter()
    tel.close()
    (ev,) = stage_events(tmp_path / "c.jsonl")
    assert before - 1e-6 <= ev["t"] <= after + 1e-6
