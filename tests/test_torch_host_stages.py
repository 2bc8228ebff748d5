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
  propose events carry their surrogate's ``fit_s`` and ``acquire_s``
  (``rf`` also its pool's ``pool_s``); every propose event counts the rows
  its space screened (``screened_rows``), all of them in the constraint's
  batch form on the cuda space and none under a batchless lambda;
* without a sink, ``drive`` reads the clock no more than the bare ask/tell
  loop does, and reads no screen count; results and stores are identical
  with the sink on and off;
* the sink stamps events on ``time.perf_counter``, the clock the
  benchmark's profiler reader maps onto the device's;
* the process's input cache: a miss, a hit and a draw after eviction give
  the bytes of ``arrays()`` and of the reference's ``materialize()``; other
  fields miss; no kernel writes its inputs, no tensor aliases the cache and
  its arrays are read-only; one lookup counted a measurement, two threads
  that miss on one key draw once, and an entry over the cap is not kept;
* a matrix call's shared device copy (``shared_inputs``): one copy of each
  ``(workload, device)`` a call, the rest counted as ``inputs.device_reuses``;
  values and store bytes equal to the units run one by one outside any
  scope; nothing held once the call returns or raises; two threads in one
  scope copy once; distinct workloads stage apart; ``run()`` and a bare
  ``materialize`` copy every time.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch import ExperimentDesign, TuningSession, TuningSpec
from repro_torch.core import MeasurementStore
from repro_torch.core import clock as port_clock
from repro_torch.core.engine import drive
from repro_torch.core.measurement import CallableMeasurement
from repro_torch.core.searchers import make_searcher
from repro_torch.core.space import SearchSpace, paper_space
from repro_torch.cuda_bench.measure import CudaMeasurement
from repro_torch.cuda_bench import workloads
from repro_torch.cuda_bench.workloads import (
    CudaWorkload,
    cached_inputs,
    clear_input_cache,
    make_workload,
    shared_inputs,
)
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


@pytest.fixture(autouse=True)
def fresh_input_cache():
    """Each test starts on an empty input cache, so test order decides
    nothing (the first staging of a workload draws)."""
    clear_input_cache()
    yield
    clear_input_cache()


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
    assert set(timings) == {"draw_s", "copy_s", "cache_hit", "device_reuse"}
    assert timings["device_reuse"] == 0     # outside a scope: a copy of its own
    assert len(timed) == len(plain) == 1
    assert timed[0].dtype == plain[0].dtype and timed[0].shape == (X, Y)
    assert timed[0].numpy().tobytes() == plain[0].numpy().tobytes()
    assert timed[0].numpy().tobytes() == w.arrays()[0].tobytes()


# ------------------------------------------------------------ the input cache

#: kernels with inputs (mandelbrot has none and bypasses the cache)
INPUT_KERNELS = ("add", "harris")
LAUNCH_CONFIGS = [
    {},
    dict(t_x=2, t_y=1, t_z=2, w_x=2, w_y=2, w_z=2),
    dict(t_x=1, t_y=1, t_z=3, w_x=3, w_y=1, w_z=1),
    dict(t_x=4, t_y=1, t_z=1, w_x=1, w_y=1, w_z=4),
]


def staged(w, device="cpu") -> tuple[tuple, dict]:
    timings: dict = {}
    return w.materialize(device, timings), timings


def assert_bytes(tensors, arrays) -> None:
    assert len(tensors) == len(arrays) > 0
    for t, a in zip(tensors, arrays, strict=True):
        assert t.dtype == torch.float32 and tuple(t.shape) == a.shape
        assert t.numpy().tobytes() == np.asarray(a).tobytes()


@pytest.mark.parametrize("kernel", INPUT_KERNELS)
@pytest.mark.parametrize("input_seed", [0, 3])
def test_cached_inputs_are_byte_identical_to_the_reference(monkeypatch, kernel, input_seed):
    """A miss, a hit and a draw after eviction each give the bytes of the
    uncached ``arrays()`` and of the reference's ``materialize()``."""
    from repro.pallas_bench import make_workload as ref_make_workload

    w = make_workload(kernel, X, Y, input_seed=input_seed)
    ref = tuple(np.asarray(a) for a in ref_make_workload(kernel, X, Y, input_seed).materialize())
    plain = w.arrays()
    miss, t_miss = staged(w)
    hit, t_hit = staged(w)
    assert (t_miss["cache_hit"], t_hit["cache_hit"]) == (0, 1)
    # a cap that holds one workload's arrays: another workload evicts this one
    monkeypatch.setattr(workloads, "INPUT_CACHE_BYTES", sum(a.nbytes for a in plain))
    staged(make_workload(kernel, X, Y, input_seed=input_seed + 1))
    assert cached_inputs(w) is None
    again, t_again = staged(w)
    assert t_again["cache_hit"] == 0
    for got in (miss, hit, again):
        assert_bytes(got, plain)
        assert_bytes(got, ref)
    assert_bytes(tuple(torch.from_numpy(a.copy()) for a in cached_inputs(w)), ref)


@pytest.mark.parametrize("field,value", [("input_seed", 1), ("x", 2 * X), ("y", 2 * Y)])
def test_another_field_misses(field, value):
    base = make_workload("harris", X, Y, input_seed=0)
    staged(base)
    other = dataclasses.replace(base, **{field: value})
    got, timings = staged(other)
    assert timings["cache_hit"] == 0
    assert_bytes(got, other.arrays())
    assert staged(base)[1]["cache_hit"] == 1
    assert workloads._INPUT_CACHE.nbytes == sum(
        a.nbytes for w in (base, other) for a in w.arrays())


def test_the_least_recently_used_entry_goes_first(monkeypatch):
    a, b, c = (make_workload("harris", X, Y, input_seed=s) for s in (0, 1, 2))
    monkeypatch.setattr(workloads, "INPUT_CACHE_BYTES", 2 * 4 * X * Y)
    staged(a), staged(b)
    assert staged(a)[1]["cache_hit"] == 1     # a is now the most recent
    staged(c)
    assert cached_inputs(b) is None
    assert cached_inputs(a) is not None and cached_inputs(c) is not None
    assert workloads._INPUT_CACHE.nbytes == 2 * 4 * X * Y


@pytest.mark.parametrize("kernel", INPUT_KERNELS)
def test_no_kernel_writes_its_inputs(kernel):
    """The staged tensors and the cache's arrays hold the drawn bytes after
    launches over several configs (the plain versions here; the card's in
    ``tests/test_torch_cuda.py``); the tensors share no memory with the
    cache, whose arrays are read-only."""
    w = make_workload(kernel, X, Y)
    plain = w.arrays()
    inputs, _ = staged(w)
    cached = cached_inputs(w)
    assert cached is not None and len(cached) == len(plain)
    for a, t in zip(cached, inputs, strict=True):
        assert not a.flags.writeable
        with pytest.raises(ValueError):
            a[0, 0] = 1.0
        assert not np.shares_memory(t.numpy(), a)
    for cfg in LAUNCH_CONFIGS:
        w.run(inputs, cfg, "cpu")
    assert_bytes(inputs, plain)
    assert_bytes(tuple(torch.from_numpy(a.copy()) for a in cached_inputs(w)), plain)
    # a tensor handed out may be written without reaching the cache
    inputs[0].fill_(0.0)
    assert_bytes(staged(w)[0], plain)


def test_mandelbrot_bypasses_the_cache(tmp_path):
    w = make_workload("mandelbrot", X, Y)
    got, timings = staged(w)
    assert got == () and "cache_hit" not in timings and "device_reuse" not in timings
    assert cached_inputs(w) is None and workloads._INPUT_CACHE.nbytes == 0
    tel = Telemetry(str(tmp_path / "t.jsonl"))
    m = CudaMeasurement(w, repeats=1, device="cpu")
    m.set_telemetry(tel)
    m.measure_batch(CONFIGS[:1])
    tel.close()
    (ev,) = stage_events(tmp_path / "t.jsonl", {"inputs"})
    assert "cache_hit" not in ev
    counters = [e for e in read_events(str(tmp_path / "t.jsonl")) if e["ev"] == "counters"]
    assert not any(k.startswith("inputs.") for e in counters for k in e["counters"])


def test_measurements_count_one_lookup_each(tmp_path):
    """Two measurements of one workload under one sink: one miss, then one
    hit, on the counters and on the ``inputs`` events."""
    tel = Telemetry(str(tmp_path / "t.jsonl"))
    for _ in range(2):
        m = CudaMeasurement(make_workload("harris", X, Y), repeats=1, device="cpu")
        m.set_telemetry(tel)
        m.measure_batch(CONFIGS)
        m.measure_final(CONFIGS[0], repeats=1)
    tel.close()
    events = stage_events(tmp_path / "t.jsonl", {"inputs"})
    assert [e["cache_hit"] for e in events] == [0, 1]
    assert all(e["bytes"] == 4 * X * Y for e in events)
    counters = [e for e in read_events(str(tmp_path / "t.jsonl"))
                if e["ev"] == "counters"][-1]["counters"]
    assert (counters["inputs.cache_misses"], counters["inputs.cache_hits"]) == (1, 1)


def test_two_threads_that_miss_together_draw_once():
    calls = []

    def slow_draw(x, y, seed):
        calls.append(seed)
        time.sleep(0.3)   # the other thread asks while this one draws
        return workloads.KERNEL_BENCHES["harris"].make_inputs(x, y, seed)

    w = CudaWorkload(dataclasses.replace(workloads.KERNEL_BENCHES["harris"],
                                         make_inputs=slow_draw), X, Y)
    start = threading.Barrier(2)
    got: list = [None, None]

    def stage(i):
        start.wait()
        got[i] = staged(w)

    threads = [threading.Thread(target=stage, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert len(calls) == 1
    assert sorted(timings["cache_hit"] for _, timings in got) == [0, 1]
    for tensors, _ in got:
        assert_bytes(tensors, make_workload("harris", X, Y).arrays())
    assert not np.shares_memory(got[0][0][0].numpy(), got[1][0][0].numpy())


def test_cache_holds_under_thread_contention(monkeypatch):
    """More threads than cores stage four workloads in random order under a
    cap that holds two, with the interpreter switching threads often: every
    staging gives the drawn bytes, and the cache's byte count equals what it
    holds and stays under the cap (a lost update would break either)."""
    import os
    import random
    import sys

    ws = [make_workload("harris", X, Y, input_seed=s) for s in range(4)]
    want = {w.cache_key: w.arrays()[0].tobytes() for w in ws}
    monkeypatch.setattr(workloads, "INPUT_CACHE_BYTES", 2 * 4 * X * Y)
    n_threads = 2 * (os.cpu_count() or 2) + 2
    faults: list = []

    def stage(seed):
        rng = random.Random(seed)
        for _ in range(40):
            w = rng.choice(ws)
            got = w.materialize("cpu")[0].numpy().tobytes()
            if got != want[w.cache_key]:
                faults.append(w.cache_key)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=stage, args=(i,)) for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert faults == []
    cache = workloads._INPUT_CACHE
    held = sum(a.nbytes for arrays in cache._entries.values() for a in arrays)
    assert cache.nbytes == held <= workloads.INPUT_CACHE_BYTES
    assert cache._drawing == {}


def test_a_draw_that_fails_is_not_kept():
    def failing(x, y, seed):
        raise RuntimeError("draw failed")

    w = CudaWorkload(dataclasses.replace(workloads.KERNEL_BENCHES["harris"],
                                         make_inputs=failing), X, Y)
    for _ in range(2):   # the second asks again: nothing of the first is left
        with pytest.raises(RuntimeError, match="draw failed"):
            staged(w)
    assert cached_inputs(w) is None and workloads._INPUT_CACHE.nbytes == 0


def test_an_entry_over_the_cap_is_not_kept(monkeypatch):
    monkeypatch.setattr(workloads, "INPUT_CACHE_BYTES", 4 * X * Y - 1)
    w = make_workload("harris", X, Y)
    for _ in range(2):
        got, timings = staged(w)
        assert timings["cache_hit"] == 0
        assert_bytes(got, w.arrays())
    assert cached_inputs(w) is None and workloads._INPUT_CACHE.nbytes == 0


# ------------------------------------------- a matrix call's shared device copy


def matrix_spec(tmp_path, name: str) -> TuningSpec:
    return TuningSpec(kernel="harris", backend="cuda",
                      backend_kwargs={"x": X, "y": Y, "device": "cpu", "repeats": 1},
                      algorithms=("rs", "rf", "ga"), dataset_size=40, seed=4,
                      design=ExperimentDesign(sample_sizes=(12,), n_experiments=(2,),
                                              final_repeats=2),
                      store="json", store_path=str(tmp_path / f"{name}.json"))


@pytest.fixture
def stagings(monkeypatch) -> list[tuple]:
    """Every ``materialize`` from here on, as ``(workload, tensors,
    timings)``, the untraced dataset measurement's included."""
    seen: list[tuple] = []
    plain = CudaWorkload.materialize

    def recorded(self, device, timings=None):
        timings = {} if timings is None else timings
        out = plain(self, device, timings)
        seen.append((self, out, timings))
        return out

    monkeypatch.setattr(CudaWorkload, "materialize", recorded)
    return seen


def assert_nothing_held() -> None:
    shared = workloads._DEVICE_INPUTS
    assert (shared._depth, shared._entries, shared._copying) == (0, {}, {})


def test_a_matrix_call_stages_each_workload_once(tmp_path, ticking, stagings):
    tel = Telemetry(str(tmp_path / "t.jsonl"))
    TuningSession(matrix_spec(tmp_path, "m"), telemetry=tel).run_matrix()
    tel.close()
    # the dataset's measurement, each experiment's, and rf's predictions'
    assert len(stagings) == 1 + 6 + 2
    assert [t["device_reuse"] for _, _, t in stagings] == [0] + [1] * (len(stagings) - 1)
    first = stagings[0][1]
    assert all(out is first for _, out, _ in stagings)
    assert_bytes(first, make_workload("harris", X, Y).arrays())
    counters = [e for e in read_events(str(tmp_path / "t.jsonl"))
                if e["ev"] == "totals"][-1]["counters"]
    assert counters["inputs.device_reuses"] == len(stagings) - 1
    events = stage_events(tmp_path / "t.jsonl", {"inputs"})
    assert [e["device_reuse"] for e in events] == [1] * (len(stagings) - 1)
    assert_nothing_held()


def test_matrix_values_equal_its_units_run_one_by_one(tmp_path, ticking, stagings):
    """The matrix call, whose measurements share one device copy, against
    the same units run through ``run_unit`` outside any scope, each
    measurement copying its own: every value, winner and stored byte equal."""
    session = TuningSession(matrix_spec(tmp_path, "matrix"))
    results = session.run_matrix()
    n_matrix = len(stagings)
    alone = TuningSession(matrix_spec(tmp_path, "alone"))
    units = [alone.run_unit(u) for u in session.last_unit_plan]
    alone.save_store()
    assert [t["device_reuse"] for _, _, t in stagings[n_matrix:]] == [0] * n_matrix
    assert [r.unit for r in units] == [r.unit for r in session.last_unit_results]
    for mine, theirs in zip(units, session.last_unit_results, strict=True):
        for name in ("final_values", "search_best_values", "best_indices"):
            np.testing.assert_array_equal(getattr(mine, name), getattr(theirs, name))
    for key, cell in results.cells.items():
        unit = next(r for r in units if (r.unit.algo, r.unit.sample_size) == key)
        np.testing.assert_array_equal(cell.final_values, unit.final_values)

    def values(name: str) -> bytes:
        store = MeasurementStore(str(tmp_path / f"{name}.json"))
        return json.dumps(sorted(store.items()), sort_keys=True).encode()

    assert values("matrix") == values("alone")


@pytest.mark.parametrize("ends", ["returns", "raises"])
def test_the_scope_holds_nothing_after_the_call(tmp_path, monkeypatch, stagings, ends):
    plain_final = CudaMeasurement.measure_final
    if ends == "raises":
        def fail(self, config, repeats=10):
            raise RuntimeError("the final re-measurement failed")

        monkeypatch.setattr(CudaMeasurement, "measure_final", fail)
        with pytest.raises(RuntimeError, match="final re-measurement"):
            TuningSession(matrix_spec(tmp_path, ends)).run_matrix()
    else:
        TuningSession(matrix_spec(tmp_path, ends)).run_matrix()
    assert stagings and stagings[0][2]["device_reuse"] == 0
    assert_nothing_held()
    monkeypatch.setattr(CudaMeasurement, "measure_final", plain_final)
    n = len(stagings)
    TuningSession(matrix_spec(tmp_path, "again")).run_matrix()
    again = [t["device_reuse"] for _, _, t in stagings[n:]]
    assert again[0] == 0 and sum(again) == len(again) - 1   # the next call copies anew, once
    assert_nothing_held()


def test_two_threads_in_one_scope_copy_once(monkeypatch):
    copies = []
    plain_fence = workloads.fence

    def slow_fence(t):
        copies.append(t)
        time.sleep(0.3)   # the other thread asks while this one copies
        plain_fence(t)

    monkeypatch.setattr(workloads, "fence", slow_fence)
    w = make_workload("harris", X, Y)
    w.arrays()
    start = threading.Barrier(2)
    got: list = [None, None]

    def stage(i):
        start.wait()
        got[i] = staged(w)

    with shared_inputs():
        threads = [threading.Thread(target=stage, args=(i,)) for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
        assert len(copies) == 1
        assert sorted(timings["device_reuse"] for _, timings in got) == [0, 1]
        assert got[0][0][0] is got[1][0][0]
        assert_bytes(got[0][0], w.arrays())
    assert_nothing_held()


def test_distinct_workloads_stage_separately():
    ws = [make_workload("harris", X, Y), make_workload("harris", X, Y, input_seed=1),
          make_workload("harris", 2 * X, Y), make_workload("add", X, Y)]
    with shared_inputs():
        with shared_inputs():   # an inner scope owns nothing
            first = [staged(w) for w in ws]
        again = [staged(w) for w in ws]
        assert [t["device_reuse"] for _, t in first] == [0] * len(ws)
        assert [t["device_reuse"] for _, t in again] == [1] * len(ws)
        for w, (a, _), (b, _) in zip(ws, first, again, strict=True):
            assert a is b
            assert_bytes(a, w.arrays())
        assert len(workloads._DEVICE_INPUTS._entries) == len(ws)
        assert not np.shares_memory(first[0][0][0].numpy(), first[1][0][0].numpy())
    assert_nothing_held()
    assert staged(ws[0])[1]["device_reuse"] == 0


def test_shared_copies_hold_under_thread_contention():
    """More threads than cores stage four workloads in random order, each
    inside nested scopes of its own, while an outer scope stays open and the
    interpreter switches threads often: each workload is copied once, every
    staging gives the drawn bytes, and nothing is held after the outer
    scope (a lost update would break one of these)."""
    import os
    import random
    import sys

    ws = [make_workload("harris", X, Y, input_seed=s) for s in range(4)]
    want = {w.cache_key: w.arrays()[0].tobytes() for w in ws}
    n_threads = 2 * (os.cpu_count() or 2) + 2
    faults: list = []
    copies: list = []

    def stage(seed):
        rng = random.Random(seed)
        for _ in range(10):
            with shared_inputs():
                for _ in range(4):
                    w = rng.choice(ws)
                    timings: dict = {}
                    got = w.materialize("cpu", timings)[0].numpy().tobytes()
                    if not timings["device_reuse"]:
                        copies.append(w.cache_key)
                    if got != want[w.cache_key]:
                        faults.append(w.cache_key)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with shared_inputs():
            threads = [threading.Thread(target=stage, args=(i,)) for i in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            assert not any(t.is_alive() for t in threads)
            held = len(workloads._DEVICE_INPUTS._entries)
    finally:
        sys.setswitchinterval(interval)
    assert faults == []
    assert sorted(copies) == sorted(set(copies)) and held == len(set(copies))
    assert_nothing_held()


def test_run_and_bare_materialize_copy_every_time(tmp_path, stagings):
    w = make_workload("harris", X, Y)
    (a, ta), (b, tb) = staged(w), staged(w)
    assert (ta["device_reuse"], tb["device_reuse"]) == (0, 0)
    assert not np.shares_memory(a[0].numpy(), b[0].numpy())
    tel = Telemetry(str(tmp_path / "t.jsonl"))
    for _ in range(2):
        TuningSession(TuningSpec(kernel="harris", backend="cuda",
                                 backend_kwargs={"x": X, "y": Y, "device": "cpu",
                                                 "repeats": 1},
                                 searcher="ga", budget=BUDGETS["ga"], seed=5,
                                 final_repeats=2), telemetry=tel).run()
    tel.close()
    assert [t["device_reuse"] for _, _, t in stagings] == [0] * 4
    events = read_events(str(tmp_path / "t.jsonl"))
    assert [e["device_reuse"] for e in events
            if e["ev"] == "stage" and e["stage"] == "inputs"] == [0, 0]
    assert not any("inputs.device_reuses" in e.get("counters", {}) for e in events)
    assert_nothing_held()


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
    # a tune call's host stages: the serving path's ``fleet`` and ``serve``
    # are tests/test_torch_serving.py's
    assert {e["stage"] for e in events} == {*PIPELINE_STAGES, "propose", "session"}
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
    split = {"bo_gp": {"fit_s", "acquire_s"},
             "rf": {"fit_s", "pool_s", "acquire_s"}}.get(algo, set())
    for e in proposes:
        assert split == set(e) & {"fit_s", "pool_s", "acquire_s"}
        assert sum(e[k] for k in split) <= e["dur"]
    for k in split:
        assert sum(e[k] for e in proposes) > 0
    # the cuda space's screen: every row in its batch form; bo_gp searches
    # the unconstrained space and screens none
    screened = sum(e["screened_rows"] for e in proposes)
    assert sum(e["screened_batched"] for e in proposes) == screened
    assert (screened > 0) == (algo != "bo_gp")


def test_propose_events_count_a_batchless_screen(tmp_path):
    """Under a constraint with no batch form the rows are counted as
    screened and none as batched; the counts are the space's, event by
    event."""
    space = SearchSpace(paper_space().params, constraint=lambda c: c["t_z"] <= 12)
    tel = Telemetry(str(tmp_path / "l.jsonl"))
    drive(make_searcher("rf", space, seed=2, pool_size=512), CallableMeasurement(objective),
          BUDGETS["rf"], telemetry=tel)
    tel.close()
    proposes = stage_events(tmp_path / "l.jsonl", {"propose"})
    assert sum(e["screened_rows"] for e in proposes) == space.screened_rows > 512
    assert all(e["screened_batched"] == 0 for e in proposes)
    assert sum(e["pool_s"] for e in proposes) > 0


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
    with pytest.MonkeyPatch.context() as mp:   # no count read with the sink off
        mp.setattr(SearchSpace, "screened", lambda self: pytest.fail("read"))
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
