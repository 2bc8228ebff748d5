"""The port's executor layer on the CPU: every executor gives the serial
loop's matrix byte for byte, journaled units resume with zero measurements,
a killed worker's shard store is recovered, and the device executor pins
its threads to cards — and raises where there is none.

The matrix is the reference's executor-test spec on the port's cost model
(harris on v5e, rs/rf/ga), so the serial run is itself held to the
reference in ``tests/test_torch_matrix.py``.  The device executor runs here
over two CPU devices patched in for the cards.
"""

import os
import shutil
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch import (
    EXECUTORS,
    ExperimentDesign,
    TuningSession,
    TuningSpec,
    build_units,
)
from repro_torch.core import MeasurementStore, executors
from repro_torch.core.executors import ExecutionPlan, run_units, shard_store_path

SPEC = TuningSpec(
    kernel="harris",
    backend="costmodel",
    backend_kwargs={"chip": "v5e"},
    algorithms=("rs", "rf", "ga"),
    design=ExperimentDesign(sample_sizes=(25,), n_experiments=(4,), final_repeats=3),
    seed=11,
    dataset_size=200,
)


def assert_same_cells(a, b):
    assert set(a.cells) == set(b.cells)
    for key in a.cells:
        for name in ("final_values", "search_best_values", "n_samples_used"):
            np.testing.assert_array_equal(getattr(a.cells[key], name),
                                          getattr(b.cells[key], name))


def store_values_bytes(path: str) -> bytes:
    """Canonical bytes of a JSON store's measurement VALUES (journal entries
    carry wall-clocks, which vary run to run)."""
    import json

    return json.dumps(sorted(MeasurementStore(path).items()), sort_keys=True).encode()


@pytest.fixture
def two_cpu_devices(monkeypatch):
    """The device executor's card list, replaced by two CPU devices."""
    monkeypatch.setattr(executors, "cuda_devices",
                        lambda: [torch.device("cpu"), torch.device("cpu")])


def spy_run_unit(monkeypatch):
    ran = []
    orig = TuningSession.run_unit

    def spy(self, u):
        ran.append(u.key)
        return orig(self, u)

    monkeypatch.setattr(TuningSession, "run_unit", spy)
    return ran


# ------------------------------------------------------- executor equivalence


def test_every_executor_is_byte_identical_to_serial(tmp_path, two_cpu_devices):
    """serial ≡ shards=2 ≡ process ≡ futures ≡ steal ≡ static ≡ device:
    identical cells and record cells, byte-identical store values, no shard
    files left — including within-cell splits of the dataset-served rs and
    rf paths."""
    runs = {
        "serial": dict(),
        "shards": dict(shards=2),
        "process": dict(executor="process", max_workers=3),
        "futures": dict(executor="futures", max_workers=3,
                        futures_pool=ThreadPoolExecutor(max_workers=3)),
        "static": dict(executor="process", max_workers=2, scheduler="static"),
        "futures_static": dict(executor="futures", scheduler="static",
                               futures_pool=ThreadPoolExecutor(max_workers=2)),
        "device": dict(executor="device", max_workers=2),
        "device_static": dict(executor="device", max_workers=2, scheduler="static"),
    }
    results, records, bytes_, plans = {}, {}, {}, {}
    for name, kwargs in runs.items():
        path = str(tmp_path / f"{name}.json")
        session = TuningSession(SPEC.replace(store="json", store_path=path))
        results[name] = session.run_matrix(**kwargs)
        records[name] = session.last_record.result
        bytes_[name] = store_values_bytes(path)
        plans[name] = len(session.last_unit_plan)
    for name in runs:
        assert_same_cells(results["serial"], results[name])
        assert records[name]["cells"] == records["serial"]["cells"]
        assert bytes_[name] == bytes_["serial"], name
    assert plans["serial"] == 3 and plans["process"] >= 12   # the cells split
    assert not [f for f in os.listdir(tmp_path) if ".shard" in f]


def test_default_futures_pool_spawns_processes(tmp_path):
    spec = SPEC.replace(algorithms=("rs",), dataset_size=None,
                        store="json", store_path=str(tmp_path / "f.json"))
    base = repro_torch.tune_matrix(spec.replace(store=None, store_path=None))
    assert_same_cells(base, repro_torch.tune_matrix(spec, executor="futures", max_workers=2))
    assert not [f for f in os.listdir(tmp_path) if ".shard" in f]


def test_unit_experiments_cap_is_bit_identical():
    spec = SPEC.replace(algorithms=("rs", "rf"))
    session = TuningSession(spec)
    capped = session.run_matrix(unit_experiments=1)
    assert len(session.last_unit_plan) == 8      # 2 cells x 4 experiments
    assert_same_cells(repro_torch.tune_matrix(spec), capped)


# --------------------------------------------------------------- the device


def test_device_executor_raises_without_a_card(monkeypatch):
    """No card: a RuntimeError naming the cause, never a run on the CPU."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    assert executors.cuda_devices() == []
    ran = spy_run_unit(monkeypatch)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        repro_torch.tune_matrix(SPEC, executor="device", max_workers=2)
    assert ran == []


def test_device_executor_lists_the_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    assert executors.cuda_devices() == [torch.device("cuda", i) for i in range(3)]


@pytest.mark.parametrize("scheduler", ["steal", "static"])
def test_device_threads_hold_their_pin(monkeypatch, scheduler):
    """Each thread builds its session and runs every unit under its own
    card's pin, and one thread serves each card."""
    spec = SPEC.replace(algorithms=("rs", "ga"), dataset_size=None)
    base = repro_torch.tune_matrix(spec)
    devices = [torch.device("cpu", 0), torch.device("cpu", 1)]
    monkeypatch.setattr(executors, "cuda_devices", lambda: devices)
    pinned = threading.local()

    class Pin:
        def __init__(self, device):
            self.device = device

        def __enter__(self):
            pinned.device = self.device

        def __exit__(self, *exc):
            pinned.device = None

    monkeypatch.setattr(executors, "_pin", Pin)
    built, ran = [], []
    orig_init, orig_run = TuningSession.__init__, TuningSession.run_unit

    def init(self, *args, **kwargs):
        orig_init(self, *args, **kwargs)
        self.pinned_to = getattr(pinned, "device", None)
        built.append(self.pinned_to)

    def run_unit(self, unit):
        ran.append((threading.get_ident(), self.pinned_to, getattr(pinned, "device", None)))
        return orig_run(self, unit)

    monkeypatch.setattr(TuningSession, "__init__", init)
    monkeypatch.setattr(TuningSession, "run_unit", run_unit)
    res = TuningSession(spec).run_matrix(executor="device", max_workers=2, scheduler=scheduler)
    assert_same_cells(base, res)
    assert built[0] is None and sorted(map(str, built[1:3])) == ["cpu:0", "cpu:1"]
    assert len(ran) >= 2 and all(session_pin == unit_pin is not None
                                 for _, session_pin, unit_pin in ran)
    by_thread = {}
    for thread, _, unit_pin in ran:
        by_thread.setdefault(thread, set()).add(str(unit_pin))
    assert all(len(pins) == 1 for pins in by_thread.values())


@pytest.mark.parametrize("scheduler", ["steal", "static"])
def test_each_card_keeps_its_own_thread_when_work_ends_early(monkeypatch, scheduler):
    """Force the race a thread pool loses: each hand-off to a pool waits
    until its task is done, so the first card's work finishes before the
    second card's is handed out, and a pool would give it to its idle
    thread.  Every card still gets its own thread, and its session is
    built under its own pin."""
    import concurrent.futures as cf

    spec = SPEC.replace(algorithms=("rs", "ga"), dataset_size=None)
    devices = [torch.device("cpu", 0), torch.device("cpu", 1)]
    monkeypatch.setattr(executors, "cuda_devices", lambda: devices)
    orig_submit = cf.ThreadPoolExecutor.submit

    def submit_and_wait(self, fn, *args, **kwargs):
        future = orig_submit(self, fn, *args, **kwargs)
        cf.wait([future])
        return future

    monkeypatch.setattr(cf.ThreadPoolExecutor, "submit", submit_and_wait)
    pinned = threading.local()

    class Pin:
        def __init__(self, device):
            self.device = device

        def __enter__(self):
            pinned.device = self.device

        def __exit__(self, *exc):
            pinned.device = None

    monkeypatch.setattr(executors, "_pin", Pin)
    threads_by_card, built = {}, []
    orig_init, orig_run = TuningSession.__init__, TuningSession.run_unit

    def init(self, *args, **kwargs):
        orig_init(self, *args, **kwargs)
        built.append(str(getattr(pinned, "device", None)))

    def run_unit(self, unit):
        card = str(getattr(pinned, "device", None))
        threads_by_card.setdefault(card, set()).add(threading.current_thread())
        return orig_run(self, unit)

    monkeypatch.setattr(TuningSession, "__init__", init)
    monkeypatch.setattr(TuningSession, "run_unit", run_unit)
    TuningSession(spec).run_matrix(executor="device", max_workers=2, scheduler=scheduler)
    assert sorted(built[1:]) == ["cpu:0", "cpu:1"]
    owners = [t for ts in threads_by_card.values() for t in ts]
    assert set(threads_by_card) <= {"cpu:0", "cpu:1"}
    assert len(owners) == len(set(owners)) == len(threads_by_card)   # one card each
    if scheduler == "static":
        assert set(threads_by_card) == {"cpu:0", "cpu:1"}


@pytest.mark.parametrize("scheduler", ["steal", "static"])
def test_process_workers_measure_on_distinct_cards(tmp_path, monkeypatch, scheduler):
    """Each spawned worker pins a card of its own: under ``static`` payload
    k runs on card k, under ``steal`` each worker takes a distinct slot from
    the queue of card indices.  Two CPU devices stand in for the cards; the
    store stays byte-identical to the serial loop's."""
    devices = [torch.device("cpu", 0), torch.device("cpu", 1)]
    monkeypatch.setattr(executors, "cuda_devices", lambda: devices)
    spec = SPEC.replace(algorithms=("rs", "ga"), store="json")
    serial = spec.replace(store_path=str(tmp_path / "serial.json"))
    base = TuningSession(serial).run_matrix()
    session = TuningSession(spec.replace(store_path=str(tmp_path / "p.json")))
    res = session.run_matrix(executor="process", max_workers=2, scheduler=scheduler)
    assert_same_cells(base, res)
    assert store_values_bytes(session.spec.store_path) == store_values_bytes(serial.store_path)
    ran = session.last_unit_devices
    assert sorted(ran) == sorted(u.key for u in session.last_unit_plan)
    card_of: dict[str, set] = {}
    for where in ran.values():
        card_of.setdefault(where["worker"], set()).add(where["device"])
    # every worker on exactly one card, no card shared between workers
    assert all(len(cards) == 1 for cards in card_of.values())
    cards = [c for cs in card_of.values() for c in cs]
    assert len(cards) == len(set(cards)) and set(cards) <= {"cpu:0", "cpu:1"}
    if scheduler == "static":
        assert card_of == {"payload0": {"cpu:0"}, "payload1": {"cpu:1"}}
    assert not [f for f in os.listdir(tmp_path) if ".shard" in f]


def test_launch_counts_add_exactly_across_threads():
    """The launch counters add under a lock: threads on several cards never
    lose a count (a short switch interval makes a lost update likely)."""
    import sys

    from repro_torch.kernels.common import LaunchCounter

    counter, n_threads, per_thread = LaunchCounter(), 16, 5000
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [counter.add() for _ in range(per_thread)])
                   for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert counter.n == n_threads * per_thread


def test_device_executor_warns_and_caps(tmp_path, two_cpu_devices):
    spec = SPEC.replace(algorithms=("rs", "ga"), dataset_size=None,
                        store="json", store_path=str(tmp_path / "d.json"))
    with pytest.warns(UserWarning, match="capping"):
        res = TuningSession(spec).run_matrix(executor="device", max_workers=3)
    assert_same_cells(repro_torch.tune_matrix(spec.replace(store=None, store_path=None)), res)
    assert sorted(f for f in os.listdir(tmp_path) if ".shard" in f) == []


# ------------------------------------------------------- degrade + errors


def test_executor_registry_and_argument_errors():
    assert {"serial", "process", "futures", "device"} <= set(EXECUTORS)
    assert repro_torch.EXECUTORS is EXECUTORS
    with pytest.raises(KeyError, match="unknown executor"):
        run_units("warp", ExecutionPlan(session=None))
    session = TuningSession(SPEC)
    with pytest.raises(KeyError, match="unknown executor"):
        session.run_matrix(executor="warp")
    with pytest.raises(ValueError, match="unknown scheduler"):
        session.run_matrix(scheduler="warp")
    with pytest.raises(ValueError, match="futures_pool"):
        session.run_matrix(executor="process", futures_pool=ThreadPoolExecutor(max_workers=2))
    with pytest.raises(ValueError, match="max_workers"):
        session.run_matrix(max_workers=0)
    # the reference's speed knobs: no port backend has a compile pipeline
    for spec in (SPEC, SPEC.replace(backend="cuda", backend_kwargs={"device": "cpu"})):
        with pytest.raises(ValueError, match="pipeline_workers"):
            TuningSession(spec).run_matrix(pipeline_workers=2)
        with pytest.raises(ValueError, match="compile_cache"):
            TuningSession(spec).run_matrix(compile_cache="cache")
    with pytest.raises(ValueError, match="design"):
        TuningSession(SPEC.replace(design=None)).run_matrix()


def test_process_executor_refuses_more_workers_than_cards(monkeypatch):
    """On the card each spawned worker opens its own CUDA context, so
    workers sharing a card would time each other's kernels."""
    from repro_torch.core import api

    spec = SPEC.replace(backend="cuda", backend_kwargs={"x": 64, "y": 128},
                        algorithms=("rs", "ga"), dataset_size=None)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    ran = spy_run_unit(monkeypatch)
    for kwargs in (dict(executor="process", max_workers=2), dict(shards=3)):
        with pytest.raises(ValueError, match="(?s)'serial'.*'device'"):
            TuningSession(spec).run_matrix(**kwargs)
    assert ran == []

    class Planned(Exception):
        pass

    def planned(name, plan):
        raise Planned(name, plan.max_workers)

    monkeypatch.setattr(api, "run_units", planned)
    # as many workers as cards, and the plain versions on the CPU, pass
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(Planned, match="process"):
        TuningSession(spec).run_matrix(executor="process", max_workers=2)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    on_cpu = spec.replace(backend_kwargs={"x": 64, "y": 128, "device": "cpu"})
    with pytest.raises(Planned, match="process"):
        TuningSession(on_cpu).run_matrix(executor="process", max_workers=2)


def test_parallel_request_degrades_to_serial_with_warning():
    spec = SPEC.replace(
        algorithms=("ga",), dataset_size=None,
        design=ExperimentDesign(sample_sizes=(25,), n_experiments=(1,), final_repeats=3))
    with pytest.warns(UserWarning, match="degrades to serial"):
        res = TuningSession(spec).run_matrix(shards=4)
    assert set(res.cells) == {("ga", 25)}


def test_parallel_runs_reject_what_cannot_be_shipped():
    from repro_torch.core import make_measurement

    session = TuningSession(SPEC, measurement_factory=lambda s: make_measurement(
        "costmodel", kernel="harris", seed=s))
    for executor in ("process", "futures", "device"):
        with pytest.raises(RuntimeError, match="serialized spec"):
            session.run_matrix(executor=executor, max_workers=2)
    spec = SPEC.replace(algorithms=("rs", "ga"), dataset_size=None, backend="callable",
                        backend_kwargs={"fn": lambda cfg: 1.0}, space=session.space)
    assert not repro_torch.BACKENDS["callable"].serializable
    with pytest.raises(RuntimeError, match="in-process callables"):
        TuningSession(spec).run_matrix(executor="process", max_workers=2)


# ------------------------------------------------------------ kill-and-resume


def test_resume_skips_journaled_units(tmp_path, monkeypatch):
    """A run interrupted after 2 of its units resumes from the journal:
    those units never run again (not even as cache hits) and the matrix
    equals an uninterrupted run."""
    clean = repro_torch.tune_matrix(SPEC)
    spec = SPEC.replace(store="json", store_path=str(tmp_path / "c.json"))
    partial = TuningSession(spec)
    units = build_units(partial.cells(), min_units=4)
    journal = partial.unit_journal()
    for u in units[:2]:
        journal.put(partial.run_unit(u))
    partial.save_store()

    ran = spy_run_unit(monkeypatch)
    res = TuningSession(spec).run_matrix(resume=True)
    assert not ({u.key for u in units[:2]} & set(ran))
    assert_same_cells(clean, res)
    # a whole journal replays with zero measurements
    ran.clear()
    again = TuningSession(spec)
    assert_same_cells(clean, again.run_matrix(resume=True))
    assert ran == [] and again.measurement is None


def test_resume_ignores_a_different_specs_journal(tmp_path, monkeypatch):
    spec = SPEC.replace(algorithms=("ga",), dataset_size=None, searcher_kwargs={"pop_size": 8},
                        store="json", store_path=str(tmp_path / "c.json"))
    TuningSession(spec).run_matrix(resume=True)
    changed = spec.replace(searcher_kwargs={"pop_size": 12})
    ran = spy_run_unit(monkeypatch)
    TuningSession(changed).run_matrix(resume=True)
    assert len(ran) == 1


def test_resume_without_store_warns():
    with pytest.warns(UserWarning, match="persistent store"):
        repro_torch.tune_matrix(SPEC.replace(algorithms=("ga",), dataset_size=None),
                                resume=True)


@pytest.mark.parametrize("ident", [0, 31337])
def test_resume_recovers_a_killed_workers_shard(tmp_path, monkeypatch, ident):
    """A parallel run killed before the merge leaves ``*.shard<k>`` stores
    (device index or pid) whose journals hold the workers' completed units;
    a resumed run absorbs them and runs nothing that finished."""
    spec = SPEC.replace(algorithms=("rs", "ga"), store="json",
                        store_path=str(tmp_path / "c.json"))
    ghost = TuningSession(spec.replace(store_path=str(tmp_path / "ghost.json")))
    ghost_res = ghost.run_matrix()

    ran = spy_run_unit(monkeypatch)
    resumed = TuningSession(spec)
    shard = shard_store_path(resumed, ident)
    shutil.move(str(tmp_path / "ghost.json"), shard)
    res = resumed.run_matrix(resume=True)
    assert ran == []
    assert not os.path.exists(shard)
    assert_same_cells(ghost_res, res)
    # another spec's shard beside the same store is left alone
    other = TuningSession(spec.replace(seed=12))
    foreign = shard_store_path(other, ident)
    shutil.copy(spec.store_path, foreign)
    assert executors.recover_shard_stores(TuningSession(spec)) == 0
    assert os.path.exists(foreign)


def test_process_failure_still_merges_completed_shards(tmp_path, monkeypatch):
    """Fail fast: when the parent's drain dies, completed workers' shard
    stores are absorbed before the error surfaces, so a resume runs nothing
    that finished."""
    import concurrent.futures as cf

    spec = SPEC.replace(algorithms=("rs", "ga"), dataset_size=None, store="json",
                        store_path=str(tmp_path / "c.json"))
    clean = repro_torch.tune_matrix(spec.replace(store=None, store_path=None))

    def dying_drain(futures):
        cf.wait(list(futures))               # let every unit finish first
        raise RuntimeError("parent died mid-drain")

    monkeypatch.setattr(executors, "_drain_steal", dying_drain)
    with pytest.raises(RuntimeError, match="parent died mid-drain"):
        TuningSession(spec).run_matrix(executor="process", max_workers=2)
    monkeypatch.undo()
    assert not [f for f in os.listdir(tmp_path) if ".shard" in f]

    ran = spy_run_unit(monkeypatch)
    res = TuningSession(spec).run_matrix(resume=True)
    assert ran == []
    assert_same_cells(clean, res)
