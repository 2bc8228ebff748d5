"""The port's staged compile-prefetch pipeline (``CudaMeasurement(...,
pipeline_workers=N)``), held against the reference's ``PallasMeasurement``
on the same configs: prefetch on/off equivalence (identical values,
identical fills), screened-out geometries never prefetched, the pool
reusable after ``close``, prefetched refusals as penalties, per-run
counters.  Then the port's own rules: no launch of the pool falls inside a
timed window, and a pool task launches on the measurement's device.
"""

import contextlib
import itertools
import os
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.cuda_bench import CudaMeasurement, make_workload
from repro_torch.cuda_bench.workloads import CudaWorkload
from repro_torch.kernels import _build
from repro_torch.kernels.common import KernelBenchSpec


def counter_timer():
    """Deterministic timing-stage clock: measured values become pure
    functions of call order, so pipelined and inline runs compare exactly."""
    ticks = itertools.count()
    return lambda: float(next(ticks))


def cuda_measurement(**kwargs):
    return CudaMeasurement(make_workload("add", x=16, y=256), device="cpu", **kwargs)


def pallas_measurement(**kwargs):
    from repro.pallas_bench import PallasMeasurement
    from repro.pallas_bench import make_workload as ref_workload

    return PallasMeasurement(ref_workload("add", x=16, y=256), **kwargs)


def batch_configs():
    """A batch mixing valid configs, screened-out configs, and geometry
    duplicates (w_z does not enter the add program)."""
    return [
        dict(t_x=tx, t_y=1, t_z=tz, w_x=1, w_y=1, w_z=wz)
        for tx, tz, wz in itertools.product((1, 2, 4, 16), (1, 2), (1, 2))
    ]


# ------------------------------------------------- prefetch on/off equivalence


def test_prefetch_equivalence_against_the_reference():
    cfgs = batch_configs()
    got = {}
    for name, make in (("port", cuda_measurement), ("ref", pallas_measurement)):
        inline = make(repeats=3, timer=counter_timer())
        v_inline = inline.measure_batch(cfgs)
        piped = make(repeats=3, pipeline_workers=3, timer=counter_timer())
        v_piped = piped.measure_batch(cfgs)
        piped.close()
        np.testing.assert_array_equal(v_inline, v_piped)
        assert inline.n_compiles == piped.n_compiles
        assert inline.run_compiles == piped.run_compiles
        got[name] = (v_piped.tolist(), piped.n_compiles)
    assert got["port"] == got["ref"]
    assert np.isfinite(got["port"][0]).any() and np.isinf(got["port"][0]).any()


def test_prefetch_skips_screened_out_geometries():
    cfgs = batch_configs()
    fills = {}
    for name, make in (("port", cuda_measurement), ("ref", pallas_measurement)):
        inline = make(repeats=1)
        inline.measure_batch(cfgs)
        piped = make(repeats=1, pipeline_workers=4)
        piped.measure_batch(cfgs)
        piped.close()
        assert piped.n_compiles == inline.n_compiles
        assert sorted(piped._compiled) == sorted(inline._compiled)
        fills[name] = sorted(piped._compiled)
    assert fills["port"] == fills["ref"]


def test_pipeline_pool_is_reusable_after_close():
    m = cuda_measurement(repeats=1, pipeline_workers=2)
    cfgs = batch_configs()[:4]
    a = m.measure_batch(cfgs)
    m.close()
    assert m._pool is None
    b = m.measure_batch(cfgs)           # pool rebuilds lazily
    np.testing.assert_array_equal(np.isfinite(a), np.isfinite(b))
    m.close()
    m.close()                           # idempotent


def refusing_workload(calls: list | None = None) -> CudaWorkload:
    """A workload whose every launch the card refuses for its geometry."""
    def refuse(inputs, cfg, x, y, device):
        if calls is not None:
            calls.append(dict(cfg))
        raise _build.LaunchError("repro_boom", 9, "invalid configuration argument")

    bench = KernelBenchSpec(name="boom", n_inputs=0,
                            make_inputs=lambda x, y, seed: (), run=refuse)
    return CudaWorkload(bench=bench, x=64, y=128)


def test_prefetched_refusals_are_penalties():
    """A geometry whose launch is refused becomes a cached inf penalty
    through the prefetcher exactly as it does inline (the reference's
    compile failure)."""
    m = CudaMeasurement(refusing_workload(), repeats=2, device="cpu", pipeline_workers=2)
    cfgs = [dict(t_x=1, t_y=1, t_z=z, w_x=1, w_y=1, w_z=1) for z in (1, 2, 2)]
    vals = m.measure_batch(cfgs)
    m.close()
    assert np.isinf(vals).all()
    assert m.n_compiles == 2            # one per distinct geometry, cached
    assert "invalid configuration" in m.reason_for(cfgs[0])
    assert m.reason_for(cfgs[0]).startswith("compile:")


def test_prefetched_non_config_errors_raise():
    def boom(inputs, cfg, x, y, device):
        raise RuntimeError("no library")

    bench = KernelBenchSpec(name="boom", n_inputs=0,
                            make_inputs=lambda x, y, seed: (), run=boom)
    m = CudaMeasurement(CudaWorkload(bench=bench, x=64, y=128), device="cpu",
                        pipeline_workers=2)
    cfgs = [dict(t_x=1, t_y=1, t_z=z, w_x=1, w_y=1, w_z=1) for z in (1, 2)]
    with pytest.raises(RuntimeError, match="no library"):
        m.measure_batch(cfgs)
    m.close()


# ------------------------------------------------ per-run provenance counters


@pytest.mark.parametrize("workers", [0, 2])
def test_provenance_counters_are_per_run(workers):
    """n_compiles / n_invalid in provenance report work since the last
    reset(), as the reference's do, with the pipeline off and on."""
    got = {}
    # the port stages its inputs in a stage of its own, once a measurement;
    # the reference stages them inside its compile stage
    stages = {"port": {"screen", "inputs", "compile", "time", "record"},
              "ref": {"screen", "compile", "time", "record"}}
    for name, make in (("port", cuda_measurement), ("ref", pallas_measurement)):
        m = make(repeats=1, pipeline_workers=workers)
        m.measure_batch(batch_configs())
        first = m.provenance()
        assert first["n_compiles"] > 0 and first["n_invalid"] > 0
        assert first["n_compiles_total"] == m.n_compiles
        assert set(first["stage_s"]) == stages[name]
        assert first["pipeline_workers"] == workers and first["compile_cache"] is False

        m.reset()
        blank = m.provenance()
        assert blank["n_compiles"] == 0 and blank["n_invalid"] == 0
        assert blank["n_compiles_total"] == first["n_compiles_total"]
        assert blank["stage_s"] == {}

        m.measure_batch(batch_configs())
        warm = m.provenance()
        m.close()
        assert warm["n_compiles"] == 0
        assert warm["n_invalid"] == first["n_invalid"]
        assert warm["stage_s"].get("compile", 0.0) == 0.0
        assert warm["stage_s"].get("inputs", 0.0) == 0.0
        assert warm["stage_s"]["time"] > 0.0
        got[name] = [(p["n_compiles"], p["n_compiles_total"], p["n_invalid"],
                      p["n_pcache_hits"]) for p in (first, blank, warm)]
    assert got["port"] == got["ref"]


# ------------------------------------------------ the pool on the card's rules


class Recorder:
    """One event sequence of timed-window edges (the timer's readings, two
    a repeat) and launches (start and end, by thread)."""

    def __init__(self):
        self.lock = threading.Lock()
        self.events: list[tuple[str, str]] = []
        self.timer_reads = 0

    def timer(self) -> float:
        with self.lock:
            self.timer_reads += 1
            edge = "open" if self.timer_reads % 2 else "close"
            self.events.append((edge, threading.current_thread().name))
            return float(self.timer_reads)

    def workload(self) -> CudaWorkload:
        def run(inputs, cfg, x, y, device):
            name = threading.current_thread().name
            with self.lock:
                self.events.append(("launch", name))
            # a launch long enough that an unserialised one would overlap
            time.sleep(0.001)
            with self.lock:
                self.events.append(("end", name))
            return None

        bench = KernelBenchSpec(name="probe", n_inputs=0,
                                make_inputs=lambda x, y, seed: (), run=run)
        return CudaWorkload(bench=bench, x=1024, y=2048)


def test_no_pool_launch_falls_inside_a_timed_window():
    rec = Recorder()
    # two threads for four new geometries a batch: the pool is still
    # warming the batch's later geometries while the first ones are timed
    m = CudaMeasurement(rec.workload(), repeats=3, warmup=2, device="cpu",
                        pipeline_workers=2, timer=rec.timer)
    space = [dict(t_x=tx, t_y=ty, t_z=tz, w_x=1, w_y=1, w_z=1)
             for tx in (1, 2, 4, 8) for ty in (1, 2, 4, 8) for tz in (1, 2)]
    for b in range(8):                       # many batches, new geometries in each
        m.measure_batch(space[b * 4:(b + 1) * 4] + space[:2])
    m.close()
    assert m.n_compiles == 32
    pool_launches = [e for e in rec.events if e[0] == "launch" and e[1].startswith("cuda-compile")]
    assert len(pool_launches) >= 16          # the pool really launched
    inside = False
    for kind, thread in rec.events:
        if kind == "open":
            inside = True
        elif kind == "close":
            inside = False
        elif inside:
            # inside a window only the timing thread's own launch runs
            assert not thread.startswith("cuda-compile"), rec.events
    # and every launch ended before the next window opened
    depth = 0
    for kind, _ in rec.events:
        if kind == "launch":
            depth += 1
        elif kind == "end":
            depth -= 1
        elif kind == "open":
            assert depth == 0


def test_pool_counters_hold_under_contention():
    """More pool threads than cores, a short switch interval: every fill is
    counted once and every geometry cached (a lost update would break it)."""
    import sys

    rec = Recorder()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        m = CudaMeasurement(rec.workload(), repeats=1, device="cpu",
                            pipeline_workers=(os.cpu_count() or 1) + 4, timer=rec.timer)
        cfgs = [dict(t_x=tx, t_y=ty, t_z=tz, w_x=1, w_y=1, w_z=wz)
                for tx in (1, 2, 4, 8) for ty in (1, 2, 4, 8) for tz in (1, 2) for wz in (1, 2)]
        for _ in range(3):
            m.measure_batch(cfgs)
        m.close()
    finally:
        sys.setswitchinterval(interval)
    assert m.n_compiles == m.run_compiles == 32
    assert len(m._compiled) == 32 and not m._inflight


def test_pool_task_launches_on_the_measurements_device(monkeypatch):
    """torch's current CUDA device is per thread: a pool task enters the
    measurement's device before it launches."""
    current = threading.local()
    seen = []

    @contextlib.contextmanager
    def fake_device(dev):
        prev = getattr(current, "dev", None)
        current.dev = torch.device(dev)
        try:
            yield
        finally:
            current.dev = prev

    def run(inputs, cfg, x, y, device):
        seen.append((threading.current_thread().name, getattr(current, "dev", None), device))
        return None

    bench = KernelBenchSpec(name="probe", n_inputs=0,
                            make_inputs=lambda x, y, seed: (), run=run)
    m = CudaMeasurement(CudaWorkload(bench=bench, x=64, y=128), device="cpu",
                        pipeline_workers=2)
    m.device = torch.device("cuda", 1)       # a process worker pinned to card 1
    monkeypatch.setattr(torch.cuda, "device", fake_device)
    cfgs = [dict(t_x=1, t_y=1, t_z=z, w_x=1, w_y=1, w_z=1) for z in (1, 2, 4)]
    m.measure_batch(cfgs)
    m.close()
    pool = [s for s in seen if s[0].startswith("cuda-compile")]
    assert pool, seen
    assert all(dev == torch.device("cuda", 1) and arg == torch.device("cuda", 1)
               for _, dev, arg in pool), pool


def test_pipeline_with_the_cache_gives_the_same_values(tmp_path):
    """Both knobs at once, cold then warm: values equal the plain inline
    run's, fills and pcache hits add up to the geometries."""
    cfgs = batch_configs()
    plain = cuda_measurement(repeats=2, timer=counter_timer())
    want = plain.measure_batch(cfgs)
    for run, (fills, hits) in (("cold", (plain.n_compiles, 0)),
                               ("warm", (0, plain.n_compiles))):
        m = cuda_measurement(repeats=2, timer=counter_timer(), pipeline_workers=3,
                             compile_cache=str(tmp_path / "cc"))
        np.testing.assert_array_equal(m.measure_batch(cfgs), want)
        m.close()
        assert (m.n_compiles, m.n_pcache_hits) == (fills, hits), run


def test_pipelined_matrix_counts_every_fill_in_its_unit(tmp_path):
    """A traced matrix with both knobs: a pool fill's counters and stage time
    land in the unit that asked for it, even where its runner was cached
    before its task ended: the trace's stage totals equal the units' summed
    ``stage_s``, and every fill is published and counted once."""
    from repro_torch import TuningSession, build_units, tune_matrix
    from repro_torch.core import ExperimentDesign, TuningSpec
    from repro_torch.telemetry import read_run, stage_percentiles
    from repro_torch.telemetry.events import HOST_STAGES

    spec = TuningSpec(kernel="add", backend="cuda",
                      backend_kwargs={"device": "cpu", "x": 64, "y": 128, "repeats": 1},
                      algorithms=("rs", "ga"),
                      design=ExperimentDesign(sample_sizes=(8,), n_experiments=(4,),
                                              final_repeats=1),
                      store="json", store_path=str(tmp_path / "s.json"))
    tune_matrix(spec, pipeline_workers=3, compile_cache=str(tmp_path / "cc"),
                telemetry_dir=str(tmp_path / "run"))
    events = read_run(str(tmp_path / "run"))
    totals = [e for e in events if e["ev"] == "totals"][-1]["counters"]
    session = TuningSession(spec)
    journal = session.unit_journal()
    stage_s, stores = {}, 0
    for u in build_units(session.cells(), min_units=1, cost=session._unit_cost()):
        result = journal.get(u)
        stores += result.counters.get("pcache.stores", 0)
        for k, v in result.stage_s.items():
            stage_s[k] = stage_s.get(k, 0.0) + v
    trace = {k: v["total_s"] for k, v in stage_percentiles(events).items()}
    # the host stages are trace-only: the measurement's stages are compared
    host = {k for k in trace if k in HOST_STAGES}
    measured = {k: v for k, v in trace.items() if k not in HOST_STAGES}
    assert host == {"propose", "session"}
    assert set(measured) == set(stage_s)
    assert all(abs(measured[k] - stage_s[k]) <= 1e-6 for k in measured), (trace, stage_s)
    entries = [f for f in os.listdir(tmp_path / "cc") if f.endswith(".pkl")]
    assert stores == totals["pcache.stores"] == totals["compiles"] == len(entries) > 0
