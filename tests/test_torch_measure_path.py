"""The port's one measurement path (``CudaMeasurement`` with
``device="cpu"``) against the reference's ``PallasMeasurement``, and what
that path guarantees on its own.

* under each of the reference's speed knobs — ``pipeline_workers`` 0 or 2,
  ``compile_cache`` none, cold or warm — the reference measures what the
  port measures with no knob at all: the same values, the same penalties
  and the same repeat logs, with the port's fills equal to the reference's
  fills plus its cache hits, on add, harris and mandelbrot at 64x128;
* the path's own rules: a screened-out config is never filled, a launch
  refused for its geometry is a cached ``compile``-stage penalty, any other
  error raises and leaves nothing cached, provenance counters are per run;
* nothing keeps a finished measurement or session alive: with the cyclic
  collector off, a ``CudaMeasurement`` that warmed a geometry, and a
  ``TuningSession`` after ``run()``, ``run_unit`` or its dataset, are freed
  with their staged inputs as soon as the last name for them goes.
"""

import gc
import itertools
import weakref

import numpy as np
import pytest

from repro_torch import ExperimentUnit
from repro_torch.core import ExperimentDesign, TuningSession, TuningSpec
from repro_torch.cuda_bench import CudaMeasurement, make_workload
from repro_torch.cuda_bench.workloads import CudaWorkload
from repro_torch.kernels import _build
from repro_torch.kernels.common import KernelBenchSpec

KERNELS = ("add", "harris", "mandelbrot")
X, Y = 64, 128


def square_timer():
    """A timing-stage clock that reads n² at its n-th reading: each timed
    repeat's value says how many readings came before it, so two runs give
    equal values only if they time the same repeats in the same order."""
    ticks = itertools.count()
    return lambda: float(next(ticks) ** 2)


def batch_configs():
    """Valid configs, configs the screen refuses at 64x128, and geometry
    duplicates (``w_z`` does not enter the program)."""
    return [
        dict(t_x=tx, t_y=ty, t_z=tz, w_x=1, w_y=1, w_z=wz)
        for tx, ty, tz, wz in itertools.product((1, 2, 16), (1, 2), (1, 2), (1, 2))
    ]


def port_measurement(kernel: str = "add", **kwargs) -> CudaMeasurement:
    return CudaMeasurement(make_workload(kernel, x=X, y=Y), device="cpu", **kwargs)


def ref_measurement(kernel: str = "add", **kwargs):
    from repro.pallas_bench import PallasMeasurement
    from repro.pallas_bench import make_workload as ref_workload

    return PallasMeasurement(ref_workload(kernel, x=X, y=Y), **kwargs)


def measured(m, cfgs: list) -> dict:
    """Everything a measurement reports for ``cfgs``: values, the winner's
    final, each config's penalty and repeat log."""
    values = m.measure_batch(cfgs).tolist()
    final = m.measure_final(cfgs[0], 3)
    return {
        "values": values,
        "final": final,
        "reasons": [m.reason_for(c) for c in cfgs],
        "repeats": [m.repeats_for(c) for c in cfgs],
    }


# ------------------------------------- the reference's knobs change no value


@pytest.mark.parametrize("cache", ["none", "cold", "warm"])
@pytest.mark.parametrize("workers", [0, 2])
@pytest.mark.parametrize("kernel", KERNELS)
def test_one_path_equals_the_reference_under_each_knob(kernel, workers, cache, tmp_path):
    cfgs = batch_configs()
    root = None if cache == "none" else str(tmp_path / "cc")
    if cache == "warm":
        ref_measurement(kernel, repeats=1, compile_cache=root).measure_batch(cfgs)
    ref = ref_measurement(kernel, repeats=2, timer=square_timer(),
                          pipeline_workers=workers, compile_cache=root)
    want = measured(ref, cfgs)
    ref.close()
    ours = port_measurement(kernel, repeats=2, timer=square_timer())
    got = measured(ours, cfgs)
    assert got == want
    assert np.isfinite(got["values"]).any() and np.isinf(got["values"]).any()
    assert ours.n_compiles == ref.n_compiles + ref.n_pcache_hits
    assert (ref.n_pcache_hits > 0) == (cache == "warm")


# ---------------------------------------------------------- the path's rules


def test_screened_out_configs_are_never_filled():
    """Only geometries of configs the screen passes are filled, as in the
    reference's inline path."""
    cfgs = batch_configs()
    fills = {}
    for name, make in (("port", port_measurement), ("ref", ref_measurement)):
        m = make(repeats=1)
        m.measure_batch(cfgs)
        passed = {m._geom_key(c) for c in cfgs
                  if not (m.reason_for(c) or "").startswith("validity:")}
        assert set(m._compiled) == passed and m.n_compiles == len(passed)
        fills[name] = sorted(m._compiled)
    assert fills["port"] == fills["ref"]


def refusing_workload(calls: list) -> CudaWorkload:
    """A workload whose every launch the card refuses for its geometry."""
    def refuse(inputs, cfg, x, y, device):
        calls.append(dict(cfg))
        raise _build.LaunchError("repro_boom", 9, "invalid configuration argument")

    bench = KernelBenchSpec(name="boom", n_inputs=0,
                            make_inputs=lambda x, y, seed: (), run=refuse)
    return CudaWorkload(bench=bench, x=X, y=Y)


def test_refusals_are_compile_stage_penalties():
    """A geometry whose launch is refused becomes a cached inf penalty of
    the ``compile`` stage (the reference's compile failure): one refused
    launch a geometry, none for a config that shares it, none timed."""
    calls = []
    m = CudaMeasurement(refusing_workload(calls), repeats=2, device="cpu")
    cfgs = [dict(t_x=1, t_y=1, t_z=z, w_x=1, w_y=1, w_z=1) for z in (1, 2, 2)]
    vals = m.measure_batch(cfgs)
    assert np.isinf(vals).all()
    assert m.n_compiles == 2 and len(calls) == 2
    assert "invalid configuration" in m.reason_for(cfgs[0])
    assert all(m.reason_for(c).startswith("compile:") for c in cfgs)
    assert m.repeats_for(cfgs[0]) is None


@pytest.mark.parametrize("call", ["measure_batch", "measure"])
def test_non_config_errors_raise(call):
    """Any other launch error raises, is never a penalty, and caches
    nothing: once the fault is gone the same geometry is filled and
    measured."""
    broken = [True]

    def run(inputs, cfg, x, y, device):
        if broken[0]:
            raise RuntimeError("no library")
        return None

    bench = KernelBenchSpec(name="flaky", n_inputs=0,
                            make_inputs=lambda x, y, seed: (), run=run)
    m = CudaMeasurement(CudaWorkload(bench=bench, x=X, y=Y), device="cpu")
    cfgs = [dict(t_x=1, t_y=1, t_z=z, w_x=1, w_y=1, w_z=1) for z in (1, 2)]
    measure = (lambda: m.measure_batch(cfgs)) if call == "measure_batch" \
        else (lambda: np.array([m.measure(c) for c in cfgs]))
    with pytest.raises(RuntimeError, match="no library"):
        measure()
    assert m.invalid == {} and m._compiled == {}
    broken[0] = False
    assert np.isfinite(measure()).all()
    assert all(m.reason_for(c) is None for c in cfgs)
    assert len(m._compiled) == 2


def test_provenance_counters_are_per_run():
    """n_compiles / n_invalid in provenance report work since the last
    reset(), as the reference's do; the port's provenance names no knob."""
    got = {}
    # the port stages its inputs in a stage of its own, once a measurement;
    # the reference stages them inside its compile stage
    stages = {"port": {"screen", "inputs", "compile", "time", "record"},
              "ref": {"screen", "compile", "time", "record"}}
    for name, make in (("port", port_measurement), ("ref", ref_measurement)):
        m = make(repeats=1)
        m.measure_batch(batch_configs())
        first = m.provenance()
        assert first["n_compiles"] > 0 and first["n_invalid"] > 0
        assert first["n_compiles_total"] == m.n_compiles
        assert set(first["stage_s"]) == stages[name]

        m.reset()
        blank = m.provenance()
        assert blank["n_compiles"] == 0 and blank["n_invalid"] == 0
        assert blank["n_compiles_total"] == first["n_compiles_total"]
        assert blank["stage_s"] == {}

        m.measure_batch(batch_configs())
        warm = m.provenance()
        assert warm["n_compiles"] == 0
        assert warm["n_invalid"] == first["n_invalid"]
        assert warm["stage_s"].get("compile", 0.0) == 0.0
        assert warm["stage_s"].get("inputs", 0.0) == 0.0
        assert warm["stage_s"]["time"] > 0.0
        got[name] = [(p["n_compiles"], p["n_compiles_total"], p["n_invalid"])
                     for p in (first, blank, warm)]
        if name == "port":
            assert not {"pipeline_workers", "compile_cache", "n_pcache_hits"} & set(first)
    assert got["port"] == got["ref"]


# ------------------------------------------------------ no reference cycles


@pytest.fixture
def no_cyclic_collector():
    """The cyclic collector off for the test: what it frees, only
    refcounting may free."""
    gc.collect()
    gc.disable()
    try:
        yield
    finally:
        gc.enable()


@pytest.mark.parametrize("kernel", KERNELS)
def test_a_finished_measurement_is_freed_by_refcounting(kernel, no_cyclic_collector):
    m = port_measurement(kernel, repeats=1)
    values = m.measure_batch(batch_configs())
    m.measure_final(batch_configs()[0], 2)
    assert np.isfinite(values).any() and m._compiled
    gone = weakref.ref(m)
    inputs = [weakref.ref(t) for t in m._inputs]
    assert len(inputs) == make_workload(kernel).bench.n_inputs
    del m
    assert gone() is None
    assert all(t() is None for t in inputs)


@pytest.fixture
def live_measurements(monkeypatch):
    """A weak set of every ``CudaMeasurement`` built while the test runs."""
    live = weakref.WeakSet()
    init = CudaMeasurement.__init__

    def tracked(self, *args, **kwargs):
        init(self, *args, **kwargs)
        live.add(self)

    monkeypatch.setattr(CudaMeasurement, "__init__", tracked)
    return live


def session_spec(kernel: str, **kwargs) -> TuningSpec:
    return TuningSpec(kernel=kernel, backend="cuda", searcher="rs", seed=3,
                      backend_kwargs={"device": "cpu", "x": X, "y": Y, "repeats": 1},
                      **kwargs)


@pytest.mark.parametrize("path", ["run", "run_unit", "dataset"])
@pytest.mark.parametrize("kernel", KERNELS)
def test_a_finished_session_is_freed_by_refcounting(kernel, path, no_cyclic_collector,
                                                    live_measurements):
    """The session's factory binds the spec, not the session, and no
    runner holds its measurement: after ``run()``, after a unit, and after
    a unit that measured the matrix's dataset, the session and every
    measurement it built go with the last name for the session."""
    design = ExperimentDesign(sample_sizes=(4,), n_experiments=(2,), final_repeats=1)
    unit = ExperimentUnit(algo="rs", sample_size=4, exp_lo=0, exp_hi=2, n_exp=2)
    if path == "run":
        session = TuningSession(session_spec(kernel, budget=4, final_repeats=1))
        assert np.isfinite(session.run().final_value)
    else:
        extra = {"dataset_size": 8} if path == "dataset" else {}
        session = TuningSession(session_spec(kernel, design=design, **extra))
        result = session.run_unit(unit)
        assert np.isfinite(result.final_values).all()
        assert (session._dataset is not None) == (path == "dataset")
    assert session.measurement is not None and len(live_measurements) > 0
    gone = weakref.ref(session)
    del session
    assert gone() is None
    assert len(live_measurements) == 0
