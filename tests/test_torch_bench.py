"""The port's measurement backend (``repro_torch.cuda_bench``) against the
reference's (``repro.pallas_bench``): byte-identical workload inputs, the
same penalty meta format, the same pre-screen verdicts at a small problem,
and the measurement protocol on the CPU."""

import dataclasses
import math

import numpy as np
import pytest
import torch

from repro.core.space import paper_space
from repro.pallas_bench import InvalidMeasurement as RefInvalid
from repro.pallas_bench import fit_constraint as ref_fit_constraint
from repro.pallas_bench import make_workload as ref_make_workload
from repro_torch.cuda_bench import (
    CudaMeasurement,
    InvalidMeasurement,
    default_space,
    fit_constraint,
    make_workload,
    validate_config,
)
from repro_torch.cuda_bench import measure as measure_mod
from repro_torch.cuda_bench.validity import MAX_GRID_Y, SMEM_LIMIT, validate_geometry
from repro_torch.kernels import KERNEL_BENCHES, _build
from repro_torch.kernels.common import KernelGeometry


@pytest.mark.parametrize("kernel", ["add", "harris", "mandelbrot"])
@pytest.mark.parametrize("shape", [(64, 128), (128, 256), (40, 384)])
@pytest.mark.parametrize("input_seed", [0, 3])
def test_materialize_is_byte_identical_to_reference(kernel, shape, input_seed):
    ours = make_workload(kernel, *shape, input_seed=input_seed).materialize()
    ref = ref_make_workload(kernel, *shape, input_seed=input_seed).materialize()
    assert len(ours) == len(ref) == KERNEL_BENCHES[kernel].n_inputs
    for t, r in zip(ours, ref, strict=True):
        assert t.dtype == torch.float32
        assert np.array_equal(t.numpy(), np.asarray(r))


def test_workload_defaults_and_minimum():
    w = make_workload("add")
    assert (w.x, w.y) == (8192, 8192)
    with pytest.raises(ValueError):
        make_workload("add", x=4, y=128)
    with pytest.raises(KeyError):
        make_workload("nope")


@pytest.mark.parametrize(
    "meta",
    ["validity:block:(64,256) exceeds padded image (64,128)",
     "compile:RuntimeError: launch failed", "run:RuntimeError: fault",
     "no stage prefix at all"],
)
def test_invalid_measurement_meta_round_trips_both_ways(meta):
    ours, ref = InvalidMeasurement.from_meta(meta), RefInvalid.from_meta(meta)
    assert (ours.stage, ours.reason) == (ref.stage, ref.reason)
    assert ours.to_meta() == ref.to_meta()
    assert RefInvalid.from_meta(ours.to_meta()) == ref
    assert InvalidMeasurement.from_meta(ref.to_meta()) == ours
    assert math.isinf(ours.penalty)


@pytest.mark.parametrize("kernel", ["add", "harris", "mandelbrot"])
def test_cuda_fit_accepts_what_pallas_fit_accepts_at_64x128(kernel):
    ours = fit_constraint(make_workload(kernel, 64, 128))
    ref = ref_fit_constraint(ref_make_workload(kernel, 64, 128))
    configs = paper_space(constrained=False).sample_batch(
        np.random.default_rng(7), 20000)
    verdicts = [(ours(c), ref(c)) for c in configs]
    assert all(a == b for a, b in verdicts)
    assert 0 < sum(a for a, _ in verdicts) < len(verdicts)


def test_validity_rules_in_reference_order():
    bench = KERNEL_BENCHES["harris"]
    misaligned, too_wide = KernelGeometry(12, 128, 1, 1, 1, 1), KernelGeometry(8, 256, 1, 1, 1, 1)
    assert validate_geometry(bench, misaligned, 64, 128).startswith("align:")
    assert validate_geometry(bench, too_wide, 64, 128).startswith("block:")
    # 8192 tile rows per region split x 8 splits > gridDim.y's 65535
    reason = validate_geometry(bench, KernelGeometry(8, 128, 1, 8, 1, 1), 8 * 65535, 128)
    assert reason.startswith("grid:")
    too_much_smem = dataclasses.replace(bench, smem_bytes=SMEM_LIMIT + 1)
    assert validate_geometry(too_much_smem, KernelGeometry(8, 128, 1, 1, 1, 1),
                             64, 128).startswith("smem:")
    assert validate_geometry(bench, KernelGeometry(8, 128, 1, 1, 1, 1), 64, 128) is None


def test_default_space_constraint_id_round_trips():
    from repro_torch import TuningSpec

    space = default_space("harris", x=64, y=256)
    cid = space.constraint.constraint_id
    assert cid == f"cuda_fit:harris:64:256:232448:{MAX_GRID_Y}"
    spec = TuningSpec(kernel="harris", backend="cuda", space=space, budget=4,
                      backend_kwargs={"x": 64, "y": 256, "device": "cpu"})
    back = TuningSpec.from_json(spec.to_json())
    assert back.to_dict() == spec.to_dict()
    rebuilt = back.space.constraint
    cfgs = paper_space(constrained=False).sample_batch(np.random.default_rng(1), 500)
    assert [rebuilt(c) for c in cfgs] == [space.constraint(c) for c in cfgs]


def test_cuda_measurement_on_cuda_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CudaMeasurement(make_workload("add", 64, 128), device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CudaMeasurement(make_workload("add", 64, 128))


def test_cpu_measurement_protocol():
    ticks = iter(range(1000))
    m = CudaMeasurement(make_workload("add", 64, 128), repeats=3, device="cpu",
                        timer=lambda: float(next(ticks)))
    good = dict(t_x=2, t_y=1, t_z=2, w_x=1, w_y=1, w_z=1)
    bad = dict(t_x=1, t_y=2, t_z=1, w_x=1, w_y=1, w_z=1)     # 256 cols > 128
    vals = m.measure_batch([good, {**good, "w_z": 5}, bad])
    assert m.n_dispatches == 1 and m.n_samples == 3
    assert vals[0] == vals[1] == 1.0              # injected clock: 1 tick/repeat
    assert math.isinf(vals[2])
    assert m.n_compiles == 1                      # w_z shares one warm entry
    assert m.reason_for(bad).startswith("validity:block:")
    assert m.repeats_for(good) == [1.0, 1.0, 1.0]
    assert m.measure_final(good, repeats=4) == 1.0
    assert len(m.repeats_for(good)) == 4
    assert set(m.stage_times()) >= {"screen", "compile", "time", "record"}
    assert validate_config(m.workload, bad) is not None
    m.reset()
    assert m.n_samples == 0 and m.n_compiles == 1 and m.run_compiles == 0


def test_a_failed_build_raises_from_tune(monkeypatch):
    """The library builds when a card measurement is made: no nvcc fails the
    run instead of penalising every config."""
    from repro_torch import TuningSpec, tune

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(measure_mod, "resolve_device", lambda d: torch.device("cuda", 0))
    monkeypatch.setattr(_build, "_loaded", [])
    monkeypatch.setattr(_build, "find_nvcc", no_nvcc)
    spec = TuningSpec(kernel="add", backend="cuda", searcher="rs", budget=4,
                      backend_kwargs={"x": 64, "y": 128})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        tune(spec)


def _faulty_measurement(code: int) -> CudaMeasurement:
    def run(inputs, cfg, x, y, device):
        if cfg.get("t_x") == 2:
            raise _build.LaunchError("repro_add_f32", code, "injected")
        return inputs[0] + inputs[1]

    bench = dataclasses.replace(KERNEL_BENCHES["add"], run=run)
    workload = dataclasses.replace(make_workload("add", 64, 128), bench=bench)
    return CudaMeasurement(workload, repeats=2, device="cpu")


@pytest.mark.parametrize("code", sorted(_build.CONFIG_ERRORS))
def test_a_launch_refused_for_its_geometry_is_a_penalty(code):
    m = _faulty_measurement(code)
    refused, fine = dict(t_x=2), dict(t_x=1)
    vals = m.measure_batch([refused, fine])
    assert math.isinf(vals[0]) and math.isfinite(vals[1])
    assert m.reason_for(refused).startswith("compile:LaunchError:")
    assert m.provenance()["n_invalid"] == 1


@pytest.mark.parametrize("code", [2, 700, 999])  # out of memory, illegal address, unknown
def test_a_fault_no_config_causes_raises(code):
    m = _faulty_measurement(code)
    with pytest.raises(_build.LaunchError, match=f"error {code} "):
        m.measure_batch([dict(t_x=1), dict(t_x=2)])
