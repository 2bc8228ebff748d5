"""The controls, read on the card at the cells' own size: each reference
in bfloat16 put in the program's place, and the tuner's timer with its
fence taken out, must each come out as not correct, on three seeds.  The
readings print (``pytest -s``); PERF.md keeps them beside the limits."""

from __future__ import annotations

import json

import pytest

from bench.harness import layout, program, runner
from bench.harness.timing import kernel_ms

SEEDS = (2**31 + 101, 2**31 + 102, 2**31 + 103)
CONFIGS = [c["name"] for c in layout.load_benchmark()["configs"]]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CONFIGS)
def test_the_lower_precision_control_fails(name, cuda):
    cell = next(layout.cell(w["name"]) for w in layout.load_benchmark()["workloads"]
                if w["config"] == name)
    cfg = cell.config
    x, y, kernel = int(cfg["x"]), int(cfg["y"]), cfg["kernel"]
    ref = layout.reference(kernel)
    program.build_kernels()
    readings = []
    for seed in SEEDS:
        inputs = ref.make_inputs(x, y, runner.bench_generator(seed, "cuda"), "cuda")
        expect = ref.reference(inputs, x, y, "cuda")
        sound = ref.error(program.run_kernel(kernel, inputs, runner.DEFAULT_CONFIG, x, y, "cuda"),
                          expect)
        control = ref.error(ref.control(inputs, x, y, "cuda"), expect)
        readings.append({"seed": seed, "program": sound, "control": control})
    print(f"control {name} {ref.CHECK} limit {ref.LIMIT}: {json.dumps(readings)}")
    assert all(r["program"] <= ref.LIMIT < r["control"] for r in readings)


@pytest.mark.cuda
@pytest.mark.parametrize("name", layout.first_cells())
def test_a_timer_without_its_fence_fails(name, cuda, monkeypatch):
    """The tuner's repeats timed without the synchronise inside the timed
    region (they read the launch's enqueue): the timer ratio of each call
    exceeds its limit."""
    import repro_torch.cuda_bench.measure as measure

    cell = layout.cell(name)
    tune = layout.entry("tune")
    ctx = runner.Context(cell=cell, seed=SEEDS[0])
    program.build_kernels()
    monkeypatch.setattr(measure, "fence", lambda out: out)
    x, y, kernel = int(cell.config["x"]), int(cell.config["y"]), cell.config["kernel"]
    ref = layout.reference(kernel)
    readings = []
    for seed in SEEDS:
        call = tune.one_call(ctx, 20, seed)
        inputs = ref.make_inputs(x, y, runner.bench_generator(seed, "cuda"), "cuda")
        ms = kernel_ms(lambda: program.run_kernel(kernel, inputs, call["winner"], x, y, "cuda"))
        readings.append({"seed": seed, "final_ms": call["final_s"] * 1e3, "event_ms": ms,
                         "ratio": ms / (call["final_s"] * 1e3)})
        del inputs
    print(f"control {name} timer_ratio limit {runner.TIMER_RATIO_LIMIT}: {json.dumps(readings)}")
    assert all(r["ratio"] > runner.TIMER_RATIO_LIMIT for r in readings)
