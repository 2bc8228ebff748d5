"""The harness drives a whole run on the CPU (the port's plain versions,
small images, deterministic clocks) and reports ``correct`` true; with the
timed path broken underneath, once for each fault a tuning cell can have,
it reports false.  The look for a card is skipped; the command itself
refuses to run without one, or without the program beside it."""

from __future__ import annotations

import dataclasses
import json
import shutil
import subprocess
import sys
import time

import pytest
import torch

from bench.harness import layout, runner, trace

ROOT = layout.ROOT
#: the benchmark's kernel time of every config in these runs, against the
#: port's clock ticking 1 ms a reading: the timer ratio reads 0.9
BENCH_MS = 0.9
#: the first cell of each configuration: every kernel the benchmark runs
FIRST_CELLS = layout.first_cells()


def small_cell(name: str, x: int = 64, y: int = 256, budget: int = 20):
    cell = layout.cell(name)
    return dataclasses.replace(
        cell, config=dict(cell.config, x=x, y=y),
        traffic=dict(cell.traffic, budget=budget, warmup_budget=budget))


@pytest.fixture
def ticking_clock():
    """The port's clock advances 1 ms a reading, so a timed repeat (two
    readings around one launch) reads 1 ms exactly."""
    from repro_torch.core import clock

    ticks = iter(range(10**9))
    prev = clock.set_timer(lambda: next(ticks) * 1e-3)
    try:
        yield
    finally:
        clock.set_timer(prev)


def cpu_run(cell, seed: int = 2**31 + 11):
    return runner.run_cell(cell, seed=seed, seconds=0.05, trace=False,
                           t_start=time.perf_counter(), device="cpu",
                           timer=lambda fn: BENCH_MS)


@pytest.mark.parametrize("name", FIRST_CELLS)
def test_a_sound_run_is_correct(name, ticking_clock):
    res = cpu_run(small_cell(name))
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] >= 1
    assert list(res)[-1] == "checks"
    for c in res["checks"].values():
        assert c["value"] <= c["limit"]
    assert res["checks"]["timer_ratio"]["value"] == pytest.approx(BENCH_MS)
    assert set(res["metrics"]) == {"samples_per_s", "winner_ms", "setup_s"}
    assert res["metrics"]["winner_ms"]["value"] == pytest.approx(BENCH_MS)


def _unchanged(out, x, y):
    return torch.zeros_like(out)


def _half(out, x, y):
    out = out.clone()
    out[x // 2:] = 0
    return out


def _one_answer(out, x, y):
    out = out.clone()
    out[x // 3, y // 5] = 1 - out[x // 3, y // 5]
    return out


@pytest.mark.parametrize("fault", [_unchanged, _half, _one_answer])
@pytest.mark.parametrize("name", FIRST_CELLS)
def test_a_broken_kernel_is_not_correct(name, fault, ticking_clock, monkeypatch):
    """The kernel leaves its output unchanged, computes half the image, or
    alters one pixel where it is produced."""
    from repro_torch.kernels import KERNEL_BENCHES

    cell = small_cell(name)
    kernel = cell.config["kernel"]
    bench = KERNEL_BENCHES[kernel]
    broken = dataclasses.replace(
        bench, run=lambda inputs, cfg, x, y, device: fault(bench.run(inputs, cfg, x, y, device), x, y))
    monkeypatch.setitem(KERNEL_BENCHES, kernel, broken)
    res = cpu_run(cell)
    ref = layout.reference(kernel)
    assert res["correct"] is False and res["failed"] == res["attempted"]
    assert res["checks"][ref.CHECK]["value"] > res["checks"][ref.CHECK]["limit"]


def test_a_timer_that_reads_too_little_is_not_correct(ticking_clock, monkeypatch):
    """The winner's reported time altered where it is produced: the final
    re-measurement reads a twentieth of the kernel's time, as a timer that
    measures the enqueue would."""
    from repro_torch.cuda_bench.measure import CudaMeasurement

    final = CudaMeasurement.measure_final
    monkeypatch.setattr(CudaMeasurement, "measure_final",
                        lambda self, cfg, repeats=10: final(self, cfg, repeats) / 20)
    res = cpu_run(small_cell("harris.ga-200"))
    assert res["correct"] is False and res["failed"] == res["attempted"]
    assert res["checks"]["timer_ratio"]["value"] == pytest.approx(20 * BENCH_MS)


def test_a_short_search_record_is_not_correct(ticking_clock, monkeypatch):
    """The search loop's record altered: a sample dropped from the history."""
    from repro_torch.core import api

    drive = api.drive

    def short(*args, **kwargs):
        result = drive(*args, **kwargs)
        result.history_values.pop()
        result.history_configs.pop()
        result.n_samples -= 1
        return result

    monkeypatch.setattr(api, "drive", short)
    with pytest.raises(RuntimeError, match="warm-up call failed"):
        cpu_run(small_cell("mandelbrot.ga-200"))


def test_record_faults_rules():
    tune = layout.entry("tune")
    space = layout.cell("harris.ga-200").config["space"]
    cfg = {"t_x": 2, "t_y": 1, "t_z": 1, "w_x": 1, "w_y": 1, "w_z": 1}
    other = dict(cfg, t_x=3)

    @dataclasses.dataclass
    class R:
        best_config: dict
        best_value: float
        history_configs: list
        history_values: list
        n_samples: int
        final_value: float = 1e-3

    ok = R(cfg, 1.0, [other, cfg], [2.0, 1.0], 2)
    assert tune.record_faults(ok, 2, space) == []
    assert tune.record_faults(ok, 3, space)                                   # short of budget
    assert tune.record_faults(R(other, 2.0, [other, cfg], [2.0, 1.0], 2), 2, space)  # not the least
    assert tune.record_faults(R(other, 2.0, [other, cfg], [2.0, 1.0], 2), 2, space, among_last=1)
    assert tune.record_faults(R(cfg, 2.0, [other, cfg], [2.0, 1.0], 2), 2, space)  # never sampled
    bad = dict(cfg, t_x=17)
    assert tune.record_faults(R(bad, 1.0, [other, bad], [2.0, 1.0], 2), 2, space)  # outside
    assert tune.record_faults(R(cfg, float("inf"), [cfg], [float("inf")], 1), 1, space)
    assert tune.record_faults(dataclasses.replace(ok, final_value=float("nan")), 2, space)
    assert tune.call_seed(2**31 + 5, 0) != tune.call_seed(2**31 + 5, 1)
    assert 0 <= tune.call_seed(2**40, 7) < 2**31


def test_forbidden_modules_compare_whole_names():
    sys.path.insert(0, str(ROOT / "bench"))
    try:
        import run as bench_run
    finally:
        sys.path.remove(str(ROOT / "bench"))
    names = ["repro_torch", "repro_torch.core", "jax_like", "jaxtyping", "repro",
             "repro.core.api", "jax", "jaxlib.xla", "flax.linen", "numpy"]
    assert bench_run.forbidden_modules(names) == [
        "flax.linen", "jax", "jaxlib.xla", "repro", "repro.core.api"]


def _command(cwd, *extra):
    return subprocess.run(
        [sys.executable, "bench/run.py", "--workload", "harris.ga-200", "--seed",
         str(2**31 + 3), "--seconds", "1", "--trace", "0", *extra],
        cwd=cwd, capture_output=True, text=True, timeout=300)


def test_the_command_refuses_without_the_program(tmp_path):
    """A directory holding only BENCHMARK.json and bench/: non-zero, no
    result."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = _command(tmp_path)
    assert proc.returncode != 0 and '"correct"' not in proc.stdout


def test_the_command_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    proc = _command(ROOT)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "CUDA card" in proc.stderr


def test_trace_summary_labels_idle_gaps():
    """Device work at [0, 1] and [3, 4] s of a [0, 6] s window; the host
    spent [1, 2] in a compile stage and [3.5, 5] in a time stage, inside a
    call over [0.5, 5.5]."""
    us = 1e6
    events = [
        {"ph": "X", "cat": "user_annotation", "name": trace.MARKER, "ts": 100 * us, "dur": 6 * us},
        {"ph": "X", "cat": "kernel", "name": "k", "ts": 100 * us, "dur": 1 * us},
        {"ph": "X", "cat": "gpu_memcpy", "name": "copy", "ts": 103 * us, "dur": 0.5 * us},
        {"ph": "X", "cat": "kernel", "name": "k", "ts": 103.5 * us, "dur": 0.5 * us},
        {"ph": "X", "cat": "cpu_op", "name": "aten::empty", "ts": 101 * us, "dur": 1 * us},
    ]
    host0 = 50.0  # the host clock reads 50 s where the trace reads 100 s
    s = trace.summarize(events, host0, [(50.5, 55.5)],
                        [(51.0, 52.0, "compile"), (53.5, 55.0, "time")])
    assert s["busy_s"] == pytest.approx(2.0) and s["window_s"] == pytest.approx(6.0)
    gaps = dict(s["idle_gaps"])
    assert gaps["compile stage"] == pytest.approx(1.0)
    assert gaps["time stage"] == pytest.approx(1.0)
    assert gaps["search (in a call, outside every stage)"] == pytest.approx(1.5)
    assert gaps["harness (between calls)"] == pytest.approx(0.5)
    assert s["device_ops"][0] == ["k", pytest.approx(1.5)]
    assert s["longest_gap_s"] == pytest.approx(2.0)
