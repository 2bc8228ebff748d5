"""The ``tune_matrix`` entry driven end to end on the CPU (the port's plain
versions, a small image, the port's clock ticking 1 ms a reading): a sound
run reads ``correct`` true, its records hold a call's totals once each; a
dropped experiment, a winner moved outside the space, one output pixel
altered, the final time divided by 20 and a missing ``(algo, S)`` row each
read ``correct`` false.

At 64x256 only 1 % of the unconstrained space fits the image, and BO GP's
and BO TPE's proposals here find no config that fits in some experiments
(at the cell's 8192x8192 every config fits), so these runs take the cell's
design with ``rs``, ``rf`` and ``ga`` alone; the budgets follow the entry's
rule."""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import pytest

from bench.harness import layout, runner

CELL = "harris.matrix-s25-50"
#: the benchmark's kernel time of every config, against the port's clock
#: ticking 1 ms a reading: the timer ratio reads 0.9
BENCH_MS = 0.9
ALGOS = ("rs", "rf", "ga")


def small_cell():
    entry = layout.entry("tune_matrix")
    cell = layout.cell(CELL)
    traffic = dict(cell.traffic, algorithms=list(ALGOS))
    traffic["budget"] = entry.call_budget(entry.design_of(traffic))
    traffic["warmup_budget"] = entry.call_budget(entry.design_of(traffic, warmup=True))
    return dataclasses.replace(cell, config=dict(cell.config, x=64, y=256), traffic=traffic)


@pytest.fixture
def ticking_clock():
    from repro_torch.core import clock

    ticks = iter(range(10**9))
    prev = clock.set_timer(lambda: next(ticks) * 1e-3)
    try:
        yield
    finally:
        clock.set_timer(prev)


def cpu_run(cell=None, seed: int = 2**31 + 17):
    return runner.run_cell(cell or small_cell(), seed=seed, seconds=0.05, trace=False,
                           t_start=time.perf_counter(), device="cpu",
                           timer=lambda fn: BENCH_MS)


def test_the_traffic_states_the_cells_design_and_its_cut():
    entry = layout.entry("tune_matrix")
    t = layout.cell(CELL).traffic
    assert t["entry"] == "tune_matrix" and t["executor"] == "serial"
    assert t["algorithms"] == ["rs", "rf", "ga", "bo_gp", "bo_tpe"]
    assert (t["sample_sizes"], t["n_experiments"], t["final_repeats"], t["dataset_size"]) == \
        ([25, 50], [4, 2], 10, 200)
    assert t["budget"] == entry.call_budget(entry.design_of(t)) == 200 + 3 * 200 + 6 * 10
    assert t["warmup_budget"] == entry.call_budget(entry.design_of(t, warmup=True)) == 110
    assert t["paper_design"]["dataset_size"] == 20000
    assert set(t["reduced"]) == {"sample_sizes", "n_experiments", "dataset_size"}
    assert [entry.search_samples(a, 25) for a in t["algorithms"]] == [0, 10, 25, 25, 25]


def test_the_configuration_states_the_deployment_the_traffic_runs():
    """``harris-8192-matrix`` is ``harris-8192``'s kernel, image and space
    under the paper's matrix: the design the traffic runs, the paper's own
    beside it, and ``reduced`` naming exactly the keys cut from it."""
    bench = layout.load_benchmark()
    entry = {c["name"]: c for c in bench["configs"]}["harris-8192-matrix"]
    cell = layout.cell(CELL)
    cfg, base = cell.config, layout.cell("harris.ga-200").config
    assert {w["config"] for w in bench["workloads"] if w["name"] == CELL} == {entry["name"]}
    for key in ("kernel", "dtype", "x", "y", "space", "space_size"):
        assert cfg[key] == base[key], key
    design = layout.entry("tune_matrix").design_of(cell.traffic)
    assert {k: cfg[k] for k in design} == design
    assert cfg["final_repeats"] == cell.traffic["final_repeats"]
    paper = cfg["paper_design"]
    assert paper["n_experiments"] == [20000 // s for s in paper["sample_sizes"]]
    assert sorted(entry["reduced"]) == sorted(k for k in paper if cfg[k] != paper[k])
    assert set(cfg["reduced_why"]) == set(entry["reduced"]) == set(cell.traffic["reduced"])


def test_records_count_a_calls_totals_once(ticking_clock):
    """One matrix call's records: one an experiment in the session's cell
    order, the dataset's samples and the call's wall, stages and span on
    its first record, the readers reading them."""
    cell = small_cell()
    entry = layout.entry("tune_matrix")
    ctx = runner.Context(cell=cell, seed=2**31 + 5, device="cpu")
    recs = entry.one_call(ctx, entry.design_of(cell.traffic), entry.call_seed(ctx.seed, 0))
    assert [(r["algo"], r["sample_size"], r["experiment"]) for r in recs] == [
        (a, s, e) for a in ALGOS for s, n in ((25, 4), (50, 2)) for e in range(n)]
    assert not any(r["faults"] for r in recs)
    assert sum(r["samples"] for r in recs) == cell.traffic["budget"] == 200 + 200 + 60
    first, rest = recs[0], recs[1:]
    assert first["t0"] < first["t1"] and all(r["t0"] == r["t1"] == first["t1"] for r in rest)
    assert all(r["wall_s"] == 0.0 and r["stage_s"] == {} for r in rest)
    assert {"dataset", "inputs", "compile", "time"} <= set(first["stage_s"])
    assert first["wall_s"] > sum(first["stage_s"].values()) > 0
    space = cell.config["space"]
    assert all(set(r["winner"]) == set(space) for r in recs)
    run = runner.Run(cell=cell, setup_s=1.0, start=first["t0"], calls=recs)
    got = layout.reader("dataset_ms_per_sample").read(run)
    assert got == pytest.approx(first["stage_s"]["dataset"] / 460 * 1e3)
    for name in ("search_ms_per_sample", "inputs_ms_per_sample", "time_ms_per_sample",
                 "compile_ms_per_sample", "samples_per_s"):
        assert layout.reader(name).read(run) > 0, name
    single = runner.Run(cell=cell, setup_s=1.0, start=0.0,
                        calls=[{"samples": 10, "stage_s": {"time": 1.0}, "wall_s": 2.0}])
    assert layout.reader("dataset_ms_per_sample").read(single) is None


def test_a_sound_run_is_correct(ticking_clock):
    res = cpu_run()
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] >= 18 and res["attempted"] % 18 == 0   # 3 algorithms x 6
    assert list(res)[-1] == "checks"
    for c in res["checks"].values():
        assert c["value"] <= c["limit"]
    assert res["checks"]["timer_ratio"]["value"] == pytest.approx(BENCH_MS)
    assert set(res["metrics"]) == {"samples_per_s", "winner_ms", "setup_s"}
    assert res["metrics"]["winner_ms"]["value"] == pytest.approx(BENCH_MS)
    assert res["run"]["samples"] == res["attempted"] // 18 * 460
    assert res["run"]["stage_s"]["dataset"] > 0


def plant(monkeypatch, edit):
    """``edit`` each cell of the window's matrices (the rows of two or more
    experiments: the set-up's warm-up matrix has one a row, so it passes)
    where the matrix merges its units."""
    from repro_torch.core import api

    merge = api.merge_unit_results

    def planted(cells, results):
        out, walls = merge(cells, results)
        return [c for c in (edit(c) if len(c.final_values) > 1 else c for c in out)
                if c is not None], walls

    monkeypatch.setattr(api, "merge_unit_results", planted)


def _drop_an_experiment(cell):
    if cell.algo != "ga" or cell.sample_size != 25:
        return cell
    return dataclasses.replace(
        cell, final_values=cell.final_values[:-1], n_samples_used=cell.n_samples_used[:-1],
        search_best_values=cell.search_best_values[:-1], best_indices=cell.best_indices[:-1])


def _winner_outside(cell):
    best = cell.best_indices.copy()
    best[0, 0] = 16                      # t_x has 16 values: index 16 is none of them
    return dataclasses.replace(cell, best_indices=best)


def _row_missing(cell):
    return None if (cell.algo, cell.sample_size) == ("rf", 50) else cell


@pytest.mark.parametrize("edit", [_drop_an_experiment, _winner_outside, _row_missing])
def test_a_broken_matrix_record_is_not_correct(edit, ticking_clock, monkeypatch):
    plant(monkeypatch, edit)
    res = cpu_run()
    assert res["correct"] is False and res["failed"] >= 1
    assert res["checks"]["record_faults"]["value"] >= 1
    if edit is not _winner_outside:     # a matrix-wide fault: every record of a call
        assert res["failed"] == res["attempted"]


def test_one_altered_pixel_is_not_correct(ticking_clock, monkeypatch):
    from repro_torch.kernels import KERNEL_BENCHES

    bench = KERNEL_BENCHES["harris"]

    def one_pixel(inputs, cfg, x, y, device):
        out = bench.run(inputs, cfg, x, y, device).clone()
        out[x // 3, y // 5] = 1 - out[x // 3, y // 5]
        return out

    monkeypatch.setitem(KERNEL_BENCHES, "harris", dataclasses.replace(bench, run=one_pixel))
    res = cpu_run()
    ref = layout.reference("harris")
    assert res["correct"] is False and res["failed"] == res["attempted"]
    assert res["checks"][ref.CHECK]["value"] > ref.LIMIT


def test_a_final_time_divided_by_20_is_not_correct(ticking_clock, monkeypatch):
    from repro_torch.cuda_bench.measure import CudaMeasurement

    final = CudaMeasurement.measure_final
    monkeypatch.setattr(CudaMeasurement, "measure_final",
                        lambda self, cfg, repeats=10: final(self, cfg, repeats) / 20)
    res = cpu_run()
    assert res["correct"] is False and res["failed"] == res["attempted"]
    assert res["checks"]["timer_ratio"]["value"] == pytest.approx(20 * BENCH_MS)


def test_a_program_without_winners_is_refused_before_any_build(monkeypatch):
    """The parent of this cell keeps no winner per experiment: its set-up
    raises before it builds or measures anything."""
    from repro_torch.core import api

    init = api.TuningSession.__init__

    def older(self, *args, **kwargs):
        init(self, *args, **kwargs)
        del self.last_unit_results

    monkeypatch.setattr(api.TuningSession, "__init__", older)
    built = []
    monkeypatch.setattr(runner.program, "build_kernels", lambda: built.append(1) or 0.0)
    with pytest.raises(RuntimeError, match="no winner per matrix experiment"):
        cpu_run()
    assert built == []


def test_record_faults_rules():
    entry = layout.entry("tune_matrix")
    space = layout.cell(CELL).config["space"]
    cfg = {"t_x": 2, "t_y": 1, "t_z": 1, "w_x": 1, "w_y": 1, "w_z": 1}
    assert entry.record_faults("ga", 25, 25, cfg, 1.0, 1e-3, space) == []
    assert entry.record_faults("ga", 25, 24, cfg, 1.0, 1e-3, space)
    assert entry.record_faults("ga", 25, 25, dict(cfg, t_x=17), 1.0, 1e-3, space)
    assert entry.record_faults("ga", 25, 25, None, 1.0, 1e-3, space)
    assert entry.record_faults("ga", 25, 25, cfg, float("inf"), 1e-3, space)
    assert entry.record_faults("ga", 25, 25, cfg, 1.0, float("nan"), space)
    assert entry.record_faults("ga", 25, 25, cfg, 1.0, 0.0, space)
    from repro_torch.core.backends import BACKENDS

    sp = BACKENDS["cuda"].default_space(kernel="harris", x=8192, y=8192)
    assert entry.decode(sp, np.zeros(6, dtype=np.int64)) == {k: 1 for k in cfg}
    assert entry.decode(sp, np.full(6, -1)) is None
    assert entry.decode(sp, np.array([16, 0, 0, 0, 0, 0])) is None
