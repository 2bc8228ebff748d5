"""The ``serve`` entry on the CPU (the port's plain versions, 64x256,
``device="cpu"``, the port's clock ticking 1 ms a reading): a sound cold
fill through the winners service is ``correct``; a served config that is
not the plain answer, a skipped collect, a dropped done marker and a drain
that times out each fail their call, and none hangs.  Each fault is armed
after the set-up's warm-up fill, so it falls in the window."""

from __future__ import annotations

import dataclasses
import inspect
import math
import time

import pytest

from bench.harness import layout, runner
from bench.tests.test_bench_faults import BENCH_MS, ticking_clock  # noqa: F401

CELL = "harris.serve-cold-fill"
SEED = 2**31 + 29


def small_cell(budget: int = 20, **traffic):
    cell = layout.cell(CELL)
    return dataclasses.replace(
        cell, config=dict(cell.config, x=64, y=256),
        traffic=dict(cell.traffic, budget=budget, warmup_budget=budget, **traffic))


def cpu_run(cell):
    return runner.run_cell(cell, seed=SEED, seconds=0.05, trace=False,
                           t_start=time.perf_counter(), device="cpu",
                           timer=lambda fn: BENCH_MS)


def arm_after_setup(monkeypatch, arm):
    """Run the entry's set-up as it is, then ``arm()`` the fault."""
    entry = layout.entry("serve")
    setup = entry.setup

    def armed(ctx):
        out = setup(ctx)
        arm()
        return out

    monkeypatch.setattr(entry, "setup", armed)


def assert_failed(res, fault: str):
    assert res["correct"] is False and res["failed"] == res["attempted"] >= 1
    assert res["checks"]["record_faults"]["value"] == res["attempted"]
    assert any(fault in f for f in res["run"]["faults"]), res["run"]["faults"]


def test_the_traffic_is_the_services_own_miss_job():
    """The cell's design and algorithms are ``default_miss_spec``'s, and its
    budget is that job's search samples (800)."""
    from repro_torch.core import ExperimentDesign
    from repro_torch.serving.api import default_miss_spec

    traffic = layout.cell(CELL).traffic
    entry = layout.entry("serve")
    assert traffic["design"] == ExperimentDesign.smoke().to_dict()
    default = inspect.signature(default_miss_spec).parameters["algorithms"].default
    assert tuple(traffic["algorithms"]) == tuple(default)
    assert entry.design_budget(traffic["algorithms"], traffic["design"]) == traffic["budget"] == 800
    assert entry.design_of(traffic) == traffic["design"]
    assert entry.design_of(traffic, warmup=True) == traffic["warmup_design"]
    assert entry.design_of(dict(traffic, budget=20)) == dict(
        traffic["design"], sample_sizes=[10], n_experiments=[1])


def test_the_plain_answer_is_the_least_final_value_ties_on_key():
    class Store:
        def items(self):
            return iter([
                ("k/seed=1|t_x=2,t_y=1|final3", 2.0e-3),
                ("k/seed=2|t_x=4,t_y=1|final3", 1.0e-3),
                ("k/seed=1|t_x=3,t_y=1|final3", 1.0e-3),    # ties: the lesser key
                ("k/seed=1|t_x=5,t_y=1", 0.5e-3),           # a search sample
                ("k/seed=3|t_x=6,t_y=1|final3", math.inf),  # a penalty
                ("j/seed=1|t_x=7,t_y=1|final3", 0.1e-3),    # another job's key
                ("__unit__|k|rs/S10/E1/e0-1", 0.0),
            ])

    entry = layout.entry("serve")
    assert entry.plain_answer(Store(), "k") == ({"t_x": 3, "t_y": 1}, 1.0e-3)
    assert entry.plain_answer(Store(), "none") is None


def test_a_sound_fill_is_correct(ticking_clock):  # noqa: F811
    res = cpu_run(small_cell())
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] >= 1
    assert res["run"]["faults"] == []
    assert res["run"]["samples"] == 20 * res["attempted"]
    assert res["checks"]["timer_ratio"]["value"] == pytest.approx(BENCH_MS)
    assert {"inputs", "compile", "time"} <= set(res["run"]["stage_s"])
    assert res["run"]["search_s"] > 0


def test_a_served_config_that_is_not_the_plain_answer_is_not_correct(
        ticking_clock, monkeypatch):  # noqa: F811
    """The winners index answers with the second best final entry of the
    job (a config of its own) in place of the best."""
    from repro_torch.serving import api
    from repro_torch.serving.winners import lookup_winner

    def second_best(store, kernel, x, y, device):
        rec = lookup_winner(store, kernel, x, y, device)
        if rec is None:
            return None
        finals = sorted((v, k) for k, v in store.items()
                        if "|final" in k and math.isfinite(v))
        best = layout.entry("serve").plain_answer(store, rec.source)[0]
        for _, key in finals:
            cfg = {k: int(v) for k, v in (p.split("=") for p in key.split("|")[1].split(","))}
            if cfg != best:
                return dataclasses.replace(rec, config=cfg)
        raise AssertionError("the job measured one config only")

    arm_after_setup(monkeypatch, lambda: monkeypatch.setattr(api, "lookup_winner", second_best))
    assert_failed(cpu_run(small_cell()), "is not the plain answer")


def test_a_skipped_collect_is_not_correct(ticking_clock, monkeypatch):  # noqa: F811
    """The owner never collects: the second query still misses."""
    from repro_torch.serving import fleet

    arm_after_setup(monkeypatch, lambda: monkeypatch.setattr(
        fleet, "collect_jobs", lambda *args, **kwargs: []))
    res = cpu_run(small_cell())
    assert_failed(res, "second answer miss")
    assert res["checks"]["timer_ratio"]["value"] == math.inf


def test_a_dropped_done_marker_is_not_correct(ticking_clock, monkeypatch):  # noqa: F811
    """The worker never publishes its first unit's done marker: the job is
    never unit-complete, so the drain runs to its bound."""
    from repro_torch.serving.queue import JobQueue

    write = JobQueue.write_unit_done

    def drop_first(self, jid, unit_key, payload):
        if not unit_key.startswith("rs/"):
            write(self, jid, unit_key, payload)

    arm_after_setup(monkeypatch, lambda: monkeypatch.setattr(
        JobQueue, "write_unit_done", drop_first))
    assert_failed(cpu_run(small_cell(drain_timeout_s=2.0)), "the drain completed 0 job(s)")


def test_a_drain_that_times_out_fails_its_call_and_does_not_hang(monkeypatch):
    """A live peer holds the claim of one unit for good: the worker runs
    the others, waits for the peer until its bound, and the call fails.
    On the real clock, so the bound is seconds."""
    from repro_torch.serving.fleet import FleetWorker
    from repro_torch.serving.queue import JobQueue

    claim, drain = JobQueue.claim_unit, FleetWorker.drain
    drained = []

    def held_by_a_peer(self, jid, unit_key, ident):
        return None if unit_key.startswith("ga/") else claim(self, jid, unit_key, ident)

    def timed_drain(self, **kwargs):
        t0 = time.perf_counter()
        drained.append((drain(self, **kwargs), time.perf_counter() - t0))
        return drained[-1][0]

    def arm():
        monkeypatch.setattr(JobQueue, "claim_unit", held_by_a_peer)
        monkeypatch.setattr(FleetWorker, "drain", timed_drain)

    arm_after_setup(monkeypatch, arm)
    t0 = time.perf_counter()
    res = cpu_run(small_cell(drain_timeout_s=1.0))
    assert time.perf_counter() - t0 < 120
    assert_failed(res, "second answer miss")
    assert drained and all(n == 0 and 1.0 <= s < 30 for n, s in drained), drained
