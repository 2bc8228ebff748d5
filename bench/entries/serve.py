"""The ``serve`` entry: a team serving tuned geometries to its jobs through
the port's winners service, when a new card type joins the fleet: the index
holds no winner for the card, so every first query misses and the service
tunes the key on the card.  A closed loop of cold fills, one a call.

Each call runs, in a fresh temporary directory under ``$TMPDIR`` holding one
sqlite store and one queue directory (removed once the call's checks have
run), the public serving calls that ``python -m repro_torch.serving query / worker /
collect`` make, in this process:

1. ``best_config(store, kernel, x, y, label, queue=..., enqueue_spec=...)``
   with the service's own miss job, ``default_miss_spec(kernel, x, y,
   label, algorithms, design, seed=s_j)``: a ``"miss"`` that enqueues it;
2. ``FleetWorker(...).drain(timeout_s=...)``: one worker claims the job's
   units and runs them through ``run_unit`` on the card, journalling each
   into its shard store; the bound makes a stuck job a failed call, never
   a hang;
3. ``collect_jobs(...)``: the shards absorbed, the winner indexed, the job
   marked done;
4. ``best_config(...)`` again: a ``"hit"``.

``label`` is the card's ``device_label`` (``"cpu"`` where the run is on
the CPU).  A call's time runs from the job's spec built to the owner's
store handle closed, so the store's and queue's set-up count in the call
and not between calls.  One client: call ``j`` starts
when call ``j - 1`` has ended, takes ``s_j`` from ``(--seed, j)`` as the
``tune`` entry does, and no call starts once the window's seconds have
passed.

A call yields one record: ``winner`` and ``final_s`` are the served config
and value, the answer the service's users get; ``samples`` the job's
search samples (``S`` for each experiment of each algorithm; ``rs``
measures its own, as the job has no dataset; the final repeats are left
out, as the other entries leave them out); ``stage_s`` and ``wall_s`` sum
the job's journalled units' ``stage_s`` and ``wall_s``, so
``search_ms_per_sample`` keeps its layer and the service's own work shows
in the trace's ``fleet``, ``serve`` and ``session`` stages (the last the
worker's record of each unit in its shard session).

The record's ``faults``, checked on the store and queue a fill left once
the window's loop has ended, so no check counts against the window's
calls: a first answer that is not a ``"miss"`` with a
job, a drain that completed no job, a collect that did not collect it, a
second answer that is not a ``"hit"``, a job not ``"done"`` or a claim or
done file left behind, an experiment that breaks ``tune_matrix``'s
``record_faults`` / ``matrix_faults`` rules, and a served config or value
that is not the **plain answer**: the least ``|final`` value over the
parent store's items under the job's cache key, found by a scan in Python
(ties on key), independent of the store's ``best_item`` and of the
winners index.  A call with no hit holds the default config and a
``final_s`` of NaN, so the harness still launches a config, and fails it.

The traffic file gives ``algorithms``, ``design`` (``sample_sizes``,
``n_experiments``, ``final_repeats``), ``budget`` (a fill's samples by the
rule above), ``warmup_design`` and ``warmup_budget`` (the set-up's one
fill), and ``drain_timeout_s``.  Where a budget is not its design's, the
fill runs one experiment an algorithm at ``S = budget // len(algorithms)``.
``searcher`` and ``final_repeats`` are what a single tune call on this
configuration runs (the timer control of ``test_bench_controls.py``).
"""

from __future__ import annotations

import math
import os
import shutil
import tempfile
import time
import types

from bench.harness import layout, program
from bench.harness.runner import DEFAULT_CONFIG

_matrix = layout.entry("tune_matrix")
#: the seed of call ``j`` of a run seeded ``seed``: the ``tune`` entry's rule
call_seed = _matrix.call_seed


def design_budget(algorithms, design: dict) -> int:
    """A fill's search samples: ``S`` for each experiment of each algorithm."""
    return len(algorithms) * sum(
        s * e for s, e in zip(design["sample_sizes"], design["n_experiments"]))


def design_of(traffic: dict, warmup: bool = False) -> dict:
    """The design of the window's fills, or of the set-up's one; one
    experiment an algorithm at ``budget // len(algorithms)`` samples where
    the traffic's budget is not its design's."""
    design = dict(traffic["warmup_design" if warmup else "design"])
    budget = traffic["warmup_budget" if warmup else "budget"]
    algorithms = traffic["algorithms"]
    if design_budget(algorithms, design) != budget:
        design.update(sample_sizes=[budget // len(algorithms)], n_experiments=[1])
    return design


def plain_answer(store, cache_key: str) -> tuple[dict, float] | None:
    """The least finite ``|final`` value under ``{cache_key}/`` (ties on
    key) and its config, from a scan of every item in Python.  A key reads
    ``{cache_key}/seed={s}|k=v,k2=v2,...|final{repeats}``."""
    best = None
    for key, value in store.items():
        if (key.startswith(f"{cache_key}/") and "|final" in key and math.isfinite(value)
                and (best is None or (value, key) < (best[1], best[0]))):
            best = (key, float(value))
    if best is None:
        return None
    pairs = best[0][len(cache_key):].split("|")[1].split(",")
    return {k: int(v) for k, v in (p.split("=", 1) for p in pairs)}, best[1]


def job_faults(job: dict, design: dict, space: dict) -> tuple[list[str], list, str]:
    """``(faults, units, cache_key)``: what the job's journalled experiments
    get wrong by ``tune_matrix``'s rules, its unit results as the parent
    store's journal holds them, and the job's cache key."""
    from repro_torch import TuningSession, TuningSpec
    from repro_torch.core.workunits import merge_unit_results
    from repro_torch.serving.fleet import job_units

    session = TuningSession(TuningSpec.from_dict(job["spec"]))
    try:
        done, pending = session.unit_journal().partition(job_units(session, job))
        if pending:
            return [f"{len(pending)} unit(s) not journalled"], done, session.cache_key
        cells, _ = merge_unit_results(session.cells(), done)
        results = types.SimpleNamespace(cells={(c.algo, c.sample_size): c for c in cells})
        faults = _matrix.matrix_faults(
            results, {"algorithms": job["spec"]["algorithms"], **design})
        for c in cells:
            for e in range(len(c.final_values)):
                row = c.best_indices[e] if c.best_indices is not None else None
                winner = _matrix.decode(session.space, row) if row is not None else None
                faults += _matrix.record_faults(
                    c.algo, c.sample_size, int(c.n_samples_used[e]), winner,
                    float(c.search_best_values[e]), float(c.final_values[e]), space)
        return faults, done, session.cache_key
    finally:
        if session.store is not None:
            session.store.close()


def fill(ctx, design: dict, seed: int, telemetry=None) -> dict:
    """One cold fill, unchecked: what the call's checks need (its temporary
    directory stays until :func:`check` removes it)."""
    t0 = time.perf_counter()
    from repro_torch.core import ExperimentDesign
    from repro_torch.serving import api, fleet, queue as queue_mod, winners

    traffic, config = ctx.cell.traffic, ctx.cell.config
    kernel, x, y = config["kernel"], int(config["x"]), int(config["y"])
    label = winners.device_label(ctx.device)
    spec = api.default_miss_spec(
        kernel, x, y, label, algorithms=tuple(traffic["algorithms"]),
        design=ExperimentDesign(sample_sizes=tuple(design["sample_sizes"]),
                                n_experiments=tuple(design["n_experiments"]),
                                final_repeats=int(design["final_repeats"])),
        seed=seed)
    tmp = tempfile.mkdtemp(prefix="bench-serve-")
    path, qdir = os.path.join(tmp, "store.sqlite"), os.path.join(tmp, "queue")
    try:
        store, kind = api.open_serve_store(path)
        try:
            queue = queue_mod.JobQueue(store, kind, path, qdir, telemetry=telemetry)
            worker = fleet.FleetWorker(kind, path, qdir, ident="bench", telemetry=telemetry)
            miss = api.best_config(store, kernel, x, y, label, queue=queue,
                                   enqueue_spec=spec, telemetry=telemetry)
            completed = worker.drain(timeout_s=float(traffic["drain_timeout_s"]))
            collected = fleet.collect_jobs(kind, path, qdir, telemetry=telemetry)
            hit = api.best_config(store, kernel, x, y, label, telemetry=telemetry)
            ctx.synchronize()
        finally:
            store.close()
        t1 = time.perf_counter()
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return {"t0": t0, "t1": t1, "seed": seed, "miss": miss, "completed": completed,
            "collected": collected, "hit": hit, "tmp": tmp, "path": path, "qdir": qdir}


def check(ctx, design: dict, done: dict) -> dict:
    """A fill's record, its checks made on the store and queue it left;
    its temporary directory removed."""
    from repro_torch.serving import api, queue as queue_mod

    miss, hit = done["miss"], done["hit"]
    served = (({k: int(v) for k, v in hit.config.items()}, float(hit.value))
              if hit.status == "hit" else None)
    faults = []
    if miss.status != "miss" or miss.job_id is None:
        faults.append(f"first answer {miss.status} (job {miss.job_id}), not a miss")
    if done["completed"] != 1:
        faults.append(f"the drain completed {done['completed']} job(s), not 1")
    if done["collected"] != [miss.job_id]:
        faults.append(f"collect returned {done['collected']}, not [{miss.job_id}]")
    if hit.status != "hit":
        faults.append(f"second answer {hit.status}, not a hit")
    units = []
    try:
        store, kind = api.open_serve_store(done["path"])
        try:
            queue = queue_mod.JobQueue(store, kind, done["path"], done["qdir"])
            job = queue.job(miss.job_id) if miss.job_id else None
            if job is None or job.get("state") != "done":
                faults.append(f"job state {None if job is None else job.get('state')}, not done")
            left = sorted(f for f in os.listdir(done["qdir"])
                          if f.startswith(f"{miss.job_id}.u"))
            if left:
                faults.append(f"{len(left)} claim or done file(s) left: {left[:2]}")
            if job is not None:
                job_f, units, cache_key = job_faults(job, design, ctx.cell.config["space"])
                faults += job_f
                plain = plain_answer(store, cache_key)
                if served != plain:
                    faults.append(f"served {served} is not the plain answer {plain}")
        finally:
            store.close()
    finally:
        shutil.rmtree(done["tmp"], ignore_errors=True)

    stage_s: dict = {}
    for r in units:
        for k, v in r.stage_s.items():
            stage_s[k] = stage_s.get(k, 0.0) + float(v)
    return {
        "t0": done["t0"],
        "t1": done["t1"],
        "seed": done["seed"],
        "job": miss.job_id,
        "samples": design_budget(ctx.cell.traffic["algorithms"], design),
        "winner": served[0] if served else dict(DEFAULT_CONFIG),
        "final_s": served[1] if served else math.nan,
        "wall_s": float(sum(r.wall_s for r in units)),
        "stage_s": stage_s,
        "faults": faults,
    }


def setup(ctx) -> dict:
    """Build or load the kernels and make one fill of the warm-up design:
    every path the window's fills take (the queue, the worker's sessions
    and shard store, both searchers, staging, the kernel's launches,
    collect and the index) and the checks run once."""
    build_s = program.build_kernels() if ctx.device == "cuda" else 0.0
    design = design_of(ctx.cell.traffic, warmup=True)
    warm = check(ctx, design, fill(ctx, design, call_seed(ctx.seed, -1)))
    if warm["faults"]:
        raise RuntimeError(f"the warm-up fill failed its checks: {warm['faults']}")
    return {"build_s": build_s, "warmup_call_s": warm["t1"] - warm["t0"]}


def window(ctx, seconds: float, telemetry=None) -> tuple[float, list[dict]]:
    """The closed loop: ``(start, records)``; no call starts after
    ``start + seconds``.  The fills' checks run once the loop has ended."""
    design = design_of(ctx.cell.traffic)
    filled = []
    try:
        start = time.perf_counter()
        while time.perf_counter() - start < seconds:
            filled.append(fill(ctx, design, call_seed(ctx.seed, len(filled)), telemetry))
        return start, [check(ctx, design, done) for done in filled]
    finally:
        for done in filled:
            shutil.rmtree(done["tmp"], ignore_errors=True)
