"""Entry driver ``tune_matrix``: a researcher running the paper's comparison
of search techniques (section VI) at small budgets on one card, a closed
loop of cold experiment matrices through the port's matrix entry.

Each call is ``TuningSession(spec, telemetry=...).run_matrix(executor=...)``
with ``spec = TuningSpec(kernel, backend="cuda", algorithms, design,
seed=s_j, dataset_size, dataset_seed=s_j, dataset_gen_seed=s_j)`` at the
configuration's image size: no store, no dataset cache, no pipeline
workers and no compile cache, so every call measures its dataset anew, a
fresh run of the paper's protocol.  One client: call ``j`` starts when call
``j - 1`` has ended, takes ``s_j`` from ``(--seed, j)`` as the ``tune``
entry does, and no call starts once the window's seconds have passed.

A call yields one record per experiment, in the order of the session's
cells, so the harness launches and times every experiment's winner:
``winner`` is the experiment's ``best_indices`` row decoded in the
session's space, ``final_s`` its final value.  Across a call's records the
call's totals are each counted once:

* ``samples`` counts what the call measured on the card in its search: the
  dataset's ``dataset_size`` (on the call's first record), ``S`` for each
  experiment of a searcher (``ga``, ``bo_gp``, ``bo_tpe``, ...), the top
  predictions the forest measures (``min(10, max(1, S // 2))``) for each
  ``rf`` experiment, and nothing for ``rs``, which the dataset serves.  The
  final repeats are left out, as the ``tune`` entry leaves them out;
* ``wall_s`` (the record's ``provenance.wall_s``) and ``stage_s`` (the
  units' summed stage clocks) are the call's, on its first record, and
  0 and ``{}`` on the others;
* ``t0``/``t1``: the first record spans the call; the others are empty
  intervals at its end.  The harness's trace reader sums idle seconds over
  the records' intervals, so a span repeated on every record would count
  each second of a call once per experiment.

``record_faults`` names what a record gets wrong: its ``n_samples_used``
against ``S``, its winner against the configuration's space (a row that
does not decode stands as the default config, so the check still launches
a config), a search best or a final value that is not finite, or a final
value that is not positive; a matrix missing an ``(algo, S)`` row of the
traffic's design, holding one of the wrong ``E``, or without winners
faults every one of its records.

The traffic file gives ``algorithms``, ``sample_sizes``, ``n_experiments``,
``final_repeats``, ``dataset_size``, ``executor``, ``searcher`` and
``searcher_kwargs`` (the spec's named searcher, the one the kwargs go to),
``budget`` (a call's samples by the rule above), ``warmup_design`` and
``warmup_budget`` (the set-up's one matrix and its samples).
"""

from __future__ import annotations

import math
import time

from bench.harness import layout, program
from bench.harness.runner import DEFAULT_CONFIG

#: the seed of call ``j`` of a run seeded ``seed``: the ``tune`` entry's rule
call_seed = layout.entry("tune").call_seed


def search_samples(algo: str, s: int) -> int:
    """What one experiment of ``algo`` at sample size ``s`` measures on the
    card in its search, its dataset aside."""
    if algo == "rs":
        return 0
    if algo == "rf":
        return min(10, max(1, s // 2))
    return s


def design_of(traffic: dict, warmup: bool = False) -> dict:
    """``algorithms``, ``sample_sizes``, ``n_experiments`` and
    ``dataset_size`` of the window's calls, or of the set-up's one."""
    d = {k: traffic[k] for k in ("algorithms", "sample_sizes", "n_experiments", "dataset_size")}
    return {**d, **traffic["warmup_design"]} if warmup else d


def call_budget(design: dict) -> int:
    """A call's samples by the module's rule."""
    return design["dataset_size"] + sum(
        search_samples(a, s) * e for a in design["algorithms"]
        for s, e in zip(design["sample_sizes"], design["n_experiments"]))


def decode(space, row) -> dict | None:
    """The config of an index row of the session's space, or ``None`` where
    an index lies outside its parameter's values."""
    params = space.params
    if len(row) != len(params) or not all(0 <= int(i) < len(p.values)
                                          for p, i in zip(params, row)):
        return None
    return {k: int(v) for k, v in space.decode(row).items()}


def record_faults(algo: str, s: int, n_used: int, winner: dict | None,
                  search_best: float, final_s: float, space: dict) -> list[str]:
    """What one experiment's record gets wrong (the matrix-wide rules are
    :func:`matrix_faults`')."""
    faults = []
    if n_used != s:
        faults.append(f"{algo} S={s}: n_samples_used {n_used} != {s}")
    if winner is None or set(winner) != set(space) or not all(
            lo <= winner[k] <= hi for k, (lo, hi) in space.items()):
        faults.append(f"{algo} S={s}: winner {winner} outside the space")
    if not math.isfinite(search_best):
        faults.append(f"{algo} S={s}: search best {search_best}")
    if not (math.isfinite(final_s) and final_s > 0):
        faults.append(f"{algo} S={s}: final_value {final_s}")
    return faults


def matrix_faults(results, design: dict) -> list[str]:
    """What the matrix as a whole gets wrong: a row of the design missing,
    a row of the wrong ``E``, a row without winners."""
    faults = []
    for algo in design["algorithms"]:
        for s, e in zip(design["sample_sizes"], design["n_experiments"]):
            cell = results.cells.get((algo, s))
            if cell is None:
                faults.append(f"matrix row ({algo}, S={s}) missing")
            elif len(cell.final_values) != e:
                faults.append(f"matrix row ({algo}, S={s}) has {len(cell.final_values)} "
                              f"experiments, not {e}")
            elif cell.best_indices is None or len(cell.best_indices) != e:
                faults.append(f"matrix row ({algo}, S={s}) holds no winner for each experiment")
    return faults


def one_call(ctx, design: dict, seed: int, telemetry=None) -> list[dict]:
    """One cold matrix; its records."""
    TuningSpec, TuningSession = program.tuning()
    traffic, config = ctx.cell.traffic, ctx.cell.config
    spec = TuningSpec(
        kernel=config["kernel"],
        backend="cuda",
        backend_kwargs=ctx.backend_kwargs,
        searcher=traffic["searcher"],
        searcher_kwargs=dict(traffic.get("searcher_kwargs", {})),
        algorithms=tuple(design["algorithms"]),
        design={"sample_sizes": list(design["sample_sizes"]),
                "n_experiments": list(design["n_experiments"]),
                "final_repeats": traffic["final_repeats"]},
        seed=seed,
        dataset_size=design["dataset_size"],
        dataset_seed=seed,
        dataset_gen_seed=seed,
    )
    t0 = time.perf_counter()
    session = TuningSession(spec, telemetry=telemetry)
    results = session.run_matrix(executor=traffic["executor"])
    ctx.synchronize()
    t1 = time.perf_counter()
    stage_s: dict = {}
    for r in session.last_unit_results:
        for k, v in r.stage_s.items():
            stage_s[k] = stage_s.get(k, 0.0) + float(v)
    shared = matrix_faults(results, design)
    records = []
    for algo, s, _ in session.cells():
        cell = results.cells.get((algo, s))
        if cell is None:
            continue
        for e in range(len(cell.final_values)):
            has = cell.best_indices is not None and e < len(cell.best_indices)
            winner = decode(session.space, cell.best_indices[e]) if has else None
            final_s = float(cell.final_values[e])
            records.append({
                "t0": t1,
                "t1": t1,
                "seed": seed,
                "algo": algo,
                "sample_size": s,
                "experiment": e,
                "samples": search_samples(algo, s),
                "winner": winner if winner is not None else dict(DEFAULT_CONFIG),
                "final_s": final_s,
                "wall_s": 0.0,
                "stage_s": {},
                "faults": shared + record_faults(
                    algo, s, int(cell.n_samples_used[e]), winner,
                    float(cell.search_best_values[e]), final_s, config["space"]),
            })
    if records:
        records[0].update(t0=t0, samples=records[0]["samples"] + design["dataset_size"],
                          wall_s=float(session.last_record.provenance["wall_s"]),
                          stage_s=stage_s)
    return records


def setup(ctx) -> dict:
    """Refuse a program that keeps no winner per experiment (before any
    build, so such a run ends in seconds), build or load the kernels, and
    run one matrix of the warm-up design: every path the window's calls
    take (each searcher's imports and surrogate, the dataset, the batched
    forest, staging, the kernel's launches) runs once."""
    TuningSpec, TuningSession = program.tuning()
    traffic = ctx.cell.traffic
    probe = TuningSession(TuningSpec(kernel=ctx.cell.config["kernel"], backend="cuda",
                                     backend_kwargs=ctx.backend_kwargs))
    if not hasattr(probe, "last_unit_results"):
        raise RuntimeError("the program keeps no winner per matrix experiment "
                           "(TuningSession.last_unit_results, CellResult.best_indices)")
    for warmup in (False, True):
        got, want = call_budget(design_of(traffic, warmup)), traffic[
            "warmup_budget" if warmup else "budget"]
        if got != want:
            raise ValueError(f"the traffic's {'warm-up ' if warmup else ''}budget {want} "
                             f"is not its design's {got} samples")
    build_s = program.build_kernels() if ctx.device == "cuda" else 0.0
    warm = one_call(ctx, design_of(traffic, warmup=True), call_seed(ctx.seed, -1))
    faults = sorted({f for r in warm for f in r["faults"]})
    if faults or not warm:
        raise RuntimeError(f"the warm-up matrix failed its checks: {faults}")
    return {"build_s": build_s, "warmup_call_s": warm[0]["t1"] - warm[0]["t0"]}


def window(ctx, seconds: float, telemetry=None) -> tuple[float, list[dict]]:
    """The closed loop: ``(start, records)``; no call starts after
    ``start + seconds``."""
    design = design_of(ctx.cell.traffic)
    records = []
    start = time.perf_counter()
    j = 0
    while time.perf_counter() - start < seconds:
        records.extend(one_call(ctx, design, call_seed(ctx.seed, j), telemetry))
        j += 1
    return start, records
