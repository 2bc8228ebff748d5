"""Comparison statistics over loaded matrix results.

One function per paper artifact (all consume the ``{(bench, chip):
(MatrixResults, meta)}`` dict from :func:`repro_torch.analysis.load_all`):

* :func:`fig2_pct_optimum` — fraction-of-optimum per (algo x S) per combo
  (the true costmodel optimum when the record carries one, else relative to
  the best observed final — ``meta["optimum_is_true"]`` says which),
* :func:`fig3_aggregate` — aggregate mean + bootstrap CI across combos,
* :func:`fig4a_speedup` / :func:`speedup_with_ci` — median speedup over
  Random Search, point estimate and seeded-bootstrap CI over the repeats,
* :func:`fig4b_cles` — CLES (probability of beating RS),
* :func:`mwu_vs_rs` — the MWU significance companion (alpha = 0.01),
* :func:`rank_table` / :func:`mean_ranks` / :func:`winners_by_size` — the
  per-benchmark/per-architecture winner rankings the claims layer consumes,
* :func:`search_cost` — per-cell wall-clock from
  ``RunRecord.extra["cell_wall_s"]``, split into compile vs. measure
  seconds where the backend's staged pipeline recorded them.

The scalar machinery (MWU, CLES, percentile bootstrap) lives in
:mod:`repro_torch.core.stats`; this module applies it across a results directory.
Budget-resolved curves build on the single budget-clipping convention
defined by :meth:`TuningResult.trajectory` (see :func:`best_at_budget`).
"""

from __future__ import annotations

import numpy as np

from ..core import stats as core_stats
from ..core.runner import stable_seed
from ..core.searchers.base import TuningResult
from .records import ALGOS


def best_at_budget(result: TuningResult, budget: int) -> float:
    """Best value a search had found after ``budget`` samples.

    Defers to ``TuningResult.trajectory(budget)`` — the ONE place the
    early-termination convention is defined (searches that ended early hold
    their final best; histories never exceed the budget).
    """
    return float(result.trajectory(budget)[budget - 1])


def budget_curve(result: TuningResult, budgets) -> np.ndarray:
    """Best-so-far at each requested budget (Schoonhoven-style
    budget-resolved performance curve for a single search)."""
    budgets = np.asarray(budgets, dtype=np.int64)
    full = result.trajectory(int(budgets.max()))
    return full[budgets - 1]


# ------------------------------------------------------------- paper tables
def _cell_sizes(res, algo: str) -> list[int]:
    """Sample sizes where this algorithm actually has a cell (matrices may
    be ragged — a combo can lack some (algo, S) cells; tables include only
    what exists instead of raising)."""
    return [s for s in res.sample_sizes() if (algo, s) in res.cells]


def fig2_pct_optimum(results: dict) -> dict:
    """{(bench, chip): {algo: {S: median pct-of-optimum}}}."""
    table = {}
    for key, (res, meta) in results.items():
        opt = meta["optimum"]
        table[key] = {
            algo: {
                s: float(
                    np.median(core_stats.pct_of_optimum(res.finals(algo, s), opt))
                )
                for s in _cell_sizes(res, algo)
            }
            for algo in ALGOS
            if _cell_sizes(res, algo)
        }
    return table


def fig3_aggregate(results: dict) -> dict:
    """{algo: {S: (mean, lo, hi)}} across all combos (bootstrap CI)."""
    f2 = fig2_pct_optimum(results)
    sample_sizes = sorted({s for t in f2.values() for a in t.values() for s in a})
    out = {}
    for algo in ALGOS:
        out[algo] = {}
        for s in sample_sizes:
            vals = np.array(
                [t[algo][s] for t in f2.values() if algo in t and s in t[algo]]
            )
            if len(vals):
                out[algo][s] = core_stats.bootstrap_ci(vals)
    return out


def fig4a_speedup(results: dict) -> dict:
    """{(bench, chip): {algo: {S: median speedup over RS}}}."""
    table = {}
    for key, (res, _) in results.items():
        table[key] = {}
        for algo in ALGOS:
            sizes = _vs_rs_sizes(res, algo)
            if not sizes:
                continue
            table[key][algo] = {
                s: core_stats.median_speedup(
                    res.finals("rs", s), res.finals(algo, s)
                )
                for s in sizes
            }
    return table


def _vs_rs_sizes(res, algo: str) -> list[int]:
    """Sizes where both the algorithm and the RS baseline have cells."""
    if algo == "rs":
        return []
    return [s for s in _cell_sizes(res, algo) if ("rs", s) in res.cells]


def speedup_with_ci(
    results: dict, n_boot: int = 2000, ci: float = 0.95, seed: int = 0
) -> dict:
    """{(bench, chip): {algo: {S: (speedup, lo, hi)}}} over Random Search.

    The point estimate is the paper's ``median(RS) / median(algo)``; the CI
    is a percentile bootstrap over the experiment repeats — both populations
    resampled independently per draw.  Each cell's draws come from a
    dedicated rng seeded by ``stable_seed(seed, bench, chip, algo, S)``, so
    the table is bit-stable regardless of dict iteration order, combo
    subsetting, or which executor produced the results.
    """
    lo_q, hi_q = (1 - ci) / 2 * 100, (1 + ci) / 2 * 100
    table = {}
    for (bench, chip), (res, _) in results.items():
        table[(bench, chip)] = {}
        for algo in ALGOS:
            sizes = _vs_rs_sizes(res, algo)
            if not sizes:
                continue
            row = {}
            for s in sizes:
                rs_v = np.asarray(res.finals("rs", s), dtype=np.float64)
                a_v = np.asarray(res.finals(algo, s), dtype=np.float64)
                rng = np.random.default_rng(
                    stable_seed(seed, bench, chip, algo, s)
                )
                rs_b = rs_v[rng.integers(0, len(rs_v), size=(n_boot, len(rs_v)))]
                a_b = a_v[rng.integers(0, len(a_v), size=(n_boot, len(a_v)))]
                boots = np.median(rs_b, axis=1) / np.median(a_b, axis=1)
                lo, hi = np.percentile(boots, [lo_q, hi_q])
                row[s] = (
                    core_stats.median_speedup(rs_v, a_v),
                    float(lo),
                    float(hi),
                )
            table[(bench, chip)][algo] = row
    return table


def fig4b_cles(results: dict) -> dict:
    """{(bench, chip): {algo: {S: P(algo beats RS)}}}."""
    table = {}
    for key, (res, _) in results.items():
        table[key] = {}
        for algo in ALGOS:
            sizes = _vs_rs_sizes(res, algo)
            if not sizes:
                continue
            table[key][algo] = {
                s: core_stats.cles_lower_better(
                    res.finals(algo, s), res.finals("rs", s)
                )
                for s in sizes
            }
    return table


def mwu_vs_rs(results: dict) -> dict:
    """{(bench, chip): {algo: {S: p-value}}} (alpha = 0.01 in the paper)."""
    table = {}
    for key, (res, _) in results.items():
        table[key] = {}
        for algo in ALGOS:
            sizes = _vs_rs_sizes(res, algo)
            if not sizes:
                continue
            table[key][algo] = {
                s: core_stats.mann_whitney_u(
                    res.finals(algo, s), res.finals("rs", s)
                ).p_value
                for s in sizes
            }
    return table


# --------------------------------------------------------- rankings/winners
def rank_table(results: dict) -> dict:
    """{(bench, chip): {algo: {S: rank}}} — 1 = best median final runtime.

    Ranks are computed among the algorithms present at each sample size
    (ragged matrices rank whatever exists there).
    """
    table = {}
    for key, (res, _) in results.items():
        t: dict = {}
        for s in res.sample_sizes():
            algos = [a for a in ALGOS if (a, s) in res.cells]
            medians = {a: float(np.median(res.finals(a, s))) for a in algos}
            # canonical-order tiebreak keeps ranks deterministic
            by_median = sorted(algos, key=lambda a: (medians[a], ALGOS.index(a)))
            for rank, a in enumerate(by_median, start=1):
                t.setdefault(a, {})[s] = rank
        table[key] = t
    return table


def mean_ranks(results: dict) -> dict:
    """{algo: {S: mean rank across combos}} — the rank-heatmap payload."""
    ranks = rank_table(results)
    out: dict = {}
    for t in ranks.values():
        for algo, row in t.items():
            for s, r in row.items():
                out.setdefault(algo, {}).setdefault(s, []).append(r)
    return {
        algo: {s: float(np.mean(v)) for s, v in sorted(rows.items())}
        for algo, rows in out.items()
    }


def winners_by_size(results: dict) -> dict:
    """{S: {algo: number of combos it wins at S}} (win = rank 1)."""
    ranks = rank_table(results)
    out: dict = {}
    for t in ranks.values():
        for algo, row in t.items():
            for s, r in row.items():
                out.setdefault(s, {}).setdefault(algo, 0)
                if r == 1:
                    out[s][algo] += 1
    return {s: dict(sorted(w.items())) for s, w in sorted(out.items())}


# ------------------------------------------------------------- search cost
def search_cost(results: dict) -> dict:
    """{(bench, chip): {algo: {S: {"wall", "compile", "measure"}}}} —
    per-cell search cost with the staged pipeline's breakdown.

    The work-unit layer records wall-clock per executed unit and the session
    aggregates it per cell into ``RunRecord.extra["cell_wall_s"]`` (sums of
    unit walls, so the number is total compute even for parallel runs).
    Staged backends (cuda) additionally charge each pipeline stage to a
    clock, so ``compile`` (validity screen + the first launch per geometry,
    which on the card holds the input materialisation) and ``measure``
    (fenced timing) split the wall per cell; unstaged backends report 0 for
    both.  Read alongside the quality tables: the paper's 'which algorithm
    at which sample size' question is really quality *per unit of search
    cost* — and a cell whose wall is mostly ``compile`` is bounded by its
    set-up, not the tuner.  Combos recorded before the wall-clock landed
    are skipped; records from before the breakdown carry 0 for both splits.
    """
    table = {}
    for key, (_, meta) in results.items():
        rows = meta.get("cell_wall_s")
        if not rows:
            continue
        t: dict = {}
        for r in rows:
            t.setdefault(r["algo"], {})[r["sample_size"]] = {
                "wall": float(r["wall_s"]),
                "compile": float(r.get("compile_s", 0.0)),
                "measure": float(r.get("measure_s", 0.0)),
            }
        table[key] = t
    return table
