"""Matplotlib reproductions of the paper's figures (headless Agg backend).

Three artifacts, all written as PNG by :func:`make_figures`:

* ``speedup_vs_sample_size.png`` — median speedup over RS vs sample size,
  one panel per (benchmark, chip) combo, bootstrap-CI bands (Fig. 4a),
* ``rank_heatmap.png`` — mean algorithm rank across combos per sample size,
* ``pct_of_optimum.png`` — aggregate fraction-of-optimum curve with CI
  bands (Fig. 3).

matplotlib is an optional dependency: importing this module without it
works (``HAVE_MATPLOTLIB`` is False) and ``make_figures`` returns ``[]`` so
the report generator degrades to tables-only.

Colors follow one fixed algorithm→hue assignment (a colorblind-validated
categorical palette; identity is never re-cycled per chart), and the rank
heatmap uses a single-hue light→dark sequential ramp — dark = rank 1.
"""

from __future__ import annotations

import os

import numpy as np

from .records import ALGOS
from .stats import fig3_aggregate, mean_ranks, speedup_with_ci

try:  # gate, don't require: report generation degrades to tables-only
    import matplotlib

    matplotlib.use("Agg")  # headless: must precede the pyplot import
    import matplotlib.pyplot as plt

    HAVE_MATPLOTLIB = True
except ImportError:  # pragma: no cover - exercised only without matplotlib
    HAVE_MATPLOTLIB = False

#: fixed algorithm -> color map (categorical slots of a CVD-validated
#: palette, assigned once in the paper's algorithm order — an algorithm
#: keeps its hue in every figure, whatever subset is plotted).
ALGO_COLORS = {
    "rs": "#2a78d6",      # blue
    "rf": "#eb6834",      # orange
    "ga": "#1baf7a",      # aqua
    "bo_gp": "#eda100",   # yellow
    "bo_tpe": "#e87ba4",  # magenta
}

#: light→dark steps of the blue ramp (sequential: magnitude only).
_BLUE_RAMP = ["#cde2fb", "#9ec5f4", "#6da7ec", "#3987e5", "#256abf", "#184f95"]

_INK = "#3d3d3a"          # neutral text/axis ink — series color never labels


def _style_axes(ax):
    ax.grid(True, axis="y", color="#e3e2d9", linewidth=0.6, zorder=0)
    for side in ("top", "right"):
        ax.spines[side].set_visible(False)
    for side in ("left", "bottom"):
        ax.spines[side].set_color("#c9c8bf")
    ax.tick_params(colors=_INK, labelsize=8)


def fig_speedup_vs_sample_size(
    results: dict, path: str, n_boot: int = 2000, seed: int = 0,
    table: dict | None = None,
) -> str | None:
    """Median speedup over RS vs sample size, one panel per combo, with
    percentile-bootstrap CI bands (the paper's Fig. 4a, budget-resolved).

    ``table`` accepts a precomputed :func:`speedup_with_ci` result (the
    report generator passes its own so the bootstrap runs once).  Returns
    ``None`` without writing when there is nothing to compare (results
    holding only the RS baseline)."""
    if table is None:
        table = speedup_with_ci(results, n_boot=n_boot, seed=seed)
    if not any(table.values()):
        return None
    keys = sorted(table)
    ncols = min(3, len(keys))
    nrows = int(np.ceil(len(keys) / ncols))
    fig, axes = plt.subplots(
        nrows, ncols, figsize=(3.6 * ncols, 2.8 * nrows),
        squeeze=False, sharey=True,
    )
    for ax in axes.flat[len(keys):]:
        ax.set_visible(False)
    for ax, key in zip(axes.flat, keys, strict=False):
        bench, chip = key
        for algo in ALGOS:
            if algo not in table[key]:
                continue
            rows = table[key][algo]
            sizes = sorted(rows)
            mid = [rows[s][0] for s in sizes]
            lo = [rows[s][1] for s in sizes]
            hi = [rows[s][2] for s in sizes]
            color = ALGO_COLORS.get(algo, _INK)
            ax.plot(sizes, mid, color=color, linewidth=2, marker="o",
                    markersize=4, label=algo, zorder=3)
            ax.fill_between(sizes, lo, hi, color=color, alpha=0.15,
                            linewidth=0, zorder=2)
        ax.axhline(1.0, color="#8a8a85", linewidth=1, linestyle="--", zorder=1)
        ax.set_xscale("log", base=2)
        sizes_all = sorted({s for a in table[key].values() for s in a})
        ax.set_xticks(sizes_all)
        ax.set_xticklabels([str(s) for s in sizes_all])
        ax.set_title(f"{bench} × {chip}", fontsize=9, color=_INK)
        _style_axes(ax)
    for ax in axes[-1]:
        ax.set_xlabel("sample size (budget)", fontsize=8, color=_INK)
    for row in axes:
        row[0].set_ylabel("speedup over RS", fontsize=8, color=_INK)
    by_label = {}
    for ax in axes.flat:
        handles, labels = ax.get_legend_handles_labels()
        by_label.update(zip(labels, handles, strict=True))
    if by_label:
        fig.legend(by_label.values(), by_label.keys(), loc="upper center",
                   ncol=len(by_label), frameon=False, fontsize=8,
                   bbox_to_anchor=(0.5, 1.02))
    fig.suptitle("Median speedup over Random Search (95% bootstrap CI)",
                 fontsize=10, color=_INK, y=1.07)
    fig.tight_layout()
    fig.savefig(path, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return path


def fig_rank_heatmap(results: dict, path: str) -> str:
    """Mean algorithm rank (1 = best median runtime) across combos, per
    sample size — dark = better, annotated with the mean rank."""
    ranks = mean_ranks(results)
    algos = [a for a in ALGOS if a in ranks]
    sizes = sorted({s for rows in ranks.values() for s in rows})
    grid = np.array(
        [[ranks[a].get(s, np.nan) for s in sizes] for a in algos]
    )
    n_algos = max(2, len(algos))
    cmap = matplotlib.colors.LinearSegmentedColormap.from_list(
        "blues", list(reversed(_BLUE_RAMP))  # dark (rank 1) → light (worst)
    )
    fig, ax = plt.subplots(
        figsize=(1.1 * len(sizes) + 2.4, 0.55 * len(algos) + 1.4)
    )
    im = ax.imshow(grid, cmap=cmap, vmin=1, vmax=n_algos, aspect="auto")
    ax.set_xticks(range(len(sizes)), [f"S={s}" for s in sizes], fontsize=8)
    ax.set_yticks(range(len(algos)), algos, fontsize=8)
    ax.tick_params(colors=_INK, length=0)
    for spine in ax.spines.values():
        spine.set_visible(False)
    mid = 1 + (n_algos - 1) / 2
    for i in range(len(algos)):
        for j in range(len(sizes)):
            v = grid[i, j]
            if np.isnan(v):
                continue
            ax.text(j, i, f"{v:.1f}", ha="center", va="center", fontsize=8,
                    color="#ffffff" if v < mid else _INK)
    cbar = fig.colorbar(im, ax=ax, shrink=0.85)
    cbar.set_label("mean rank (1 = best)", fontsize=8, color=_INK)
    cbar.ax.tick_params(colors=_INK, labelsize=7)
    ax.set_title("Mean algorithm rank across benchmark × chip combos",
                 fontsize=10, color=_INK)
    fig.tight_layout()
    fig.savefig(path, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return path


def fig_pct_optimum(results: dict, path: str) -> str:
    """Aggregate mean fraction-of-optimum vs sample size with bootstrap CI
    bands (the paper's Fig. 3)."""
    agg = fig3_aggregate(results)
    fig, ax = plt.subplots(figsize=(5.2, 3.4))
    for algo in ALGOS:
        rows = agg.get(algo)
        if not rows:
            continue
        sizes = sorted(rows)
        mid = [rows[s][0] for s in sizes]
        lo = [rows[s][1] for s in sizes]
        hi = [rows[s][2] for s in sizes]
        color = ALGO_COLORS.get(algo, _INK)
        ax.plot(sizes, mid, color=color, linewidth=2, marker="o",
                markersize=4, label=algo, zorder=3)
        ax.fill_between(sizes, lo, hi, color=color, alpha=0.15,
                        linewidth=0, zorder=2)
    ax.set_xscale("log", base=2)
    sizes_all = sorted({s for rows in agg.values() for s in rows})
    ax.set_xticks(sizes_all)
    ax.set_xticklabels([str(s) for s in sizes_all])
    ax.set_xlabel("sample size (budget)", fontsize=8, color=_INK)
    ax.set_ylabel("% of optimum (mean across combos)", fontsize=8, color=_INK)
    ax.legend(frameon=False, fontsize=8, loc="lower right")
    ax.set_title("Tuned-runtime quality vs sample size (95% bootstrap CI)",
                 fontsize=10, color=_INK)
    _style_axes(ax)
    fig.tight_layout()
    fig.savefig(path, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return path


def make_figures(results: dict, fig_dir: str, n_boot: int = 2000,
                 seed: int = 0, speedup_table: dict | None = None) -> list[str]:
    """Render every figure into ``fig_dir``; returns the written paths
    (empty — with no error — when matplotlib is unavailable or there is
    nothing to plot; figures without data, e.g. the speedup panel on
    RS-only results, are skipped individually)."""
    if not HAVE_MATPLOTLIB or not results:
        return []
    os.makedirs(fig_dir, exist_ok=True)
    paths = [
        fig_speedup_vs_sample_size(
            results, os.path.join(fig_dir, "speedup_vs_sample_size.png"),
            n_boot=n_boot, seed=seed, table=speedup_table,
        ),
        fig_rank_heatmap(results, os.path.join(fig_dir, "rank_heatmap.png")),
        fig_pct_optimum(results, os.path.join(fig_dir, "pct_of_optimum.png")),
    ]
    return [p for p in paths if p is not None]
