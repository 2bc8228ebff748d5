"""One-command report generation: a results directory in, ``REPORT.md`` out.

``python -m repro_torch.analysis.report results/matrix`` (or ``python -m
repro_torch.analysis``, or :func:`generate_report` from code) renders
everything the paper's analysis needs from the on-disk ``RunRecord`` +
``.npz`` artifacts alone:

* provenance (spec fingerprints, backend, the code's version and commit,
  record versions, wall-clock),
* the figures (``figures/*.png``, skipped gracefully without matplotlib),
* fraction-of-optimum, speedup-over-RS (with bootstrap CIs), CLES, MWU,
  rank/winner and search-cost tables,
* the claim verdicts (pass / fail / insufficient-data).

From "Quality vs sample size" on, the report is the reference's
(``repro.analysis.report``) text for the same records, the Telemetry
section included: the counter totals a record carries and, when the
directory holds a run's trace (``tune_matrix(telemetry_dir=...)``), the
per-stage duration table read from it.  The markdown table renderers
(:func:`render_grid` & friends) are public.
"""

from __future__ import annotations

import argparse
import json
import os

from ..core.runner import stable_seed
from .claims import INSUFFICIENT, check_claims
from .figures import HAVE_MATPLOTLIB, make_figures
from .records import load_all
from .stats import (
    fig2_pct_optimum,
    fig3_aggregate,
    fig4b_cles,
    mean_ranks,
    mwu_vs_rs,
    search_cost,
    speedup_with_ci,
    winners_by_size,
)

# ------------------------------------------------------------ table renderers


def render_fig2(table: dict) -> str:
    return render_grid(table, fmt="{:.1f}%", title="pct-of-optimum")


def render_grid(table: dict, fmt: str = "{:.3f}", title: str = "") -> str:
    """One markdown table per combo.  Combos with nothing to show (e.g. a
    speedup table for RS-only results) are skipped; ragged rows render
    ``-`` where an (algo, S) cell is absent."""
    lines = []
    for (bench, chip), algos in sorted(table.items()):
        if not algos:
            continue
        sizes = sorted({s for row in algos.values() for s in row})
        lines.append(f"\n### {title} — {bench} x {chip}")
        lines.append("| algo | " + " | ".join(f"S={s}" for s in sizes) + " |")
        lines.append("|---|" + "---|" * len(sizes))
        for algo, row in algos.items():
            cells = [fmt.format(row[s]) if s in row else "-" for s in sizes]
            lines.append(f"| {algo} | " + " | ".join(cells) + " |")
    return "\n".join(lines) if lines else "(no data)"


def render_fig3(agg: dict) -> str:
    sizes = sorted({s for rows in agg.values() for s in rows})
    lines = ["| algo | " + " | ".join(f"S={s}" for s in sizes) + " |",
             "|---|" + "---|" * len(sizes)]
    for algo, rows in agg.items():
        cells = []
        for s in sizes:
            if s in rows:
                m, lo, hi = rows[s]
                cells.append(f"{m:.1f}% [{lo:.1f}, {hi:.1f}]")
            else:
                cells.append("-")
        lines.append(f"| {algo} | " + " | ".join(cells) + " |")
    return "\n".join(lines)


def _render_speedup_ci(table: dict) -> str:
    return render_grid(
        table,
        fmt="{0[0]:.3f}x [{0[1]:.2f}, {0[2]:.2f}]",
        title="median speedup over RS (95% bootstrap CI)",
    )


def _render_ranks(results: dict) -> str:
    ranks = mean_ranks(results)
    if not ranks:
        return "(no data)"
    sizes = sorted({s for rows in ranks.values() for s in rows})
    winners = winners_by_size(results)
    lines = ["| algo | " + " | ".join(f"S={s}" for s in sizes) + " |",
             "|---|" + "---|" * len(sizes)]
    for algo, rows in ranks.items():
        cells = []
        for s in sizes:
            wins = winners.get(s, {}).get(algo, 0)
            cells.append(f"{rows[s]:.1f}" + (f" ({wins}W)" if wins else ""))
        lines.append(f"| {algo} | " + " | ".join(cells) + " |")
    lines.append("\nmean rank across combos, 1 = best; `(nW)` = combos won.")
    return "\n".join(lines)


def _telemetry_section(results: dict, results_dir: str) -> str:
    """Counter totals from each combo's RunRecord plus per-stage duration
    percentiles from the run's merged trace (when one exists).  Empty when
    every combo ran with telemetry disabled and no trace file is present."""
    lines: list[str] = []
    combo_counters = {
        key: meta["telemetry"].get("counters", {})
        for key, (_, meta) in sorted(results.items())
        if isinstance(meta.get("telemetry"), dict)
        and meta["telemetry"].get("counters")
    }
    if combo_counters:
        names = sorted({n for c in combo_counters.values() for n in c})
        lines += ["### Counter totals", "",
                  "| combo | " + " | ".join(names) + " |",
                  "|---|" + "---|" * len(names)]
        for (bench, chip), c in combo_counters.items():
            cells = [str(c.get(n, 0)) for n in names]
            lines.append(f"| {bench} x {chip} | " + " | ".join(cells) + " |")
    from ..telemetry import TRACE_FILE, read_run, stage_percentiles

    if os.path.exists(os.path.join(results_dir, TRACE_FILE)):
        stages = stage_percentiles(read_run(results_dir))
        if stages:
            if lines:
                lines.append("")
            lines += [
                "### Pipeline stage durations",
                "",
                "| stage | n | total (s) | p50 (ms) | p90 (ms) | p99 (ms) "
                "| max (ms) |",
                "|---|---|---|---|---|---|---|",
            ]
            for name, st in stages.items():
                lines.append(
                    f"| {name} | {st['count']} | {st['total_s']:.3f} | "
                    f"{st['p50'] * 1e3:.3f} | {st['p90'] * 1e3:.3f} | "
                    f"{st['p99'] * 1e3:.3f} | {st['max'] * 1e3:.3f} |"
                )
    return "\n".join(lines)


def _spec_fingerprint(spec: dict) -> str:
    """Stable 8-hex id of a recorded spec (storage fields and the
    reference's speed knobs excluded, matching its unit journal's namespace
    convention)."""
    d = {k: v for k, v in spec.items() if k not in ("store", "store_path")}
    if isinstance(d.get("backend_kwargs"), dict):
        d["backend_kwargs"] = {
            k: v for k, v in d["backend_kwargs"].items()
            # knobs only the reference's records carry; the port has none
            if k not in ("pipeline_workers", "compile_cache")
        }
    try:
        return f"{stable_seed(json.dumps(d, sort_keys=True)):08x}"
    except (TypeError, ValueError):
        return "n/a"


def _code_version(prov: dict) -> str:
    """The package version and, from a checkout, its commit (``+`` when the
    tree had uncommitted changes)."""
    code = str(prov.get("repro_version", "?"))
    if prov.get("git_sha"):
        code += f" @ {prov['git_sha'][:12]}" + ("+" if prov.get("git_dirty") else "")
    return code


def _provenance_section(results: dict) -> str:
    lines = [
        "| combo | backend | spec fingerprint | code | record v | created | "
        "wall (s) | search cost (s) |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for (bench, chip), (_, meta) in sorted(results.items()):
        prov = meta.get("provenance", {})
        cell_walls = meta.get("cell_wall_s") or []
        cost = sum(w["wall_s"] for w in cell_walls)
        lines.append(
            f"| {bench} x {chip} | {meta.get('backend', '?')} "
            f"| `{_spec_fingerprint(meta.get('spec', {}))}` "
            f"| {_code_version(prov)} "
            f"| {meta.get('run_record_version', 'legacy')} "
            f"| {prov.get('created_at', '?')} "
            f"| {prov.get('wall_s', '?')} "
            f"| {cost:.1f} |"
        )
    bp = {
        k: meta["backend_provenance"]
        for k, (_, meta) in sorted(results.items())
        if meta.get("backend_provenance")
    }
    if bp:
        (bench, chip), one = next(iter(bp.items()))
        lines.append(
            f"\nBackend provenance ({bench} x {chip}): "
            f"`{json.dumps(one, sort_keys=True)}`"
        )
    return "\n".join(lines)


def _claims_section(results: dict) -> str:
    checks = check_claims(results)
    mark = {"pass": "✅ pass", "fail": "❌ fail",
            INSUFFICIENT: "⬜ insufficient-data"}
    lines = ["| claim | verdict | detail |", "|---|---|---|"]
    for v in checks.values():
        detail = json.dumps(v.detail, sort_keys=True)
        lines.append(f"| **{v.claim}** — {v.statement} | {mark[v.status]} "
                     f"| `{detail}` |")
    n_pass = sum(v.passed for v in checks.values())
    n_dec = sum(v.status != INSUFFICIENT for v in checks.values())
    lines.append(
        f"\n**{n_pass}/{n_dec} decidable claims reproduced"
        + (f"; {len(checks) - n_dec} need more data (see "
           "`repro_torch.analysis.claims.MIN_EXPERIMENTS`)**"
           if len(checks) != n_dec else "**")
    )
    return "\n".join(lines)


# ---------------------------------------------------------------- generator


def generate_report(
    results_dir: str,
    out_path: str | None = None,
    fig_dir: str | None = None,
    n_boot: int = 2000,
    seed: int = 0,
) -> str:
    """Render ``REPORT.md`` (plus ``figures/``) from a results directory.

    Returns the report path.  ``out_path`` defaults to
    ``<results_dir>/REPORT.md`` and ``fig_dir`` to ``<results_dir>/figures``
    (figure links in the report are relative to the report's directory).
    """
    results = load_all(results_dir)
    out_path = out_path or os.path.join(results_dir, "REPORT.md")
    fig_dir = fig_dir or os.path.join(results_dir, "figures")
    # the bootstrap is the report's most expensive computation — run it once
    # and share it between the figure and the table
    speedup = speedup_with_ci(results, n_boot=n_boot, seed=seed)
    fig_paths = make_figures(results, fig_dir, n_boot=n_boot, seed=seed,
                             speedup_table=speedup)

    n_exp = sum(
        len(cell.final_values)
        for res, _ in results.values()
        for cell in res.cells.values()
    )
    parts = [
        "# Autotuning analysis report",
        "",
        "Reproduction artifacts for *Analyzing Search Techniques for "
        "Autotuning Image-based GPU Kernels: The Impact of Sample Sizes* "
        "(Tørring & Elster 2022), generated by `repro_torch.analysis.report` "
        f"from `{results_dir}`: {len(results)} (benchmark × chip) combos, "
        f"{n_exp} tuning experiments.",
        "",
        "## Provenance",
        "",
        _provenance_section(results) if results else "(no combos found)",
        "",
    ]
    if fig_paths:
        out_dir = os.path.dirname(os.path.abspath(out_path))
        parts += ["## Figures", ""]
        for p in fig_paths:
            rel = os.path.relpath(os.path.abspath(p), out_dir)
            name = os.path.splitext(os.path.basename(p))[0]
            parts.append(f"![{name}]({rel})")
            parts.append("")
    elif not HAVE_MATPLOTLIB:
        parts += ["## Figures", "", "(matplotlib unavailable — tables only)",
                  ""]
    if results:
        opt_kinds = {meta["optimum_is_true"] for _, meta in results.values()}
        denom = (
            "the backend's noise-free true optimum"
            if opt_kinds == {True}
            else "the best observed final (no analytic optimum recorded)"
            if opt_kinds == {False}
            else "the true optimum where recorded, else the best observed final"
        )
        parts += [
            "## Quality vs sample size",
            "",
            f"Fraction-of-optimum denominators: {denom}.",
            "",
            "### Aggregate mean pct-of-optimum (95% bootstrap CI)",
            "",
            render_fig3(fig3_aggregate(results)),
            render_fig2(fig2_pct_optimum(results)),
            "",
            "## Speedup over Random Search",
            _render_speedup_ci(speedup),
            render_grid(fig4b_cles(results), "{:.2f}",
                        "CLES: P(algo beats RS)"),
            render_grid(mwu_vs_rs(results), "{:.2g}",
                        "MWU p-value vs RS (alpha = 0.01)"),
            "",
            "## Algorithm ranking",
            "",
            _render_ranks(results),
        ]
        cost = search_cost(results)
        if cost:
            # wall with the staged pipeline's compile/measure split; cells
            # from unstaged backends (or pre-breakdown records) show 0c+0m
            parts += [
                render_grid(
                    cost,
                    "{0[wall]:.2f}s ({0[compile]:.2f}c + {0[measure]:.2f}m)",
                    "search cost (wall = compile + measure)",
                )
            ]
        tel = _telemetry_section(results, results_dir)
        if tel:
            parts += ["", "## Telemetry", "", tel]
    parts += ["", "## Paper-claim verdicts", "", _claims_section(results), ""]

    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as f:
        f.write("\n".join(parts))
    return out_path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Render REPORT.md (tables + figures + claim verdicts) "
        "from a matrix results directory."
    )
    ap.add_argument("results_dir", help="e.g. results/matrix")
    ap.add_argument("--out", default=None,
                    help="report path (default <results_dir>/REPORT.md)")
    ap.add_argument("--fig-dir", default=None,
                    help="figure directory (default <results_dir>/figures)")
    ap.add_argument("--n-boot", type=int, default=2000,
                    help="bootstrap draws for the CI tables/bands")
    ap.add_argument("--seed", type=int, default=0,
                    help="bootstrap seed (CIs are deterministic per seed)")
    args = ap.parse_args(argv)
    path = generate_report(args.results_dir, out_path=args.out,
                           fig_dir=args.fig_dir, n_boot=args.n_boot,
                           seed=args.seed)
    print(f"[report] wrote {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
