"""Regenerate EXPERIMENTS_torch.md from the port's results/ artifacts (a
port of ``benchmarks/make_experiments_md.py``; it never writes the
reference's EXPERIMENTS.md).

Sections:
  §Validation — paper-claims checks against the experiment matrix
  §Figures    — fig2/3/4 reproductions (markdown tables)
  §Dry-run    — per-cell trace summary (memory / flops / collectives)
  §Roofline   — three-term table on the H100's constants + dominant terms
  §Perf       — hill-climbing log (hypothesis -> change -> before/after)
  §Repro-perf — where the port's host-side costs are measured

Every number comes from the records it reads: the matrix directory (by
default the card's, ``results/paper_matrix_cuda``), ``results/dryrun_torch``
(``python -m repro_torch.launch.dryrun``), the roofline rows of its
single-pod records (``repro_torch.launch.roofline``, the H100's constants)
and ``results/perf_torch`` (``python -m repro_torch.benchmarks.hillclimb``).
The reference's hard-coded analysis of its cost-model matrix is printed
only when the matrix's records are the cost model's.

    PYTHONPATH=src python -m repro_torch.benchmarks.make_experiments_md
"""

from __future__ import annotations

import argparse
import json
import os

from ..analysis import load_all, validate
from ..analysis.claims import INSUFFICIENT
from ..analysis.report import render_fig2, render_fig3, render_grid
from ..analysis.stats import (
    fig2_pct_optimum,
    fig3_aggregate,
    fig4a_speedup,
    fig4b_cles,
)
from ..configs import REGISTRY, applicable_shapes
from ..launch.roofline import HBM_BW, ICI_BW, PEAK_FLOPS, markdown_table, roofline_row

MATRIX_DIR = os.path.join("results", "paper_matrix_cuda")
DRYRUN_DIR = os.path.join("results", "dryrun_torch")
PERF_DIR = os.path.join("results", "perf_torch")
OUT = "EXPERIMENTS_torch.md"

#: the H100 SXM's device memory (data sheet: 80 GB), the fits check's budget
HBM_BYTES = 80e9

HEADER = """\
# EXPERIMENTS (PyTorch/CUDA port)

Reproduction of *Analyzing Search Techniques for Autotuning Image-based GPU
Kernels: The Impact of Sample Sizes* (Tørring & Elster 2022) with the
PyTorch/CUDA port (`src/repro_torch/`): the kernels are hand-written CUDA
C++ for an NVIDIA H100 (sm_90a), timed on the card.  All artifacts
regenerate with:

```bash
PYTHONPATH=src python -m repro_torch.benchmarks.paper_matrix --design paper   # on the card
PYTHONPATH=src python -m repro_torch.launch.dryrun                            # fake ranks, CPU
PYTHONPATH=src python -m repro_torch.benchmarks.hillclimb
PYTHONPATH=src python -m repro_torch.benchmarks.make_experiments_md           # this file
```

Experiment design (paper-faithful): sample sizes S={25,50,100,200,400} with
E={800,400,200,100,50} experiments, 20k-sample pre-generated datasets for
the non-SMBO methods, winning config re-measured 10x, MWU alpha=0.01 + CLES.
On the card the chip axis collapses to the card: 3 benchmarks x 5
algorithms.
"""

#: the reference's reading of its cost-model matrix (its surface and
#: searchers are the port's too); printed only over cost-model records
COSTMODEL_ANALYSIS = """
**Analysis of the divergences.**  The paper's headline — *no single
algorithm wins at every sample size* — reproduces cleanly (winners rotate
across S in both per-cell and aggregate views; C3/C4/C6 all hold).  Two
per-cell-winner checks diverge, with identifiable causes:

* **RF is stronger at S=25-50 here than in the paper.**  Our analytic TPU
  cost surface is near-separable in the six integer parameters — exactly
  what axis-aligned CART splits learn from 15 samples — whereas real GPU
  wall-times carry interaction structure CART cannot exploit.  A 2x-noise
  sensitivity matrix (results/matrix_noise2x, scaled design) *refutes* the
  alternative "our noise is too mild" explanation: RF's small-S win count
  is unchanged at double noise (15/27 both ways), so the separable surface
  is the cause.  (At 2x noise the large-S winner shifts toward BO-TPE,
  whose Parzen smoothing is the most noise-robust — consistent with the
  paper's 'TPE is a good balance' observation.)  RF still satisfies the
  paper's literal claim C5 ('never outperforms all the others' overall).
* **BO-GP does not collapse at S=200-400 the way skopt's gp_minimize
  does** (the paper attributes its dip to overfitting; our from-scratch GP
  refits hyperparameters on a doubling schedule and keeps an explicit
  noise term, which appears to be more robust — dips still occur in 3/9
  combos, C6).  Consequently GA's large-S margin over BO-GP is narrower
  per cell, though GA is still the best algorithm at S=200/400 by the
  aggregate Fig.-3 metric (C2b).
"""


def section_validation(matrix_dir: str | None = None) -> str:
    matrix_dir = matrix_dir or MATRIX_DIR
    try:
        checks = validate(matrix_dir)
    except Exception as e:  # matrix not finished yet
        return f"## §Validation\n\n(matrix incomplete: {e})\n"
    lines = ["## §Validation — paper claims vs our matrix\n"]
    n_pass = sum(v.passed for v in checks.values())
    n_dec = sum(v.status != INSUFFICIENT for v in checks.values())
    lines.append(f"**{n_pass}/{n_dec} decidable claims reproduced"
                 + (f" ({len(checks) - n_dec} insufficient-data).**\n"
                    if n_dec != len(checks) else ".**\n"))
    for name, v in checks.items():
        tag = {"pass": "PASS", "fail": "FAIL", INSUFFICIENT: "N/A"}[v.status]
        lines.append(f"- **[{tag}] {name}** — `{v.detail}`")
    backends = {meta.get("backend") for _, meta in load_all(matrix_dir).values()}
    if backends == {"costmodel"}:
        lines.append(COSTMODEL_ANALYSIS)
    else:
        lines.append(f"\n(records of the {', '.join(sorted(map(str, backends)))} backend: "
                     "the reference's analysis of its cost-model matrix does not "
                     "apply to them and is left out.)\n")
    return "\n".join(lines)


def section_figures(matrix_dir: str | None = None) -> str:
    try:
        results = load_all(matrix_dir or MATRIX_DIR)
    except Exception as e:
        return f"## §Figures\n\n(matrix incomplete: {e})\n"
    if not results:
        return "## §Figures\n\n(matrix empty)\n"
    out = ["## §Figures — paper reproductions\n"]
    out.append("### Fig. 3 — mean pct-of-optimum across all benchmarks+chips\n")
    out.append(render_fig3(fig3_aggregate(results)))
    out.append("\n### Fig. 2 — per-combo pct-of-optimum (medians)\n")
    out.append(render_fig2(fig2_pct_optimum(results)))
    out.append("\n### Fig. 4a — median speedup over Random Search\n")
    out.append(render_grid(fig4a_speedup(results), "{:.3f}x", "speedup over RS"))
    out.append("\n### Fig. 4b — CLES: P(algorithm beats RS)\n")
    out.append(render_grid(fig4b_cles(results), "{:.2f}", "CLES vs RS"))
    out.append("")
    return "\n".join(out)


def section_dryrun(dryrun_dir: str | None = None) -> str:
    dryrun_dir = dryrun_dir or DRYRUN_DIR
    cells = []
    if os.path.isdir(dryrun_dir):
        for f in sorted(os.listdir(dryrun_dir)):
            if f.endswith(".json"):
                with open(os.path.join(dryrun_dir, f)) as fh:
                    cells.append(json.load(fh))
    lines = [
        "## §Dry-run — one traced step of every (arch x shape x mesh)\n",
        f"{len(cells)} cells traced (single pod 16x16=256 ranks; multi-pod "
        "2x16x16=512 ranks), each one step under `FakeTensorMode` on a fake "
        "process group, counted as one rank runs it "
        "(`python -m repro_torch.launch.dryrun`).  long_500k runs on the "
        "sub-quadratic families (zamba2, mamba2) per spec; pure "
        "full-attention archs skip it.\n",
        "| arch | shape | mesh | peak GiB/dev | args GiB/dev | HLO dot FLOPs/dev | coll B/dev | AG | AR | A2A |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for c in cells:
        b = c["collectives"]["bytes"]
        lines.append(
            f"| {c['arch']} | {c['shape']} | {c['mesh']} | "
            f"{c['memory']['peak_bytes_per_dev']/2**30:.2f} | "
            f"{c['memory']['argument_bytes_per_dev']/2**30:.2f} | "
            f"{c.get('flops_dot_corrected', 0):.2e} | "
            f"{c['collectives']['total_bytes']:.2e} | "
            f"{b.get('all-gather', 0):.1e} | {b.get('all-reduce', 0):.1e} | "
            f"{b.get('all-to-all', 0):.1e} |"
        )
    over = [c for c in cells if c["memory"]["peak_bytes_per_dev"] > HBM_BYTES]
    lines.append("")
    lines.append(
        f"**Fits check**: {len(cells) - len(over)}/{len(cells)} cells under "
        f"the {HBM_BYTES / 1e9:.0f} GB of one H100"
        + (f"; over budget: {[(c['arch'], c['shape'], c['mesh']) for c in over]}"
           if over else ".")
    )
    lines.append("")
    return "\n".join(lines)


def roofline_rows(dryrun_dir: str) -> list:
    """``launch.roofline.all_rows`` over the single-pod records in
    ``dryrun_dir``: every (arch, shape) that has one, in registry order."""
    rows = []
    for arch_name, arch in REGISTRY.items():
        for shape_name in applicable_shapes(arch):
            path = os.path.join(dryrun_dir, f"{arch_name}_{shape_name}_single.json")
            if os.path.exists(path):
                with open(path) as f:
                    rows.append(roofline_row(arch_name, shape_name, record=json.load(f)))
    return rows


def section_roofline(dryrun_dir: str | None = None) -> str:
    rows = roofline_rows(dryrun_dir or DRYRUN_DIR)
    lines = [
        "## §Roofline — single pod (256 ranks), H100 constants "
        f"({PEAK_FLOPS / 1e12:.0f} TFLOP/s bf16 dense, {HBM_BW / 1e12:.2f} TB/s HBM3, "
        f"{ICI_BW / 1e9:.0f} GB/s NVLink)\n",
        "Terms: compute = dot FLOPs one rank runs / peak; memory = analytic "
        "HBM traffic / (ranks x bw); collective = per-rank collective bytes / "
        "link bw.  `useful` = MODEL_FLOPS / counted FLOPs (6ND-style vs "
        "traced — exposes remat recompute and MoE capacity padding).  The "
        "counts are the ops the traced step runs, every layer included "
        "(see launch/hlo_analysis.py).\n",
        markdown_table(rows),
    ]
    doms = {}
    for r in rows:
        doms[r.dominant] = doms.get(r.dominant, 0) + 1
    lines.append(f"\nDominant-term census: {doms}.  ")
    lines.append(
        "One-sentence movers per dominant term:\n"
        "- collective: move weight gathers to bf16 (H1), shard attention "
        "head_dim when head counts are indivisible (H3), gather each layer's "
        "weights once (H4); see §Perf for what each moved.\n"
        "- memory: batch more decode requests per step or quantize the KV "
        "cache.\n"
        "- compute: shrink the mesh or grow the model/batch.\n"
    )
    return "\n".join(lines)


def section_perf(perf_dir: str | None = None) -> str:
    perf_dir = perf_dir or PERF_DIR
    lines = ["## §Perf — hillclimbing log (hypothesis -> change -> measure)\n"]
    if not os.path.isdir(perf_dir):
        return lines[0] + "\n(hillclimb not yet run)\n"
    by_cell: dict = {}
    for f in sorted(os.listdir(perf_dir)):
        if f.endswith(".json"):
            with open(os.path.join(perf_dir, f)) as fh:
                d = json.load(fh)
            cell = f.split("__")[0]
            by_cell.setdefault(cell, []).append(d)
    lines.append(
        "Chosen cells: olmoe-1b-7b/train_4k (worst roofline fraction), "
        "deepseek-v2-236b/train_4k (most collective-bound), yi-34b/train_4k "
        "(canonical dense; most representative of kernel-config tuning).  "
        "Baseline = paper-faithful defaults; variants per "
        "repro_torch/benchmarks/hillclimb.py, whose run names the variants "
        "that change no op of the port (H2 keeps the reference's flag by "
        "name only).\n"
    )
    for cell, variants in by_cell.items():
        variants.sort(key=lambda d: d["step_s"])
        base = next(v for v in variants if v["variant"] == "baseline")
        lines.append(f"\n### {cell}\n")
        lines.append("| variant | step (s) | collective (s) | compute (s) | "
                     "roofline frac | vs baseline |")
        lines.append("|---|---|---|---|---|---|")
        for v in variants:
            speed = base["step_s"] / v["step_s"] if v["step_s"] else 0
            lines.append(
                f"| {v['variant']} | {v['step_s']:.3f} | "
                f"{v['collective_s']:.3f} | {v['compute_s']:.3f} | "
                f"{v['roofline_fraction']:.3f} | {speed:.2f}x |"
            )
    lines.append("")
    return "\n".join(lines)


def section_repro_perf() -> str:
    return """\
## §Repro-perf — host-side cost of the search

The reference's table times its searchers on a CPU core; its numbers are
not the port's and are not carried over.  The port's host-side costs are
measured by `python -m repro_torch.cuda_bench.search_cost` (the searchers'
steps on each kernel's space) and `python -m repro_torch.benchmarks.run`
(searcher, engine, scheduler and pipeline rows); PERF.md records them, each
beside the card and host it was taken on.
"""


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--matrix-dir", default=MATRIX_DIR)
    ap.add_argument("--dryrun-dir", default=DRYRUN_DIR)
    ap.add_argument("--perf-dir", default=PERF_DIR)
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    parts = [
        HEADER,
        section_validation(args.matrix_dir),
        section_figures(args.matrix_dir),
        section_dryrun(args.dryrun_dir),
        section_roofline(args.dryrun_dir),
        section_perf(args.perf_dir),
        section_repro_perf(),
    ]
    with open(args.out, "w") as f:
        f.write("\n".join(parts))
    print(f"{args.out} written", f"({sum(len(p) for p in parts)} chars)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
