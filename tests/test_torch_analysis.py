"""The port's statistics and analysis layer against the reference's, on the
CPU.

* ``repro_torch.core.stats`` equals ``repro.core.stats`` bit for bit on
  numpy-seeded populations, ties included: MWU U and p, CLES, the speedup,
  pct-of-optimum and the bootstrap CI;
* on the cost-model smoke matrix (harris on v5e, the five paper algorithms,
  S = 25, 50 with E = 8, 4), written once by each package's
  ``tune_matrix(out_dir=...)``, every analysis table of the port equals the
  reference's, each package on its own results and on the other's;
* ``check_claims`` gives the reference's status and detail for every claim:
  insufficient on the smoke matrix, pass on a decidable synthetic matrix,
  fail where it is contradicted;
* ``generate_report`` renders the reference's text from "Quality vs sample
  size" through the claims, and without matplotlib renders tables only.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

import repro
import repro_torch
from repro import analysis as ref_analysis
from repro.analysis import stats as ref_astats
from repro.core import CellResult as RefCell
from repro.core import ExperimentDesign as RefDesign
from repro.core import MatrixResults as RefResults
from repro.core import TuningSpec as RefSpec
from repro.core import stats as ref_stats
from repro_torch import analysis
from repro_torch.analysis import claims as aclaims
from repro_torch.analysis import stats as astats
from repro_torch.analysis.records import ALGOS
from repro_torch.core import CellResult, ExperimentDesign, MatrixResults, TuningSpec
from repro_torch.core import stats

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE_KW = dict(
    kernel="harris", backend="costmodel", backend_kwargs={"chip": "v5e"},
    algorithms=("rs", "rf", "ga", "bo_gp", "bo_tpe"), seed=3, dataset_size=400,
)


# ------------------------------------------------------------ core/stats


def _populations(seed: int):
    """Two runtime populations; odd seeds draw from a coarse grid, so ties
    within and across the samples are common."""
    rng = np.random.default_rng(seed)
    n_a, n_b = int(rng.integers(1, 40)), int(rng.integers(1, 40))
    if seed % 2:
        return (rng.integers(0, 5, n_a) * 0.25 + 1.0, rng.integers(0, 5, n_b) * 0.25 + 1.0)
    return rng.lognormal(0.0, 0.3, n_a), rng.lognormal(0.1, 0.3, n_b)


@pytest.mark.parametrize("seed", range(8))
def test_core_stats_equal_the_reference(seed):
    a, b = _populations(seed)
    both = np.concatenate([a, b])
    assert stats._rankdata(both).tolist() == ref_stats._rankdata(both).tolist()
    ours, ref = stats.mann_whitney_u(a, b), ref_stats.mann_whitney_u(a, b)
    assert (ours.u, ours.p_value, ours.n_a, ours.n_b) == (ref.u, ref.p_value, ref.n_a, ref.n_b)
    assert ours.significant() == ref.significant()
    assert stats.cles(a, b) == ref_stats.cles(a, b)
    assert stats.cles_lower_better(a, b) == ref_stats.cles_lower_better(a, b)
    assert stats.median_speedup(a, b) == ref_stats.median_speedup(a, b)
    assert stats.pct_of_optimum(a, 0.9).tolist() == ref_stats.pct_of_optimum(a, 0.9).tolist()
    for stat in (np.mean, np.median):
        assert stats.bootstrap_ci(a, stat, n_boot=300, seed=seed) == \
            ref_stats.bootstrap_ci(a, stat, n_boot=300, seed=seed)
    assert stats.compare_algorithms(a, b) == ref_stats.compare_algorithms(a, b)


def test_mwu_edge_cases_equal_the_reference():
    same = np.full(6, 2.0)
    assert stats.mann_whitney_u(same, same).p_value == ref_stats.mann_whitney_u(same, same).p_value == 1.0
    for fn in (stats.mann_whitney_u, ref_stats.mann_whitney_u):
        with pytest.raises(ValueError, match="empty"):
            fn(np.array([]), same)
    assert stats.ALPHA == ref_stats.ALPHA == 0.01


# ------------------------------------------------------ the smoke matrix


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """One results directory written by each package."""
    root = tmp_path_factory.mktemp("analysis")
    ours, ref = str(root / "ours"), str(root / "ref")
    repro_torch.tune_matrix(TuningSpec(design=ExperimentDesign.smoke(), **SMOKE_KW),
                            out_dir=ours)
    repro.tune_matrix(RefSpec(design=RefDesign.smoke(), **SMOKE_KW), out_dir=ref)
    return {"ours": ours, "ref": ref}


TABLES = ("fig2_pct_optimum", "fig3_aggregate", "fig4a_speedup", "fig4b_cles",
          "mwu_vs_rs", "rank_table", "mean_ranks", "winners_by_size")


@pytest.mark.parametrize("source", ["ours", "ref"])
def test_tables_equal_the_reference(dirs, source):
    """Each package's analysis of one results directory, table for table;
    and the port's matrix gives the reference's tables."""
    ours, ref = analysis.load_all(dirs[source]), ref_analysis.load_all(dirs[source])
    assert list(ours) == list(ref) == [("harris", "v5e")]
    (res, meta), (ref_res, ref_meta) = ours[("harris", "v5e")], ref[("harris", "v5e")]
    assert isinstance(res, MatrixResults)
    assert meta["optimum_is_true"] is ref_meta["optimum_is_true"] is True
    assert (meta["optimum"], meta["backend"]) == (ref_meta["optimum"], ref_meta["backend"])
    assert analysis.present_algorithms(ours) == ref_analysis.present_algorithms(ref) == list(ALGOS)
    for name in TABLES:
        assert getattr(astats, name)(ours) == getattr(ref_astats, name)(ref), name
    assert astats.speedup_with_ci(ours, n_boot=300, seed=5) == \
        ref_astats.speedup_with_ci(ref, n_boot=300, seed=5)
    assert astats.search_cost(ours) == ref_astats.search_cost(ref)
    # the port's matrix is the reference's matrix
    other = ref_analysis.load_all(dirs["ref" if source == "ours" else "ours"])
    for name in TABLES:
        assert getattr(astats, name)(ours) == getattr(ref_astats, name)(other), name


def test_claims_are_insufficient_on_the_smoke_matrix(dirs):
    ours = analysis.check_claims(analysis.load_all(dirs["ours"]))
    ref = ref_analysis.check_claims(ref_analysis.load_all(dirs["ref"]))
    assert list(ours) == list(ref) and len(ours) == 7
    for cid, v in ours.items():
        assert (v.status, v.detail, v.statement) == (ref[cid].status, ref[cid].detail,
                                                     ref[cid].statement)
        assert v.status == aclaims.INSUFFICIENT and str(v) == str(ref[cid])
    assert analysis.validate(dirs["ours"]).keys() == ours.keys()


def _synthetic(medians: dict, spread: dict | None, cell, results_cls, n_exp: int = 30):
    """The reference's synthetic combo (tests/test_analysis.py), built with
    either package's result classes."""
    rng = np.random.default_rng(0)
    res = results_cls()
    for (algo, s), m in medians.items():
        vals = np.maximum(m + rng.normal(0, (spread or {}).get(s, 0.01), size=n_exp), 1.0)
        res.add(cell(algo=algo, sample_size=s, final_values=vals,
                     search_best_values=vals.copy(), n_samples_used=np.full(n_exp, s)))
    meta = {"optimum": 1.0, "optimum_is_true": True, "spec": {},
            "provenance": {}, "backend": "synthetic"}
    return {("synth", "chip"): (res, meta)}


DECIDABLE = {
    "rs":     {25: 1.60, 50: 1.55, 100: 1.50, 200: 1.30, 400: 1.25},
    "rf":     {25: 1.40, 50: 1.38, 100: 1.35, 200: 1.18, 400: 1.15},
    "ga":     {25: 1.30, 50: 1.25, 100: 1.20, 200: 1.02, 400: 1.01},
    "bo_gp":  {25: 1.05, 50: 1.06, 100: 1.08, 200: 1.25, 400: 1.12},
    "bo_tpe": {25: 1.15, 50: 1.12, 100: 1.10, 200: 1.08, 400: 1.05},
}


@pytest.mark.parametrize("case", ["decidable", "contradicted", "ragged"])
def test_claim_verdicts_equal_the_reference(case):
    spread = None
    if case == "decidable":
        medians = {(a, s): v for a, row in DECIDABLE.items() for s, v in row.items()}
        spread = {25: 0.15, 50: 0.15, 100: 0.12, 200: 0.005, 400: 0.005}
    else:
        medians = {(a, s): (1.05 if a == "rf" else 1.5)
                   for a in ALGOS for s in (25, 50, 100, 200, 400)}
    if case == "ragged":
        del medians[("bo_tpe", 200)]
    ours = analysis.check_claims(_synthetic(medians, spread, CellResult, MatrixResults))
    ref = ref_analysis.check_claims(_synthetic(medians, spread, RefCell, RefResults))
    for cid, v in ours.items():
        assert (v.status, v.detail) == (ref[cid].status, ref[cid].detail), cid
    statuses = {v.status for v in ours.values()}
    if case == "decidable":
        assert statuses == {aclaims.PASS}
    elif case == "contradicted":
        assert ours["C1_bo_wins_small_S"].status == aclaims.FAIL
        assert ours["C5_rf_not_overall_winner"].status == aclaims.FAIL
    else:
        assert aclaims.INSUFFICIENT in statuses


# ---------------------------------------------------------------- report


def _from_quality(text: str) -> str:
    return text[text.index("## Quality vs sample size"):]


@pytest.mark.parametrize("source", ["ours", "ref"])
def test_report_text_equals_the_reference(dirs, tmp_path, source):
    ours = analysis.generate_report(dirs[source], out_path=str(tmp_path / "ours.md"),
                                    fig_dir=str(tmp_path / "figs"), n_boot=200)
    ref = ref_analysis.generate_report(dirs[source], out_path=str(tmp_path / "ref.md"),
                                       fig_dir=str(tmp_path / "ref_figs"), n_boot=200)
    text, ref_text = open(ours).read(), open(ref).read()
    # the one difference after the provenance: the claims note names the
    # module holding MIN_EXPERIMENTS
    assert _from_quality(text).replace("repro_torch.analysis", "repro.analysis") == \
        _from_quality(ref_text)
    assert "generated by `repro_torch.analysis.report`" in text
    provenance = text[text.index("## Provenance"):text.index("## Quality")]
    version = (repro_torch if source == "ours" else repro).__version__
    assert f"| {version}" in provenance and "| costmodel |" in provenance
    if analysis.HAVE_MATPLOTLIB:
        assert sorted(os.listdir(tmp_path / "figs")) == sorted(os.listdir(tmp_path / "ref_figs"))
        assert len(os.listdir(tmp_path / "figs")) == 3


def test_report_without_matplotlib_is_tables_only(dirs, tmp_path, capsys):
    """With matplotlib hidden, as on a host that lacks it, the report CLI
    still runs and says the report holds tables only; the claims CLI
    prints every verdict."""
    out = str(tmp_path / "REPORT.md")
    code = (
        "import sys\n"
        "sys.modules['matplotlib'] = None\n"
        "from repro_torch.analysis import HAVE_MATPLOTLIB\n"
        "assert not HAVE_MATPLOTLIB\n"
        "from repro_torch.analysis.report import main\n"
        f"sys.exit(main([{dirs['ours']!r}, '--out', {out!r}, '--n-boot', '50']))\n"
    )
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    run = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=300)
    assert run.returncode == 0, run.stderr
    text = open(out).read()
    assert "(matplotlib unavailable — tables only)" in text and "![" not in text
    assert "Paper-claim verdicts" in text
    assert not os.path.exists(os.path.join(dirs["ours"], "figures"))
    assert aclaims.main([dirs["ours"]]) == 0
    printed = capsys.readouterr().out
    assert printed.count("[N/A ] C") == 7
    assert "0/0 decidable paper claims reproduced (7 insufficient-data)" in printed


def test_records_fall_back_to_the_best_observed_final(tmp_path):
    """A backend without a true optimum (the card's): pct-of-optimum is
    taken against the best observed final, and the report says so."""
    spec = TuningSpec(kernel="harris", backend="cuda",
                      backend_kwargs={"x": 64, "y": 128, "device": "cpu", "repeats": 1},
                      algorithms=("rs", "ga"), cache_key="harris/cpu",
                      design=ExperimentDesign(sample_sizes=(10,), n_experiments=(2,),
                                              final_repeats=1), seed=1)
    out = str(tmp_path / "card")
    results = repro_torch.tune_matrix(spec, out_dir=out)
    loaded = analysis.load_all(out)
    (res, meta), = loaded.values()
    assert list(loaded) == [("harris", "cpu")]
    assert meta["optimum_is_true"] is False and meta["optimum"] == results.optimum
    assert meta["backend"] == "cuda" and meta["backend_provenance"]["device"] == "cpu"
    text = open(analysis.generate_report(out, n_boot=50)).read()
    assert "the best observed final (no analytic optimum recorded)" in text
    assert '"device_kind": ' in text
