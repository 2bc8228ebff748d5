"""repro_torch.analysis — the paper's contribution, as a subsystem (a port of
``repro.analysis``).

The paper's result is an *analysis*: speedup-over-RS per sample size,
per-benchmark/per-architecture winner rankings, and the claim that BO
GP/TPE win at 25–100 samples while GA wins at 200+.  This package consumes
versioned :class:`~repro_torch.core.api.RunRecord` JSON (+ ``.npz`` result
arrays) from any results directory — the port's ``tune_matrix(out_dir=...)``
writes one ``<bench>_<chip>`` pair per combo — and reproduces those
artifacts end-to-end:

* :mod:`~repro_torch.analysis.records` — loading + RunRecord normalization,
* :mod:`~repro_torch.analysis.stats`   — comparison tables (fraction-of-optimum,
  speedup-over-RS with seeded bootstrap CIs, CLES/MWU, ranks/winners,
  search cost) and budget-resolved curves,
* :mod:`~repro_torch.analysis.claims`  — the paper's claims as machine-checkable
  predicates with pass / fail / insufficient-data verdicts,
* :mod:`~repro_torch.analysis.figures` — matplotlib reproductions (headless
  Agg); without matplotlib the report is tables only,
* :mod:`~repro_torch.analysis.report`  — ``REPORT.md`` generation
  (``python -m repro_torch.analysis <results_dir>``).

The on-disk schema is the reference's (``docs/analysis_and_report.md``).
Nothing here imports ``repro``: the tests hold every table and verdict
equal to the reference's on the same records.
"""

from . import claims, figures, records, report, stats
from .claims import ClaimVerdict, check_claims, validate
from .figures import HAVE_MATPLOTLIB, make_figures
from .records import ALGOS, load_all, normalize_meta, present_algorithms
from .report import generate_report
from .stats import best_at_budget, budget_curve, speedup_with_ci

__all__ = [
    "ALGOS",
    "ClaimVerdict",
    "HAVE_MATPLOTLIB",
    "best_at_budget",
    "budget_curve",
    "check_claims",
    "claims",
    "figures",
    "generate_report",
    "load_all",
    "make_figures",
    "normalize_meta",
    "present_algorithms",
    "records",
    "report",
    "speedup_with_ci",
    "stats",
    "validate",
]
