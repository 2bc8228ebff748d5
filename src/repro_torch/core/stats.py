"""Statistics for comparing autotuning algorithms.

The paper's toolkit (sections II.C, V.A):

* Mann-Whitney U test (two-sided, normal approximation with tie correction)
  at alpha = 0.01 — non-parametric because tuned-runtime populations are
  "obviously non-gaussian".
* Common Language Effect Size (CLES / Vargha-Delaney A, eq. 1):
  A(X_A, X_B) = P(X_A > X_B) + 0.5 P(X_A = X_B).

Implemented from first principles on numpy, a copy of ``repro.core.stats``
(the tests hold the two equal bit for bit), so the port has no hard scipy
dependency at runtime.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

ALPHA = 0.01  # the paper's significance threshold


def _rankdata(x: np.ndarray) -> np.ndarray:
    """Average ranks (1-based), ties share the mean rank."""
    order = np.argsort(x, kind="mergesort")
    ranks = np.empty(len(x), dtype=np.float64)
    sx = x[order]
    i = 0
    while i < len(sx):
        j = i
        while j + 1 < len(sx) and sx[j + 1] == sx[i]:
            j += 1
        ranks[order[i : j + 1]] = 0.5 * (i + j) + 1.0
        i = j + 1
    return ranks


def _norm_sf(z: float) -> float:
    """Standard normal survival function via erfc."""
    return 0.5 * math.erfc(z / math.sqrt(2.0))


@dataclass(frozen=True)
class MWUResult:
    u: float
    p_value: float
    n_a: int
    n_b: int

    def significant(self, alpha: float = ALPHA) -> bool:
        return self.p_value < alpha


def mann_whitney_u(a: np.ndarray, b: np.ndarray) -> MWUResult:
    """Two-sided MWU with tie-corrected normal approximation.

    Matches scipy.stats.mannwhitneyu(method="asymptotic", use_continuity=True),
    as the reference's does.
    """
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    n_a, n_b = len(a), len(b)
    if n_a == 0 or n_b == 0:
        raise ValueError("empty sample")
    both = np.concatenate([a, b])
    ranks = _rankdata(both)
    r_a = ranks[:n_a].sum()
    u_a = r_a - n_a * (n_a + 1) / 2.0
    mu = n_a * n_b / 2.0
    # tie correction
    _, counts = np.unique(both, return_counts=True)
    n = n_a + n_b
    tie_term = ((counts**3 - counts).sum()) / (n * (n - 1)) if n > 1 else 0.0
    sigma2 = n_a * n_b / 12.0 * ((n + 1) - tie_term)
    if sigma2 <= 0:
        return MWUResult(u=u_a, p_value=1.0, n_a=n_a, n_b=n_b)
    # two-sided with continuity correction
    z = (u_a - mu - 0.5 * np.sign(u_a - mu)) / math.sqrt(sigma2)
    p = min(1.0, 2.0 * _norm_sf(abs(z)))
    return MWUResult(u=u_a, p_value=p, n_a=n_a, n_b=n_b)


def cles(a: np.ndarray, b: np.ndarray) -> float:
    """Common Language Effect Size  A(X_A, X_B) = P(A > B) + 0.5 P(A = B).

    Computed exactly from ranks in O((n+m) log(n+m)) rather than the O(n*m)
    pairwise comparison — equivalent by the U-statistic identity.
    """
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    n_a, n_b = len(a), len(b)
    both = np.concatenate([a, b])
    ranks = _rankdata(both)
    r_a = ranks[:n_a].sum()
    u_a = r_a - n_a * (n_a + 1) / 2.0  # = #(A>B) + 0.5 #(A==B)
    return float(u_a / (n_a * n_b))


def cles_lower_better(a: np.ndarray, b: np.ndarray) -> float:
    """P(algorithm A beats B) when the metric is runtime (lower is better).

    The paper's Fig. 4b plots 'probability of the algorithm's solution
    outperforming Random Search' — with runtimes, A outperforms B when
    X_A < X_B, i.e. CLES(B, A) in the eq.-1 sense.
    """
    return cles(np.asarray(b), np.asarray(a))


def median_speedup(baseline: np.ndarray, algo: np.ndarray) -> float:
    """median(baseline) / median(algo): >1 means algo is faster (Fig. 4a)."""
    return float(np.median(baseline) / np.median(algo))


def pct_of_optimum(values: np.ndarray, optimum: float) -> np.ndarray:
    """Percentage-of-optimum performance for runtimes: optimum / value * 100.

    100% means the tuned config matches the study's best-known runtime
    (the paper's Fig. 2 metric).
    """
    values = np.asarray(values, dtype=np.float64)
    return optimum / values * 100.0


def bootstrap_ci(
    x: np.ndarray,
    stat=np.mean,
    n_boot: int = 2000,
    ci: float = 0.95,
    seed: int = 0,
) -> tuple[float, float, float]:
    """(stat, lo, hi) percentile-bootstrap confidence interval (Fig. 3 bands)."""
    x = np.asarray(x, dtype=np.float64)
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, len(x), size=(n_boot, len(x)))
    boots = stat(x[idx], axis=1)
    lo, hi = np.percentile(boots, [(1 - ci) / 2 * 100, (1 + ci) / 2 * 100])
    return float(stat(x)), float(lo), float(hi)


def compare_algorithms(
    results_a: np.ndarray, results_b: np.ndarray
) -> dict:
    """Full paper-style comparison of two runtime populations (lower=better)."""
    mwu = mann_whitney_u(results_a, results_b)
    return {
        "median_a": float(np.median(results_a)),
        "median_b": float(np.median(results_b)),
        "speedup_a_over_b": median_speedup(results_b, results_a),
        "cles_a_beats_b": cles_lower_better(results_a, results_b),
        "mwu_p": mwu.p_value,
        "significant": mwu.significant(),
    }
