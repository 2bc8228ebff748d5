"""Bayesian Optimization with Tree-Parzen Estimators (Bergstra et al. 2011),
a copy of ``repro.core.searchers.bo_tpe``.

The paper uses the HyperOpt library.  The port depends on no HyperOpt, so
this is a from-scratch TPE over the integer/categorical index space:

* the first ``n_startup`` samples (HyperOpt default: 20) are random,
* observations are split into 'good' l(x) and 'bad' g(x) groups with
  HyperOpt's rule  n_good = min(ceil(gamma * sqrt(n)), 25), gamma = 0.25
  (a linear quantile would make l(x) far too broad at large sample sizes
  and visibly degrades TPE beyond S=200),
* each parameter dimension is modeled with a smoothed Parzen histogram over
  its index values (uniform prior weight + triangular [0.25, 0.5, 0.25]
  neighbor smoothing for ordered ints — the discrete analogue of HyperOpt's
  gaussian-smoothed quantized-uniform),
* ``n_ei_candidates`` (24) draws from l(x) are scored by l(x)/g(x); the
  argmax is measured.

Like the paper, TPE gets no constraint specification (section V.C).
Candidates are drawn with ``rng.choice(card, size, p=pmf)`` as the reference
draws them, so one seed proposes one config sequence in both packages.
"""

from __future__ import annotations

import numpy as np

from .base import ProposalGen, Searcher, TuningResult, register


def _parzen_pmf(
    indices: np.ndarray, cardinality: int, prior_weight: float = 1.0
) -> np.ndarray:
    """Smoothed pmf over [0..cardinality): prior + kernel-smoothed counts."""
    counts = np.bincount(indices, minlength=cardinality).astype(np.float64)
    # triangular smoothing over neighbors (ordered-integer kernel)
    smoothed = counts * 0.5
    smoothed[1:] += counts[:-1] * 0.25
    smoothed[:-1] += counts[1:] * 0.25
    # reflect mass lost at the edges back in so sum(counts) is preserved
    smoothed[0] += counts[0] * 0.25
    smoothed[-1] += counts[-1] * 0.25
    pmf = smoothed + prior_weight / cardinality
    return pmf / pmf.sum()


@register
class BOTPESearcher(Searcher):
    name = "bo_tpe"
    uses_constraints = False

    def __init__(
        self,
        space,
        seed: int = 0,
        n_startup: int = 20,
        gamma: float = 0.25,
        n_ei_candidates: int = 24,
        prior_weight: float = 1.0,
    ):
        super().__init__(space, seed)
        self.n_startup = n_startup
        self.gamma = gamma
        self.n_ei_candidates = n_ei_candidates
        self.prior_weight = prior_weight

    def _propose(self, budget: int, result: TuningResult) -> ProposalGen:
        n_startup = min(self.n_startup, budget)
        init = self.space.sample_indices(self.rng, n_startup)
        init_vals = yield self.space.decode_batch(init)

        X = [np.asarray(r) for r in init]
        y = [float(v) for v in init_vals]

        for _ in range(budget - n_startup):
            Xa = np.stack(X)
            ya = np.asarray(y)
            n_good = max(1, min(int(np.ceil(self.gamma * np.sqrt(len(ya)))), 25))
            order = np.argsort(ya, kind="stable")
            good, bad = Xa[order[:n_good]], Xa[order[n_good:]]
            if len(bad) == 0:  # degenerate early case
                bad = Xa

            # per-dimension Parzen pmfs
            l_pmfs, g_pmfs = [], []
            for d, card in enumerate(self.space.cardinalities):
                l_pmfs.append(_parzen_pmf(good[:, d], card, self.prior_weight))
                g_pmfs.append(_parzen_pmf(bad[:, d], card, self.prior_weight))

            # sample candidates from l(x), score by l/g
            n_c = self.n_ei_candidates
            cand = np.stack(
                [
                    self.rng.choice(len(pmf), size=n_c, p=pmf)
                    for pmf in l_pmfs
                ],
                axis=1,
            ).astype(np.int64)
            log_ratio = np.zeros(n_c)
            for d in range(self.space.n_params):
                log_ratio += np.log(l_pmfs[d][cand[:, d]]) - np.log(
                    g_pmfs[d][cand[:, d]]
                )
            pick = cand[int(np.argmax(log_ratio))]
            v = float((yield [self.space.decode(pick)])[0])
            X.append(pick)
            y.append(v)
