"""Bayesian Optimization with a Gaussian-Process surrogate (a copy of
``repro.core.searchers.bo_gp``).

The paper uses scikit-optimize's ``gp_minimize`` with Expected Improvement;
'Initialization uses 8% of the samples, and the remaining 92% are used as
prediction samples in the search.'  SMBO methods do NOT receive the
constraint specification (section V.C).

Per step: fit the GP on all observations (unit-cube inputs), score a
candidate set (fresh random configs + perturbations of the incumbent) by EI,
measure the argmax.
"""

from __future__ import annotations

import numpy as np

from ..clock import monotonic
from ..surrogates.gp import GaussianProcess, expected_improvement
from .base import ProposalGen, Searcher, TuningResult, register


@register
class BOGPSearcher(Searcher):
    name = "bo_gp"
    uses_constraints = False  # paper: no constraint support in SMBO searches
    SPLIT = ("fit_s", "acquire_s")

    def __init__(
        self,
        space,
        seed: int = 0,
        init_frac: float = 0.08,
        n_candidates: int = 1024,
        n_local: int = 256,
    ):
        super().__init__(space, seed)
        self.init_frac = init_frac
        self.n_candidates = n_candidates
        self.n_local = n_local

    @staticmethod
    def _gp_value(v: float, y_finite: list) -> float:
        """Observation as the GP sees it: non-finite penalties (invalid
        configs from a real-measurement backend) become a large FINITE value
        — strictly worse than any *finite* observation so far — so
        standardization and the Cholesky stay defined while the surrogate
        still learns to avoid the region (kernel_tuner does the same with
        its failure value).  The cap derives from finite observations only:
        deriving it from previous penalties would compound exponentially.
        """
        v = float(v)
        if np.isfinite(v):
            return v
        if y_finite:
            m = max(y_finite)
            return m + abs(m) + 1.0
        return 1.0

    def _candidates(self, incumbent: np.ndarray, n: int) -> np.ndarray:
        """Random + incumbent-local candidate pool.

        The pool shrinks as the GP grows (posterior-variance evaluation is
        O(n^2) per candidate), keeping per-step cost roughly constant.
        """
        n_rand = int(np.clip(self.n_candidates * 64 // max(n, 64), 256, self.n_candidates))
        n_loc = int(np.clip(self.n_local * 64 // max(n, 64), 64, self.n_local))
        rand = self.space.sample_indices(self.rng, n_rand)
        local = self.space.mutate_batch(self.rng, incumbent, 0.3, n_loc)
        return np.concatenate([rand, local])

    def _propose(self, budget: int, result: TuningResult) -> ProposalGen:
        n_init = max(1, min(budget, int(round(self.init_frac * budget))))
        init_idx = self.space.sample_indices(self.rng, n_init)
        init_vals = yield self.space.decode_batch(init_idx)

        X = list(init_idx)
        X_unit: list[np.ndarray] = []
        y: list[float] = []          # as the GP sees them (penalties clipped)
        y_fin: list[float] = []      # finite observations only (clip basis)
        pen_idx: list[int] = []      # positions in y holding clipped penalties
        gp = GaussianProcess()

        def observe(row: np.ndarray, raw: float) -> None:
            """Feed one observation to the GP, keeping every stored penalty
            strictly worse than every finite observation: when the finite
            max overtakes the current clip value, old penalties are
            re-clipped and the GP batch-refit (rare — the max only grows
            O(log n) times), so argmin/EI can never chase an invalid
            config."""
            raw = float(raw)
            if np.isfinite(raw):
                y_fin.append(raw)
            else:
                pen_idx.append(len(y))
            u = self.space.to_unit(row[None, :])[0]
            X_unit.append(u)
            y.append(self._gp_value(raw, y_fin))
            clip = self._gp_value(float("inf"), y_fin)
            if pen_idx and any(y[i] != clip for i in pen_idx):
                for i in pen_idx:
                    y[i] = clip
                gp.fit(np.stack(X_unit), np.asarray(y))
            else:
                gp.add(u, y[-1])

        # fit_s: the GP's observe/fit; acquire_s: candidates, predict, EI
        t = monotonic()
        for r, v in zip(init_idx, init_vals, strict=True):
            observe(r, v)
        seen_keys = self.space.flat_keys(init_idx).tolist()
        t = self._lap("fit_s", t)

        for _ in range(budget - n_init):
            inc = X[int(np.argmin(y))]
            cand = self._candidates(np.asarray(inc), gp.n)
            # drop already-measured configs (re-measuring wastes budget)
            fresh = cand[~np.isin(self.space.flat_keys(cand), seen_keys)]
            if len(fresh) == 0:
                fresh = self.space.sample_indices(self.rng, 256)
            mu, sigma = gp.predict(self.space.to_unit(fresh))
            ei = expected_improvement(mu, sigma, best=float(np.min(y)))
            pick = fresh[int(np.argmax(ei))]
            self._lap("acquire_s", t)
            raw = float((yield [self.space.decode(pick)])[0])
            t = monotonic()
            X.append(pick)
            observe(pick, raw)
            seen_keys.append(int(self.space.flat_keys(pick[None, :])[0]))
            t = self._lap("fit_s", t)
