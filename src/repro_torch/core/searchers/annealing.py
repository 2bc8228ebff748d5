"""Simulated Annealing — beyond-paper searcher (CLTune / related work III), a
copy of ``repro.core.searchers.annealing``.

Geometric cooling over +-1 neighborhood moves in index space; acceptance by
the Metropolis criterion on the (noisy) runtime.  Included so the CLTune-era
claim 'SA outperforms RS' can be re-examined inside the same harness
(the paper lists SA/PSO as related work it did not compare).

SA is inherently sequential — each move depends on the previous acceptance —
so its ask/tell proposals are single-config batches."""

from __future__ import annotations

import numpy as np

from .base import ProposalGen, Searcher, TuningResult, register


@register
class SimulatedAnnealing(Searcher):
    name = "sa"
    uses_constraints = True

    def __init__(self, space, seed: int = 0, t0: float = 1.0, t1: float = 1e-3):
        super().__init__(space, seed)
        self.t0 = t0
        self.t1 = t1

    def _propose(self, budget: int, result: TuningResult) -> ProposalGen:
        cur = self.space.sample_indices(self.rng, 1)[0]
        cur_v = float((yield [self.space.decode(cur)])[0])
        scale = abs(cur_v) if np.isfinite(cur_v) and cur_v else 1.0
        for step in range(budget - 1):
            frac = step / max(1, budget - 2)
            temp = self.t0 * (self.t1 / self.t0) ** frac
            for _ in range(100):
                nxt = self.space.neighbor(self.rng, cur)
                if self.space.is_valid(self.space.decode(nxt)):
                    break
            nxt_v = float((yield [self.space.decode(nxt)])[0])
            # non-finite values (invalid-config penalties from real
            # measurement backends) short-circuit the Metropolis rule:
            # inf - inf is NaN, which would wedge the walk on an invalid
            # start forever
            if not np.isfinite(nxt_v):
                continue
            if not np.isfinite(cur_v):
                cur, cur_v = nxt, nxt_v
                scale = abs(cur_v) or 1.0
                continue
            delta = (nxt_v - cur_v) / scale
            if delta <= 0 or self.rng.random() < np.exp(-delta / max(temp, 1e-12)):
                cur, cur_v = nxt, nxt_v
