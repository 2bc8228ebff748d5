"""Random-Forest model-based autotuning (the paper's non-SMBO RF method), a
copy of ``repro.core.searchers.random_forest``.

Section VI.B: 'For model-based approaches like Random Forest (RF), we train
the models with the subset of size S-10 for each experiment and then run the
top 10 predictions. The top performing prediction is then stored as the
output.'

So with budget S: S-10 random (constrained) training samples are measured
(ONE batch through the engine), an RF regressor is fit on them, the model
ranks a large candidate pool, and the 10 best-predicted configs are actually
measured (a second batch); the best of those 10 is the result.  The
candidate pool is a constraint-valid random subsample of the space
(pool_size=16384 by default — predicting over all 2.1M configs with a
pure-python forest would only change which near-tied candidate wins; the
reference's own deviation from the paper).
"""

from __future__ import annotations

import numpy as np

from ..clock import monotonic
from ..surrogates.forest_batched import BatchedForest
from .base import ProposalGen, Searcher, TuningResult, register


@register
class RandomForestSearcher(Searcher):
    name = "rf"
    uses_constraints = True
    SPLIT = ("fit_s", "acquire_s")

    def __init__(
        self,
        space,
        seed: int = 0,
        n_estimators: int = 100,
        top_k: int = 10,
        pool_size: int = 16384,
    ):
        super().__init__(space, seed)
        self.n_estimators = n_estimators
        self.top_k = top_k
        self.pool_size = pool_size

    def _propose(self, budget: int, result: TuningResult) -> ProposalGen:
        top_k = min(self.top_k, max(1, budget // 2))
        n_train = budget - top_k
        train_idx = self.space.sample_indices(self.rng, n_train)
        train_vals = yield self.space.decode_batch(train_idx)

        # fit_s: the forest's fit; acquire_s: the pool's draw, predict, sort
        t = monotonic()
        forest = BatchedForest(
            self.space.cardinalities,
            n_estimators=self.n_estimators,
            seed=int(self.rng.integers(0, 2**31)),
        )
        forest.fit(train_idx[None], np.asarray(train_vals)[None])
        t = self._lap("fit_s", t)

        pool = self.space.sample_indices(self.rng, self.pool_size)
        preds = forest.predict(pool)[0]
        best = np.argsort(preds, kind="stable")[: top_k]
        pred_cfgs = self.space.decode_batch(pool[best])
        self._lap("acquire_s", t)
        pred_vals = yield pred_cfgs
        # The RF result is the best of the top-k *predictions* actually run —
        # NOT the best training sample (the paper stores the top performing
        # prediction).  The engine tracked the global best including training
        # samples, so override with the prediction-only best:
        j = int(np.argmin(pred_vals))
        result.best_value = float(pred_vals[j])
        result.best_config = pred_cfgs[j]
