"""Grid search (a copy of ``repro.core.searchers.grid``) — included for
completeness (Bergstra & Bengio 2012 showed RS beats it; the harness lets
that claim be re-verified).  With budget < |S| it
measures an evenly-strided subset of the enumeration order, proposed as ONE
vectorized batch.  Constraint-invalid strided points are replaced by
continuing the strided enumeration at the next offset, so grid consumes its
exact budget whenever the space holds enough valid configs."""

from __future__ import annotations

import numpy as np

from .base import ProposalGen, Searcher, TuningResult, register


@register
class GridSearch(Searcher):
    name = "grid"
    uses_constraints = True

    def _propose(self, budget: int, result: TuningResult) -> ProposalGen:
        total = self.space.cardinality
        cards = self.space.cardinalities
        stride = max(1, total // budget)
        batch: list = []
        for offset in range(stride):
            flats = np.arange(offset, total, stride, dtype=np.int64)
            idxs = np.stack(
                np.unravel_index(flats, tuple(cards)), axis=1
            ).astype(np.int64)
            valid = self.space.valid_mask(idxs)
            batch.extend(self.space.decode_batch(idxs[valid]))
            if len(batch) >= budget:
                break
        yield batch[:budget]
