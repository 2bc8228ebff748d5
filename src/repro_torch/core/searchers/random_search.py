"""Random Search — the paper's baseline.

'For the case of Random Search (RS), we simply select the minimum runtime
from the collection of S samples for the given experiment.' (section VI.B)

RS samples the *constrained* space (constraint specification is available to
non-SMBO methods).  Under the ask/tell engine the whole budget is proposed
as ONE batch — a single measurement dispatch on vectorized backends.
"""

from __future__ import annotations

from .base import ProposalGen, Searcher, TuningResult, register


@register
class RandomSearch(Searcher):
    name = "rs"
    uses_constraints = True

    def _propose(self, budget: int, result: TuningResult) -> ProposalGen:
        yield self.space.sample_batch(self.rng, budget)
