"""Searchers ported so far: the paper's baseline (``rs``) and the default
searcher of :class:`~repro_torch.core.api.TuningSpec` (``ga``).  Both are
copies of the reference's, so one seed proposes one config sequence in both
packages."""

from .base import SEARCHERS, Searcher, TuningResult, make_searcher, register
from .genetic import GeneticAlgorithm
from .random_search import RandomSearch

__all__ = [
    "SEARCHERS",
    "Searcher",
    "TuningResult",
    "make_searcher",
    "register",
    "GeneticAlgorithm",
    "RandomSearch",
]
