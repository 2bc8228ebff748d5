"""The searchers: the paper's five (``rs``, ``rf``, ``ga``, ``bo_gp``,
``bo_tpe``) and three beyond it (``sa``, ``pso``, ``grid``).  Each is a copy
of the reference's, so one seed proposes one config sequence in both
packages."""

from .annealing import SimulatedAnnealing
from .base import SEARCHERS, Searcher, TuningResult, make_searcher, register
from .bo_gp import BOGPSearcher
from .bo_tpe import BOTPESearcher
from .genetic import GeneticAlgorithm
from .grid import GridSearch
from .pso import ParticleSwarm
from .random_forest import RandomForestSearcher
from .random_search import RandomSearch

PAPER_ALGORITHMS = ("rs", "rf", "ga", "bo_gp", "bo_tpe")
EXTRA_ALGORITHMS = ("sa", "pso", "grid")

__all__ = [
    "SEARCHERS",
    "Searcher",
    "TuningResult",
    "make_searcher",
    "register",
    "RandomSearch",
    "RandomForestSearcher",
    "GeneticAlgorithm",
    "BOGPSearcher",
    "BOTPESearcher",
    "SimulatedAnnealing",
    "ParticleSwarm",
    "GridSearch",
    "PAPER_ALGORITHMS",
    "EXTRA_ALGORITHMS",
]
