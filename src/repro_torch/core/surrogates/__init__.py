"""Surrogate models of the model-based searchers (copies of
``repro.core.surrogates``): the Gaussian process of ``bo_gp`` and the random
forests of ``rf``."""

from .forest import RandomForestRegressor, RegressionTree
from .gp import GaussianProcess

__all__ = ["RandomForestRegressor", "RegressionTree", "GaussianProcess"]
