"""Gaussian-process regression, from scratch on numpy (a copy of
``repro.core.surrogates.gp``).

The paper uses scikit-optimize's ``gp_minimize`` (Matérn kernel + Expected
Improvement, 8% random initialization).  The port depends on neither skopt
nor sklearn, so this module implements the GP surrogate directly:

* Matérn-5/2 kernel with a shared lengthscale on unit-cube inputs,
* observation-noise variance (the measurement IS noisy — the paper runs each
  config once during search),
* hyperparameters chosen by log-marginal-likelihood over a log-space grid,
  re-selected only when the training set doubles (grid search is O(n^3) per
  combo; doubling keeps total refit cost O(n^3) amortized),
* **incremental Cholesky**: appending one observation extends L with one
  triangular solve — O(n^2) per BO step instead of O(n^3).

y is standardized internally (against the *current* observation set), so the
signal variance is fixed at 1.

The surrogate is host code in float64 with the reference's order of
operations (``np.linalg.cholesky`` with its jitter loop, scipy's triangular
solves): a near-tie in expected improvement then breaks the same way in both
packages, so one seed proposes one config sequence.
"""

from __future__ import annotations

import numpy as np

_SQRT5 = np.sqrt(5.0)

#: the log-marginal-likelihood grid the hyperparameters are picked from
_LENGTHSCALES = (0.1, 0.25, 0.6, 1.5)
_NOISES = (1e-4, 1e-2, 1e-1)


def matern52(a: np.ndarray, b: np.ndarray, lengthscale: float) -> np.ndarray:
    """Matérn-5/2 kernel matrix for row-vector inputs in the unit cube."""
    d2 = np.maximum(
        (a**2).sum(1)[:, None] + (b**2).sum(1)[None, :] - 2.0 * a @ b.T, 0.0
    )
    r = np.sqrt(d2) / lengthscale
    return (1.0 + _SQRT5 * r + 5.0 / 3.0 * r**2) * np.exp(-_SQRT5 * r)


class GaussianProcess:
    """Online GP for sequential model-based optimization (minimization)."""

    def __init__(self):
        self.lengthscale = _LENGTHSCALES[len(_LENGTHSCALES) // 2]
        self.noise = _NOISES[1]
        self._X: list[np.ndarray] = []
        self._y: list[float] = []
        self._L: np.ndarray | None = None
        self._alpha: np.ndarray | None = None
        self._y_mean = 0.0
        self._y_std = 1.0
        self._last_refit_n = 0

    # -- internals ------------------------------------------------------------
    @staticmethod
    def _chol(K: np.ndarray) -> np.ndarray:
        jitter = 1e-10
        for _ in range(10):
            try:
                return np.linalg.cholesky(K + jitter * np.eye(len(K)))
            except np.linalg.LinAlgError:
                jitter *= 100.0
        raise np.linalg.LinAlgError("kernel matrix not PD even with jitter")

    def _standardize(self) -> np.ndarray:
        y = np.asarray(self._y)
        self._y_mean = float(y.mean())
        self._y_std = float(y.std()) or 1.0
        return (y - self._y_mean) / self._y_std

    def _lml(self, X: np.ndarray, yn: np.ndarray, ls: float, nz: float) -> float:
        K = matern52(X, X, ls) + nz * np.eye(len(X))
        try:
            L = self._chol(K)
        except np.linalg.LinAlgError:
            return -np.inf
        a = np.linalg.solve(L.T, np.linalg.solve(L, yn))
        return float(-0.5 * yn @ a - np.log(np.diag(L)).sum())

    def _full_refit(self) -> None:
        X = np.stack(self._X)
        yn = self._standardize()
        best = -np.inf
        for ls in _LENGTHSCALES:
            for nz in _NOISES:
                lml = self._lml(X, yn, ls, nz)
                if lml > best:
                    best, self.lengthscale, self.noise = lml, ls, nz
        K = matern52(X, X, self.lengthscale) + self.noise * np.eye(len(X))
        self._L = self._chol(K)
        self._alpha = np.linalg.solve(self._L.T, np.linalg.solve(self._L, yn))
        self._last_refit_n = len(X)

    def _refresh_alpha(self) -> None:
        yn = self._standardize()
        from scipy.linalg import solve_triangular  # fast dtrsv path

        z = solve_triangular(self._L, yn, lower=True)
        self._alpha = solve_triangular(self._L.T, z, lower=False)

    # -- public API ------------------------------------------------------------
    @property
    def n(self) -> int:
        return len(self._y)

    def add(self, x: np.ndarray, y: float) -> None:
        """Add one observation; O(n^2) unless a hyperparameter refit fires."""
        x = np.asarray(x, dtype=np.float64)
        self._X.append(x)
        self._y.append(float(y))
        n = len(self._y)
        if self._L is None or n >= 2 * max(self._last_refit_n, 4):
            self._full_refit()
            return
        # rank-1 Cholesky append:  K' = [[K, k], [k^T, k_nn + noise]]
        X_old = np.stack(self._X[:-1])
        k = matern52(x[None, :], X_old, self.lengthscale)[0]
        from scipy.linalg import solve_triangular

        b = solve_triangular(self._L, k, lower=True)
        d2 = 1.0 + self.noise - b @ b
        d = np.sqrt(max(d2, 1e-10))
        n_old = len(X_old)
        L_new = np.zeros((n_old + 1, n_old + 1))
        L_new[:n_old, :n_old] = self._L
        L_new[n_old, :n_old] = b
        L_new[n_old, n_old] = d
        self._L = L_new
        self._refresh_alpha()

    def fit(self, X: np.ndarray, y: np.ndarray) -> "GaussianProcess":
        """Batch (re)fit — resets the online state."""
        self._X = [np.asarray(r, dtype=np.float64) for r in np.asarray(X)]
        self._y = [float(v) for v in np.asarray(y)]
        self._full_refit()
        return self

    def predict(self, Xs: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Posterior mean and stddev (in the original y units)."""
        if self._L is None:
            raise RuntimeError("call fit first: GP has no observations")
        from scipy.linalg import solve_triangular

        Xs = np.asarray(Xs, dtype=np.float64)
        X = np.stack(self._X)
        Ks = matern52(Xs, X, self.lengthscale)
        mu = Ks @ self._alpha
        v = solve_triangular(self._L, Ks.T, lower=True)
        var = np.maximum(1.0 + self.noise - (v**2).sum(axis=0), 1e-12)
        return (
            mu * self._y_std + self._y_mean,
            np.sqrt(var) * self._y_std,
        )


def _erf(x: np.ndarray) -> np.ndarray:
    """Vectorized erf (Abramowitz & Stegun 7.1.26, |err| < 1.5e-7)."""
    s = np.sign(x)
    x = np.abs(x)
    t = 1.0 / (1.0 + 0.3275911 * x)
    poly = t * (
        0.254829592
        + t * (-0.284496736 + t * (1.421413741 + t * (-1.453152027 + t * 1.061405429)))
    )
    return s * (1.0 - poly * np.exp(-x * x))


def expected_improvement(
    mu: np.ndarray, sigma: np.ndarray, best: float, xi: float = 0.0
) -> np.ndarray:
    """EI for MINIMIZATION:  E[max(best - Y - xi, 0)]."""
    sigma = np.maximum(sigma, 1e-12)
    z = (best - mu - xi) / sigma
    cdf = 0.5 * (1.0 + _erf(z / np.sqrt(2.0)))
    pdf = np.exp(-0.5 * z**2) / np.sqrt(2.0 * np.pi)
    return (best - mu - xi) * cdf + sigma * pdf
