"""Random-forest regression, from scratch on numpy (a copy of
``repro.core.surrogates.forest``).

The paper uses sklearn's RandomForestRegressor as the RF surrogate (Breiman
2001: bootstrap bagging over variance-reduction decision trees with random
feature selection).  The port depends on no sklearn, so this is a faithful
re-implementation with the same defaults that matter:
``n_estimators=100, bootstrap=True, min_samples_leaf=1, min_samples_split=2``,
and every feature a split candidate at every node.

Trees are stored as flat arrays so batch prediction is a vectorized
level-by-level traversal (no Python recursion at predict time).  The ``rf``
searcher uses :class:`~.forest_batched.BatchedForest`; this per-node CART is
the reference the batched forest is checked against.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class _FlatTree:
    feature: np.ndarray   # int32, -1 for leaf
    threshold: np.ndarray # float64
    left: np.ndarray      # int32 child index
    right: np.ndarray     # int32 child index
    value: np.ndarray     # float64 leaf prediction


class RegressionTree:
    """CART regression tree: greedy SSE-minimizing axis-aligned splits."""

    def __init__(
        self,
        max_depth: int = 32,
        min_samples_split: int = 2,
        min_samples_leaf: int = 1,
        rng: np.random.Generator | None = None,
    ):
        self.max_depth = max_depth
        self.min_samples_split = min_samples_split
        self.min_samples_leaf = min_samples_leaf
        self.rng = rng or np.random.default_rng(0)
        self.tree_: _FlatTree | None = None

    # -- fitting ------------------------------------------------------------
    def fit(self, X: np.ndarray, y: np.ndarray) -> "RegressionTree":
        X = np.asarray(X, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        n, d = X.shape
        feature, threshold, left, right, value = [], [], [], [], []

        def new_node() -> int:
            feature.append(-1)
            threshold.append(0.0)
            left.append(-1)
            right.append(-1)
            value.append(0.0)
            return len(feature) - 1

        # iterative build with an explicit stack: (node_id, sample_idx, depth)
        root = new_node()
        stack = [(root, np.arange(n), 0)]
        while stack:
            nid, idx, depth = stack.pop()
            y_node = y[idx]
            value[nid] = float(y_node.mean())
            if (
                depth >= self.max_depth
                or len(idx) < self.min_samples_split
                or np.ptp(y_node) == 0.0
            ):
                continue
            # every feature is a candidate, tried in a random order (the
            # order breaks ties between equal gains)
            feats = self.rng.permutation(d)
            best = self._best_split(X[idx], y_node, feats)
            if best is None:
                continue
            f, thr = best
            mask = X[idx, f] <= thr
            li, ri = idx[mask], idx[~mask]
            if len(li) < self.min_samples_leaf or len(ri) < self.min_samples_leaf:
                continue
            feature[nid] = int(f)
            threshold[nid] = float(thr)
            lid, rid = new_node(), new_node()
            left[nid], right[nid] = lid, rid
            stack.append((lid, li, depth + 1))
            stack.append((rid, ri, depth + 1))

        self.tree_ = _FlatTree(
            feature=np.array(feature, dtype=np.int32),
            threshold=np.array(threshold, dtype=np.float64),
            left=np.array(left, dtype=np.int32),
            right=np.array(right, dtype=np.int32),
            value=np.array(value, dtype=np.float64),
        )
        return self

    def _best_split(self, X: np.ndarray, y: np.ndarray, feats: np.ndarray):
        """Vectorized best (feature, threshold) by SSE reduction.

        Uses the prefix-sum identity:  SSE_left + SSE_right is minimized by
        maximizing  (S_L^2 / n_L + S_R^2 / n_R)  where S is the y-prefix-sum
        over the feature-sorted order.
        """
        n = len(y)
        best_gain, best = 0.0, None
        total = y.sum()
        base = (total * total) / n
        for f in feats:
            xf = X[:, f]
            order = np.argsort(xf, kind="mergesort")
            xs, ys = xf[order], y[order]
            # candidate split points: between distinct consecutive x values
            diff = xs[1:] != xs[:-1]
            if not diff.any():
                continue
            csum = np.cumsum(ys)[:-1]            # sum of left part, size n-1
            n_l = np.arange(1, n, dtype=np.float64)
            n_r = n - n_l
            score = csum**2 / n_l + (total - csum) ** 2 / n_r
            score = np.where(diff, score, -np.inf)
            k = int(np.argmax(score))
            gain = score[k] - base
            if gain > best_gain + 1e-12:
                best_gain = gain
                best = (int(f), 0.5 * (xs[k] + xs[k + 1]))
        return best

    # -- prediction ---------------------------------------------------------
    def predict(self, X: np.ndarray) -> np.ndarray:
        if self.tree_ is None:
            raise RuntimeError("call fit first")
        X = np.asarray(X, dtype=np.float64)
        t = self.tree_
        node = np.zeros(len(X), dtype=np.int32)
        active = t.feature[node] >= 0
        while active.any():
            f = t.feature[node[active]]
            thr = t.threshold[node[active]]
            go_left = X[active, f] <= thr
            nxt = np.where(go_left, t.left[node[active]], t.right[node[active]])
            node[active] = nxt
            active = t.feature[node] >= 0
        return t.value[node]


class RandomForestRegressor:
    """Bagged ensemble of regression trees (Breiman 2001)."""

    def __init__(
        self,
        n_estimators: int = 100,
        max_depth: int = 32,
        min_samples_leaf: int = 1,
        bootstrap: bool = True,
        seed: int = 0,
    ):
        self.n_estimators = n_estimators
        self.max_depth = max_depth
        self.min_samples_leaf = min_samples_leaf
        self.bootstrap = bootstrap
        self.seed = seed
        self.trees_: list[RegressionTree] = []

    def fit(self, X: np.ndarray, y: np.ndarray) -> "RandomForestRegressor":
        X = np.asarray(X, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        n = len(X)
        root_rng = np.random.default_rng(self.seed)
        self.trees_ = []
        for _ in range(self.n_estimators):
            rng = np.random.default_rng(root_rng.integers(0, 2**63))
            idx = rng.integers(0, n, size=n) if self.bootstrap else np.arange(n)
            tree = RegressionTree(
                max_depth=self.max_depth,
                min_samples_leaf=self.min_samples_leaf,
                rng=rng,
            )
            tree.fit(X[idx], y[idx])
            self.trees_.append(tree)
        return self

    def predict(self, X: np.ndarray) -> np.ndarray:
        preds = np.stack([t.predict(X) for t in self.trees_], axis=0)
        return preds.mean(axis=0)
