"""Vectorized histogram random forests over integer feature spaces (a copy
of ``repro.core.surrogates.forest_batched``).

Autotuning search spaces are small-cardinality integer grids (here: 16^3 x
8^3), so tree splits can be found with *histograms* (bincount per feature
value) instead of per-node sorts — and, crucially, ALL trees of ALL forests
of an experiment cell can be grown level-synchronously in one numpy pass
(the LightGBM trick, applied across the forest/experiment axes).

This replaces the per-node recursive CART in ``forest.py`` for the ``rf``
searcher and the paper's experiment matrix.  ``forest.py`` remains the
reference implementation the two are cross-checked against.

Semantics per tree match sklearn's RandomForestRegressor defaults used by
the paper: bootstrap resampling, variance-reduction (SSE) splits over all
features, grown to purity (min_samples_leaf=1, min_samples_split=2).
"""

from __future__ import annotations

import numpy as np

#: forests descended together in one predict pass (bounds its gather arrays)
_CHUNK_FORESTS = 32


class BatchedForest:
    """G independent forests fit simultaneously.

    Parameters
    ----------
    cards: per-feature cardinalities (features are integer indices in
        ``[0, card)``).
    """

    def __init__(
        self,
        cards: np.ndarray,
        n_estimators: int = 100,
        max_depth: int = 32,
        min_samples_leaf: int = 1,
        min_samples_split: int = 2,
        seed: int = 0,
    ):
        self.cards = np.asarray(cards, dtype=np.int64)
        self.n_estimators = n_estimators
        self.max_depth = max_depth
        self.min_samples_leaf = min_samples_leaf
        self.min_samples_split = min_samples_split
        self.seed = seed
        # node storage (filled by fit)
        self.feature: np.ndarray | None = None  # (M,) int32, -1 => leaf
        self.thresh: np.ndarray | None = None   # (M,) int32 (go left if x <= t)
        self.left: np.ndarray | None = None     # (M,) int64
        self.right: np.ndarray | None = None    # (M,) int64
        self.value: np.ndarray | None = None    # (M,) float64
        self.root: np.ndarray | None = None     # (B,) roots, B = G * T
        self.n_forests = 0

    # ------------------------------------------------------------------ fit
    def fit(
        self,
        X: np.ndarray,
        y: np.ndarray,
        bootstrap_idx: np.ndarray | None = None,
    ) -> "BatchedForest":
        """X: (G, n, d) integer indices; y: (G, n).

        ``bootstrap_idx`` optionally supplies the per-tree resampling rows,
        shape ``(G * n_estimators, n)`` — forest ``g`` uses rows
        ``[g*T, (g+1)*T)``.  The work-unit layer uses this to fit a SLICE of
        an experiment cell with the exact draws the full-cell fit would
        have used, keeping within-cell splits bit-identical.  Default:
        drawn here from ``seed`` (one ``integers(0, n, (G*T, n))`` call, so
        an external draw of the full cell sliced to ``[lo*T, hi*T)``
        reproduces it exactly).
        """
        X = np.asarray(X)
        y = np.asarray(y, dtype=np.float64)
        if X.ndim == 2:
            X, y = X[None], y[None]
        G, n, d = X.shape
        T = self.n_estimators
        B = G * T
        self.n_forests = G

        # bootstrap: each tree resamples n rows from its forest's data
        if bootstrap_idx is None:
            rng = np.random.default_rng(self.seed)
            samp = rng.integers(0, n, size=(B, n))
        else:
            samp = np.asarray(bootstrap_idx)
            if samp.shape != (B, n):
                raise ValueError(
                    f"bootstrap_idx shape {samp.shape} != ({B}, {n})"
                )
        forest_of_tree = np.repeat(np.arange(G), T)
        Xb = X[forest_of_tree[:, None], samp]          # (B, n, d)
        yb = y[forest_of_tree[:, None], samp]          # (B, n)

        # flatten to the sample axis
        Xv = Xb.reshape(B * n, d).astype(np.int64)
        yv = yb.reshape(B * n)

        # growing node tables
        feature = [np.full(B, -1, dtype=np.int32)]
        thresh = [np.zeros(B, dtype=np.int32)]
        left = [np.full(B, -1, dtype=np.int64)]
        right = [np.full(B, -1, dtype=np.int64)]
        value = [np.zeros(B, dtype=np.float64)]
        n_nodes = B
        self.root = np.arange(B, dtype=np.int64)

        # frontier state: every active sample points at a frontier slot
        leaf = np.repeat(np.arange(B, dtype=np.int64), n)  # frontier slot per sample
        frontier_nodes = np.arange(B, dtype=np.int64)       # node id per slot
        active = np.ones(B * n, dtype=bool)
        depth = 0
        min_leaf = self.min_samples_leaf

        while len(frontier_nodes) and depth < self.max_depth:
            F = len(frontier_nodes)
            lv, Xa, ya = leaf[active], Xv[active], yv[active]
            N = np.bincount(lv, minlength=F).astype(np.float64)
            S = np.bincount(lv, weights=ya, minlength=F)
            base = np.where(N > 0, S * S / np.maximum(N, 1.0), 0.0)

            best_gain = np.full(F, 1e-12)
            best_feat = np.full(F, -1, dtype=np.int64)
            best_thr = np.zeros(F, dtype=np.int64)
            for f in range(d):
                V = int(self.cards[f])
                key = lv * V + Xa[:, f]
                cnt = np.bincount(key, minlength=F * V).reshape(F, V)
                ysum = np.bincount(key, weights=ya, minlength=F * V).reshape(F, V)
                cl = cnt.cumsum(1)[:, :-1].astype(np.float64)
                sl = ysum.cumsum(1)[:, :-1]
                nr = N[:, None] - cl
                sr = S[:, None] - sl
                ok = (cl >= min_leaf) & (nr >= min_leaf)
                score = np.where(
                    ok,
                    sl * sl / np.maximum(cl, 1.0) + sr * sr / np.maximum(nr, 1.0),
                    -np.inf,
                )
                t = score.argmax(1)
                g = score[np.arange(F), t] - base
                better = g > best_gain
                best_gain = np.where(better, g, best_gain)
                best_feat = np.where(better, f, best_feat)
                best_thr = np.where(better, t, best_thr)

            split = (best_feat >= 0) & (N >= self.min_samples_split)
            # finalize non-splitting leaves
            done = ~split
            value_arr = np.where(N > 0, S / np.maximum(N, 1.0), 0.0)
            if done.any():
                nodes_done = frontier_nodes[done]
                self._scatter(value, nodes_done, value_arr[done])
            if not split.any():
                break

            # allocate children for splitting leaves
            n_split = int(split.sum())
            kids = n_nodes + np.arange(2 * n_split, dtype=np.int64)
            n_nodes += 2 * n_split
            for arr, fill in (
                (feature, np.full(2 * n_split, -1, dtype=np.int32)),
                (thresh, np.zeros(2 * n_split, dtype=np.int32)),
                (left, np.full(2 * n_split, -1, dtype=np.int64)),
                (right, np.full(2 * n_split, -1, dtype=np.int64)),
                (value, np.zeros(2 * n_split, dtype=np.float64)),
            ):
                arr.append(fill)
            nodes_split = frontier_nodes[split]
            self._scatter(feature, nodes_split, best_feat[split].astype(np.int32))
            self._scatter(thresh, nodes_split, best_thr[split].astype(np.int32))
            self._scatter(left, nodes_split, kids[0::2])
            self._scatter(right, nodes_split, kids[1::2])

            # route samples: new frontier slot = 2*rank(split leaf) (+1 right)
            slot_of_leaf = np.full(F, -1, dtype=np.int64)
            slot_of_leaf[split] = np.arange(n_split) * 2
            samp_slot = slot_of_leaf[lv]
            still = samp_slot >= 0
            f_per = best_feat[lv[still]]
            x_per = Xa[still][np.arange(int(still.sum())), f_per]
            go_left = x_per <= best_thr[lv[still]]
            new_leaf = samp_slot[still] + np.where(go_left, 0, 1)

            # compact the active set
            idx_active = np.flatnonzero(active)
            keep = idx_active[still]
            active[:] = False
            active[keep] = True
            leaf[keep] = new_leaf
            frontier_nodes = kids
            depth += 1

        # any frontier leaves left at max depth: finalize with their mean
        if len(frontier_nodes):
            lv, ya = leaf[active], yv[active]
            F = len(frontier_nodes)
            N = np.bincount(lv, minlength=F).astype(np.float64)
            S = np.bincount(lv, weights=ya, minlength=F)
            self._scatter(value, frontier_nodes, np.where(N > 0, S / np.maximum(N, 1), 0.0))

        self.feature = np.concatenate(feature)
        self.thresh = np.concatenate(thresh)
        self.left = np.concatenate(left)
        self.right = np.concatenate(right)
        self.value = np.concatenate(value)
        return self

    @staticmethod
    def _scatter(chunks: list[np.ndarray], idx: np.ndarray, vals: np.ndarray) -> None:
        """Scatter into a chunked (growing) array by global index."""
        offsets = np.cumsum([0] + [len(c) for c in chunks])
        for i, c in enumerate(chunks):
            m = (idx >= offsets[i]) & (idx < offsets[i + 1])
            if m.any():
                c[idx[m] - offsets[i]] = vals[m]

    def _freeze_leaves(self) -> None:
        """Make leaves self-looping so predict needs no masking:
        leaf.left = leaf.right = leaf, leaf.feature = 0, leaf.thresh = big."""
        if getattr(self, "_frozen", False):
            return
        is_leaf = self.left < 0
        ids = np.arange(len(self.left), dtype=np.int64)
        self.left = np.where(is_leaf, ids, self.left)
        self.right = np.where(is_leaf, ids, self.right)
        self.thresh = np.where(is_leaf, np.int32(2**30), self.thresh)
        self.feature = np.where(is_leaf, np.int32(0), self.feature)
        self._is_leaf = is_leaf
        self._frozen = True

    # -------------------------------------------------------------- predict
    def predict(self, Xp: np.ndarray) -> np.ndarray:
        """Xp: (P, d) shared pool or (G, P, d) per-forest pools -> (G, P).

        Level-synchronous descent with self-looping leaves: every iteration
        is 4 flat gathers + a compare over (chunk*T*P,) arrays — no boolean
        mask bookkeeping.  Early-exits when the whole chunk is at leaves.
        """
        if self.feature is None:
            raise RuntimeError("call fit first")
        self._freeze_leaves()
        Xp = np.asarray(Xp)
        shared = Xp.ndim == 2
        G, T = self.n_forests, self.n_estimators
        P = Xp.shape[-2]
        d = Xp.shape[-1]
        out = np.zeros((G, P), dtype=np.float64)
        for g0 in range(0, G, _CHUNK_FORESTS):
            g1 = min(G, g0 + _CHUNK_FORESTS)
            nB = (g1 - g0) * T
            node = np.repeat(self.root[g0 * T : g1 * T], P)  # (nB*P,)
            if shared:
                xp_flat = np.ascontiguousarray(Xp, dtype=np.int32).reshape(-1)
                base = np.tile(np.arange(P, dtype=np.int64) * d, nB)
            else:
                xp_flat = (
                    np.ascontiguousarray(Xp[g0:g1], dtype=np.int32).reshape(-1)
                )
                fidx = np.repeat(np.arange(g1 - g0, dtype=np.int64), T * P)
                base = fidx * (P * d) + np.tile(np.arange(P, dtype=np.int64) * d, nB)
            for _ in range(self.max_depth + 1):
                f = self.feature[node]
                xv = xp_flat[base + f]
                go_left = xv <= self.thresh[node]
                node = np.where(go_left, self.left[node], self.right[node])
                if self._is_leaf[node].all():
                    break
            preds = self.value[node].reshape(g1 - g0, T, P)
            out[g0:g1] = preds.mean(axis=1)
        return out
