"""Search-space definitions for autotuning.

The paper's space: 6 integer parameters — thread dims {X,Y,Z}_t in [1..16]
and work-group dims {X,Y,Z}_w in [1..8] — giving |S| = 2,097,152 configs,
with the constraint prod(workgroup) <= 256 available only to non-SMBO
methods.  The port keeps the reference's cardinalities and sampling code
verbatim (a copy of ``repro.core.space``), so the same seed proposes the same
configs in both packages.  The machinery is generic: integer ranges,
categorical choices, optional log2 semantics, and arbitrary predicate
constraints.

Configs are plain dicts ``{param_name: value}``.  Internally every searcher
works on an *index vector* (one integer index per parameter) so crossover,
mutation, Parzen estimators and tree splits are uniform across param types.

A constraint may carry a ``batch`` attribute: a function of the value
columns of many configs (``{name: int64 array}``) that returns the
predicate's verdict for each as a bool array.  :meth:`SearchSpace.valid_mask`
screens with it, in one numpy pass, when every parameter's values are
integers; otherwise it calls the predicate once a config.  The verdicts are
the same either way, so the draws, proposals and random streams are too.
"""

from __future__ import annotations

import itertools
import threading
from dataclasses import dataclass
from typing import Callable, Iterator, Sequence

import numpy as np

Config = dict
ConstraintFn = Callable[[Config], bool]


@dataclass(frozen=True)
class Param:
    """A single tunable parameter over an explicit, ordered value list."""

    name: str
    values: tuple

    @staticmethod
    def int_range(name: str, lo: int, hi: int) -> "Param":
        """Inclusive integer range [lo..hi]."""
        return Param(name, tuple(range(lo, hi + 1)))

    @staticmethod
    def pow2(name: str, lo: int, hi: int) -> "Param":
        """Powers of two 2**lo .. 2**hi."""
        return Param(name, tuple(2**e for e in range(lo, hi + 1)))

    @staticmethod
    def choice(name: str, options: Sequence) -> "Param":
        return Param(name, tuple(options))

    @property
    def cardinality(self) -> int:
        return len(self.values)

    def index_of(self, value) -> int:
        return self.values.index(value)


class SearchSpace:
    """An ordered collection of :class:`Param` with an optional constraint.

    The constraint mirrors the paper's design point: constrained generation is
    offered to non-SMBO methods (RS/RF dataset generation, GA init), while
    SMBO methods (BO-GP / BO-TPE) search the raw space.  Use
    :meth:`unconstrained` to get the raw view.
    """

    def __init__(self, params: Sequence[Param], constraint: ConstraintFn | None = None):
        if not params:
            raise ValueError("SearchSpace needs at least one Param")
        names = [p.name for p in params]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate param names: {names}")
        self.params: tuple[Param, ...] = tuple(params)
        self.constraint = constraint
        self._cards = np.array([p.cardinality for p in self.params], dtype=np.int64)
        #: each parameter's values as an int64 array, or None where a value
        #: is not an integer or not small (the batch screen then does not
        #: apply)
        self._int_values = (
            tuple(np.array(p.values, dtype=np.int64) for p in self.params)
            if all(_is_int(v) for p in self.params for v in p.values) else None
        )
        #: rows screened by :meth:`valid_mask`, and of those the rows screened
        #: through the constraint's ``batch`` form; trace attributes only
        self.screened_rows = 0
        self.screened_batched = 0
        self._count_lock = threading.Lock()

    # -- basic properties ---------------------------------------------------
    @property
    def names(self) -> tuple[str, ...]:
        return tuple(p.name for p in self.params)

    @property
    def n_params(self) -> int:
        return len(self.params)

    @property
    def cardinality(self) -> int:
        return int(np.prod(self._cards))

    @property
    def cardinalities(self) -> np.ndarray:
        return self._cards.copy()

    def unconstrained(self) -> "SearchSpace":
        return SearchSpace(self.params, constraint=None)

    def with_constraint(self, fn: ConstraintFn) -> "SearchSpace":
        return SearchSpace(self.params, constraint=fn)

    # -- encode / decode ----------------------------------------------------
    def decode(self, idx: np.ndarray) -> Config:
        """Index vector -> config dict."""
        return {p.name: p.values[int(i)] for p, i in zip(self.params, idx, strict=True)}

    def encode(self, config: Config) -> np.ndarray:
        return np.array(
            [p.index_of(config[p.name]) for p in self.params], dtype=np.int64
        )

    def decode_batch(self, idxs: np.ndarray) -> list[Config]:
        return [self.decode(row) for row in idxs]

    def encode_batch(self, configs: Sequence[Config]) -> np.ndarray:
        """Config dicts -> (n, d) index-vector matrix (inverse of
        :meth:`decode_batch`) — for external ask/tell loops that key their
        evaluation history by index row rather than by config dict."""
        lut = [{v: i for i, v in enumerate(p.values)} for p in self.params]
        try:
            return np.array(
                [[m[c[p.name]] for p, m in zip(self.params, lut, strict=True)] for c in configs],
                dtype=np.int64,
            ).reshape(len(configs), self.n_params)
        except KeyError as e:
            raise ValueError(f"config value {e.args[0]!r} not in this space") from e

    def to_unit(self, idxs: np.ndarray) -> np.ndarray:
        """Index vectors -> points in the unit cube (for GP kernels).

        Cell-centred: index i of a k-ary param maps to (i + 0.5) / k.
        """
        return (idxs.astype(np.float64) + 0.5) / self._cards.astype(np.float64)

    def from_unit(self, x: np.ndarray) -> np.ndarray:
        idx = np.floor(np.clip(x, 0.0, np.nextafter(1.0, 0.0)) * self._cards)
        return idx.astype(np.int64)

    # -- validity -----------------------------------------------------------
    def is_valid(self, config: Config) -> bool:
        return self.constraint is None or bool(self.constraint(config))

    def valid_mask(self, idxs: np.ndarray) -> np.ndarray:
        if self.constraint is None:
            return np.ones(len(idxs), dtype=bool)
        batch = getattr(self.constraint, "batch", None)
        batched = batch is not None and self._int_values is not None
        with self._count_lock:
            self.screened_rows += len(idxs)
            self.screened_batched += len(idxs) if batched else 0
        if batched:
            columns = {p.name: v[idxs[:, j]] for j, (p, v)
                       in enumerate(zip(self.params, self._int_values, strict=True))}
            return np.asarray(batch(columns), dtype=bool)
        return np.array([self.is_valid(self.decode(r)) for r in idxs], dtype=bool)

    def screened(self) -> tuple[int, int]:
        """(:attr:`screened_rows`, :attr:`screened_batched`), read together."""
        with self._count_lock:
            return self.screened_rows, self.screened_batched

    def __getstate__(self) -> dict:
        state = self.__dict__.copy()
        del state["_count_lock"]
        return state

    def __setstate__(self, state: dict) -> None:
        self.__dict__.update(state)
        self._count_lock = threading.Lock()

    # -- sampling -----------------------------------------------------------
    def sample_indices(self, rng: np.random.Generator, n: int) -> np.ndarray:
        """n random index vectors, rejection-sampled against the constraint."""
        if self.constraint is None:
            return self._raw(rng, n)
        out = np.empty((0, self.n_params), dtype=np.int64)
        # rejection sampling; the paper's constraint keeps ~57% of the space,
        # so a few rounds always suffice for any sane constraint.
        for _ in range(1000):
            cand = self._raw(rng, max(n - len(out), 1) * 2)
            cand = cand[self.valid_mask(cand)]
            out = np.concatenate([out, cand])[: n]
            if len(out) == n:
                return out
        raise RuntimeError("constraint rejection sampling failed to converge")

    def _raw(self, rng: np.random.Generator, n: int) -> np.ndarray:
        cols = [rng.integers(0, c, size=n) for c in self._cards]
        return np.stack(cols, axis=1).astype(np.int64)

    def sample(self, rng: np.random.Generator) -> Config:
        return self.decode(self.sample_indices(rng, 1)[0])

    def sample_batch(self, rng: np.random.Generator, n: int) -> list[Config]:
        return self.decode_batch(self.sample_indices(rng, n))

    # -- enumeration (small spaces / grid search) ----------------------------
    def iter_indices(self) -> Iterator[np.ndarray]:
        for combo in itertools.product(*(range(c) for c in self._cards)):
            yield np.array(combo, dtype=np.int64)

    def mutate(
        self, rng: np.random.Generator, idx: np.ndarray, p_mut: float
    ) -> np.ndarray:
        """Per-gene uniform resample with probability ``p_mut`` (GA/SA)."""
        out = idx.copy()
        for j, c in enumerate(self._cards):
            if rng.random() < p_mut:
                out[j] = rng.integers(0, c)
        return out

    def mutate_batch(
        self, rng: np.random.Generator, idx: np.ndarray, p_mut: float, n: int
    ) -> np.ndarray:
        """n independent mutations of one index vector, fully vectorized."""
        out = np.broadcast_to(idx, (n, self.n_params)).copy()
        mask = rng.random((n, self.n_params)) < p_mut
        rand = self._raw(rng, n)
        return np.where(mask, rand, out)

    def flat_keys(self, idxs: np.ndarray) -> np.ndarray:
        """Row-wise unique int64 key (mixed-radix encoding) for dedup."""
        strides = np.concatenate(
            [np.cumprod(self._cards[::-1])[::-1][1:], [1]]
        ).astype(np.int64)
        return idxs @ strides

    def neighbor(self, rng: np.random.Generator, idx: np.ndarray) -> np.ndarray:
        """+-1 step on one random axis (simulated-annealing move)."""
        out = idx.copy()
        j = int(rng.integers(0, self.n_params))
        step = 1 if rng.random() < 0.5 else -1
        out[j] = int(np.clip(out[j] + step, 0, self._cards[j] - 1))
        return out

    def __repr__(self) -> str:  # pragma: no cover
        ps = ", ".join(f"{p.name}[{p.cardinality}]" for p in self.params)
        constrained = self.constraint is not None
        return f"SearchSpace({ps}, |S|={self.cardinality}, constrained={constrained})"


#: a batch screen takes integer values within this bound, so the products
#: of a few values that a constraint forms cannot wrap in int64 as Python's
#: integers would not
_BATCH_VALUE_LIMIT = 2**20


def _is_int(v) -> bool:
    return (isinstance(v, (int, np.integer)) and not isinstance(v, bool)
            and abs(int(v)) < _BATCH_VALUE_LIMIT)


def _paper_wg256(cfg: Config) -> bool:
    """The paper's workgroup constraint: prod(w) <= 256 threads."""
    return cfg["w_x"] * cfg["w_y"] * cfg["w_z"] <= 256


def _paper_wg256_batch(columns: dict[str, np.ndarray]) -> np.ndarray:
    return columns["w_x"] * columns["w_y"] * columns["w_z"] <= 256


#: stable id used by TuningSpec serialization (see repro_torch.core.api)
_paper_wg256.constraint_id = "paper_wg256"
_paper_wg256.batch = _paper_wg256_batch


def paper_space(constrained: bool = True) -> SearchSpace:
    """The paper's 6-parameter space, as the reference defines it.

    t_x, t_y, t_z in [1..16]  (block-row mult, block-col mult, coarsening)
    w_x, w_y, w_z in [1..8]   (grid splits, pipeline depth)

    |S| = 16^3 * 8^3 = 2,097,152.  The paper's constraint prod(w) <= 256 maps
    onto the *raw parameter* form used by the paper; per-kernel resource
    limits are applied by the measurement backend (see
    repro_torch.cuda_bench.validity).  Here we keep the paper's exact
    arithmetic constraint so the constrained/unconstrained split matches.
    """
    params = [
        Param.int_range("t_x", 1, 16),
        Param.int_range("t_y", 1, 16),
        Param.int_range("t_z", 1, 16),
        Param.int_range("w_x", 1, 8),
        Param.int_range("w_y", 1, 8),
        Param.int_range("w_z", 1, 8),
    ]
    return SearchSpace(params, constraint=_paper_wg256 if constrained else None)
