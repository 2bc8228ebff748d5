"""Search-space definitions for autotuning.

The paper's space: 6 integer parameters — thread dims {X,Y,Z}_t in [1..16]
and work-group dims {X,Y,Z}_w in [1..8] — giving |S| = 2,097,152 configs,
with the constraint prod(workgroup) <= 256 available only to non-SMBO
methods.  The port keeps the reference's cardinalities and sampling code
verbatim (a copy of ``repro.core.space``), so the same seed proposes the same
configs in both packages.  The machinery is generic: integer ranges,
categorical choices and predicate constraints; what the unported searchers
need beyond that (unit-cube maps, enumeration, neighbour moves) comes with
them.

Configs are plain dicts ``{param_name: value}``.  Internally every searcher
works on an *index vector* (one integer index per parameter) so crossover,
mutation, Parzen estimators and tree splits are uniform across param types.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Sequence

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

    # -- validity -----------------------------------------------------------
    def is_valid(self, config: Config) -> bool:
        return self.constraint is None or bool(self.constraint(config))

    def valid_mask(self, idxs: np.ndarray) -> np.ndarray:
        if self.constraint is None:
            return np.ones(len(idxs), dtype=bool)
        return np.array([self.is_valid(self.decode(r)) for r in idxs], dtype=bool)

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


    def mutate(
        self, rng: np.random.Generator, idx: np.ndarray, p_mut: float
    ) -> np.ndarray:
        """Per-gene uniform resample with probability ``p_mut`` (GA/SA)."""
        out = idx.copy()
        for j, c in enumerate(self._cards):
            if rng.random() < p_mut:
                out[j] = rng.integers(0, c)
        return out

    def __repr__(self) -> str:  # pragma: no cover
        ps = ", ".join(f"{p.name}[{p.cardinality}]" for p in self.params)
        constrained = self.constraint is not None
        return f"SearchSpace({ps}, |S|={self.cardinality}, constrained={constrained})"


def _paper_wg256(cfg: Config) -> bool:
    """The paper's workgroup constraint: prod(w) <= 256 threads."""
    return cfg["w_x"] * cfg["w_y"] * cfg["w_z"] <= 256


#: stable id used by TuningSpec serialization (see repro_torch.core.api)
_paper_wg256.constraint_id = "paper_wg256"


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
