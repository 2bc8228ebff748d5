"""Genetic Algorithm, following van Werkhoven's Kernel Tuner implementation
(the paper: 'we based our Genetic Algorithm implementation on the
implementation that van Werkhoven used in their study').

Kernel Tuner's GA (kernel_tuner/strategies/genetic_algorithm.py):
  * population size 20, generations = budget / popsize,
  * selection: population sorted by fitness, the better half survives,
  * crossover: "single_point" / uniform mix of two parents — we use the
    paper's description: half the variables from parent A, half from B,
  * mutation: each gene mutates with low probability (10%).

Each generation is proposed as ONE batch through the ask/tell engine.
Re-visited chromosomes consume no extra budget (their previous observation
is reused), matching tuners that memoize; the engine trims the final batch
so the search stops precisely at the sample budget.

Late in a run the population converges and most offspring are revisits, so
the post-dedup proposal batches shrink (~3x smaller than the population on
the paper space).  With ``refill=True`` (default) the GA speculatively
breeds extra offspring until the batch holds a full population's worth of
*unseen* chromosomes (bounded attempts — a fully converged population stops
early), keeping batched dispatch efficient without changing the budget
accounting.  The post-evaluation population is truncated back to
``pop_size`` best, so selection pressure is unchanged.
"""

from __future__ import annotations

import numpy as np

from .base import ProposalGen, Searcher, TuningResult, register


@register
class GeneticAlgorithm(Searcher):
    name = "ga"
    uses_constraints = True

    def __init__(
        self,
        space,
        seed: int = 0,
        pop_size: int = 20,
        p_mut: float = 0.1,
        refill: bool = True,
    ):
        super().__init__(space, seed)
        self.pop_size = pop_size
        self.p_mut = p_mut
        self.refill = refill

    def _crossover(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        """Half the variables from A, the other half from B (paper III.B.2)."""
        d = len(a)
        take_a = np.zeros(d, dtype=bool)
        take_a[self.rng.permutation(d)[: d // 2 + d % 2]] = True
        return np.where(take_a, a, b)

    def _evaluate(self, idxs: np.ndarray, seen: dict):
        """Sub-generator: yield only unseen rows as one batch; return the
        fitness of every row (revisits served from ``seen`` for free)."""
        keys = [tuple(int(v) for v in row) for row in idxs]
        fresh_keys: list = []
        fresh_rows: list = []
        for key, row in zip(keys, idxs, strict=True):
            if key not in seen and key not in fresh_keys:
                fresh_keys.append(key)
                fresh_rows.append(row)
        if fresh_rows:
            vals = yield self.space.decode_batch(np.array(fresh_rows))
            seen.update(zip(fresh_keys, (float(v) for v in vals), strict=True))
        # a trimmed final batch leaves some keys unmeasured; the engine never
        # resumes the generator in that case, so every key is present here.
        return np.array([seen[k] for k in keys], dtype=np.float64)

    def _propose(self, budget: int, result: TuningResult) -> ProposalGen:
        pop_n = min(self.pop_size, budget)
        seen: dict[tuple, float] = {}

        population = self.space.sample_indices(self.rng, pop_n)
        fitness = yield from self._evaluate(population, seen)

        stale = 0  # generations that measured nothing new
        while len(population) >= 2:
            order = np.argsort(fitness)
            n_keep = max(2, len(population) // 2)
            survivors = population[order[:n_keep]]
            target = pop_n - n_keep
            children: list = []
            fresh_keys: set = set()
            attempts = 0
            # base quota: `target` offspring, revisits included.  refill:
            # keep breeding speculative extras until `target` of them are
            # actually UNSEEN (a full post-dedup batch), bounded so a
            # converged population can't spin forever.
            max_attempts = 200 if not self.refill else max(200, 40 * target)
            while attempts < max_attempts and (
                len(children) < target
                or (self.refill and len(fresh_keys) < target)
            ):
                attempts += 1
                i, j = self.rng.choice(n_keep, size=2, replace=False)
                child = self._crossover(survivors[i], survivors[j])
                child = self.space.mutate(self.rng, child, self.p_mut)
                if not self.space.is_valid(self.space.decode(child)):
                    continue
                children.append(child)
                key = tuple(int(v) for v in child)
                if key not in seen:
                    fresh_keys.add(key)
            if not children:
                break
            child_idx = np.array(children)
            n_seen = len(seen)
            child_fit = yield from self._evaluate(child_idx, seen)
            # a small (or fully explored) space can leave every breedable
            # child a revisit: without a yield the generator would spin
            # forever while the engine waits for proposals.  Stop when the
            # space is provably exhausted, or after many consecutive
            # all-revisit generations (a converged population on a large
            # space recovers within a couple via mutation — 50 without a
            # single fresh config means there is nothing left to measure).
            if len(seen) >= self.space.cardinality:
                break
            stale = stale + 1 if len(seen) == n_seen else 0
            if stale >= 50:
                break
            population = np.concatenate([survivors, child_idx])
            fitness = np.concatenate([fitness[order[:n_keep]], child_fit])
            if len(population) > pop_n:
                # speculative extras joined the generation; truncate back to
                # the configured population size (best-first, stable)
                sel = np.argsort(fitness, kind="stable")[:pop_n]
                population, fitness = population[sel], fitness[sel]
