"""Particle Swarm Optimization — beyond-paper searcher (CLTune related work),
a copy of ``repro.core.searchers.pso``.

Particles live in the continuous unit cube and are decoded to index vectors
for measurement (standard discrete-PSO relaxation).  Velocity update with
inertia w, cognitive c1, social c2 (Kernel-Tuner-like defaults).

Synchronous PSO under the ask/tell engine: every iteration moves the whole
swarm using the previous iteration's personal/global bests, then proposes
all particle positions as ONE batch (the textbook synchronous variant —
per-particle gbest updates would serialize the swarm)."""

from __future__ import annotations

import numpy as np

from .base import ProposalGen, Searcher, TuningResult, register


@register
class ParticleSwarm(Searcher):
    name = "pso"
    uses_constraints = True

    def __init__(
        self,
        space,
        seed: int = 0,
        n_particles: int = 16,
        w: float = 0.7,
        c1: float = 1.6,
        c2: float = 1.6,
    ):
        super().__init__(space, seed)
        self.n_particles = n_particles
        self.w, self.c1, self.c2 = w, c1, c2

    def _propose(self, budget: int, result: TuningResult) -> ProposalGen:
        n_p = min(self.n_particles, budget)
        d = self.space.n_params
        pos = self.space.to_unit(self.space.sample_indices(self.rng, n_p))
        vel = self.rng.uniform(-0.1, 0.1, size=(n_p, d))

        def repair(p: np.ndarray) -> np.ndarray:
            """Re-seed constraint-violating particles at valid random
            positions (the swarm must only propose measurable configs)."""
            bad = ~self.space.valid_mask(self.space.from_unit(p))
            if bad.any():
                p = p.copy()
                p[bad] = self.space.to_unit(
                    self.space.sample_indices(self.rng, int(bad.sum()))
                )
            return p

        def decode_all(p: np.ndarray) -> list:
            return self.space.decode_batch(self.space.from_unit(p))

        pbest_v = yield decode_all(pos)
        pbest = pos.copy()
        g = int(np.argmin(pbest_v))
        gbest, gbest_v = pbest[g].copy(), pbest_v[g]

        while True:
            r1 = self.rng.random((n_p, d))
            r2 = self.rng.random((n_p, d))
            vel = (
                self.w * vel
                + self.c1 * r1 * (pbest - pos)
                + self.c2 * r2 * (gbest[None, :] - pos)
            )
            pos = repair(np.clip(pos + vel, 0.0, 1.0))
            vals = yield decode_all(pos)
            improved = vals < pbest_v
            pbest[improved] = pos[improved]
            pbest_v = np.where(improved, vals, pbest_v)
            g = int(np.argmin(pbest_v))
            if pbest_v[g] < gbest_v:
                gbest, gbest_v = pbest[g].copy(), pbest_v[g]
