"""Experiment design: the paper's sample-size methodology (a copy of
``repro.core.experiment``).

Section V.B: experiment counts scale inversely with sample size because
result variance falls as the sample size grows.  'With the assumption that we
wanted at least 50 experiments for our sample_size = 400 case, we performed
800 experiments for our sample_size = 25 case and scaled the number of
experiments for the rest of the sample sizes similarly.'

i.e. E(S) = (400 * 50) / S = 20000 / S:

    S:  25  50  100 200 400
    E: 800 400  200 100  50

which also makes every (S, E) row consume exactly the 20,000-sample
pre-generated dataset used by the non-SMBO methods (section VI.B).
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ExperimentDesign:
    sample_sizes: tuple[int, ...]
    n_experiments: tuple[int, ...]
    final_repeats: int = 10

    def __post_init__(self):
        if len(self.sample_sizes) != len(self.n_experiments):
            raise ValueError("sample_sizes and n_experiments length mismatch")

    @classmethod
    def paper(cls) -> "ExperimentDesign":
        return cls(sample_sizes=(25, 50, 100, 200, 400),
                   n_experiments=(800, 400, 200, 100, 50))

    @classmethod
    def scaled(cls, budget: int = 20000,
               sample_sizes: tuple[int, ...] = (25, 50, 100, 200, 400),
               min_experiments: int = 3) -> "ExperimentDesign":
        """Same inverse scaling with a different total budget per cell."""
        return cls(
            sample_sizes=tuple(sample_sizes),
            n_experiments=tuple(max(min_experiments, budget // s) for s in sample_sizes),
        )

    @classmethod
    def smoke(cls) -> "ExperimentDesign":
        """Tiny design for tests."""
        return cls(sample_sizes=(25, 50), n_experiments=(8, 4), final_repeats=3)

    # -- serialization (TuningSpec round-trips through JSON) -----------------
    def to_dict(self) -> dict:
        return {
            "sample_sizes": list(self.sample_sizes),
            "n_experiments": list(self.n_experiments),
            "final_repeats": self.final_repeats,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "ExperimentDesign":
        return cls(
            sample_sizes=tuple(int(s) for s in d["sample_sizes"]),
            n_experiments=tuple(int(e) for e in d["n_experiments"]),
            final_repeats=int(d.get("final_repeats", 10)),
        )

    @property
    def total_search_samples(self) -> int:
        return sum(s * e for s, e in zip(self.sample_sizes, self.n_experiments, strict=True))

    def rows(self):
        return list(zip(self.sample_sizes, self.n_experiments, strict=True))
