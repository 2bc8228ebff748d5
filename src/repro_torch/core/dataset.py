"""Pre-generated sample datasets (paper section VI.B; a copy of
``repro.core.dataset``).

'For our non-SMBO approaches, we streamline the experimental sample
collection process by creating a dataset of 20 000 samples in one go for each
architecture and benchmark. We can then subdivide the samples for each sample
size and experiment.'

RS experiments draw disjoint chunks of S samples; RF experiments draw chunks
of S-10 for training.  Chunking is deterministic given the dataset seed.

Generation routes through ``measure_batch`` — on the vectorized cost-model
backend the whole 20k-sample dataset is ONE Python-level dispatch — and can
be persisted (``save``/``load`` or ``generate(..., cache_path=...)``) so a
re-run of the same (kernel, seed) combo never re-measures it.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from .measurement import BaseMeasurement
from .space import SearchSpace


@dataclass
class SampleDataset:
    space: SearchSpace
    indices: np.ndarray   # (n, d) index vectors
    values: np.ndarray    # (n,) measured runtimes

    @classmethod
    def generate(
        cls,
        space: SearchSpace,
        measurement: BaseMeasurement,
        n: int = 20000,
        seed: int = 0,
        cache_path: str | None = None,
    ) -> "SampleDataset":
        rng = np.random.default_rng(seed)
        idx = space.sample_indices(rng, n)
        if cache_path is not None and os.path.exists(cache_path):
            ds = cls.load(space, cache_path)
            # the cache is only valid for this exact draw: same n, same
            # sample seed, same space (a changed measurement seed writes a
            # new file at the caller's discretion; a changed sample stream
            # is detected here by index equality)
            if len(ds) == n and np.array_equal(ds.indices, idx):
                return ds
        vals = measurement.measure_batch(space.decode_batch(idx))
        ds = cls(space=space, indices=idx, values=np.asarray(vals, dtype=np.float64))
        if cache_path is not None:
            ds.save(cache_path)
        return ds

    def save(self, path: str) -> None:
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        # write through a file handle so the data lands at ``path`` exactly
        # (np.savez_compressed appends '.npz' to bare string paths, which
        # would break the generate() existence check)
        with open(path, "wb") as f:
            np.savez_compressed(f, indices=self.indices, values=self.values)

    @classmethod
    def load(cls, space: SearchSpace, path: str) -> "SampleDataset":
        data = np.load(path, allow_pickle=False)
        return cls(space=space, indices=data["indices"], values=data["values"])

    def __len__(self) -> int:
        return len(self.values)

    def chunk(self, experiment: int, size: int) -> tuple[np.ndarray, np.ndarray]:
        """Disjoint chunk ``experiment`` of ``size`` samples (wraps around if
        the design over-asks, which the paper's design never does)."""
        start = (experiment * size) % len(self)
        stop = start + size
        if stop <= len(self):
            sl = slice(start, stop)
            return self.indices[sl], self.values[sl]
        first = len(self) - start
        return (
            np.concatenate([self.indices[start:], self.indices[: size - first]]),
            np.concatenate([self.values[start:], self.values[: size - first]]),
        )

    @property
    def optimum(self) -> float:
        """Best runtime observed in the dataset (used as the denominator of
        'percentage of optimum' alongside search-discovered optima)."""
        return float(self.values.min())
