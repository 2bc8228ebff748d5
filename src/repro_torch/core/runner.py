"""Matrix result containers and process-invariant seed derivation (a copy of
``repro.core.runner``).

The matrix driver itself lives in :mod:`repro_torch.core.api`: a
:class:`~repro_torch.core.api.TuningSession` owns the (algorithm x
sample-size x experiment) loop, decomposed into work units
(:mod:`repro_torch.core.workunits`) run through the executor registry
(:mod:`repro_torch.core.executors`).
"""

from __future__ import annotations

import json
import os
import zlib
from dataclasses import dataclass, field

import numpy as np


def stable_seed(*parts) -> int:
    """Deterministic 31-bit seed from arbitrary parts (python's ``hash`` is
    process-salted and would break run-to-run reproducibility)."""
    return zlib.crc32("|".join(map(str, parts)).encode()) & 0x7FFFFFFF


@dataclass
class CellResult:
    """All experiments of one (algorithm, sample_size) cell."""

    algo: str
    sample_size: int
    final_values: np.ndarray          # (E,) median-of-10 runtimes
    search_best_values: np.ndarray    # (E,) best value observed during search
    n_samples_used: np.ndarray        # (E,) budget audit
    #: (E, n_params) each experiment's winner as an index vector of the
    #: space, -1 where it has none (the port's own; ``None`` where a fragment
    #: was written without)
    best_indices: np.ndarray | None = None


@dataclass
class MatrixResults:
    cells: dict = field(default_factory=dict)  # (algo, S) -> CellResult
    optimum: float = np.inf

    def add(self, cell: CellResult) -> None:
        self.cells[(cell.algo, cell.sample_size)] = cell
        self.optimum = min(self.optimum, float(cell.final_values.min(initial=np.inf)))

    def finals(self, algo: str, sample_size: int) -> np.ndarray:
        return self.cells[(algo, sample_size)].final_values

    def algorithms(self) -> list[str]:
        return sorted({a for a, _ in self.cells})

    def sample_sizes(self) -> list[int]:
        return sorted({s for _, s in self.cells})

    # -- persistence --------------------------------------------------------
    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        arrays, meta = {}, []
        for i, ((algo, s), cell) in enumerate(sorted(self.cells.items())):
            arrays[f"final_{i}"] = cell.final_values
            arrays[f"search_{i}"] = cell.search_best_values
            arrays[f"nsamp_{i}"] = cell.n_samples_used
            if cell.best_indices is not None:
                arrays[f"best_{i}"] = cell.best_indices
            meta.append({"algo": algo, "sample_size": s, "index": i})
        meta_json = json.dumps({"cells": meta, "optimum": self.optimum})
        np.savez_compressed(path, meta=meta_json, **arrays)

    @classmethod
    def load(cls, path: str) -> "MatrixResults":
        data = np.load(path, allow_pickle=False)
        meta = json.loads(str(data["meta"]))
        out = cls(optimum=meta["optimum"])
        for m in meta["cells"]:
            i = m["index"]
            out.cells[(m["algo"], m["sample_size"])] = CellResult(
                algo=m["algo"],
                sample_size=m["sample_size"],
                final_values=data[f"final_{i}"],
                search_best_values=data[f"search_{i}"],
                n_samples_used=data[f"nsamp_{i}"],
                best_indices=data[f"best_{i}"] if f"best_{i}" in data.files else None,
            )
        return out
