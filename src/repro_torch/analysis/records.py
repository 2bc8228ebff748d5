"""Loading matrix results + versioned :class:`RunRecord` metadata from disk.

A results directory (see ``docs/analysis_and_report.md`` for the full layout)
holds one ``<bench>_<chip>.npz`` / ``<bench>_<chip>.json`` pair per
(benchmark, chip) combo, plus measurement caches (``*_cache.*``), datasets
(``*_dataset_*.npz``) and report artifacts (``figures/``, ``REPORT.md``) the
loader skips.  The JSON side is a versioned RunRecord (the ``tune_matrix``
facade's output); the legacy flat meta dict written before the record
existed is still accepted.
"""

from __future__ import annotations

import json
import os

from ..core import MatrixResults

#: the paper's five algorithms, in its fixed presentation order.  Every
#: table, figure, and color assignment downstream uses THIS order — never a
#: per-call ordering — so an algorithm keeps its identity across artifacts.
ALGOS = ("rs", "rf", "ga", "bo_gp", "bo_tpe")


def normalize_meta(meta: dict) -> dict:
    """Accept both a versioned RunRecord dict and the legacy flat meta dict;
    always expose:

    * ``meta["optimum"]`` — the pct-of-optimum denominator: the backend's
      noise-free true optimum when recorded, else the best observed final,
    * ``meta["optimum_is_true"]`` — which of the two it was,
    * ``meta["spec"]`` / ``meta["provenance"]`` — empty dicts for legacy
      records,
    * ``meta["backend"]`` — which measurement produced the numbers
      ("costmodel" analytical vs "cuda" real execution; the
      ``backend_provenance`` extra carries the detail when recorded).  The
      ``cuda`` backend records no true optimum, so its denominator is the
      best observed final.
    """
    if "run_record_version" not in meta:
        out = dict(meta)
        out.setdefault("optimum_is_true", "optimum" in meta)
        out.setdefault("spec", {})
        out.setdefault("provenance", {})
        out.setdefault("backend", "costmodel")
        return out
    result = dict(meta.get("result", {}))
    flat = {**meta.get("extra", {}), **result}
    flat["optimum"] = result.get("true_optimum", result.get("best_observed"))
    flat["optimum_is_true"] = "true_optimum" in result
    flat["spec"] = meta.get("spec", {})
    flat["provenance"] = meta.get("provenance", {})
    flat["run_record_version"] = meta["run_record_version"]
    flat["backend"] = flat["spec"].get("backend", "costmodel")
    return flat


def load_all(results_dir: str) -> dict:
    """``{(bench, chip): (MatrixResults, meta)}`` for every stored combo.

    ``meta`` is the :func:`normalize_meta` flat view of the combo's
    RunRecord.  Raises ``FileNotFoundError`` when the directory does not
    exist; returns ``{}`` when it holds no result pairs.
    """
    out = {}
    for fname in sorted(os.listdir(results_dir)):
        if not fname.endswith(".npz") or "_dataset_" in fname:
            continue
        bench, chip = fname[:-4].rsplit("_", 1)
        res = MatrixResults.load(os.path.join(results_dir, fname))
        with open(os.path.join(results_dir, f"{bench}_{chip}.json")) as f:
            meta = normalize_meta(json.load(f))
        out[(bench, chip)] = (res, meta)
    return out


def present_algorithms(results: dict) -> list[str]:
    """Algorithms present in every loaded combo, in the canonical order."""
    present = None
    for res, _ in results.values():
        algos = {a for a, _ in res.cells}
        present = algos if present is None else (present & algos)
    present = present or set()
    return [a for a in ALGOS if a in present] + sorted(
        a for a in present if a not in ALGOS
    )
