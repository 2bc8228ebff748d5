"""``repro_torch.staticcheck`` — the port's static gate (a port of
``repro.staticcheck``, aimed at this package).

Every claim table the port emits rests on invariants the test suite can
only establish by *re-running* things: bit-identical results across
executors, speed knobs excluded from cache keys, JSON-round-trippable specs,
complete registries.  This package checks those invariants **statically, in
seconds** — before any kernel build, any measurement, any multi-million-sample
matrix.  It has the reference's rule catalog, rule ids, CLI and suppression
syntax:

* :mod:`.det`   — DET rules: no non-injected wall clock, no unseeded global
  randomness, no unordered-set iteration in determinism-critical modules
  (``repro_torch/core/``, ``repro_torch/cuda_bench/``).
* :mod:`.prov`  — PROV rules: speed knobs (``pipeline_workers`` & friends)
  provably never reach cache keys, journal namespaces, spec fingerprints.
* :mod:`.reg`   — REG rules: the port's SEARCHERS / BACKENDS / EXECUTORS /
  STORES / KERNEL_BENCHES / TUNABLE_KERNELS registries are complete and
  constructible, without building or launching a kernel.
* :mod:`.ser`   — SER rules: specs and registered kwargs stay
  JSON-representable; no callables sneak into serialized paths.
* :mod:`.lib`   — LIB rules: no bare ``assert`` for runtime errors in
  library code (stripped under ``python -O``).
* :mod:`.spec_rules` — the spec-level pre-flight: space size, unsatisfiable
  constraints, seed-namespace collisions for a :class:`TuningSpec` or the
  full paper design.

Run it::

    python -m repro_torch.staticcheck src/repro_torch   # lint the port's tree
    python -m repro_torch.staticcheck --preflight-paper
    python -m repro_torch.staticcheck --list-rules

Findings carry rule ids and ``file:line``; ``--format github`` emits CI
annotations; a trailing ``# repro: allow[RULE]`` comment suppresses a rule
(or a whole family: ``# repro: allow[DET]``) on that line — the same comment
both packages' gates read.
"""

from __future__ import annotations

from .catalog import RULES, Rule
from .findings import Finding, format_finding, suppressions_for
from .runner import check_paths
from .spec_rules import preflight_design, preflight_paper, preflight_spec

__all__ = [
    "RULES",
    "Finding",
    "Rule",
    "check_paths",
    "format_finding",
    "preflight_design",
    "preflight_paper",
    "preflight_spec",
    "suppressions_for",
]
