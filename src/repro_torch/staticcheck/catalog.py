"""The invariant catalog: every rule the checker can emit, by id.

Rule ids are stable API — suppression comments, ``--select``, CI
annotations, and both packages' gates refer to them: the port's catalog
has the reference's ids, each summary aimed at the port's modules.  Add
rules; never renumber them.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Rule:
    id: str
    family: str
    summary: str
    severity: str = "error"


_ALL = (
    # -- DET: determinism of results -----------------------------------------
    Rule(
        "DET001",
        "DET",
        "non-injected wall clock (time.time/perf_counter/datetime.now...) in "
        "a determinism-critical module; route through repro_torch.core.clock",
    ),
    Rule(
        "DET002",
        "DET",
        "unseeded global randomness (np.random.* module state, stdlib "
        "random.*) in a determinism-critical module; use "
        "np.random.default_rng(seed)",
    ),
    Rule(
        "DET003",
        "DET",
        "iteration over an unordered set feeds downstream order; wrap in "
        "sorted() or use a deterministic container",
    ),
    # -- PROV: provenance / cache-key hygiene --------------------------------
    Rule(
        "PROV001",
        "PROV",
        "a speed knob (max_workers/executor/futures_pool/scheduler) "
        "is injected into a TuningSpec's backend_kwargs but not excluded by a "
        "cache-key / journal-namespace / fingerprint sink "
        "(repro_torch.core.api, repro_torch.analysis.report)",
    ),
    # -- OBS: observability isolation ----------------------------------------
    Rule(
        "OBS001",
        "OBS",
        "a telemetry/trace identifier appears inside a cache-key / "
        "journal-namespace / fingerprint sink — telemetry is a pure "
        "observability knob and must never reach run identity",
    ),
    # -- REG: registry completeness ------------------------------------------
    Rule(
        "REG001",
        "REG",
        "a SEARCHERS entry does not implement _propose or cannot be "
        "constructed from JSON kwargs",
    ),
    Rule(
        "REG002",
        "REG",
        "a BACKENDS / EXECUTORS / STORES entry is malformed (missing "
        "callables, wrong interface)",
    ),
    Rule(
        "REG003",
        "REG",
        "a kernel package publishes an incomplete ops/ref/csrc triple "
        "into repro_torch.kernels.KERNEL_BENCHES / TUNABLE_KERNELS",
    ),
    # -- SER: serialization ---------------------------------------------------
    Rule(
        "SER001",
        "SER",
        "TuningSpec does not JSON round-trip (field defaults or to_dict/"
        "from_dict drift)",
    ),
    Rule(
        "SER002",
        "SER",
        "a registered searcher/backend declares non-JSON-representable "
        "constructor defaults on a serializable path",
    ),
    Rule(
        "SER003",
        "SER",
        "a callable (lambda) is embedded in a *_kwargs dict bound for "
        "serialization",
    ),
    # -- LIB: library hygiene -------------------------------------------------
    Rule(
        "LIB001",
        "LIB",
        "bare assert used for a runtime error in library code (stripped "
        "under python -O); raise a real exception",
    ),
    # -- SPEC: the pre-flight (spec-level, not per-file) ----------------------
    Rule("SPEC001", "SPEC", "search-space size / constrained fraction", "info"),
    Rule(
        "SPEC002",
        "SPEC",
        "the constrained search space is empty or unsatisfiable",
    ),
    Rule(
        "SPEC003",
        "SPEC",
        "experiment-seed namespace collision: two cells share a cache/seed "
        "namespace entry",
    ),
    Rule(
        "SPEC004",
        "SPEC",
        "paper-scale design without a persistent measurement store",
        "warning",
    ),
    Rule(
        "SPEC005",
        "SPEC",
        "design rows with too few experiments for decidable claim verdicts",
        "info",
    ),
    # -- the checker itself ---------------------------------------------------
    Rule("PARSE", "PARSE", "file does not parse"),
)

RULES: dict[str, Rule] = {r.id: r for r in _ALL}

FAMILIES: tuple[str, ...] = tuple(
    sorted({r.family for r in _ALL if r.family != "PARSE"})
)


def resolve_select(select: str | None) -> frozenset[str] | None:
    """``--select`` tokens -> concrete rule-id set (families expand)."""
    if not select:
        return None
    out: set[str] = set()
    for tok in select.split(","):
        tok = tok.strip()
        if not tok:
            continue
        if tok in RULES:
            out.add(tok)
        elif any(r.family == tok for r in _ALL):
            out.update(r.id for r in _ALL if r.family == tok)
        else:
            raise KeyError(
                f"unknown rule or family {tok!r}; see --list-rules"
            )
    return frozenset(out)
