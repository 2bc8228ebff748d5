"""The spec-level pre-flight: catch doomed runs before any kernel build.

A paper-exact matrix is ~3M samples; a spec with an unsatisfiable
constraint, a colliding seed namespace, or no persistent store wastes hours
before anyone notices.  Given a :class:`~repro_torch.core.api.TuningSpec` (or the
full paper design), these checks statically resolve the search space and the
experiment plan and report:

* **SPEC001** (info) — resolved space size and the constrained fraction
  (exact enumeration up to 2^16 configs, a seeded 4096-point Monte-Carlo
  estimate above).
* **SPEC002** — the constrained space is empty/unsatisfiable: every search
  would die in rejection sampling.
* **SPEC003** — experiment-seed namespace collisions: two (algo, S, e)
  cells hashing to the same ``stable_seed`` would silently share cached
  measurements under one cache key.
* **SPEC004** (warning) — a paper-scale design (>= 250k search samples)
  with no persistent store: a crash at hour N re-measures everything.
* **SPEC005** (info) — design rows below ``analysis.claims.MIN_EXPERIMENTS``
  leave the paper-claim verdicts undecidable.

``preflight_paper()`` runs the whole battery over the paper's
3-benchmark x 3-chip combo specs — the reference's cost-model specs, so the
two packages' pre-flights compare finding for finding.  A ``cuda`` spec
resolves its space through the backend's ``default_space`` (the CUDA
validity screen of :mod:`repro_torch.cuda_bench.validity`); that builds no
kernel, touches no card and draws no input, whatever the problem size.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np

from .catalog import RULES
from .findings import Finding

#: exact constraint enumeration below this many configs; Monte-Carlo above
EXACT_ENUMERATION_LIMIT = 2**16
MC_SAMPLES = 4096
#: one paper combo is 5 algos x 100k search samples; anything in that class
#: (>= 250k) deserves a persistent store
PAPER_SCALE_SAMPLES = 250_000


def _finding(rule: str, where: str, message: str) -> Finding:
    return Finding(
        path=where,
        line=0,
        rule=rule,
        message=message,
        severity=RULES[rule].severity,
    )


def _resolve_space(spec):
    """The space the session would search, without building a measurement."""
    from ..core.backends import BACKENDS

    if spec.space is not None:
        return spec.space
    backend = BACKENDS[spec.backend]
    if backend.default_space is None:
        return None
    return backend.default_space(kernel=spec.kernel, **spec.backend_kwargs)


def constrained_fraction(space) -> float:
    """Fraction of the raw space satisfying the constraint (exact when the
    space is small, seeded Monte-Carlo when it is not)."""
    if space.constraint is None:
        return 1.0
    total = space.cardinality
    if total <= EXACT_ENUMERATION_LIMIT:
        idxs = np.stack(
            np.meshgrid(
                *[np.arange(c) for c in space.cardinalities], indexing="ij"
            ),
            axis=-1,
        ).reshape(-1, space.n_params)
        return float(space.valid_mask(idxs).mean())
    rng = np.random.default_rng(0)
    raw = space.unconstrained().sample_indices(rng, MC_SAMPLES)
    return float(space.valid_mask(raw).mean())


def check_space(spec, where: str = "<spec>") -> list[Finding]:
    findings: list[Finding] = []
    try:
        space = _resolve_space(spec)
    except Exception as e:  # noqa: BLE001 — unresolvable space IS the finding
        return [
            _finding(
                "SPEC002",
                where,
                f"search space failed to resolve: {type(e).__name__}: {e}",
            )
        ]
    if space is None:
        return [
            _finding(
                "SPEC002",
                where,
                f"backend {spec.backend!r} has no default space and the "
                "spec sets none — the session would refuse to start",
            )
        ]
    total = space.cardinality
    frac = constrained_fraction(space)
    exact = total <= EXACT_ENUMERATION_LIMIT or space.constraint is None
    findings.append(
        _finding(
            "SPEC001",
            where,
            f"space: {total:,} configs across {space.n_params} params; "
            f"constrained fraction {'=' if exact else '~'}{frac:.1%}",
        )
    )
    if total == 0 or frac == 0.0:
        findings.append(
            _finding(
                "SPEC002",
                where,
                "the constrained space admits no configuration — every "
                "search would fail rejection sampling"
                + ("" if exact else f" (0/{MC_SAMPLES} MC samples valid)"),
            )
        )
    return findings


def check_seed_namespace(spec, where: str = "<spec>") -> list[Finding]:
    """Collisions in the DiskCachedMeasurement ``seed=`` namespace."""
    from ..core.runner import stable_seed

    if spec.design is None:
        return []
    seen: dict[int, tuple] = {}
    collisions: list[tuple] = []
    for algo in spec.matrix_algorithms:
        for s, e_total in spec.design.rows():
            for e in range(e_total):
                seed = stable_seed(spec.seed, algo, s, e)
                cell = (algo, s, e)
                if seed in seen and seen[seed] != cell:
                    collisions.append((seen[seed], cell, seed))
                else:
                    seen[seed] = cell
    findings = []
    for first, second, seed in collisions[:5]:
        findings.append(
            _finding(
                "SPEC003",
                where,
                f"experiment-seed collision: cells {first} and {second} "
                f"both hash to seed {seed} — they would share cached "
                "measurements under one cache key",
            )
        )
    if len(collisions) > 5:
        findings.append(
            _finding(
                "SPEC003",
                where,
                f"... {len(collisions) - 5} more seed collisions",
            )
        )
    return findings


def check_scale(spec, where: str = "<spec>") -> list[Finding]:
    if spec.design is None:
        return []
    findings: list[Finding] = []
    n_algos = len(spec.matrix_algorithms)
    total = spec.design.total_search_samples * n_algos
    if total >= PAPER_SCALE_SAMPLES and spec.store is None:
        findings.append(
            _finding(
                "SPEC004",
                where,
                f"paper-scale design ({total:,} search samples) without a "
                "persistent store: a crash re-measures everything — set "
                "TuningSpec.store='sqlite'",
            )
        )
    try:
        from ..analysis.claims import MIN_EXPERIMENTS
    except Exception:  # noqa: BLE001 — analysis layer optional here
        MIN_EXPERIMENTS = 20
    thin = [(s, e) for s, e in spec.design.rows() if e < MIN_EXPERIMENTS]
    if thin:
        findings.append(
            _finding(
                "SPEC005",
                where,
                f"{len(thin)} design row(s) have fewer than "
                f"{MIN_EXPERIMENTS} experiments (e.g. S={thin[0][0]}, "
                f"E={thin[0][1]}): paper-claim verdicts stay undecidable",
            )
        )
    return findings


def check_cache_key_namespaces(specs, where: str = "<specs>") -> list[Finding]:
    """Distinct specs sharing one store must not share a cache key."""
    by_key: dict[str, list] = defaultdict(list)
    for spec in specs:
        if spec.store is None:
            continue
        key = (spec.store, spec.store_path, spec.cache_key or spec.default_cache_key())
        by_key[key].append(spec)
    findings = []
    for (_, path, cache_key), group in sorted(by_key.items(), key=str):
        if len(group) < 2:
            continue
        dicts = []
        for s in group:
            d = s.to_dict()
            d.pop("store", None), d.pop("store_path", None)
            dicts.append(d)
        if any(d != dicts[0] for d in dicts[1:]):
            findings.append(
                _finding(
                    "SPEC003",
                    where,
                    f"{len(group)} distinct specs share cache key "
                    f"{cache_key!r} in store {path!r}: cached measurements "
                    "would cross-serve between different problems",
                )
            )
    return findings


def preflight_spec(spec, where: str = "<spec>") -> list[Finding]:
    """The full battery for one spec."""
    findings = check_space(spec, where)
    if any(f.rule == "SPEC002" for f in findings):
        return findings  # the space is broken; the rest would only cascade
    findings += check_seed_namespace(spec, where)
    findings += check_scale(spec, where)
    return findings


def preflight_design(design, seed: int = 0, algorithms=("rs", "ga"),
                     where: str = "<design>") -> list[Finding]:
    """Design-only battery (no backend): seeds + scale, space skipped."""
    from ..core.api import TuningSpec

    spec = TuningSpec(
        kernel="preflight",
        backend="callable",
        design=design,
        seed=seed,
        algorithms=tuple(algorithms),
    )
    return check_seed_namespace(spec, where) + check_scale(spec, where)


def preflight_paper() -> list[Finding]:
    """Pre-flight the paper's full 3-benchmark x 3-chip matrix (the
    reference's ``benchmarks.paper_matrix`` specs on the port's ``costmodel``
    backend, sqlite-store configuration)."""
    from ..core.api import TuningSpec
    from ..core.experiment import ExperimentDesign

    benches = ("add", "harris", "mandelbrot")
    chips = ("v5e", "v4", "v3")
    algos = ("rs", "rf", "ga", "bo_gp", "bo_tpe")
    design = ExperimentDesign.paper()
    specs = []
    findings: list[Finding] = []
    for bench in benches:
        for chip in chips:
            spec = TuningSpec(
                kernel=bench,
                backend="costmodel",
                backend_kwargs={"chip": chip},
                algorithms=algos,
                design=design,
                cache_key=f"{bench}/{chip}",
                store="sqlite",
                store_path=f"results/paper_matrix/{bench}_{chip}_cache.sqlite",
            )
            specs.append(spec)
            findings += preflight_spec(spec, where=f"<paper:{bench}/{chip}>")
    findings += check_cache_key_namespaces(specs, where="<paper>")
    return findings
