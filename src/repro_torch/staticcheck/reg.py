"""REG + import-based SER rules: the registries must be whole.

These checks import the port's real registries and inspect the live
objects — "static" in the sense of *before any kernel build or
measurement*, not in the sense of never executing Python.  They catch the
registration drift the AST rules cannot see: a searcher registered without
``_propose``, a backend whose hooks are not callable, a kernel package that
forgot to publish its bench descriptor.  They never touch the card: a
backend's ``make`` is inspected by signature and never called (building a
``cuda`` measurement on a card compiles the kernel library).

* **REG001** — every ``SEARCHERS`` entry subclasses ``Searcher``, overrides
  ``_propose``, and constructs from JSON kwargs (a smoke construction on a
  tiny space, plus a signature scan for non-JSON defaults).
* **REG002** — every ``BACKENDS`` (``cuda``, ``costmodel``, the wrappers) /
  ``EXECUTORS`` (``serial``, ``process``, ``futures``, ``device``) /
  ``STORES`` (``json``, ``sqlite``) entry is
  well-formed: callables where callables belong, the store interface
  complete (get/put/save/items + the meta side-channel journaling needs).
* **REG003** — every kernel in ``TUNABLE_KERNELS`` publishes a complete
  ``KernelBenchSpec`` (name, input builder, runner) into
  ``KERNEL_BENCHES``, and the two registries agree on the kernel set.
* **SER001** — ``TuningSpec`` JSON round-trips.
* **SER002** — registered constructor defaults on serializable paths are
  JSON-representable.
"""

from __future__ import annotations

import dataclasses
import inspect

from .findings import Finding
from .ser import is_json_value


def _def_site(obj) -> tuple[str, int]:
    """(path, line) of a callable/class definition, for finding anchors."""
    try:
        path = inspect.getsourcefile(obj) or "<registry>"
        _, line = inspect.getsourcelines(obj)
        return path, line
    except (OSError, TypeError):
        return "<registry>", 0


def _finding(rule: str, obj, message: str, severity: str = "error") -> Finding:
    path, line = _def_site(obj)
    return Finding(
        path=path, line=line, rule=rule, message=message, severity=severity
    )


def _tiny_space():
    from ..core.space import Param, SearchSpace

    return SearchSpace(
        [Param("t_x", (1, 2, 4)), Param("t_y", (1, 2)), Param("t_z", (1, 2))]
    )


def check_searchers() -> list[Finding]:
    from ..core.searchers import SEARCHERS, make_searcher
    from ..core.searchers.base import Searcher

    findings: list[Finding] = []
    space = _tiny_space()
    for name, cls in sorted(SEARCHERS.items()):
        if not (isinstance(cls, type) and issubclass(cls, Searcher)):
            findings.append(
                _finding(
                    "REG001",
                    cls,
                    f"SEARCHERS[{name!r}] is not a Searcher subclass",
                )
            )
            continue
        if cls._propose is Searcher._propose or getattr(
            cls._propose, "__isabstractmethod__", False
        ):
            findings.append(
                _finding(
                    "REG001",
                    cls,
                    f"SEARCHERS[{name!r}] does not implement _propose()",
                )
            )
        try:
            make_searcher(name, space, seed=0)
        except Exception as e:  # noqa: BLE001 — any ctor failure is the finding
            findings.append(
                _finding(
                    "REG001",
                    cls,
                    f"SEARCHERS[{name!r}] failed default construction: "
                    f"{type(e).__name__}: {e}",
                )
            )
        for pname, p in inspect.signature(cls.__init__).parameters.items():
            if pname in ("self", "space", "seed") or p.kind in (
                inspect.Parameter.VAR_POSITIONAL,
                inspect.Parameter.VAR_KEYWORD,
            ):
                continue
            if p.default is not inspect.Parameter.empty and not is_json_value(
                p.default
            ):
                findings.append(
                    _finding(
                        "SER002",
                        cls,
                        f"SEARCHERS[{name!r}] default {pname}="
                        f"{p.default!r} is not JSON-representable; specs "
                        "naming this searcher cannot shard",
                    )
                )
    return findings


def check_backends() -> list[Finding]:
    from ..core.backends import BACKENDS

    findings: list[Finding] = []
    for name, backend in sorted(BACKENDS.items()):
        anchor = backend.make if callable(backend.make) else check_backends
        if not callable(backend.make):
            findings.append(
                _finding(
                    "REG002", anchor, f"BACKENDS[{name!r}].make is not callable"
                )
            )
            continue
        for hook in ("default_space", "true_optimum"):
            val = getattr(backend, hook)
            if val is not None and not callable(val):
                findings.append(
                    _finding(
                        "REG002",
                        anchor,
                        f"BACKENDS[{name!r}].{hook} is neither None nor "
                        "callable",
                    )
                )
        if backend.serializable:
            for pname, p in inspect.signature(backend.make).parameters.items():
                if p.default is not inspect.Parameter.empty and not (
                    is_json_value(p.default)
                ):
                    findings.append(
                        _finding(
                            "SER002",
                            backend.make,
                            f"BACKENDS[{name!r}] default {pname}="
                            f"{p.default!r} is not JSON-representable on a "
                            "serializable backend",
                        )
                    )
    return findings


def check_executors_and_stores() -> list[Finding]:
    from ..core.executors import EXECUTORS
    from ..core.stores import STORES

    findings: list[Finding] = []
    for name, ex in sorted(EXECUTORS.items()):
        if not callable(getattr(ex, "run", None)):
            findings.append(
                _finding(
                    "REG002",
                    type(ex),
                    f"EXECUTORS[{name!r}].run is not callable",
                )
            )
    required = ("get", "put", "save", "items", "get_meta", "put_meta",
                "get_winner", "put_winner", "winner_items")
    for name, cls in sorted(STORES.items()):
        missing = [m for m in required if not callable(getattr(cls, m, None))]
        if missing:
            findings.append(
                _finding(
                    "REG002",
                    cls,
                    f"STORES[{name!r}] ({cls.__name__}) is missing store "
                    f"interface methods: {', '.join(missing)}",
                )
            )
    return findings


def check_kernels() -> list[Finding]:
    from ..kernels import KERNEL_BENCHES, TUNABLE_KERNELS
    from ..kernels.common import KernelBenchSpec

    findings: list[Finding] = []
    for name in sorted(TUNABLE_KERNELS):
        if name not in KERNEL_BENCHES:
            findings.append(
                _finding(
                    "REG003",
                    TUNABLE_KERNELS[name],
                    f"kernel {name!r} is in TUNABLE_KERNELS but publishes no "
                    "KERNEL_BENCHES descriptor",
                )
            )
    for name, bench in sorted(KERNEL_BENCHES.items()):
        anchor = bench.run if callable(bench.run) else KernelBenchSpec
        if not isinstance(bench, KernelBenchSpec):
            findings.append(
                _finding(
                    "REG003",
                    anchor,
                    f"KERNEL_BENCHES[{name!r}] is not a KernelBenchSpec",
                )
            )
            continue
        if bench.name != name:
            findings.append(
                _finding(
                    "REG003",
                    anchor,
                    f"KERNEL_BENCHES[{name!r}].name is {bench.name!r} — the "
                    "registry key and descriptor disagree",
                )
            )
        for fld in ("make_inputs", "run"):
            if not callable(getattr(bench, fld)):
                findings.append(
                    _finding(
                        "REG003",
                        anchor,
                        f"KERNEL_BENCHES[{name!r}].{fld} is not callable — "
                        "the ops/ref/csrc triple is incomplete",
                    )
                )
        if name not in TUNABLE_KERNELS:
            findings.append(
                _finding(
                    "REG003",
                    anchor,
                    f"kernel {name!r} publishes a bench descriptor but has "
                    "no TUNABLE_KERNELS entry point",
                )
            )
    return findings


def check_spec_roundtrip() -> list[Finding]:
    from ..core.api import TuningSpec
    from ..core.experiment import ExperimentDesign

    common = dict(
        kernel="harris",
        searcher="ga",
        searcher_kwargs={"pop_size": 16},
        design=ExperimentDesign.smoke(),
        algorithms=("rs", "ga"),
        store="json",
        store_path="cache.json",
    )
    findings: list[Finding] = []
    # the reference's cost-model spec and the port's own default backend;
    # building a spec touches no card
    for backend, backend_kwargs in (
        ("costmodel", {"chip": "v5e"}),
        ("cuda", {"x": 8192, "y": 8192, "repeats": 5, "device": "cuda"}),
    ):
        try:
            spec = TuningSpec(
                backend=backend, backend_kwargs=backend_kwargs, **common
            )
            back = TuningSpec.from_json(spec.to_json())
            if back.to_dict() != spec.to_dict():
                findings.append(
                    _finding(
                        "SER001",
                        TuningSpec,
                        f"TuningSpec JSON round-trip is lossy ({backend} "
                        "spec): from_json(to_json(spec)) != spec",
                    )
                )
        except Exception as e:  # noqa: BLE001 — any round-trip failure is the finding
            findings.append(
                _finding(
                    "SER001",
                    TuningSpec,
                    f"TuningSpec JSON round-trip raised ({backend} spec) "
                    f"{type(e).__name__}: {e}",
                )
            )
    for f in dataclasses.fields(TuningSpec):
        if f.default is not dataclasses.MISSING and not (
            is_json_value(f.default)
        ):
            findings.append(
                _finding(
                    "SER001",
                    TuningSpec,
                    f"TuningSpec.{f.name} default {f.default!r} is not "
                    "JSON-representable",
                )
            )
    return findings


def check_registries() -> list[Finding]:
    """All import-and-inspect checks; import failures become findings, not
    crashes (a broken registry module IS the finding)."""
    findings: list[Finding] = []
    for check in (
        check_searchers,
        check_backends,
        check_executors_and_stores,
        check_kernels,
        check_spec_roundtrip,
    ):
        try:
            findings.extend(check())
        except Exception as e:  # noqa: BLE001 — report, keep checking
            findings.append(
                Finding(
                    path="<registry>",
                    line=0,
                    rule="REG002",
                    message=(
                        f"{check.__name__} could not run: "
                        f"{type(e).__name__}: {e}"
                    ),
                )
            )
    return findings
