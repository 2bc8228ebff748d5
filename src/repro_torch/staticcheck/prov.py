"""PROV rules: speed knobs must never reach provenance namespaces.

The executor layer's core promise is that *how fast* a run executes never
changes *what* it computes: ``pipeline_workers``, ``max_workers``,
``executor``, ``futures_pool``, ``scheduler``, ``compile_cache`` may change
wall-clock only.  The promise is
load-bearing in three sink functions — ``default_cache_key`` (the shared
measurement-store namespace), ``journal_namespace`` (resume validity), and
``_spec_fingerprint`` (the analysis layer's run identity).  If a knob leaks
into any of them, warm caches stop matching across worker counts and resume
journals orphan themselves whenever someone changes parallelism.

**PROV001** is a lightweight cross-file taint check over the scanned set:

1. *Liveness*: a knob is **live** if any scanned file injects it into
   ``backend_kwargs`` — a dict literal containing the knob as a key that is
   either bound to a ``backend_kwargs=`` keyword/assignment or spreads
   ``**...backend_kwargs``, or a ``...backend_kwargs[...] [knob] = ...``
   subscript store.
2. *Sink obligation*: every sink function (by name, plus its same-file
   callees) that reads ``backend_kwargs`` must **exclude** each live knob —
   mention it in an exclusion context: a comparison (``k != "knob"``,
   ``k not in (...)``) or a ``.pop("knob", ...)``.

Deleting the one-line filter in ``TuningSpec.default_cache_key`` makes this
rule fire — that regression is pinned by the fixture corpus.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field

from .findings import Finding

SPEED_KNOBS = (
    "pipeline_workers",
    "max_workers",
    "executor",
    "futures_pool",
    "scheduler",
    "compile_cache",
    # fleet pacing (repro_torch.serving): how fast a queue drains, never what the
    # tuned values are — byte-identity of fleet vs serial runs depends on it
    "claim_timeout_s",
    "poll_s",
    "stall_s",
)

SINK_NAMES = ("default_cache_key", "journal_namespace", "_spec_fingerprint")

_KWARGS_MARKER = "backend_kwargs"


@dataclass
class _FileFacts:
    path: str
    #: knob -> first injection line
    injections: dict[str, int] = field(default_factory=dict)
    #: function name -> FunctionDef node (module + class level)
    functions: dict[str, ast.FunctionDef] = field(default_factory=dict)


def _mentions_kwargs(node: ast.AST) -> bool:
    for sub in ast.walk(node):
        if isinstance(sub, ast.Attribute) and sub.attr == _KWARGS_MARKER:
            return True
        if isinstance(sub, ast.Name) and sub.id == _KWARGS_MARKER:
            return True
        if (
            isinstance(sub, ast.Constant)
            and isinstance(sub.value, str)
            and sub.value == _KWARGS_MARKER
        ):
            return True
    return False


def _dict_knob_keys(d: ast.Dict) -> list[tuple[str, int]]:
    out = []
    for k in d.keys:
        if (
            k is not None
            and isinstance(k, ast.Constant)
            and isinstance(k.value, str)
            and k.value in SPEED_KNOBS
        ):
            out.append((k.value, k.lineno))
    return out


def _dict_spreads_kwargs(d: ast.Dict) -> bool:
    return any(
        k is None and _mentions_kwargs(v) for k, v in zip(d.keys, d.values, strict=True)
    )


def collect_facts(path: str, tree: ast.AST) -> _FileFacts:
    facts = _FileFacts(path=path)
    # dict literals bound to a backend_kwargs keyword / assignment target
    bound_dicts: set[int] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            for kw in node.keywords:
                if kw.arg == _KWARGS_MARKER and isinstance(kw.value, ast.Dict):
                    bound_dicts.add(id(kw.value))
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                if (
                    isinstance(t, (ast.Name, ast.Attribute))
                    and _mentions_kwargs(t)
                    and isinstance(node.value, ast.Dict)
                ):
                    bound_dicts.add(id(node.value))
            # spec.backend_kwargs["pipeline_workers"] = N
            for t in node.targets:
                if (
                    isinstance(t, ast.Subscript)
                    and _mentions_kwargs(t.value)
                    and isinstance(t.slice, ast.Constant)
                    and t.slice.value in SPEED_KNOBS
                ):
                    facts.injections.setdefault(t.slice.value, t.lineno)
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict):
            knobs = _dict_knob_keys(node)
            if not knobs:
                continue
            if id(node) in bound_dicts or _dict_spreads_kwargs(node):
                for knob, line in knobs:
                    facts.injections.setdefault(knob, line)
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            facts.functions.setdefault(node.name, node)
    return facts


def _called_names(fn: ast.FunctionDef) -> set[str]:
    out: set[str] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Call):
            if isinstance(node.func, ast.Name):
                out.add(node.func.id)
            elif isinstance(node.func, ast.Attribute):
                out.add(node.func.attr)
    return out


def _excludes_knob(fn_nodes: list[ast.FunctionDef], knob: str) -> bool:
    """True if any of the sink's bodies mentions ``knob`` in an exclusion
    context: inside a comparison, or as the key argument of ``.pop``/
    ``.discard``/``del``."""
    for fn in fn_nodes:
        for node in ast.walk(fn):
            if isinstance(node, ast.Compare):
                for sub in ast.walk(node):
                    if isinstance(sub, ast.Constant) and sub.value == knob:
                        return True
            elif isinstance(node, ast.Call) and isinstance(
                node.func, ast.Attribute
            ):
                if node.func.attr in ("pop", "discard") and node.args:
                    a0 = node.args[0]
                    if isinstance(a0, ast.Constant) and a0.value == knob:
                        return True
            elif isinstance(node, ast.Delete):
                for t in node.targets:
                    if (
                        isinstance(t, ast.Subscript)
                        and isinstance(t.slice, ast.Constant)
                        and t.slice.value == knob
                    ):
                        return True
    return False


def check_project(facts_by_path: dict[str, _FileFacts]) -> list[Finding]:
    live: dict[str, tuple[str, int]] = {}
    for facts in facts_by_path.values():
        for knob, line in facts.injections.items():
            live.setdefault(knob, (facts.path, line))
    if not live:
        return []
    findings: list[Finding] = []
    for facts in facts_by_path.values():
        for sink_name in SINK_NAMES:
            fn = facts.functions.get(sink_name)
            if fn is None:
                continue
            # the sink plus its same-file helpers form the checked body
            bodies = [fn] + [
                facts.functions[n]
                for n in _called_names(fn)
                if n in facts.functions and n != sink_name
            ]
            if not any(_mentions_kwargs(b) for b in bodies):
                continue
            for knob, (inj_path, inj_line) in sorted(live.items()):
                if not _excludes_knob(bodies, knob):
                    findings.append(
                        Finding(
                            path=facts.path,
                            line=fn.lineno,
                            col=fn.col_offset,
                            rule="PROV001",
                            message=(
                                f"speed knob '{knob}' is injected into "
                                f"backend_kwargs ({inj_path}:{inj_line}) but "
                                f"{sink_name}() does not exclude it — the "
                                "knob would leak into cache/journal "
                                "namespaces"
                            ),
                        )
                    )
    return findings
