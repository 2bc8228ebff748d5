"""Orchestration: discover files, run rule families, apply suppressions.

:func:`check_paths` is the programmatic entry point (the CLI in
``__main__`` and the fixture tests both call it).  AST rule families run
per-file; PROV runs over the whole scanned set (its liveness analysis is
cross-file); the import-based registry checks run once per invocation and
can be disabled (``registry=False``) for fixture corpora that are not
importable packages.
"""

from __future__ import annotations

import ast
import os

from . import det, lib, obs, prov, ser
from .catalog import resolve_select
from .findings import Finding, apply_suppressions

SKIP_DIRS = frozenset(
    {".git", "__pycache__", ".ruff_cache", "results", "node_modules", ".venv"}
)


def iter_py_files(paths: list[str]) -> list[str]:
    """Expand files/directories into a sorted, deduplicated .py file list."""
    out: list[str] = []
    seen: set[str] = set()
    for path in paths:
        if os.path.isfile(path):
            targets = [path]
        elif os.path.isdir(path):
            targets = []
            for root, dirs, files in os.walk(path):
                dirs[:] = sorted(d for d in dirs if d not in SKIP_DIRS)
                targets.extend(
                    os.path.join(root, f) for f in sorted(files)
                    if f.endswith(".py")
                )
        else:
            raise FileNotFoundError(path)
        for t in targets:
            norm = os.path.normpath(t)
            if norm not in seen and norm.endswith(".py"):
                seen.add(norm)
                out.append(norm)
    return out


def check_paths(
    paths: list[str],
    *,
    select: str | None = None,
    registry: bool = True,
) -> list[Finding]:
    """Run the static checks over ``paths``; returns sorted findings with
    per-line suppressions already applied.

    ``select`` limits output to a comma-separated rule/family list.
    ``registry=False`` skips the import-based REG/SER checks (fixture
    corpora; syntax-only runs).
    """
    files = iter_py_files(paths)
    findings: list[Finding] = []
    sources: dict[str, str] = {}
    prov_facts = {}
    for path in files:
        try:
            with open(path, encoding="utf-8") as f:
                source = f.read()
        except OSError as e:
            findings.append(
                Finding(path, 0, "PARSE", f"unreadable: {e}")
            )
            continue
        sources[path] = source
        try:
            tree = ast.parse(source, filename=path)
        except SyntaxError as e:
            findings.append(
                Finding(path, e.lineno or 0, "PARSE", f"syntax error: {e.msg}")
            )
            continue
        findings += det.check_file(path, tree)
        findings += lib.check_file(path, tree)
        findings += ser.check_file(path, tree)
        findings += obs.check_file(path, tree)
        prov_facts[path] = prov.collect_facts(path, tree)
    findings += prov.check_project(prov_facts)
    if registry:
        from .reg import check_registries

        findings += check_registries()
    # registry findings anchor at def sites that may live outside the scanned
    # paths; load those sources too so their allow-comments are honored
    for f in findings:
        if f.path not in sources and os.path.isfile(f.path):
            try:
                with open(f.path, encoding="utf-8") as fh:
                    sources[f.path] = fh.read()
            except OSError:
                pass
    findings, _ = apply_suppressions(findings, sources)
    selected = resolve_select(select)
    if selected is not None:
        findings = [f for f in findings if f.rule in selected]
    return sorted(findings, key=Finding.sort_key)
