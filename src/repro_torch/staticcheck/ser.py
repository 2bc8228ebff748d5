"""SER rules: everything on a serialized path must survive JSON.

A :class:`~repro_torch.core.api.TuningSpec` is the unit of work the executor layer
ships to workers; anything inside it that cannot round-trip through JSON
silently downgrades the run (no sharding, no resume journal).  Two kinds of
checks live here:

* the AST check **SER003** — a ``lambda`` embedded in a ``*_kwargs`` dict
  literal (``searcher_kwargs={"fn": lambda ...}``) can never serialize;
  callers must register a named backend/constraint instead.
* the import-based checks **SER001** (TuningSpec JSON round-trip) and
  **SER002** (registered searcher/backend constructor defaults are
  JSON-representable on serializable paths), which run with the REG family
  in :mod:`.reg` because they need live registry objects.
"""

from __future__ import annotations

import ast

from .findings import Finding

JSONABLE = (str, int, float, bool, type(None))


def is_json_value(v: object) -> bool:
    """JSON-representability of a *default value* (tuples serialize as
    lists, which every consumer in this repo round-trips back)."""
    if isinstance(v, JSONABLE):
        return True
    if isinstance(v, (list, tuple)):
        return all(is_json_value(x) for x in v)
    if isinstance(v, dict):
        return all(
            isinstance(k, str) and is_json_value(x) for k, x in v.items()
        )
    return False


def check_file(path: str, tree: ast.AST) -> list[Finding]:
    findings: list[Finding] = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        for kw in node.keywords:
            if (
                kw.arg
                and kw.arg.endswith("_kwargs")
                and isinstance(kw.value, ast.Dict)
            ):
                for key, value in zip(kw.value.keys, kw.value.values, strict=True):
                    if isinstance(value, ast.Lambda):
                        keyname = (
                            key.value
                            if isinstance(key, ast.Constant)
                            else "<dynamic>"
                        )
                        findings.append(
                            Finding(
                                path=path,
                                line=value.lineno,
                                col=value.col_offset,
                                rule="SER003",
                                message=(
                                    f"lambda in {kw.arg}[{keyname!r}] cannot "
                                    "serialize; name a registered backend/"
                                    "constraint instead"
                                ),
                            )
                        )
    return findings
