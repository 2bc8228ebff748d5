"""LIB rules: library-code hygiene.

**LIB001** — a bare ``assert`` in library code is an error-handling bug
waiting for ``python -O``: asserts compile away under optimization, so a
"call fit first" guard silently vanishes exactly when someone runs the
paper-scale matrix with ``-O`` for speed.  Runtime state errors must raise
real exceptions (``RuntimeError`` / ``ValueError``); ``assert`` is for
developer-facing invariants in tests only (which this checker never scans).
"""

from __future__ import annotations

import ast

from .findings import Finding


def check_file(path: str, tree: ast.AST) -> list[Finding]:
    return [
        Finding(
            path=path,
            line=node.lineno,
            col=node.col_offset,
            rule="LIB001",
            message=(
                "bare assert is stripped under python -O; raise "
                "RuntimeError/ValueError for runtime errors in library code"
            ),
        )
        for node in ast.walk(tree)
        if isinstance(node, ast.Assert)
    ]
