"""Findings: what a rule reports, how it prints, how it is suppressed.

A :class:`Finding` is one violation (or advisory) at one source location.
Two output formats exist: the human ``path:line:col: RULE message`` form and
``--format github`` workflow annotations (``::error file=...``), so CI runs
annotate the offending lines in the PR diff.

Suppression is per-line and explicit: a trailing comment ::

    t0 = time.perf_counter()  # repro: allow[DET001]

silences exactly the named rules on that line.  A bare family name
(``allow[DET]``) silences the whole family — reserved for seam modules whose
entire point is to own the violation (``repro_torch.core.clock``).  The
comment is the reference's, so one file means the same to both gates.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

#: ``# repro: allow[DET001]`` / ``# repro: allow[DET001, SER]``
_ALLOW_RE = re.compile(r"#\s*repro:\s*allow\[([A-Z]+[0-9]*(?:\s*,\s*[A-Z]+[0-9]*)*)\]")

SEVERITIES = ("error", "warning", "info")


@dataclass(frozen=True)
class Finding:
    """One rule violation at one source location.

    ``path``/``line`` locate it (``line=0`` for whole-artifact findings like
    spec pre-flight results); ``rule`` is the catalog id; ``severity`` drives
    the exit code — only ``"error"`` findings fail the check.
    """

    path: str
    line: int
    rule: str
    message: str
    severity: str = "error"
    col: int = field(default=0, compare=False)

    def sort_key(self) -> tuple:
        return (self.path, self.line, self.col, self.rule, self.message)


def format_finding(f: Finding, fmt: str = "text") -> str:
    if fmt == "github":
        level = {"error": "error", "warning": "warning", "info": "notice"}[f.severity]
        # '::' and newlines would terminate the annotation early
        msg = f.message.replace("\n", " ").replace("::", ":")
        if f.line > 0:
            return (
                f"::{level} file={f.path},line={f.line},"
                f"col={max(1, f.col)},title={f.rule}::{msg}"
            )
        return f"::{level} file={f.path},title={f.rule}::{msg}"
    tag = "" if f.severity == "error" else f" [{f.severity}]"
    return f"{f.path}:{f.line}:{f.col}: {f.rule}{tag} {f.message}"


def suppressions_for(source: str) -> dict[int, frozenset[str]]:
    """Map 1-indexed line number -> rule ids / family prefixes allowed there."""
    out: dict[int, frozenset[str]] = {}
    for i, line in enumerate(source.splitlines(), start=1):
        hits: set[str] = set()
        for m in _ALLOW_RE.finditer(line):
            hits.update(tok.strip() for tok in m.group(1).split(","))
        if hits:
            out[i] = frozenset(hits)
    return out


def is_suppressed(f: Finding, allowed: dict[int, frozenset[str]]) -> bool:
    tokens = allowed.get(f.line)
    if not tokens:
        return False
    family = f.rule.rstrip("0123456789")
    return f.rule in tokens or family in tokens


def apply_suppressions(
    findings: list[Finding], source_by_path: dict[str, str]
) -> tuple[list[Finding], int]:
    """Drop per-line-suppressed findings; returns (kept, n_suppressed)."""
    allow_by_path = {
        path: suppressions_for(src) for path, src in source_by_path.items()
    }
    kept = [
        f
        for f in findings
        if not is_suppressed(f, allow_by_path.get(f.path, {}))
    ]
    return kept, len(findings) - len(kept)
