"""OBS rules: telemetry must never reach run identity.

The telemetry layer's contract (:mod:`repro_torch.telemetry`) is that tracing is a
*pure observability knob*: a telemetry-enabled run produces bit-identical
measurement stores, journals, and cache keys to a disabled one.  The
contract dies quietly if a trace setting ever flows into one of the
identity sinks — ``default_cache_key`` (the shared store namespace),
``journal_namespace`` (resume validity), ``_spec_fingerprint`` (the
analysis layer's run identity).

**OBS001** is a per-file lexical taint check over those sinks (the same
sink list PROV001 guards, plus each sink's same-file callees): any
telemetry identifier — ``telemetry`` / ``tracer`` / ``trace_path`` /
``trace_dir`` / ``trace_src`` — appearing inside a sink body as a name, an
attribute, or a string constant is an error.  Unlike PROV001 there is no
"exclusion context" escape: provenance sinks legitimately *filter* speed
knobs out of ``backend_kwargs``, but a telemetry token has no business in
an identity sink at all — not even to exclude itself, because telemetry is
a session/runtime knob that never enters the spec in the first place.
"""

from __future__ import annotations

import ast

from .findings import Finding
from .prov import SINK_NAMES, _called_names

#: identifiers that mark telemetry plumbing; substrings are NOT matched —
#: a token must be the whole name / attribute / string constant, so e.g.
#: ``backtrace`` or ``retrace`` never false-positive.  The serving layer's
#: plumbing (``serve_dir`` — where the winners index lives, ``qdir`` /
#: ``queue_dir`` — where fleet claims live) is equally identity-free: the
#: same spec tuned through any serve dir must produce the same store bytes.
TELEMETRY_TOKENS = ("telemetry", "tracer", "trace_path", "trace_dir",
                    "trace_src", "serve_dir", "qdir", "queue_dir")


def _token_mentions(fn: ast.FunctionDef) -> list[tuple[str, int]]:
    """Every (token, line) where a telemetry identifier appears in ``fn``."""
    out: list[tuple[str, int]] = []
    for node in ast.walk(fn):
        if isinstance(node, ast.Name) and node.id in TELEMETRY_TOKENS:
            out.append((node.id, node.lineno))
        elif isinstance(node, ast.Attribute) and node.attr in TELEMETRY_TOKENS:
            out.append((node.attr, node.lineno))
        elif (
            isinstance(node, ast.Constant)
            and isinstance(node.value, str)
            and node.value in TELEMETRY_TOKENS
        ):
            out.append((node.value, node.lineno))
        elif isinstance(node, ast.arg) and node.arg in TELEMETRY_TOKENS:
            out.append((node.arg, node.lineno))
    return out


def check_file(path: str, tree: ast.AST) -> list[Finding]:
    functions: dict[str, ast.FunctionDef] = {}
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            functions.setdefault(node.name, node)
    findings: list[Finding] = []
    # dedupe across sinks: a helper shared by two sinks reports once per line
    seen: set[tuple[int, str]] = set()
    for sink_name in SINK_NAMES:
        fn = functions.get(sink_name)
        if fn is None:
            continue
        # the sink plus its same-file helpers form the checked body —
        # mirroring PROV001, so a sink can't hide the leak in a callee
        bodies = [fn] + [
            functions[n]
            for n in _called_names(fn)
            if n in functions and n != sink_name
        ]
        for body in bodies:
            for token, line in _token_mentions(body):
                if (line, token) in seen:
                    continue
                seen.add((line, token))
                findings.append(
                    Finding(
                        path=path,
                        line=line,
                        rule="OBS001",
                        message=(
                            f"telemetry identifier '{token}' inside identity "
                            f"sink {sink_name}() — telemetry is observability "
                            "only and must never feed cache keys, journal "
                            "namespaces, or spec fingerprints"
                        ),
                    )
                )
    return findings
