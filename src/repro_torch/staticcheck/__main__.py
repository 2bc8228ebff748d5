"""CLI: ``python -m repro_torch.staticcheck [paths...] [options]`` (the
reference's CLI, aimed at the port).

Exit code 0 when no *error*-severity findings remain after suppressions
(warnings and infos print but do not fail), 1 otherwise, 2 on usage errors.
"""

from __future__ import annotations

import argparse
import json
import sys

from .catalog import RULES, resolve_select
from .findings import format_finding
from .runner import check_paths
from .spec_rules import preflight_paper, preflight_spec


def _list_rules() -> None:
    width = max(len(r.id) for r in RULES.values())
    for rule in sorted(RULES.values(), key=lambda r: r.id):
        if rule.family == "PARSE":
            continue
        sev = "" if rule.severity == "error" else f" [{rule.severity}]"
        print(f"{rule.id:<{width}}  {rule.summary}{sev}")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.staticcheck",
        description=(
            "Static determinism/provenance/registry checks gating the "
            "paper-scale run."
        ),
    )
    ap.add_argument("paths", nargs="*", help="files or directories to check")
    ap.add_argument(
        "--format",
        choices=("text", "github"),
        default="text",
        help="finding output format (github: workflow annotations)",
    )
    ap.add_argument(
        "--select",
        default=None,
        help="comma-separated rule ids or families (e.g. DET,PROV001)",
    )
    ap.add_argument(
        "--no-registry",
        action="store_true",
        help="skip the import-based REG/SER registry checks",
    )
    ap.add_argument(
        "--preflight",
        metavar="SPEC_JSON",
        default=None,
        help="pre-flight a TuningSpec JSON file (space size, constraint "
        "satisfiability, seed namespaces)",
    )
    ap.add_argument(
        "--preflight-paper",
        action="store_true",
        help="pre-flight the paper's full 3x3 combo matrix",
    )
    ap.add_argument(
        "--list-rules", action="store_true", help="print the rule catalog"
    )
    args = ap.parse_args(argv)

    if args.list_rules:
        _list_rules()
        return 0
    try:
        resolve_select(args.select)
    except KeyError as e:
        print(e.args[0], file=sys.stderr)
        return 2

    findings = []
    if args.paths:
        findings += check_paths(
            args.paths, select=args.select, registry=not args.no_registry
        )
    if args.preflight is not None:
        from ..core.api import TuningSpec

        with open(args.preflight, encoding="utf-8") as f:
            spec = TuningSpec.from_dict(json.load(f))
        findings += preflight_spec(spec, where=args.preflight)
    if args.preflight_paper:
        findings += preflight_paper()
    if not args.paths and args.preflight is None and not args.preflight_paper:
        ap.print_usage(sys.stderr)
        print(
            "error: give paths to check and/or --preflight/--preflight-paper",
            file=sys.stderr,
        )
        return 2

    for f in findings:
        print(format_finding(f, args.format))
    errors = sum(1 for f in findings if f.severity == "error")
    notes = len(findings) - errors
    tail = f", {notes} advisory" if notes else ""
    print(
        f"staticcheck: {errors} error finding(s){tail}"
        if findings
        else "staticcheck: clean"
    )
    return 1 if errors else 0


if __name__ == "__main__":
    raise SystemExit(main())
