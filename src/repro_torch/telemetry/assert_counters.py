"""Assert counter totals (and plan fields) in a run dir's telemetry trace (a
port of the reference's ``tools/assert_counters.py``).

Turns a trace into a gate: assertions are simple comparisons against the
FINAL ``totals`` event's counters (or, for standalone traces with no parent
merge — serving queries, fleet workers — the sum of all writers' cumulative
snapshots), with missing keys reading as 0::

    python -m repro_torch.telemetry.assert_counters SERVE_DIR \\
        "serve.hits==2" "serve.misses==1" --plan scheduler=steal

Exits nonzero (listing every failed assertion) when the trace disagrees.
"""

from __future__ import annotations

import argparse
import re
import sys

from .events import read_run
from .summarize import sum_counters

_ASSERT = re.compile(r"^([\w.]+)\s*(==|!=|>=|<=|>|<)\s*(-?\d+)$")

_OPS = {
    "==": lambda a, b: a == b,
    "!=": lambda a, b: a != b,
    ">=": lambda a, b: a >= b,
    "<=": lambda a, b: a <= b,
    ">": lambda a, b: a > b,
    "<": lambda a, b: a < b,
}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.telemetry.assert_counters", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument("run_dir", help="results dir holding the merged trace")
    ap.add_argument("asserts", nargs="*", metavar="KEY OP N",
                    help="counter assertions, e.g. 'compiles==0'")
    ap.add_argument("--plan", action="append", default=[],
                    metavar="FIELD=VALUE",
                    help="assert a field of the (first) plan event, e.g. "
                         "scheduler=steal")
    args = ap.parse_args(argv)

    events = read_run(args.run_dir)
    if not events:
        print(f"[assert_counters] no trace events under {args.run_dir}")
        return 1
    counters = sum_counters(events)
    plans = [e for e in events if e.get("ev") == "plan"]

    failed: list[str] = []
    for spec in args.asserts:
        m = _ASSERT.match(spec)
        if m is None:
            failed.append(f"unparseable assertion {spec!r}")
            continue
        key, op, want = m.group(1), m.group(2), int(m.group(3))
        got = int(counters.get(key, 0))
        if not _OPS[op](got, want):
            failed.append(f"{key}={got} violates {spec!r}")
    for spec in args.plan:
        field, _, want = spec.partition("=")
        if not plans:
            failed.append(f"no plan event (wanted {spec!r})")
        elif str(plans[0].get(field)) != want:
            failed.append(
                f"plan.{field}={plans[0].get(field)!r} violates {spec!r}"
            )

    if failed:
        for f in failed:
            print(f"[assert_counters] FAIL: {f}")
        print(f"[assert_counters] counters were: {counters}")
        return 1
    checked = ", ".join(args.asserts + [f"plan:{p}" for p in args.plan])
    print(f"[assert_counters] ok: {checked}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
