"""CLI: inspect a run's trace — ``python -m repro_torch.telemetry <run_dir>``.

Subcommands (a bare run dir defaults to ``summarize``):

* ``summarize <run_dir> [--top N]`` — per-cell stage breakdown, per-stage
  percentiles, top-N slowest compiles, invalid-config histogram, counters.
* ``tail <run_dir> [--follow] [--interval S]`` — one progress line (or a
  live stream of them) with ETA, usable while the matrix is running.
* ``export <run_dir> [--format chrome] [-o OUT]`` — Chrome trace-event
  JSON for ``about://tracing`` / Perfetto.
"""

from __future__ import annotations

import argparse
import sys

from .export import export_chrome
from .progress import ProgressReporter, format_progress, scan_progress
from .summarize import render_summary, summarize

_COMMANDS = ("summarize", "tail", "export")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.telemetry", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("summarize", help="stage/counter tables from the trace")
    p.add_argument("run_dir")
    p.add_argument("--top", type=int, default=10,
                   help="how many slowest compiles to list")
    p = sub.add_parser("tail", help="progress + ETA from the live trace")
    p.add_argument("run_dir")
    p.add_argument("--follow", action="store_true",
                   help="keep printing until the run completes")
    p.add_argument("--interval", type=float, default=5.0)
    p = sub.add_parser("export", help="convert the trace for external viewers")
    p.add_argument("run_dir")
    p.add_argument("--format", choices=("chrome",), default="chrome")
    p.add_argument("-o", "--out", default=None)

    if argv is None:
        argv = sys.argv[1:]
    if argv and argv[0] not in _COMMANDS and not argv[0].startswith("-"):
        argv = ["summarize", *argv]          # `<run_dir>` alone summarizes
    args = ap.parse_args(argv)

    if args.cmd == "summarize":
        print(render_summary(summarize(args.run_dir, top=args.top)))
    elif args.cmd == "tail":
        if args.follow:
            reporter = ProgressReporter(
                args.run_dir, interval=args.interval, out=sys.stderr
            )
            try:
                reporter.follow()
            except KeyboardInterrupt:
                pass
        else:
            print(format_progress(scan_progress(args.run_dir)))
    elif args.cmd == "export":
        print(export_chrome(args.run_dir, args.out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
