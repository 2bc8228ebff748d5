"""Median and quartile spread of each metric over runs of one cell.

    python3 bench/tools/spread.py A1.out A2.out ... [-- B1.out B2.out ...]

Each file holds one run's standard output; its last line is the result.
Per metric and set: the median, the quartiles as
``statistics.quantiles(values, n=4)`` gives them, and the spread
(q3 - q1) / median.  With two sets: the wider spread, the mean of the two
sets' spreads with each set's run farthest from its median left out, the
spread of all runs together, and the relative gap between the medians.
"""

from __future__ import annotations

import json
import statistics
import sys


def last_json(path: str) -> dict:
    with open(path, encoding="utf-8") as f:
        lines = [ln for ln in f.read().splitlines() if ln.strip()]
    return json.loads(lines[-1])


def spread(values: list[float]) -> float:
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def trimmed(values: list[float]) -> list[float]:
    med = statistics.median(values)
    far = max(range(len(values)), key=lambda i: abs(values[i] - med))
    return values[:far] + values[far + 1:]


def main(argv: list[str]) -> int:
    sets = [[]]
    for a in argv:
        if a == "--":
            sets.append([])
        else:
            sets[-1].append(a)
    runs = [[last_json(p) for p in s] for s in sets if s]
    names = sorted({m for s in runs for r in s for m in r["metrics"]})
    for m in names:
        vals = [[r["metrics"][m]["value"] for r in s if m in r["metrics"]] for s in runs]
        line = [f"{m}:"]
        for i, v in enumerate(vals):
            line.append(f"set{i + 1} n={len(v)} median={statistics.median(v)!r} "
                        f"spread={spread(v):.5f}" if len(v) >= 2 else f"set{i + 1} n={len(v)}")
        if len(vals) == 2 and min(len(v) for v in vals) >= 3:
            wide = max(spread(v) for v in vals)
            tight = sum(spread(trimmed(v)) for v in vals) / 2
            both = spread(vals[0] + vals[1])
            gap = statistics.median(vals[1]) / statistics.median(vals[0]) - 1
            line.append(f"wider={wide:.5f} trimmed_mean={tight:.5f} all={both:.5f} "
                        f"median_gap={gap:+.5f}")
        print(" ".join(line))
    correct = [r["correct"] for s in runs for r in s]
    print(f"runs={len(correct)} correct={sum(correct)}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
