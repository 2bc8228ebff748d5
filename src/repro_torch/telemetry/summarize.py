"""Post-hoc trace analysis: the tables behind ``python -m repro_torch.telemetry``
(a copy of ``repro.telemetry.summarize``).

Consumes the event stream (:mod:`.events`) and produces plain data the CLI
renders and the report layer embeds: merged counter totals, the per-cell
stage breakdown, per-stage duration percentiles, the top-N slowest compiles,
and the invalid-config histogram.

Counter semantics: every writer emits ONE cumulative ``counters`` snapshot
per lifetime (on ``close()``), so summing all ``counters`` events is correct
across shards AND across kill/resume sessions (each lifetime's increments
are counted exactly once).  ``totals`` events additionally carry the
parent's merged view (including worker counters returned in-band through
``UnitResult.counters``); when present, the last one wins for display.
"""

from __future__ import annotations

import numpy as np

from .events import read_run


def sum_counters(events: list[dict]) -> dict:
    """Merged counter totals: the last ``totals`` event if any (the parent's
    authoritative merge), else the sum of all ``counters`` snapshots."""
    totals = [e for e in events if e.get("ev") == "totals"]
    if totals:
        return dict(totals[-1].get("counters", {}))
    acc: dict = {}
    for e in events:
        if e.get("ev") == "counters":
            for k, v in e.get("counters", {}).items():
                acc[k] = acc.get(k, 0) + v
    return acc


def cell_table(events: list[dict]) -> list[dict]:
    """Per-cell aggregates from the parent's ``cell`` events (last per cell
    wins — a resumed run re-emits its cells with the merged numbers)."""
    cells: dict[tuple, dict] = {}
    for e in events:
        if e.get("ev") == "cell":
            cells[(e.get("algo"), e.get("sample_size"))] = e
    return [
        {
            "algo": algo,
            "sample_size": s,
            "n_experiments": e.get("n_experiments"),
            "wall_s": e.get("wall_s", 0.0),
            "compile_s": e.get("compile_s", 0.0),
            "measure_s": e.get("measure_s", 0.0),
        }
        for (algo, s), e in sorted(
            cells.items(), key=lambda kv: (str(kv[0][0]), kv[0][1] or 0)
        )
    ]


def stage_percentiles(events: list[dict]) -> dict[str, dict]:
    """Duration percentiles per pipeline stage (seconds), from ``stage``
    events across every writer."""
    durs: dict[str, list[float]] = {}
    for e in events:
        if e.get("ev") == "stage" and "dur" in e:
            durs.setdefault(str(e.get("stage")), []).append(float(e["dur"]))
    out: dict[str, dict] = {}
    for stage, vals in sorted(durs.items()):
        a = np.asarray(vals, dtype=np.float64)
        out[stage] = {
            "count": int(a.size),
            "total_s": float(a.sum()),
            "p50": float(np.percentile(a, 50)),
            "p90": float(np.percentile(a, 90)),
            "p99": float(np.percentile(a, 99)),
            "max": float(a.max()),
        }
    return out


def slowest_compiles(events: list[dict], top: int = 10) -> list[dict]:
    """The ``top`` slowest compile-stage executions, with the geometry key
    that compiled.  On the card a "compile" is a geometry's first warmed
    launch: one library serves every config, so nothing is compiled per
    config."""
    compiles = [
        e for e in events if e.get("ev") == "stage" and e.get("stage") == "compile"
    ]
    compiles.sort(key=lambda e: -float(e.get("dur", 0.0)))
    return [
        {
            "dur": float(e.get("dur", 0.0)),
            "key": e.get("key"),
            "src": e.get("src"),
        }
        for e in compiles[: max(0, top)]
    ]


def invalid_histogram(counters: dict) -> dict[str, int]:
    """``invalid.<rule>`` counters -> ``{rule: count}`` (validity rules by
    reason prefix — align/block/grid/vmem — plus compile/run failures)."""
    return {
        k.split(".", 1)[1]: int(v)
        for k, v in sorted(counters.items())
        if k.startswith("invalid.")
    }


def serving_counters(counters: dict) -> dict:
    """The serving/fleet slice of the counter totals: query outcomes
    (``serve.hits`` / ``serve.misses`` / ``serve.nearest`` / ``serve.stale``
    / ``serve.enqueued``), the ``serve.queue_depth`` gauge, and the fleet's
    ``fleet.*`` progress counters."""
    return {
        k: counters[k]
        for k in sorted(counters)
        if k.startswith(("serve.", "fleet."))
    }


def summarize(run_dir: str, top: int = 10) -> dict:
    """Everything the ``summarize`` subcommand renders, as plain data."""
    events = read_run(run_dir)
    counters = sum_counters(events)
    units_done = sum(
        1 for e in events if e.get("ev") == "end" and e.get("span") == "unit"
    )
    experiments_done = sum(
        1 for e in events if e.get("ev") == "end" and e.get("span") == "experiment"
    )
    return {
        "n_events": len(events),
        "units_done": units_done,
        "experiments_done": experiments_done,
        "counters": counters,
        "cells": cell_table(events),
        "stages": stage_percentiles(events),
        "slowest_compiles": slowest_compiles(events, top=top),
        "invalid": invalid_histogram(counters),
        "serving": serving_counters(counters),
    }


# ---------------------------------------------------------------- rendering


def _table(rows: list[list[str]], header: list[str]) -> str:
    widths = [
        max(len(str(r[i])) for r in [header, *rows]) for i in range(len(header))
    ]
    def fmt(row):
        return "  ".join(str(c).ljust(w) for c, w in zip(row, widths, strict=True))
    lines = [fmt(header), fmt(["-" * w for w in widths])]
    lines.extend(fmt(r) for r in rows)
    return "\n".join(lines)


def render_summary(s: dict) -> str:
    """Human-readable text for one :func:`summarize` result."""
    out = [
        f"events: {s['n_events']}   units done: {s['units_done']}   "
        f"experiments done: {s['experiments_done']}"
    ]
    if s["cells"]:
        rows = [
            [c["algo"], c["sample_size"], c["n_experiments"],
             f"{c['wall_s']:.3f}", f"{c['compile_s']:.3f}",
             f"{c['measure_s']:.3f}"]
            for c in s["cells"]
        ]
        out.append("\nper-cell stage breakdown (seconds)")
        out.append(_table(rows, ["algo", "S", "E", "wall", "compile", "measure"]))
    if s["stages"]:
        rows = [
            [name, st["count"], f"{st['total_s']:.3f}", f"{st['p50']*1e3:.3f}",
             f"{st['p90']*1e3:.3f}", f"{st['p99']*1e3:.3f}",
             f"{st['max']*1e3:.3f}"]
            for name, st in s["stages"].items()
        ]
        out.append("\nper-stage durations (count, total s, p50/p90/p99/max ms)")
        out.append(_table(rows, ["stage", "n", "total", "p50", "p90", "p99", "max"]))
    if s["slowest_compiles"]:
        rows = [
            [f"{c['dur']*1e3:.3f}", c["src"] or "-", c["key"] or "-"]
            for c in s["slowest_compiles"]
        ]
        out.append("\nslowest compiles (ms)")
        out.append(_table(rows, ["ms", "src", "geometry"]))
    if s["invalid"]:
        rows = [[rule, n] for rule, n in s["invalid"].items()]
        out.append("\ninvalid configs by rule")
        out.append(_table(rows, ["rule", "count"]))
    if s["serving"]:
        rows = [[k, s["serving"][k]] for k in sorted(s["serving"])]
        out.append("\nserving / fleet")
        out.append(_table(rows, ["counter", "total"]))
    if s["counters"]:
        rows = [[k, s["counters"][k]] for k in sorted(s["counters"])]
        out.append("\ncounter totals")
        out.append(_table(rows, ["counter", "total"]))
    return "\n".join(out)
