"""Chrome trace-event export: ``about://tracing`` / Perfetto flamegraphs (a
copy of ``repro.telemetry.export``).

Maps the JSONL stream onto the Chrome trace-event JSON object format
(https://docs.google.com/document/d/1CvAClvFfyA5R-PhYUmn5OOQtYMH4h6I0nSsKchNAySU):

* each writer (``src``) becomes its own *process* track, named by a
  metadata event — monotonic epochs differ across processes, so every
  track's timestamps are normalized to that writer's own first event
  (cross-track alignment would be fabricated and is not attempted),
* ``begin``/``end`` span events map to ``ph: "B"``/``"E"`` (the flame
  stack: matrix > unit > round > experiment),
* ``stage`` events map to complete ``ph: "X"`` slices with ``dur``,
* ``gauge`` events map to ``ph: "C"`` counter tracks,
* ``plan`` / ``cell`` / ``counters`` / ``totals`` map to instant events
  (``ph: "i"``) carrying their payload in ``args``.
"""

from __future__ import annotations

import json
import os

from .events import read_run


def _src_order(srcs) -> list[str]:
    """main first, then shards numerically, then anything else by name."""
    def key(s):
        if s == "main":
            return (0, 0, s)
        if s.startswith("shard") and s[5:].isdigit():
            return (1, int(s[5:]), s)
        return (2, 0, s)
    return sorted(srcs, key=key)


def _name(e: dict) -> str:
    span = e.get("span") or e.get("stage") or e.get("ev")
    if e.get("span") == "experiment" and "experiment" in e:
        return f"experiment {e['experiment']}"
    if e.get("span") == "round" and "round" in e:
        return f"round {e['round']}"
    if "unit" in e and e.get("span") == "unit":
        return f"unit {e['unit']}"
    return str(span)


def _args(e: dict) -> dict:
    skip = {"t", "seq", "src", "ev", "span", "stage", "dur"}
    return {k: v for k, v in e.items() if k not in skip}


def chrome_trace(events: list[dict]) -> dict:
    """The Chrome trace-event JSON object for an event list."""
    srcs = _src_order({str(e.get("src", "main")) for e in events})
    pid = {s: i + 1 for i, s in enumerate(srcs)}
    t0 = {}
    for e in events:
        s = str(e.get("src", "main"))
        t = float(e.get("t", 0.0))
        if s not in t0 or t < t0[s]:
            t0[s] = t
    out = [
        {
            "name": "process_name",
            "ph": "M",
            "pid": pid[s],
            "tid": 0,
            "args": {"name": s},
        }
        for s in srcs
    ]
    for e in events:
        s = str(e.get("src", "main"))
        base = {
            "pid": pid[s],
            "tid": 1,
            "ts": round((float(e.get("t", 0.0)) - t0[s]) * 1e6, 3),
        }
        ev = e.get("ev")
        if ev == "begin":
            out.append({**base, "name": _name(e), "ph": "B", "args": _args(e)})
        elif ev == "end":
            out.append({**base, "name": _name(e), "ph": "E", "args": _args(e)})
        elif ev == "stage":
            out.append(
                {
                    **base,
                    "name": str(e.get("stage")),
                    "ph": "X",
                    "dur": round(float(e.get("dur", 0.0)) * 1e6, 3),
                    "args": _args(e),
                }
            )
        elif ev == "gauge":
            out.append(
                {
                    **base,
                    "name": str(e.get("gauge")),
                    "ph": "C",
                    "args": {str(e.get("gauge")): e.get("value")},
                }
            )
        else:  # plan / cell / counters / totals / unknown -> instants
            out.append(
                {
                    **base,
                    "name": str(ev),
                    "ph": "i",
                    "s": "p",
                    "args": _args(e),
                }
            )
    return {"traceEvents": out, "displayTimeUnit": "ms"}


def export_chrome(run_dir: str, out_path: str | None = None) -> str:
    """Render ``run_dir``'s trace to Chrome trace JSON; returns the path."""
    trace = chrome_trace(read_run(run_dir))
    if out_path is None:
        out_path = os.path.join(run_dir, "trace_chrome.json")
    d = os.path.dirname(out_path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(out_path, "w", encoding="utf-8") as f:
        json.dump(trace, f)
    return out_path
