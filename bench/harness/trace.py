"""The traced run's device timeline: ``torch.profiler`` over the window,
reduced to busy seconds, the top device operations and the idle gaps
labelled by what the host was doing.

The host's labels come from the program's own trace sink: every pipeline
stage of ``CudaMeasurement`` (screen, compile, time, record) is a ``stage``
event stamped on the host's ``perf_counter`` at its end, with its duration.
Host time inside a tune call but outside every stage is the searcher's
(``search``); outside every call it is the harness loop's (``harness``).
A ``record_function`` marker opened at a known ``perf_counter`` reading
maps the host's clock onto the profiler's.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from collections import defaultdict

#: chrome-trace categories of work on the device
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
MARKER = "bench.window"


def merge(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    """Union of ``(start, end)`` intervals, sorted and disjoint."""
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def clip(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    return [(max(s, lo), min(e, hi)) for s, e in intervals if e > lo and s < hi]


def gaps(busy: list[tuple[float, float]], lo: float, hi: float) -> list[tuple[float, float]]:
    """The stretches of ``[lo, hi]`` that no interval of ``busy`` (merged)
    covers."""
    out, t = [], lo
    for s, e in busy:
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out


def overlap(spans, labelled) -> dict[str, float]:
    """Seconds of ``spans`` (sorted, disjoint) covered by each label of
    ``labelled`` (``(start, end, label)``, sorted by start, disjoint)."""
    got: dict[str, float] = defaultdict(float)
    i = 0
    for s, e in spans:
        while i < len(labelled) and labelled[i][1] <= s:
            i += 1
        j = i
        while j < len(labelled) and labelled[j][0] < e:
            a, b, label = labelled[j]
            got[label] += max(0.0, min(b, e) - max(a, s))
            j += 1
    return dict(got)


def stage_intervals(trace_path: str) -> list[tuple[float, float, str]]:
    """``(start, end, stage)`` on the host's clock from the program's JSONL
    trace (``stage`` events carry their end ``t`` and ``dur``)."""
    out = []
    with open(trace_path, encoding="utf-8") as f:
        for line in f:
            try:
                ev = json.loads(line)
            except ValueError:
                continue
            if ev.get("ev") == "stage":
                out.append((ev["t"] - ev["dur"], ev["t"], str(ev["stage"])))
    out.sort()
    return out


def summarize(events: list[dict], host0: float, calls, stages) -> dict:
    """Busy seconds, the window, the top device operations and the idle
    seconds by host label, from a chrome trace's events.

    ``host0`` is the ``perf_counter`` reading taken as the marker opened;
    ``calls`` the tune calls' ``(t0, t1)`` and ``stages`` the program's stage
    intervals, both on that clock."""
    marks = [e for e in events if e.get("name") == MARKER and e.get("ph") == "X"
             and e.get("cat") == "user_annotation"]
    if not marks:
        raise RuntimeError(f"the profiler's trace lacks the {MARKER!r} marker")
    w0 = float(marks[0]["ts"]) * 1e-6
    w1 = w0 + float(marks[0]["dur"]) * 1e-6
    offset = w0 - host0  # host clock -> profiler clock, seconds
    dev = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    spans = clip([(float(e["ts"]) * 1e-6, (float(e["ts"]) + float(e["dur"])) * 1e-6)
                  for e in dev], w0, w1)
    busy = merge(spans)
    busy_s = sum(e - s for s, e in busy)
    by_name: dict[str, float] = defaultdict(float)
    for e in dev:
        s = float(e["ts"]) * 1e-6
        if w0 <= s < w1:
            by_name[e["name"]] += float(e["dur"]) * 1e-6
    idle = gaps(busy, w0, w1)
    idle_s = sum(e - s for s, e in idle)
    in_stage = overlap(idle, [(a + offset, b + offset, lab) for a, b, lab in stages])
    in_call = overlap(idle, [(a + offset, b + offset, "call") for a, b in calls]).get("call", 0.0)
    labels = {f"{k} stage": v for k, v in in_stage.items()}
    labels["search (in a call, outside every stage)"] = in_call - sum(in_stage.values())
    labels["harness (between calls)"] = idle_s - in_call
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {
        "busy_s": busy_s,
        "window_s": w1 - w0,
        "idle_s": idle_s,
        "n_device_ops": len(dev),
        "device_ops": [[k, v] for k, v in top],
        "idle_gaps": [[k, v] for k, v in sorted(labels.items(), key=lambda kv: -kv[1])
                      if v > 0][:10],
        "longest_gap_s": max((e - s for s, e in idle), default=0.0),
    }


class DeviceTrace:
    """``with DeviceTrace(): ...`` profiles the block; :meth:`summary`
    reduces it.  The chrome trace goes to a temporary file under
    ``$TMPDIR`` and is deleted once read."""

    def __init__(self):
        self._prof = None
        self._mark = None
        self.host0 = None
        self.events: list[dict] = []

    @staticmethod
    def _profiler():
        from torch.profiler import ProfilerActivity, profile

        return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])

    @classmethod
    def warm(cls) -> None:
        """Start and stop the profiler once (its first start loads CUPTI),
        so that cost falls in set-up, not in the window."""
        import torch

        with cls._profiler():
            torch.ones(1, device="cuda").add_(1)
            torch.cuda.synchronize()

    def __enter__(self):
        from torch.profiler import record_function

        self._prof = self._profiler()
        self._prof.__enter__()
        self._mark = record_function(MARKER)
        self._mark.__enter__()
        self.host0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        import torch

        torch.cuda.synchronize()
        self._mark.__exit__(*exc)
        self._prof.__exit__(*exc)
        if exc[0] is None:
            fd, path = tempfile.mkstemp(suffix=".json")
            os.close(fd)
            try:
                self._prof.export_chrome_trace(path)
                with open(path, encoding="utf-8") as f:
                    self.events = json.load(f)["traceEvents"]
                self.trace_bytes = os.path.getsize(path)
            finally:
                os.unlink(path)
        self._prof = None
        return False
