"""The trace writer: spans, events, counters — one JSONL stream per writer
(a port of ``repro.telemetry.tracer``).

:class:`Telemetry` is the enabled implementation of the sink API whose
no-op twin lives in :mod:`.null`.  One writer owns one append-only JSONL
file and stamps every event with ``(t, seq, src)`` — ``t`` from the
injectable ``repro_torch.core.clock`` seam (so tests can drive traces on
deterministic timestamps), ``seq`` a per-writer total order, ``src`` the
writer id (``"main"`` in the parent, ``"shard<k>"`` in workers).

Writes are line-buffered and flushed per event: ``tail --follow`` reads the
file while the run is live, and a killed process loses at most one torn
line (the readers skip it).  All methods are thread-safe — the ``device``
executor's card threads each own a writer, and the serving endpoint's
request threads share one.

``stage`` events carry the duration the stage clock was charged, unrounded
(the reference rounds it to 1 µs), so a trace's per-stage totals agree with
the units' ``stage_s`` to float precision however many stages ran.

Telemetry is a pure observability knob: nothing here feeds cache keys,
journal namespaces, or measurement values, and a run with a writer attached
produces bit-identical measurement stores to one without.
"""

from __future__ import annotations

import json
import os
import threading
from contextlib import contextmanager

from ..core.clock import monotonic
from .events import SHARD_RE, TRACE_FILE, shard_file


class Telemetry:
    """Append-only JSONL trace writer + counters registry.

    ``path`` is the trace file (created lazily on the first event, in append
    mode — a resumed run extends the same trace).  ``src`` tags every event
    with the writer's identity.  ``clock`` overrides the timestamp source
    (default: the ``repro_torch.core.clock`` seam).
    """

    enabled = True

    def __init__(self, path: str, *, src: str = "main", clock=None):
        self.path = str(path)
        self.src = str(src)
        self._clock = clock if clock is not None else monotonic
        self._lock = threading.Lock()
        self._fh = None
        self._seq = 0
        self._counters: dict[str, float] = {}

    # -- plumbing --------------------------------------------------------------
    @property
    def dir(self) -> str:
        return os.path.dirname(self.path) or "."

    def _emit(self, ev: str, fields: dict) -> None:
        record = {"t": round(float(self._clock()), 6), "src": self.src, "ev": ev}
        record.update(fields)
        with self._lock:
            # seq is assigned under the lock so it is a true total order for
            # this writer even with several threads emitting concurrently
            record["seq"] = self._seq
            self._seq += 1
            line = json.dumps(record, sort_keys=True)
            if self._fh is None:
                d = self.dir
                if d:
                    os.makedirs(d, exist_ok=True)
                self._fh = open(self.path, "a", encoding="utf-8")
            self._fh.write(line + "\n")
            self._fh.flush()

    # -- spans & events --------------------------------------------------------
    @contextmanager
    def span(self, name: str, **attrs):
        """Emit ``begin``/``end`` around a code region.  The ``end`` event
        carries ``dur`` (seconds, same clock as ``t``) and ``ok: false``
        when the region raised — a wedged or crashed worker leaves either a
        dangling ``begin`` or a failed ``end``, both visible in the trace."""
        t0 = self._clock()
        self._emit("begin", {"span": name, **attrs})
        try:
            yield
        except BaseException:
            self._emit(
                "end",
                {"span": name, "dur": round(self._clock() - t0, 6),
                 "ok": False, **attrs},
            )
            raise
        self._emit(
            "end", {"span": name, "dur": round(self._clock() - t0, 6), **attrs}
        )

    def event(self, ev: str, **fields) -> None:
        """Emit one complete event of type ``ev`` (plan/cell/totals/...)."""
        self._emit(ev, fields)

    def stage(self, name: str, dur: float, **attrs) -> None:
        """A completed pipeline-stage interval (the high-frequency form:
        one line per stage execution, no begin/end pair), with the exact
        duration its stage clock was charged."""
        self._emit("stage", {"stage": name, "dur": float(dur), **attrs})

    # -- counters & gauges -----------------------------------------------------
    def inc(self, name: str, n=1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def gauge(self, name: str, value) -> None:
        """Instantaneous values are emitted immediately (they are a time
        series, not a total)."""
        self._emit("gauge", {"gauge": name, "value": value})

    def counters_snapshot(self) -> dict:
        with self._lock:
            return dict(self._counters)

    def emit_counters(self) -> None:
        snap = self.counters_snapshot()
        if snap:
            self._emit("counters", {"counters": snap})

    # -- shard plumbing (multi-process / multi-card runs) ----------------------
    def shard_path(self, shard: int) -> str:
        """Where worker ``shard`` writes its trace — ``trace.shard<k>.jsonl``
        beside this writer's file, mirroring the shard-store pattern."""
        return shard_file(self.path, shard)

    def shard_src(self, shard: int) -> str:
        return f"shard{int(shard)}"

    def absorb(self, paths) -> int:
        """Append shard trace files into this trace, deterministically:
        files in shard order, each file's own line order preserved.  Absorbed
        files are deleted (mirrors ``merge_shard_stores``).  Returns how
        many files were absorbed."""
        from .merge import absorb_traces  # lazy: merge imports events only

        return absorb_traces(self, paths)

    def recover(self) -> int:
        """Absorb shard traces a killed run left beside this trace (the
        kill-and-resume path; mirrors ``recover_shard_stores``)."""
        try:
            names = os.listdir(self.dir)
        except OSError:
            return 0
        leftovers = sorted(
            (int(m.group(1)), os.path.join(self.dir, n))
            for n in names
            if (m := SHARD_RE.match(n))
        )
        return self.absorb([p for _, p in leftovers])

    def close(self) -> None:
        """Flush the final counter snapshot and close the file handle."""
        self.emit_counters()
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None


def for_run_dir(run_dir: str, *, src: str = "main") -> Telemetry:
    """The conventional writer for a results directory: ``<dir>/trace.jsonl``."""
    return Telemetry(os.path.join(run_dir, TRACE_FILE), src=src)
