"""Live progress over a run's trace stream: done/total units + ETA (a copy
of ``repro.telemetry.progress``).

The parent's ``plan`` event fixes the denominators (``build_units`` totals,
minus what resume already served); everything after it in the merged stream
is current-session activity.  That positional rule is sound because the
trace is append-only and shard traces are only ever appended AFTER the plan
that scheduled them — a recovered pre-kill shard trace is absorbed before
the resumed session emits its plan, so stale experiment spans never inflate
the current session's progress.

``python -m repro_torch.telemetry tail [--follow]`` reads it, and
:class:`ProgressReporter` runs it on a thread beside a long matrix.
"""

from __future__ import annotations

import sys
import threading
from dataclasses import dataclass

from ..core.clock import monotonic
from .events import read_run


@dataclass
class ProgressState:
    """A snapshot of matrix progress derived from the trace."""

    units_total: int | None = None
    experiments_total: int | None = None
    units_done: int = 0
    experiments_done: int = 0
    has_plan: bool = False

    @property
    def complete(self) -> bool:
        return (
            self.experiments_total is not None
            and self.experiments_total > 0
            and self.experiments_done >= self.experiments_total
        )


def scan_events(events: list[dict]) -> ProgressState:
    """Progress from an event list (see the module docstring for why the
    position of the last ``plan`` event partitions past from present)."""
    state = ProgressState()
    plan_idx = -1
    for i, e in enumerate(events):
        if e.get("ev") == "plan":
            plan_idx = i
    if plan_idx >= 0:
        plan = events[plan_idx]
        state.has_plan = True
        state.units_total = plan.get("units_total")
        state.experiments_total = plan.get("experiments_total")
        state.units_done = int(plan.get("units_done_resume", 0) or 0)
        state.experiments_done = int(plan.get("experiments_done_resume", 0) or 0)
    for e in events[plan_idx + 1 :]:
        if e.get("ev") != "end":
            continue
        if e.get("span") == "unit":
            state.units_done += 1
        elif e.get("span") == "experiment":
            state.experiments_done += 1
    return state


def scan_progress(run_dir: str) -> ProgressState:
    """Progress snapshot for a run directory (merged + live shard traces)."""
    return scan_events(read_run(run_dir))


def format_progress(state: ProgressState, eta_s: float | None = None) -> str:
    """One status line: ``units 3/8 · experiments 120/400 (30%) · ETA 45s``."""
    def frac(done, total):
        return f"{done}/{total}" if total else f"{done}/?"
    parts = [
        f"units {frac(state.units_done, state.units_total)}",
        f"experiments {frac(state.experiments_done, state.experiments_total)}",
    ]
    if state.experiments_total:
        pct = 100.0 * state.experiments_done / state.experiments_total
        parts[-1] += f" ({pct:.0f}%)"
    if eta_s is not None:
        parts.append(f"ETA {eta_s:.0f}s" if eta_s < 3600 else f"ETA {eta_s/3600:.1f}h")
    return " · ".join(parts)


class ProgressReporter:
    """Periodically prints one progress line for a run dir to ``out``.

    ETA is rate-based over the reporter's own observation window (completed
    experiments per second since it started watching) — trace timestamps
    cannot be compared across writers, so the watcher's clock is the only
    honest timeline.  ``follow()`` blocks until the run completes or
    ``stop()`` is called; ``start()`` runs it on a daemon thread (the
    ``--progress`` flag's shape).
    """

    def __init__(self, run_dir: str, interval: float = 5.0, out=None):
        self.run_dir = run_dir
        self.interval = float(interval)
        self.out = out if out is not None else sys.stderr
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._t0: float | None = None
        self._done0: int | None = None

    def eta_s(self, state: ProgressState) -> float | None:
        now = monotonic()
        if self._t0 is None:
            self._t0, self._done0 = now, state.experiments_done
            return None
        dt = now - self._t0
        delta = state.experiments_done - (self._done0 or 0)
        if dt <= 0 or delta <= 0 or not state.experiments_total:
            return None
        remaining = max(0, state.experiments_total - state.experiments_done)
        return remaining / (delta / dt)

    def tick(self) -> ProgressState:
        state = scan_progress(self.run_dir)
        line = format_progress(state, self.eta_s(state))
        print(f"[progress] {line}", file=self.out, flush=True)
        return state

    def follow(self) -> None:
        while not self._stop.is_set():
            state = self.tick()
            if state.complete:
                break
            self._stop.wait(self.interval)

    def start(self) -> "ProgressReporter":
        self._thread = threading.Thread(
            target=self.follow, name="telemetry-progress", daemon=True
        )
        self._thread.start()
        return self

    def stop(self, final_tick: bool = True) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.interval + 5)
            self._thread = None
        if final_tick:
            self.tick()
