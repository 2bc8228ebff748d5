"""Fault-tolerant training runtime (a port of
``repro.runtime.fault_tolerance``).

``TrainingRunner`` wraps a train step with:

  * periodic asynchronous checkpoints (atomic; resume picks up the exact
    step, and the data pipeline is a pure function of the step, so the
    token stream replays identically),
  * automatic restore-on-start,
  * a straggler watchdog: per-step wall times feed a rolling median; any
    step slower than ``straggler_factor`` x median raises a
    :class:`StragglerEvent` through the callback,
  * failure injection for tests (``fail_at_step``) proving the
    checkpoint/restart path end to end.

Step times come from :func:`repro_torch.core.clock.monotonic`, so a test can
tick a fake clock.  Reading the loss as a float waits for the device, so a
step's time on the card includes its device work.  Elastic rescaling
(``runtime/elastic.py``) needs sharding and lands with ROADMAP item 6c.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..checkpoint.checkpointer import AsyncCheckpointer, latest_step, restore
from ..core import clock


class InjectedFailure(RuntimeError):
    pass


@dataclass
class StragglerEvent:
    step: int
    step_time: float
    median: float


@dataclass
class RunnerConfig:
    ckpt_dir: str
    ckpt_every: int = 50
    keep: int = 3
    straggler_factor: float = 3.0
    fail_at_step: int | None = None      # test hook


@dataclass
class RunnerReport:
    steps_run: int = 0
    restored_from: int | None = None
    stragglers: list = field(default_factory=list)
    losses: list = field(default_factory=list)


class TrainingRunner:
    def __init__(self, cfg: RunnerConfig, train_step, make_batch):
        """train_step: (state, batch) -> (state, metrics);
        make_batch: step -> batch (pure function of the step)."""
        self.cfg = cfg
        self.train_step = train_step
        self.make_batch = make_batch
        self.ckpt = AsyncCheckpointer(cfg.ckpt_dir, keep=cfg.keep)

    def run(self, state, n_steps: int, start_step: int = 0,
            on_straggler=None) -> tuple[dict, RunnerReport]:
        report = RunnerReport()
        # resume if a checkpoint exists
        last = latest_step(self.cfg.ckpt_dir)
        if last is not None and last > start_step:
            state, start_step = restore(self.cfg.ckpt_dir, state, last)
            report.restored_from = last
        times: list[float] = []
        step = start_step
        try:
            while step < n_steps:
                if self.cfg.fail_at_step is not None and step == self.cfg.fail_at_step:
                    raise InjectedFailure(f"injected failure at step {step}")
                t0 = clock.monotonic()
                batch = self.make_batch(step)
                state, metrics = self.train_step(state, batch)
                loss = float(metrics["loss"])
                dt = clock.monotonic() - t0
                times.append(dt)
                report.losses.append(loss)
                med = float(np.median(times[-20:]))
                if len(times) > 5 and dt > self.cfg.straggler_factor * med:
                    ev = StragglerEvent(step, dt, med)
                    report.stragglers.append(ev)
                    if on_straggler:
                        on_straggler(ev)
                step += 1
                report.steps_run += 1
                if step % self.cfg.ckpt_every == 0:
                    self.ckpt.save(step, state)
        finally:
            self.ckpt.wait()
        self.ckpt.save(step, state)
        self.ckpt.wait()
        return state, report
