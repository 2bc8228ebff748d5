"""One run of one cell: set-up, the measured window, then the checks.

Order of a run:

1. set-up: the entry's warm-up (the kernel library built or loaded, one
   call of the cell's searcher at a small budget), the profiler's first
   start in a traced run; ``setup_s`` ends here;
2. the window: the entry's closed loop for ``seconds`` (profiled when
   traced, with the program's trace sink attached for the host's labels);
3. the device's peak memory is read, the program's state dropped;
4. the benchmark's own work: inputs made from the seed on the device, each
   distinct winner and the default config launched through the program's
   kernel call, compared with the plain reference, and timed with the
   benchmark's CUDA-event timer; the checks; the metric readers.

``correct`` needs every compared number within its limit, and no call
failed: a call fails when its winner's output is wrong, its reported time
is off the benchmark's own, or its record breaks a rule of the search loop.
"""

from __future__ import annotations

import gc
import json
import math
import os
import subprocess
import tempfile
import time
from dataclasses import dataclass, field

from bench.harness import layout, program, trace as trace_mod
from bench.harness.timing import kernel_ms

#: the benchmark's CUDA-event time of a call's winner over the call's
#: reported ``final_value``: above 1 means the tuner reported less time
#: than the kernel takes (a timer that measures the enqueue).  Set from
#: chip readings (PERF.md section 2).
TIMER_RATIO_LIMIT = 3.0
#: calls whose record breaks a rule of the search loop (exact)
RECORD_FAULTS_LIMIT = 0

DEFAULT_CONFIG = {"t_x": 1, "t_y": 1, "t_z": 1, "w_x": 1, "w_y": 1, "w_z": 1}


def config_key(cfg: dict) -> str:
    return json.dumps({k: int(v) for k, v in cfg.items()}, sort_keys=True)


@dataclass
class Context:
    """What an entry driver needs: the cell, the device, the run's seed."""

    cell: layout.Cell
    seed: int
    device: str = "cuda"

    @property
    def backend_kwargs(self) -> dict:
        kw = {"x": int(self.cell.config["x"]), "y": int(self.cell.config["y"])}
        if self.device != "cuda":
            kw["device"] = self.device
        return kw

    def synchronize(self) -> None:
        if self.device == "cuda":
            import torch

            torch.cuda.synchronize()


@dataclass
class Run:
    """Everything a metric reader may read."""

    cell: layout.Cell
    setup_s: float
    start: float
    calls: list
    winner_ms: dict = field(default_factory=dict)   # config key -> event ms
    default_ms: float | None = None
    bound_ms: float | None = None
    bound_by: str | None = None
    trace: dict | None = None

    @property
    def samples(self) -> int:
        return sum(c["samples"] for c in self.calls)


def power_limit() -> str | None:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return out.strip().splitlines()[0] if out.strip() else None


def bench_generator(seed: int, device: str):
    import torch

    return torch.Generator(device=device).manual_seed(int(seed) % (2**63))


def check_kernels(run: Run, ref, seed: int, device: str, timer) -> dict:
    """Each distinct winner and the default config, launched through the
    program's kernel call on the benchmark's inputs: the reference's number
    for each (the largest is compared) and the benchmark's time of each."""
    x, y = int(run.cell.config["x"]), int(run.cell.config["y"])
    kernel = run.cell.config["kernel"]
    inputs = ref.make_inputs(x, y, bench_generator(seed, device), device)
    expect = ref.reference(inputs, x, y, device)
    winners = {config_key(c["winner"]): c["winner"] for c in run.calls}
    default = config_key(DEFAULT_CONFIG)
    errors = {}
    for key, cfg in {**winners, default: DEFAULT_CONFIG}.items():
        got = program.run_kernel(kernel, inputs, cfg, x, y, device)
        errors[key] = float(ref.error(got, expect))
        del got
        ms = timer(lambda cfg=cfg: program.run_kernel(kernel, inputs, cfg, x, y, device))
        if key == default:
            run.default_ms = ms
        if key in winners:
            run.winner_ms[key] = ms
    nbytes, ops = ref.counts(x, y, expect)
    del expect, inputs
    return {"errors": errors, "bytes": nbytes, "ops": ops}


def roofline_bound(nbytes: float, ops: float, peaks: dict | None):
    """``(ms, "bytes" | "operations")``: the larger of bytes over the HBM
    rate and f32 operations over the f32 rate; ``(None, None)`` for a card
    the table lacks."""
    if peaks is None:
        return None, None
    t_bytes = nbytes / peaks["bytes_per_s"] * 1e3
    t_ops = ops / peaks["f32_per_s"] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def evaluate(run: Run, ref, kernel_errors: dict) -> tuple[dict, int]:
    """The compared numbers with their limits, and the failed calls."""
    ratios = [run.winner_ms[config_key(c["winner"])] / (c["final_s"] * 1e3)
              if c["final_s"] > 0 and math.isfinite(c["final_s"]) else math.inf
              for c in run.calls]
    err = max(kernel_errors.values())
    checks = {
        ref.CHECK: {"value": err, "limit": ref.LIMIT},
        "timer_ratio": {"value": max(ratios), "limit": TIMER_RATIO_LIMIT},
        "record_faults": {"value": sum(1 for c in run.calls if c["faults"]),
                          "limit": RECORD_FAULTS_LIMIT},
    }
    failed = sum(
        1 for c, r in zip(run.calls, ratios)
        if c["faults"] or r > TIMER_RATIO_LIMIT
        or kernel_errors[config_key(c["winner"])] > ref.LIMIT)
    return checks, failed


def read_metrics(run: Run, metrics) -> dict:
    out = {}
    for m in metrics:
        value = layout.reader(m["name"], run.cell.root).read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def run_cell(cell: layout.Cell, *, seed: int, seconds: float, trace: bool,
             t_start: float, device: str = "cuda", timer=kernel_ms) -> dict:
    """One run; returns the result line's object (``checks`` last)."""
    ctx = Context(cell=cell, seed=seed, device=device)
    entry = layout.entry(cell.traffic["entry"], cell.root)
    ref = layout.reference(cell.config["kernel"], cell.root)
    set_up = entry.setup(ctx)
    if trace:
        trace_mod.DeviceTrace.warm()
    setup_s = time.perf_counter() - t_start

    summary = None
    if trace:
        with tempfile.TemporaryDirectory() as tmp:
            sink = program.telemetry(os.path.join(tmp, "trace.jsonl"))
            with trace_mod.DeviceTrace() as dt:
                start, calls = entry.window(ctx, seconds, telemetry=sink)
            sink.close()
            summary = trace_mod.summarize(
                dt.events, dt.host0, [(c["t0"], c["t1"]) for c in calls],
                trace_mod.stage_intervals(sink.path))
            summary["trace_bytes"] = dt.trace_bytes
            del dt
    else:
        start, calls = entry.window(ctx, seconds)

    device_info = {"platform": "gpu" if device == "cuda" else device, "count": 1}
    if device == "cuda":
        import torch

        device_info["kind"] = torch.cuda.get_device_name(0)
        device_info["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated())
        gc.collect()
        torch.cuda.empty_cache()
    run = Run(cell=cell, setup_s=setup_s, start=start, calls=calls, trace=summary)
    kern = check_kernels(run, ref, seed, device, timer)
    if device == "cuda":
        device_info["power"] = power_limit()
        peaks = layout.peaks(cell.root).get(device_info["kind"])
        run.bound_ms, run.bound_by = roofline_bound(kern["bytes"], kern["ops"], peaks)
    checks, failed = evaluate(run, ref, kern["errors"])
    if summary is not None:
        device_info["busy_s"] = summary["busy_s"]
        device_info["window_s"] = summary["window_s"]
    result = {
        "correct": failed == 0 and all(v["value"] <= v["limit"] for v in checks.values()),
        "attempted": len(calls),
        "failed": failed,
        "metrics": read_metrics(run, cell.metrics(trace)),
        "device": device_info,
    }
    if summary is not None:
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    result["run"] = {
        "calls": len(calls),
        "samples": run.samples,
        "window_s": (calls[-1]["t1"] - start) if calls else None,
        "distinct_winners": len(run.winner_ms),
        "default_ms": run.default_ms,
        "bound_ms": run.bound_ms,
        "bound_by": run.bound_by,
        **set_up,
        **({"trace": {k: v for k, v in summary.items()
                      if k not in ("device_ops", "idle_gaps")}} if summary else {}),
        "call_s": [round(c["t1"] - c["t0"], 4) for c in calls],
        "stage_s": {k: round(sum(c["stage_s"].get(k, 0.0) for c in calls), 4)
                    for k in sorted({k for c in calls for k in c["stage_s"]})},
        "search_s": round(sum(c["wall_s"] - sum(c["stage_s"].values()) for c in calls), 4),
        "faults": sorted({f for c in calls for f in c["faults"]})[:5],
    }
    result["checks"] = checks
    return result
