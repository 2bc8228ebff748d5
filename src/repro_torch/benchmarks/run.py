"""Benchmark driver — one function per paper table/figure.

Prints ``name,us_per_call,derived`` CSV rows:
  * per (benchmark x chip x algorithm x sample-size): the median tuned
    runtime in µs, with pct-of-optimum as the derived column (Fig. 2),
  * aggregate mean + CI rows (Fig. 3),
  * speedup-over-RS and CLES rows (Fig. 4a / 4b),
  * searcher-overhead microbenchmarks (µs per sample of algorithm cost),
  * the CUDA kernels on the card against their plain versions, in CUDA-event
    time at 8192x8192 f32, and a GA tune of add on the ``cuda`` backend.

The figure rows read a cost-model matrix: by default results/paper_matrix
if the full background run exists; otherwise a budget-scaled matrix
(--budget, default 500 — a few minutes on one core).  ``--full`` forces the
paper-exact design.  The searcher, engine, scheduler and telemetry rows
time host code on the cost model; the kernel rows need a card.

    PYTHONPATH=src python -m repro_torch.benchmarks.run --budget 100
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..analysis import load_all, validate
from ..analysis.stats import (
    fig2_pct_optimum,
    fig3_aggregate,
    fig4a_speedup,
    fig4b_cles,
)
from ..core import ExperimentDesign, TuningSession, TuningSpec, clock
from .paper_matrix import BENCHMARKS, CHIP_NAMES, combo_path, run_combo

#: the kernel rows' image: the port's full width, f32
KERNEL_X, KERNEL_Y = 8192, 8192


def ensure_matrix(out_dir: str, budget: int, shards: int = 1) -> str:
    full_dir = os.path.join("results", "paper_matrix")
    if all(
        os.path.exists(combo_path(full_dir, b, c))
        for b in BENCHMARKS
        for c in CHIP_NAMES
    ):
        return full_dir
    design = ExperimentDesign.scaled(budget=budget)
    os.makedirs(out_dir, exist_ok=True)
    for b in BENCHMARKS:
        for c in CHIP_NAMES:
            if not os.path.exists(combo_path(out_dir, b, c)):
                run_combo(b, c, design, out_dir, verbose=False, shards=shards,
                          backend="costmodel")
    return out_dir


def table_fig2(results_dir: str) -> None:
    results = load_all(results_dir)
    f2 = fig2_pct_optimum(results)
    for (bench, chip), algos in sorted(f2.items()):
        res, meta = results[(bench, chip)]
        for algo, row in algos.items():
            for s, pct in row.items():
                med = float(np.median(res.finals(algo, s)))
                print(f"fig2/{bench}_{chip}/{algo}/S{s},{med*1e6:.2f},{pct:.2f}")


def table_fig3(results_dir: str) -> None:
    agg = fig3_aggregate(load_all(results_dir))
    for algo, rows in agg.items():
        for s, (m, lo, hi) in rows.items():
            print(f"fig3/{algo}/S{s},{m:.3f},{lo:.2f}..{hi:.2f}")


def table_fig4(results_dir: str) -> None:
    results = load_all(results_dir)
    sp = fig4a_speedup(results)
    cl = fig4b_cles(results)
    for key in sorted(sp):
        bench, chip = key
        for algo in sp[key]:
            for s in sp[key][algo]:
                print(
                    f"fig4a/{bench}_{chip}/{algo}/S{s},{sp[key][algo][s]:.4f},"
                    f"cles={cl[key][algo][s]:.4f}"
                )


def table_searcher_overhead() -> None:
    """Algorithm cost per sample (the paper ignores it by design — section V
    — but the framework reports it for completeness), on the cost model."""
    for algo in ("rs", "rf", "ga", "bo_gp", "bo_tpe", "sa", "pso"):
        session = TuningSession(
            TuningSpec(kernel="harris", searcher=algo, backend="costmodel",
                       budget=100, seed=0)
        )
        t0 = clock.monotonic()
        session.run()
        dt = clock.monotonic() - t0
        print(f"searcher_overhead/{algo},{dt/100*1e6:.1f},budget=100")


def table_engine_dispatch(budget: int = 400) -> None:
    """Batched ask/tell engine vs sequential dispatch on the vectorized
    cost-model backend: Python-level measurement dispatches and wall clock
    per searcher.  The batched path must dispatch >=5x less (it does ~100x
    less for the batch-friendly searchers)."""
    tot_b = tot_o = 0
    for algo in ("rs", "rf", "ga", "pso", "grid"):
        spec = TuningSpec(kernel="harris", searcher=algo, backend="costmodel",
                          budget=budget, seed=0)
        sb = TuningSession(spec)
        t0 = clock.monotonic()
        sb.run()
        t_batch = clock.monotonic() - t0
        so = TuningSession(spec.replace(dispatch="one"))
        t0 = clock.monotonic()
        so.run()
        t_one = clock.monotonic() - t0
        tot_b += sb.measurement.n_dispatches
        tot_o += so.measurement.n_dispatches
        ratio = so.measurement.n_dispatches / max(1, sb.measurement.n_dispatches)
        print(
            f"engine_dispatch/{algo},{t_batch*1e6:.0f},"
            f"dispatches={sb.measurement.n_dispatches}v{so.measurement.n_dispatches} "
            f"ratio={ratio:.0f}x wall={t_one/max(t_batch,1e-9):.1f}x"
        )
    print(
        f"engine_dispatch/aggregate,{tot_b},"
        f"sequential={tot_o} ratio={tot_o/max(1,tot_b):.1f}x"
    )


def table_kernels(x: int = KERNEL_X, y: int = KERNEL_Y) -> None:
    """Device time of the CUDA kernels and of their plain versions on the
    card, read from CUDA events (mean of back-to-back calls), at the
    reference row's config.  add sums two distinct images (the reference's
    row adds an image to itself, which reads one array twice).  Every
    kernel call goes through its counted wrapper, which launches on the
    card or raises."""
    import torch

    from ..cuda_bench.events import time_ms
    from ..kernels import TUNABLE_KERNELS, add_ref, harris_ref, mandelbrot_ref

    gen = torch.Generator(device="cuda").manual_seed(0)
    img = torch.randn((x, y), generator=gen, device="cuda")
    other = torch.randn((x, y), generator=gen, device="cuda")
    cfg = dict(t_x=2, t_y=1, t_z=2, w_x=1, w_y=1, w_z=2)
    rows = (
        ("add", lambda: TUNABLE_KERNELS["add"](img, other, cfg),
         lambda: add_ref(img, other), 20),
        ("harris", lambda: TUNABLE_KERNELS["harris"](img, cfg),
         lambda: harris_ref(img), 10),
        ("mandelbrot", lambda: TUNABLE_KERNELS["mandelbrot"](x, y, cfg, device="cuda"),
         lambda: mandelbrot_ref(x, y, device="cuda"), 3),
    )
    for name, kernel, plain, n_plain in rows:
        t = time_ms(kernel, 20) * 1e3
        r = time_ms(plain, n_plain, warmup=1) * 1e3
        print(f"kernel_cuda/{name},{t:.1f},plain_us={r:.1f} {x}x{y}")


def table_cuda_backend(budget: int = 10) -> None:
    """The real-measurement path end-to-end on the card: tune the add kernel
    through ``backend="cuda"`` (validity pre-screen, warm-once-per-geometry,
    timed launches) and report the tuned time plus compiles per sample
    served (the first warmed launch per geometry)."""
    session = TuningSession(
        TuningSpec(
            kernel="add",
            searcher="ga",
            backend="cuda",
            backend_kwargs={"repeats": 3},
            budget=budget,
            final_repeats=3,
            seed=0,
        )
    )
    r = session.run()
    prov = session.measurement.provenance()
    print(
        f"cuda_backend/add,{r.final_value*1e6:.0f},"
        f"compiles={prov['n_compiles']}/{r.n_samples} "
        f"invalid={prov['n_invalid']} device={prov['device_kind']!r}"
    )


def table_scheduler_tail(slow_ms: float = 30.0, workers: int = 2) -> None:
    """Work-stealing vs static scheduling around a straggler cell: one cell's
    experiments each pay a slow synthetic dispatch (standing in for a
    geometry that runs far slower than its neighbours), so the static
    one-partition-per-worker schedule stalls its join behind whichever
    worker drew the straggler while the stealing scheduler splits it by
    predicted cost and rebalances.  Values must be identical across serial /
    static / steal; the wall-clock ratio is the tracked number."""
    import time
    from concurrent.futures import ThreadPoolExecutor

    from ..core.backends import BACKENDS, Backend, register_backend
    from ..core.measurement import BaseMeasurement
    from ..core.runner import stable_seed
    from ..core.space import Param, SearchSpace

    slow_s, n_exp, seed0 = 32, 4, 3

    class StragglerMeasurement(BaseMeasurement):
        """Deterministic pure-function values; experiments whose seed is in
        ``slow_seeds`` pay one ``slow_ms`` sleep per search dispatch."""

        def __init__(self, slow: bool, sleep_s: float):
            super().__init__()
            self._slow = slow
            self._sleep_s = sleep_s

        def _value(self, config) -> float:
            key = ",".join(f"{k}={v}" for k, v in sorted(config.items()))
            return 0.1 + (stable_seed(key) % 4096) / 4096.0

        def _measure_one(self, config) -> float:
            return self._value(config)

        def measure_batch(self, configs):
            self.n_samples += len(configs)
            self.n_dispatches += 1
            if self._slow:
                time.sleep(self._sleep_s)
            return np.array([self._value(c) for c in configs], dtype=np.float64)

    # the straggler cell is the largest sample size: the cost model's
    # samples-x-experiments weight marks it most expensive, so the stealing
    # split slices it first
    slow_seeds = tuple(stable_seed(seed0, "rs", slow_s, e) for e in range(n_exp))
    if "straggler" not in BACKENDS:
        register_backend(
            Backend(
                name="straggler",
                make=lambda kernel="straggler", seed=0, slow_seeds=(),
                slow_ms=0.0, **_: StragglerMeasurement(
                    seed in set(slow_seeds), slow_ms / 1e3
                ),
                default_space=lambda kernel="straggler", **_: SearchSpace(
                    [Param.int_range("t_x", 1, 16), Param.int_range("t_y", 1, 16)]
                ),
            )
        )
    spec = TuningSpec(
        kernel="straggler",
        backend="straggler",
        backend_kwargs={"slow_seeds": list(slow_seeds), "slow_ms": slow_ms},
        searcher="rs",
        algorithms=("rs",),
        design=ExperimentDesign(
            sample_sizes=(slow_s, 8, 10, 12),
            n_experiments=(n_exp,) * 4,
            final_repeats=3,
        ),
        dataset_size=None,
        seed=seed0,
    )

    def run(**kw):
        session = TuningSession(spec)
        t0 = clock.monotonic()
        res = session.run_matrix(**kw)
        return res, clock.monotonic() - t0

    serial, t_serial = run()
    static, t_static = run(
        executor="futures", max_workers=workers, scheduler="static",
        futures_pool=ThreadPoolExecutor(max_workers=workers),
    )
    steal, t_steal = run(
        executor="futures", max_workers=workers,
        futures_pool=ThreadPoolExecutor(max_workers=workers),
    )
    same = int(
        all(
            np.array_equal(
                serial.cells[k].final_values, other.cells[k].final_values
            )
            and np.array_equal(
                serial.cells[k].search_best_values,
                other.cells[k].search_best_values,
            )
            for other in (static, steal)
            for k in serial.cells
        )
    )
    if not same:
        raise AssertionError("scheduler changed values — the speed-knob contract broke")
    print(f"scheduler_tail/serial,{t_serial*1e6:.0f},cells=4 straggler=S32")
    print(
        f"scheduler_tail/static,{t_static*1e6:.0f},"
        f"workers={workers} speedup_vs_serial="
        f"{t_serial/max(t_static,1e-9):.2f}x"
    )
    print(
        f"scheduler_tail/steal,{t_steal*1e6:.0f},"
        f"workers={workers} speedup_vs_static="
        f"{t_static/max(t_steal,1e-9):.2f}x identical={same}"
    )


def table_telemetry_overhead(budget: int = 400) -> None:
    """Tracing cost on the hot path: the same cost-model tuning run with the
    default no-op telemetry vs a real JSONL tracer.  The tuned result must
    be identical (telemetry is observability only); the per-sample delta in
    µs is the tracked overhead number."""
    import shutil
    import tempfile

    from ..telemetry import TRACE_FILE, Telemetry

    spec = TuningSpec(kernel="harris", searcher="ga", backend="costmodel",
                      budget=budget, seed=0)
    t0 = clock.monotonic()
    off = TuningSession(spec).run()
    t_off = clock.monotonic() - t0

    tmp = tempfile.mkdtemp(prefix="tel_overhead_")
    try:
        tel = Telemetry(os.path.join(tmp, TRACE_FILE))
        t0 = clock.monotonic()
        on = TuningSession(spec, telemetry=tel).run()
        t_on = clock.monotonic() - t0
        tel.close()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    same = int(on.best_value == off.best_value)
    print(f"telemetry_overhead/off,{t_off/budget*1e6:.2f},budget={budget}")
    print(
        f"telemetry_overhead/on,{t_on/budget*1e6:.2f},"
        f"delta_us={(t_on-t_off)/budget*1e6:.2f} identical={same}"
    )


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.benchmarks.run")
    ap.add_argument("--budget", type=int, default=500)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--shards", type=int, default=1)
    args = ap.parse_args(argv)

    t0 = clock.monotonic()
    if args.full:
        out = os.path.join("results", "paper_matrix")
        os.makedirs(out, exist_ok=True)
        for b in BENCHMARKS:
            for c in CHIP_NAMES:
                if not os.path.exists(combo_path(out, b, c)):
                    run_combo(b, c, ExperimentDesign.paper(), out,
                              shards=args.shards, backend="costmodel")
        results_dir = out
    else:
        results_dir = ensure_matrix(
            os.path.join("results", f"matrix_{args.budget}"), args.budget,
            shards=args.shards,
        )
    print(f"# matrix: {results_dir}")
    table_fig2(results_dir)
    table_fig3(results_dir)
    table_fig4(results_dir)
    table_searcher_overhead()
    table_engine_dispatch()
    table_kernels()
    table_cuda_backend()
    table_scheduler_tail()
    table_telemetry_overhead()
    print("# paper-claims validation")
    checks = validate(results_dir)
    for name, v in checks.items():
        print(f"claim/{name},{v.status},{v.detail}")
    print(f"# total {clock.monotonic()-t0:.0f}s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
