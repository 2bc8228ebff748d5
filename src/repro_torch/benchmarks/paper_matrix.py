"""Run the paper's full experiment matrix through the ``repro_torch.tune_matrix``
facade.

3 benchmarks (add / harris / mandelbrot) x 5 algorithms (rs / rf / ga /
bo_gp / bo_tpe) x sample sizes {25, 50, 100, 200, 400} with experiment
counts {800, 400, 200, 100, 50} (or a budget-scaled design).  By default
every sample is a real kernel measurement on the card (``--backend cuda``):
the chip axis collapses to the backend's own name, ``cuda`` (the card is
the chip), so each benchmark is one combo ``<bench>_cuda``.  ``--backend
costmodel`` runs the analytical TPU model on its three chip models (v5e /
v4 / v3) instead, as the reference's driver does by default.  Each
(benchmark, chip) combo is one declarative :class:`TuningSpec`; results are
persisted per combo (``.npz`` + versioned ``RunRecord`` JSON) so finished
combos are skipped on re-run.

Each combo decomposes into work units run through the ``EXECUTORS``
registry: ``--executor process --max-workers N`` fans units (including
within-cell splits of the big-E rows) across N workers, bit-identical to
the serial run; ``--executor device`` runs one thread per card;
``--resume`` replays units an interrupted run already journaled in the
measurement store, re-measuring nothing.  ``--shards N`` is the legacy
spelling of the process executor.

``--report`` renders ``REPORT.md`` (speedup/rank tables, figures, paper-claim
verdicts — see ``repro_torch.analysis``) into the results dir after the run.
``--telemetry`` writes a JSONL span trace into the results dir;
``--progress`` adds a periodic one-line units-done/ETA update on stderr —
observability only, results and stores are bit-identical with either flag
on or off.  ``--serve-dir`` folds each combo's winners into a serving store.

The card is the default device; ``--device cpu`` runs the kernels' plain
versions on the CPU (``--backend cuda`` only), and a host with no card
raises otherwise.

Usage:
    PYTHONPATH=src python -m repro_torch.benchmarks.paper_matrix --design smoke \\
        --bench mandelbrot --report
    PYTHONPATH=src python -m repro_torch.benchmarks.paper_matrix --backend costmodel \\
        --design scaled --budget 2000 --executor process --max-workers 4 \\
        --store sqlite --resume --report
"""

from __future__ import annotations

import argparse
import os

from .. import RunRecord, tune_matrix
from ..core import ExperimentDesign, TuningSpec, clock

BENCHMARKS = ("add", "harris", "mandelbrot")
CHIP_NAMES = ("v5e", "v4", "v3")
ALGOS = ("rs", "rf", "ga", "bo_gp", "bo_tpe")
DATASET_SEED = 7
GEN_SEED = 999


def combo_path(out_dir: str, bench: str, chip: str) -> str:
    return os.path.join(out_dir, f"{bench}_{chip}.npz")


def combo_spec(bench: str, chip_name: str, design: ExperimentDesign,
               out_dir: str, algorithms=ALGOS, seed: int = 0,
               cache: bool = True, dispatch: str = "batch",
               store: str = "json", backend: str = "cuda",
               backend_kwargs: dict | None = None) -> TuningSpec:
    """The declarative spec for one (benchmark, chip) combo.

    ``backend="cuda"`` times the real CUDA kernels (on the card; on the CPU's
    plain versions with ``backend_kwargs={"device": "cpu"}``); the chip axis
    collapses to the pseudo-target ``"cuda"`` (the card IS the chip) and the
    20k pre-generated dataset is skipped — generating it through real
    timings would dwarf the matrix itself.  RS/RF fall back to their
    searcher implementations.  ``backend_kwargs`` (device, x, y, repeats)
    apply to the ``cuda`` backend only; the cost model takes the chip.
    """
    store_ext = "sqlite" if store == "sqlite" else "json"
    cuda = backend == "cuda"
    return TuningSpec(
        kernel=bench,
        backend=backend,
        backend_kwargs=dict(backend_kwargs or {}) if cuda else {"chip": chip_name},
        algorithms=tuple(algorithms),
        design=design,
        seed=seed,
        dispatch=dispatch,
        cache_key=f"{bench}/{chip_name}",
        # persistent (kernel, config) cache: re-running an interrupted combo
        # serves every previously-measured cell from disk
        store=store if cache else None,
        store_path=(
            os.path.join(out_dir, f"{bench}_{chip_name}_cache.{store_ext}")
            if cache
            else None
        ),
        # the 20k pre-generated dataset serving the non-SMBO methods
        # (seeds in the filename: changing either invalidates the cache)
        dataset_size=None if cuda else 20000,
        dataset_seed=DATASET_SEED,
        dataset_gen_seed=GEN_SEED,
        dataset_cache=(
            os.path.join(
                out_dir,
                f"{bench}_{chip_name}_dataset_s{DATASET_SEED}g{GEN_SEED}.npz",
            )
            if cache and not cuda
            else None
        ),
    )


def run_combo(bench: str, chip_name: str, design: ExperimentDesign, out_dir: str,
              algorithms=ALGOS, seed: int = 0, verbose: bool = True,
              cache: bool = True, dispatch: str = "batch", shards: int = 1,
              store: str = "json", backend: str = "cuda",
              executor: str | None = None, max_workers: int | None = None,
              resume: bool = False,
              scheduler: str = "steal",
              telemetry_dir: str | None = None,
              progress: bool = False,
              backend_kwargs: dict | None = None) -> None:
    spec = combo_spec(bench, chip_name, design, out_dir, algorithms=algorithms,
                      seed=seed, cache=cache, dispatch=dispatch, store=store,
                      backend=backend, backend_kwargs=backend_kwargs)
    t0 = clock.monotonic()
    reporter = None
    if progress and telemetry_dir is not None:
        from ..telemetry import ProgressReporter

        # periodic units-done/total + ETA on stderr, fed by the live trace
        reporter = ProgressReporter(telemetry_dir)
        reporter.start()
    try:
        tune_matrix(spec, shards=shards, executor=executor,
                    max_workers=max_workers, resume=resume,
                    scheduler=scheduler,
                    out_dir=out_dir, verbose=verbose,
                    telemetry_dir=telemetry_dir)
    finally:
        if reporter is not None:
            reporter.stop()
    record = RunRecord.load(os.path.join(out_dir, f"{bench}_{chip_name}.json"))
    opt = record.result.get("true_optimum")
    opt_cfg = record.result.get("true_optimum_config")
    if opt is not None:
        detail = f"optimum {opt*1e3:.3f} ms @ {opt_cfg}"
    else:  # real-measurement backends have no analytic optimum
        detail = f"best observed {record.result['best_observed']*1e3:.3f} ms"
    print(f"[matrix] {bench} x {chip_name} done in {clock.monotonic() - t0:.0f}s "
          f"({detail})")


def index_matrix_winners(out_dir: str, serve_dir: str, *, benches, chips,
                         design: ExperimentDesign, store: str = "json",
                         backend: str = "cuda", algorithms=ALGOS) -> int:
    """Fold every finished combo's measurement store into ``serve_dir``'s
    serving store (``serve_dir/store.sqlite``): one winners-index record per
    (kernel, geometry, device).  Equivalent to ``python -m repro_torch.serving
    index --dir serve_dir <combo stores>`` but driven off the matrix's own
    specs, so it never picks up foreign store files sitting in ``out_dir``."""
    from ..core.stores import make_store
    from ..serving import index_winners, open_serve_store

    os.makedirs(serve_dir, exist_ok=True)
    dst, _kind = open_serve_store(os.path.join(serve_dir, "store.sqlite"))
    total = 0
    try:
        for bench in benches:
            for chip_name in chips:
                spec = combo_spec(bench, chip_name, design, out_dir,
                                  algorithms=algorithms, store=store,
                                  backend=backend)
                if spec.store_path is None or not os.path.exists(spec.store_path):
                    continue
                src = make_store(spec.store, spec.store_path)
                try:
                    total += index_winners(dst, src, save=False)
                finally:
                    if hasattr(src, "close"):
                        src.close()
        dst.save()
    finally:
        if hasattr(dst, "close"):
            dst.close()
    return total


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.benchmarks.paper_matrix")
    ap.add_argument("--design", choices=("paper", "scaled", "smoke"),
                    default="scaled",
                    help="experiment design: the paper-exact matrix, the "
                         "budget-scaled one, or the tiny smoke design "
                         "(2 cells — CI-sized real-measurement runs)")
    ap.add_argument("--budget", type=int, default=2000,
                    help="per-cell sample budget for --design scaled")
    ap.add_argument("--shards", type=int, default=1,
                    help="legacy spelling of --executor process --max-workers N")
    ap.add_argument("--executor",
                    choices=("serial", "process", "futures", "device"),
                    default=None,
                    help="EXECUTORS registry entry running each combo's "
                         "work units (default: serial, or process when "
                         "workers > 1); 'device' runs one thread per card")
    ap.add_argument("--max-workers", type=int, default=None,
                    help="worker count for parallel executors (units fan "
                         "out, including within-cell splits of big-E rows)")
    ap.add_argument("--scheduler", choices=("steal", "static"),
                    default="steal",
                    help="how parallel executors hand units to workers: "
                         "'steal' over-splits cells by predicted cost and "
                         "lets workers pull from a shared queue; 'static' "
                         "is the one-partition-per-worker schedule (results "
                         "are bit-identical either way)")
    ap.add_argument("--resume", action="store_true",
                    help="replay units journaled in the measurement store "
                         "by an interrupted run (zero re-measurements)")
    ap.add_argument("--bench", default=None,
                    help="run only this benchmark (default: all)")
    ap.add_argument("--chip", default=None,
                    help="run only this chip model (default: all)")
    ap.add_argument("--algos", default=None,
                    help="comma-separated algorithm subset (default: all 5)")
    ap.add_argument("--store", choices=("json", "sqlite"), default="json",
                    help="measurement-cache backend (sqlite for paper-exact runs)")
    ap.add_argument("--backend", choices=("costmodel", "cuda"), default="cuda",
                    help="real CUDA kernel measurement (default), or the "
                         "analytical TPU model")
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="--backend cuda only: time on the card (default; "
                         "raises where there is none) or run the kernels' "
                         "plain versions on the CPU")
    ap.add_argument("--telemetry", action="store_true",
                    help="write a JSONL span trace (trace.jsonl, with "
                         "per-worker shards merged at join) into the results "
                         "dir; inspect with `python -m repro_torch.telemetry "
                         "<results_dir>`")
    ap.add_argument("--progress", action="store_true",
                    help="print a periodic one-line progress/ETA update to "
                         "stderr while combos run (implies --telemetry; the "
                         "trace is the data source)")
    ap.add_argument("--report", action="store_true",
                    help="after the run, render REPORT.md (tables + figures "
                         "+ claim verdicts) into the results dir via "
                         "repro_torch.analysis")
    ap.add_argument("--serve-dir", default=None, metavar="DIR",
                    help="after the run, fold each combo store's per-geometry "
                         "winners into DIR's serving store (DIR/store.sqlite "
                         "— see `python -m repro_torch.serving query`)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    backend_kwargs = None
    if args.backend == "cuda":
        if args.device == "cpu":
            backend_kwargs = {"device": "cpu"}
        else:
            from ..cuda_bench.measure import resolve_device

            resolve_device("cuda")  # no card: raise now, never fall back
    elif args.device is not None:
        ap.error("--device applies to --backend cuda only")

    if args.design == "paper":
        design = ExperimentDesign.paper()
        tag = "paper_matrix"
    elif args.design == "smoke":
        design = ExperimentDesign.smoke()
        tag = "matrix_smoke"
    else:
        design = ExperimentDesign.scaled(budget=args.budget)
        tag = f"matrix_{args.budget}"
    if args.backend != "costmodel":
        tag = f"{tag}_{args.backend}"
    out_dir = args.out or os.path.join("results", tag)
    os.makedirs(out_dir, exist_ok=True)

    # real measurement: the chip model axis collapses — the card is the chip
    chips = CHIP_NAMES if args.backend == "costmodel" else (args.backend,)
    benches = BENCHMARKS if args.bench is None else (args.bench,)
    if args.chip is not None:
        chips = (args.chip,)
    algos = ALGOS if args.algos is None else tuple(args.algos.split(","))
    t0 = clock.monotonic()
    for bench in benches:
        for chip_name in chips:
            path = combo_path(out_dir, bench, chip_name)
            if os.path.exists(path) and not args.force:
                print(f"[matrix] skip existing {path}")
                continue
            run_combo(bench, chip_name, design, out_dir, algorithms=algos,
                      shards=args.shards, store=args.store,
                      backend=args.backend, executor=args.executor,
                      max_workers=args.max_workers, resume=args.resume,
                      scheduler=args.scheduler,
                      telemetry_dir=(
                          out_dir if (args.telemetry or args.progress) else None
                      ),
                      progress=args.progress,
                      backend_kwargs=backend_kwargs)
    print(f"[matrix] all combos done in {(clock.monotonic()-t0)/60:.1f} min -> {out_dir}")
    if args.serve_dir is not None:
        n = index_matrix_winners(out_dir, args.serve_dir, benches=benches,
                                 chips=chips, design=design, store=args.store,
                                 backend=args.backend, algorithms=algos)
        print(f"[matrix] serving winners index <- {n} record(s) "
              f"({os.path.join(args.serve_dir, 'store.sqlite')})")
    if args.report:
        from ..analysis import generate_report

        print(f"[matrix] report -> {generate_report(out_dir)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
