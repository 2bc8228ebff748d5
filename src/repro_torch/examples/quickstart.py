"""Quickstart: autotune a kernel config with every paper algorithm —
through the one-call public API.

Tunes the Harris-corner kernel's 6-parameter space on the v5e chip model
(the analytical cost model) with a 100-sample budget and compares the
algorithms the paper compares — then runs the statistics the paper runs
(MWU + CLES).  The last part swaps the backend's name for ``cuda`` and tunes
the same kernel by real measurement on the card.

Everything goes through the declarative facade: a :class:`TuningSpec` names
the kernel, the searcher, and the measurement backend (resolved from the
``BACKENDS`` registry), and ``repro_torch.tune(spec)`` drives the batched
ask/tell engine and the paper's final re-measurement.  ``ask_tell_demo``
shows the protocol underneath — the form to use when an external system (a
job queue, a cluster scheduler) owns the evaluation loop.

    PYTHONPATH=src python -m repro_torch.examples.quickstart
    PYTHONPATH=src python -m repro_torch.examples.quickstart --repeats 2 --device cpu

``--device cpu`` runs the real-measurement part on the kernels' plain
versions at the reference example's 128x256 image; the card is the default
and a host without one raises.
"""

from __future__ import annotations

import argparse

import numpy as np

from .. import BACKENDS, make_measurement, tune
from ..core import PAPER_ALGORITHMS, TuningSession, TuningSpec, make_searcher, stats
from ..core.searchers import TuningResult

BUDGET = 100
REPEATS = 20

SPEC = TuningSpec(
    kernel="harris",
    backend="costmodel",
    backend_kwargs={"chip": "v5e"},
    budget=BUDGET,
)


def header() -> None:
    """The space, the budget and the cost model's true optimum."""
    session = TuningSession(SPEC)
    opt_cfg, opt = BACKENDS["costmodel"].true_optimum(kernel="harris", chip="v5e")
    print(f"benchmark=harris chip=v5e |S|={session.space.cardinality:,} budget={BUDGET}")
    print(f"true optimum: {opt*1e3:.3f} ms @ {opt_cfg}\n")


def ask_tell_demo() -> None:
    """Drive one search by hand through the ask/tell protocol."""
    session = TuningSession(SPEC)                 # resolves space + backend
    searcher = make_searcher("ga", session.space, seed=0)
    measurement = make_measurement("costmodel", kernel="harris", chip="v5e", seed=0)
    searcher.start(BUDGET)
    n_batches = 0
    while not searcher.done:
        configs = searcher.ask()          # the algorithm's natural batch
        if not configs:
            break
        searcher.tell(configs, measurement.measure_batch(configs))
        n_batches += 1
    result = searcher.finish()
    print(
        f"ask/tell: {result.n_samples} samples in {n_batches} batches "
        f"({measurement.n_dispatches} measurement dispatches), "
        f"best={result.best_value*1e3:.3f} ms\n"
    )


def compare(repeats: int = REPEATS) -> dict[str, np.ndarray]:
    """Every paper algorithm over ``repeats`` seeds, then each against RS by
    MWU (alpha 0.01) and CLES.  Returns each algorithm's final values."""
    _, opt = BACKENDS["costmodel"].true_optimum(kernel="harris", chip="v5e")
    finals = {}
    for algo in PAPER_ALGORITHMS:
        runs = []
        for seed in range(repeats):
            r = tune(SPEC.replace(searcher=algo, seed=seed))
            runs.append(r.final_value)     # median-of-10 re-measurement
        finals[algo] = np.array(runs)
        print(
            f"{algo:7s} median={np.median(runs)*1e3:7.3f} ms "
            f"({opt/np.median(runs)*100:5.1f}% of optimum)"
        )

    print("\nvs Random Search (MWU alpha=0.01, CLES):")
    for algo in PAPER_ALGORITHMS[1:]:
        cmp = stats.compare_algorithms(finals[algo], finals["rs"])
        print(
            f"{algo:7s} speedup={cmp['speedup_a_over_b']:.3f}x "
            f"P(beats RS)={cmp['cles_a_beats_b']:.2f} "
            f"p={cmp['mwu_p']:.4f} significant={cmp['significant']}"
        )
    return finals


def real_measurement(**backend_kwargs) -> TuningResult:
    """The same declarative API, REAL measurement: swap the backend's name
    and the engine times the CUDA harris kernel on the card (its plain
    version with ``device="cpu"``)."""
    r = tune(
        SPEC.replace(backend="cuda",
                     backend_kwargs={"repeats": 3, **backend_kwargs},
                     budget=10, final_repeats=3)
    )
    where = backend_kwargs.get("device", "cuda")
    print(f"\nreal-measurement harris (backend='cuda', device={where!r}): "
          f"{r.final_value*1e3:.2f} ms @ {r.best_config}")
    return r


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples.quickstart")
    ap.add_argument("--repeats", type=int, default=REPEATS,
                    help="seeds per algorithm in the comparison")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the real-measurement part runs (cpu: the "
                         "plain versions at 128x256)")
    args = ap.parse_args(argv)

    header()
    ask_tell_demo()
    compare(args.repeats)
    real_measurement(**({"device": "cpu", "x": 128, "y": 256}
                        if args.device == "cpu" else {}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
