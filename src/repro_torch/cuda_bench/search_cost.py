"""Host time of the searchers' own work, split into its parts.

``chip_smoke.py`` reports each tune call's ``search_s``: its wall time less
the measurement stages, i.e. the host time the searcher itself spends. This
script splits that time where it is largest:

* ``rf``: it takes the steps of ``RandomForestSearcher._propose`` one by one,
  with the searcher's own random draws, and times each: the training draw
  (rejection sampling against the space's constraint, ``valid_mask`` over
  each round of candidates), the ``BatchedForest`` fit, the pool draw, the
  forest's predictions over the pool, and the ranking. The same searcher
  then runs whole through ``Searcher.run``, whose time the parts should add
  up to; its last ``top_k`` samples must be the configs the steps ranked
  first, which shows that the steps are the searcher's.
* ``bo_gp``: the first import of ``scipy.linalg`` in a fresh interpreter that
  has imported torch (as the port's processes have), and the time of a first
  and a second ``bo_gp`` run in one process.

Measured values come from a deterministic function of the config, so no
kernel runs and no card is needed: the searchers' host work does not depend
on where the values came from. The space is the ``cuda`` backend's, with its
``cuda_fit`` screen at the problem size given.

    PYTHONPATH=src python -m repro_torch.cuda_bench.search_cost [--x 8192 --y 8192]

prints one JSON line per kernel (``rf``) and one for ``bo_gp``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

from ..core.clock import monotonic
from ..core.measurement import CallableMeasurement
from ..core.searchers import make_searcher
from ..core.surrogates.forest_batched import BatchedForest
from . import DEFAULT_X, DEFAULT_Y, default_space

KERNELS = ("add", "harris", "mandelbrot")


def objective(cfg) -> float:
    """A deterministic stand-in for a kernel's time, smooth in every param."""
    return 1.0 + float(np.log2(cfg["t_x"] * cfg["t_y"] * cfg["t_z"])) / 12.0 + (
        (cfg["w_x"] - 3) ** 2 + (cfg["w_y"] - 5) ** 2 + (cfg["w_z"] - 2) ** 2
    ) / 64.0


def rf_parts(kernel: str, x: int, y: int, budget: int = 40, seed: int = 0,
             pool_size: int = 16384) -> dict:
    """Time the steps of one ``rf`` search, then the searcher itself."""
    space = default_space(kernel, x=x, y=y)
    rf = make_searcher("rf", space, seed=seed, pool_size=pool_size)
    rng = rf.rng
    top_k = min(rf.top_k, max(1, budget // 2))
    t = {}

    t0 = monotonic()
    train_idx = space.sample_indices(rng, budget - top_k)
    t["train_draw_s"] = monotonic() - t0
    train_vals = np.array([objective(c) for c in space.decode_batch(train_idx)])

    t0 = monotonic()
    forest = BatchedForest(space.cardinalities, n_estimators=rf.n_estimators,
                           seed=int(rng.integers(0, 2**31)))
    forest.fit(train_idx[None], train_vals[None])
    t["fit_s"] = monotonic() - t0

    t0 = monotonic()
    pool = space.sample_indices(rng, rf.pool_size)
    t["pool_draw_s"] = monotonic() - t0

    t0 = monotonic()
    preds = forest.predict(pool)[0]
    t["predict_s"] = monotonic() - t0

    t0 = monotonic()
    top = space.decode_batch(pool[np.argsort(preds, kind="stable")[:top_k]])
    t["rank_s"] = monotonic() - t0

    # the screen alone, per row, on as many fresh unscreened rows as the pool
    draw = np.random.default_rng(seed + 1)
    raw = np.stack([draw.integers(0, c, size=rf.pool_size)
                    for c in space.cardinalities], axis=1)
    t0 = monotonic()
    accepted = int(space.valid_mask(raw).sum())
    screen_s = monotonic() - t0

    whole = make_searcher("rf", space, seed=seed, pool_size=pool_size)
    t0 = monotonic()
    result = whole.run(CallableMeasurement(objective), budget)
    run_s = monotonic() - t0
    if result.history_configs[-top_k:] != top:
        raise RuntimeError(f"{kernel}: the timed steps are not rf's proposals")
    return dict(
        kernel=kernel, x=x, y=y, searcher="rf", budget=budget,
        pool_size=rf.pool_size, **t,
        parts_s=sum(t.values()), searcher_run_s=run_s,
        screen_us_per_row=screen_s / len(raw) * 1e6,
        screen_accepts=accepted / len(raw),
    )


def scipy_import_s() -> float:
    """``import scipy.linalg`` in a fresh interpreter that has imported torch."""
    code = (
        "import numpy, torch\n"
        "from repro_torch.core.clock import monotonic\n"
        "t = monotonic()\n"
        "import scipy.linalg\n"
        "print(monotonic() - t)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], check=True,
                         capture_output=True, text=True, env=dict(os.environ))
    return float(out.stdout.strip().splitlines()[-1])


def bo_gp_runs(x: int, y: int, budget: int = 40, seed: int = 0) -> dict:
    """A first and a second ``bo_gp`` run in this process, with the import
    time of ``scipy.linalg`` in a fresh one beside them."""
    space = default_space("add", x=x, y=y)
    loaded = "scipy.linalg" in sys.modules
    runs = []
    for _ in range(2):
        t0 = monotonic()
        make_searcher("bo_gp", space, seed=seed).run(
            CallableMeasurement(objective), budget)
        runs.append(monotonic() - t0)
    return dict(searcher="bo_gp", x=x, y=y, budget=budget,
                scipy_loaded_before=loaded, first_run_s=runs[0],
                second_run_s=runs[1], scipy_import_s=scipy_import_s())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--x", type=int, default=DEFAULT_X)
    ap.add_argument("--y", type=int, default=DEFAULT_Y)
    args = ap.parse_args(argv)
    # bo_gp first: this process must not have imported scipy yet
    print("search_cost " + json.dumps(bo_gp_runs(args.x, args.y)), flush=True)
    for k in KERNELS:
        print("search_cost " + json.dumps(rf_parts(k, args.x, args.y)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
