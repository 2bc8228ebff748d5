"""Tune a REAL CUDA kernel by measured time — ``backend="cuda"``.

Runs the hand-written add kernel (``kernels/csrc/add.cu``) on the card and
lets the GA pick its launch geometry by measured time — the paper's loop
with a real measurement function.  The backend is selected *by name* from
the ``BACKENDS`` registry, so the whole run is described by a
JSON-serializable spec: shard workers, resumed runs, and remote executors
rebuild the identical problem from the spec alone (deterministic inputs,
validity pre-screen, warm-once-per-geometry cache).

The default image is the reference example's 128x256; ``--x 8192 --y 8192``
is the port's full width.  ``--device cpu`` runs the kernel's plain version
on the CPU (the tuning loop's path, not a timing of the card); without it a
host with no card raises.

    PYTHONPATH=src python -m repro_torch.examples.tune_kernel
    PYTHONPATH=src python -m repro_torch.examples.tune_kernel --x 8192 --y 8192
"""

from __future__ import annotations

import argparse

import numpy as np

from .. import tune
from ..core import TuningSpec
from ..core.searchers import TuningResult

X, Y = 128, 256
BUDGET = 12


def tune_add(x: int = X, y: int = Y, device: str = "cuda") -> TuningResult:
    backend_kwargs = {"x": x, "y": y, "repeats": 3, "warmup": 1}
    if device != "cuda":
        backend_kwargs["device"] = device
    spec = TuningSpec(
        kernel="add",
        searcher="ga",
        backend="cuda",
        backend_kwargs=backend_kwargs,
        budget=BUDGET,
        final_repeats=5,
        seed=0,
    )
    # the whole run is data — this is what shard workers receive
    print(f"spec: {spec.to_json()}\n")

    r = tune(spec)
    print(f"GA best config after {r.n_samples} real kernel measurements: "
          f"{r.best_config}")
    print(f"measured {r.best_value*1e3:.4f} ms per call ({x}x{y}, {device})")
    print(f"final config re-measured 5x (paper protocol): "
          f"{r.final_value*1e3:.4f} ms")
    return r


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples.tune_kernel")
    ap.add_argument("--x", type=int, default=X)
    ap.add_argument("--y", type=int, default=Y)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    r = tune_add(args.x, args.y, args.device)
    if not np.isfinite(r.final_value):
        raise SystemExit("smoke failure: tuned config did not run")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
