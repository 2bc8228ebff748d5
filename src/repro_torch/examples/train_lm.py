"""End-to-end training driver with the fault-tolerant runtime.

Trains a Mamba2 LM on the synthetic Zipfian stream with checkpointing,
straggler watchdog, and crash-resume — the full production loop (a ~15M-param
model by default; --full trains the real mamba2-130m config).  A second run
with the same ``--ckpt`` resumes from the last checkpoint.

It trains on the card (``--device cuda``, the default) and raises when there
is none; the CPU is used only when asked for (``--device cpu``)::

    PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 200
    PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 400  # resumes
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile

import numpy as np
import torch

from ..configs import REGISTRY
from ..core import clock
from ..data import DataConfig, make_train_batch
from ..models import build_model, init_params, param_count
from ..optim import AdamWConfig
from ..runtime import RunnerConfig, RunnerReport, TrainingRunner
from ..train import TrainSettings, init_train_state, make_train_step


def small_config():
    base = REGISTRY["mamba2-130m"]
    return dataclasses.replace(
        base, n_layers=6, d_model=256, vocab=8192,
        ssm=dataclasses.replace(base.ssm, d_state=32, chunk=64),
    )


def train(cfg, *, steps: int, batch: int, seq: int, ckpt: str, device="cuda",
          params=None) -> tuple[dict, RunnerReport]:
    """Train ``cfg`` for ``steps`` steps under the fault-tolerant runner
    (resuming from ``ckpt`` when it holds a checkpoint).  ``params`` is the
    initial parameter tree (default: ``init_params`` from a generator
    seeded 0 on ``device``)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu to train on the CPU")
    model = build_model(cfg)
    if params is None:
        params = init_params(model.spec(), torch.Generator(device=device).manual_seed(0), device)
    state = init_train_state(model, params)
    step_fn = make_train_step(
        model,
        TrainSettings(remat="none",
                      optimizer=AdamWConfig(lr=1e-3, warmup_steps=20)),
    )
    dc = DataConfig(seed=0)
    make_batch = lambda s: make_train_batch(dc, cfg, seq, batch, s, device=device)

    runner = TrainingRunner(
        RunnerConfig(ckpt_dir=ckpt, ckpt_every=50), step_fn, make_batch
    )
    return runner.run(state, n_steps=steps)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples.train_lm")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--full", action="store_true", help="real mamba2-130m config")
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_train_lm"))
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default: the card; 'cpu' on request)")
    args = ap.parse_args(argv)

    cfg = REGISTRY["mamba2-130m"] if args.full else small_config()
    n = param_count(build_model(cfg).spec())
    print(f"arch={cfg.name} params={n/1e6:.1f}M steps={args.steps} "
          f"batch={args.batch} seq={args.seq}")

    t0 = clock.monotonic()
    _, report = train(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
                      ckpt=args.ckpt, device=args.device)
    dt = clock.monotonic() - t0
    tok_s = report.steps_run * args.batch * args.seq / max(dt, 1e-9)
    print(f"\nresumed from: {report.restored_from}")
    print(f"steps run: {report.steps_run} in {dt:.0f}s ({tok_s:.0f} tok/s)")
    if report.losses:
        k = max(1, len(report.losses) // 10)
        first = float(np.mean(report.losses[:k]))
        last = float(np.mean(report.losses[-k:]))
        print(f"loss: {first:.3f} -> {last:.3f}")
    print(f"stragglers flagged: {len(report.stragglers)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
