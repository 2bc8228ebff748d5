"""Training launcher (a port of ``repro.launch.train``): ``--arch <id>``
selects an architecture (full or ``--reduced``), builds the train step and
runs it under the fault-tolerant runtime (checkpoints, crash-resume,
straggler watchdog).

It runs on the card (``--device cuda``, the default) and raises when there
is none; the CPU is used only when asked for (``--device cpu``)::

    PYTHONPATH=src python -m repro_torch.launch.train --arch yi-34b \\
        --reduced --steps 20 --batch 8 --seq 256 --ckpt /tmp/yi_ckpt

One card: ``--model-parallel`` other than 1 needs ``sharding/`` (ROADMAP
item 6b).
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import torch

from ..configs import REGISTRY
from ..core import clock
from ..data import DataConfig, make_train_batch
from ..models import build_model, init_params, param_count
from ..optim import AdamWConfig
from ..runtime import RunnerConfig, TrainingRunner
from ..train import TrainSettings, init_train_state, make_train_step


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=sorted(REGISTRY))
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--remat", default="none", choices=("none", "dots", "full"))
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default: the card; 'cpu' on request)")
    args = ap.parse_args(argv)

    if args.model_parallel != 1:
        raise NotImplementedError(
            "--model-parallel > 1 needs sharding/ and more than one card (ROADMAP item 6b)")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu to train on the CPU")

    cfg = REGISTRY[args.arch]
    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg)
    spec = model.spec()
    print(f"[train] arch={cfg.name} reduced={args.reduced} "
          f"params={param_count(spec)/1e6:.1f}M devices={torch.cuda.device_count()}")

    params = init_params(spec, torch.Generator(device=device).manual_seed(0), device)
    state = init_train_state(model, params)
    settings = TrainSettings(
        remat=args.remat, accum=args.accum,
        optimizer=AdamWConfig(lr=args.lr, warmup_steps=min(20, args.steps)),
    )
    step_fn = make_train_step(model, settings)
    dc = DataConfig(seed=0)
    make_batch = lambda s: make_train_batch(dc, cfg, args.seq, args.batch, s, device=device)

    ckpt_dir = args.ckpt or os.path.join(tempfile.gettempdir(), f"repro_torch_{cfg.name}_ckpt")
    runner = TrainingRunner(
        RunnerConfig(ckpt_dir=ckpt_dir, ckpt_every=args.ckpt_every), step_fn, make_batch,
    )
    t0 = clock.monotonic()
    state, report = runner.run(state, n_steps=args.steps)
    dt = clock.monotonic() - t0

    tok = report.steps_run * args.batch * args.seq
    print(f"[train] {report.steps_run} steps in {dt:.0f}s "
          f"({tok/max(dt,1e-9):.0f} tok/s), resumed_from={report.restored_from}")
    if report.losses:
        k = max(1, len(report.losses) // 10)
        print(f"[train] loss {np.mean(report.losses[:k]):.3f} -> "
              f"{np.mean(report.losses[-k:]):.3f}")


if __name__ == "__main__":
    main()
