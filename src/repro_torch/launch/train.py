"""Training launcher (a port of ``repro.launch.train``): ``--arch <id>``
selects an architecture (full or ``--reduced``), builds the (data, model)
mesh over the ranks that exist, shards params and optimizer state through
the logical-axis rules, builds the mesh-aware train step and runs it under
the fault-tolerant runtime (checkpoints, crash-resume, straggler watchdog).

It runs on the card (``--device cuda``, the default: an ``nccl`` group) and
raises when there is none; the CPU is used only when asked for (``--device
cpu``: a ``gloo`` group).  The world is one process unless ``torchrun``
started several (``--model-parallel`` is clamped to it, as the reference's
host mesh is)::

    PYTHONPATH=src python -m repro_torch.launch.train --arch yi-34b \\
        --reduced --steps 20 --batch 8 --seq 256 --ckpt /tmp/yi_ckpt
    torchrun --nproc-per-node 4 -m repro_torch.launch.train --arch yi-34b \\
        --reduced --model-parallel 2
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
from ..launch.mesh import make_host_mesh, start_process_group
from ..models import build_model, init_params, param_axes, param_count
from ..optim import AdamWConfig
from ..runtime import RunnerConfig, TrainingRunner
from ..sharding.regions import distribute
from ..sharding.rules import ShardingRules, mesh_shape
from ..train import TrainSettings, init_train_state, make_train_step
from ..tree import tree_map


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

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu to train on the CPU")

    import torch.distributed as dist

    started = not dist.is_initialized()
    rank, world = start_process_group(args.device)
    try:
        _train(args, device if device.type == "cpu" else torch.device("cuda"), rank, world)
    finally:
        if started:
            dist.destroy_process_group()


def _train(args, device, rank: int, world: int) -> None:
    cfg = REGISTRY[args.arch]
    if args.reduced:
        cfg = cfg.reduced()
    mesh = make_host_mesh(model_parallel=args.model_parallel)
    sizes = mesh_shape(mesh)
    moe_groups = sizes["data"] if args.batch % sizes["data"] == 0 else 1
    model = build_model(cfg, moe_groups=moe_groups)
    spec = model.spec()
    say = print if rank == 0 else (lambda *a, **k: None)
    say(f"[train] arch={cfg.name} reduced={args.reduced} "
        f"params={param_count(spec)/1e6:.1f}M devices={world} "
        f"mesh={tuple(sizes.values())}")

    rules = ShardingRules()
    # the same draw on every rank, then each keeps its shards
    full = init_params(spec, torch.Generator(device=device).manual_seed(0), device)
    p_shard = rules.tree_shardings(param_axes(spec), full, mesh)
    state = init_train_state(model, tree_map(distribute, full, p_shard))
    full = None
    settings = TrainSettings(
        remat=args.remat, accum=args.accum,
        optimizer=AdamWConfig(lr=args.lr, warmup_steps=min(20, args.steps)),
    )
    step_fn = make_train_step(model, settings, grad_shardings=p_shard)
    dc = DataConfig(seed=0)

    def make_batch(s):
        batch = make_train_batch(dc, cfg, args.seq, args.batch, s, device=device)
        return {k: distribute(v, rules.sharding_for(("batch",) + (None,) * (v.ndim - 1),
                                                    tuple(v.shape), mesh))
                for k, v in batch.items()}

    ckpt_dir = args.ckpt or os.path.join(tempfile.gettempdir(), f"repro_torch_{cfg.name}_ckpt")
    runner = TrainingRunner(
        RunnerConfig(ckpt_dir=ckpt_dir, ckpt_every=args.ckpt_every), step_fn, make_batch,
    )
    t0 = clock.monotonic()
    state, report = runner.run(state, n_steps=args.steps)
    dt = clock.monotonic() - t0

    tok = report.steps_run * args.batch * args.seq
    say(f"[train] {report.steps_run} steps in {dt:.0f}s "
        f"({tok/max(dt,1e-9):.0f} tok/s), resumed_from={report.restored_from}")
    if report.losses:
        k = max(1, len(report.losses) // 10)
        say(f"[train] loss {np.mean(report.losses[:k]):.3f} -> "
            f"{np.mean(report.losses[-k:]):.3f}")


if __name__ == "__main__":
    main()
