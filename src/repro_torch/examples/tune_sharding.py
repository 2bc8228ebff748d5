"""Beyond-paper: autotune the DISTRIBUTED-TRAINING config with the paper's
search algorithms (a port of ``examples/tune_sharding.py``).

The measurement function is the dry run's dominant roofline term
(``repro_torch.launch.roofline``, the H100's constants) — the paper's
empirical-search loop pointed at a production objective: which remat
policy / sequence-parallelism setting / attention head_dim sharding /
microbatching minimizes the modelled step time of yi-34b train_4k on the
256-rank mesh.  Each sample is one dry run of the train step under
``FakeTensorMode`` on a fake process group (nothing is allocated; about
half a minute for yi-34b on a CPU core), so the budget is small; BO-TPE is
the right tool at tiny budgets — exactly the paper's S=25 regime
conclusion.

``seq_parallel=False`` swaps ``sharding.constrain.constrain_residual`` for
the identity, as the reference does; the models bound that name when they
were imported, so the knob changes no op — the reference's property, kept.

    PYTHONPATH=src python -m repro_torch.examples.tune_sharding [--budget 6]
"""

from __future__ import annotations

import argparse

from ..configs import REGISTRY, SHAPES
from ..core import CachedMeasurement, CallableMeasurement, Param, SearchSpace, clock, make_searcher
from ..launch.dryrun import build_step
from ..launch.hlo_analysis import StepCounter
from ..launch.mesh import make_production_mesh, start_fake_process_group
from ..launch.roofline import HBM_BW, ICI_BW, PEAK_FLOPS, memory_bytes
from ..sharding import constrain as constrain_mod
from ..sharding.rules import ShardingRules
from ..train.step import TrainSettings


def step_time_model(arch_name: str, shape_name: str, cfg: dict) -> float:
    """Trace one train step with the candidate config on the 256-rank fake
    mesh; return the largest roofline term."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    arch, shape = REGISTRY[arch_name], SHAPES[shape_name]
    mesh = make_production_mesh()        # outside the fake mode: real rank tensor
    rules = ShardingRules()
    if cfg["head_dim_tp"]:
        rules = rules.with_overrides(head_dim=("model",))
    if not cfg["seq_parallel"]:
        constrain_mod.constrain_residual, saved = (lambda x: x), constrain_mod.constrain_residual
    try:
        settings = TrainSettings(remat=cfg["remat"], accum=cfg["accum"])
        with FakeTensorMode():
            fn, args = build_step(arch, shape, mesh, rules, settings)
            with StepCounter() as counter:
                fn(*args)
        coll = counter.collectives()["total_bytes"] / ICI_BW
        comp = counter.dots()["flops"] / PEAK_FLOPS
        mem = memory_bytes(arch, shape) / (256 * HBM_BW)
        return max(coll, comp, mem)
    finally:
        if not cfg["seq_parallel"]:
            constrain_mod.constrain_residual = saved


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--budget", type=int, default=6)
    ap.add_argument("--arch", default="yi-34b")
    args = ap.parse_args(argv)
    start_fake_process_group(256)        # the single pod's ranks, in this process

    space = SearchSpace(
        [
            Param.choice("remat", ("none", "dots", "full")),
            Param.choice("accum", (1, 2, 4)),
            Param.choice("seq_parallel", (False, True)),
            Param.choice("head_dim_tp", (False, True)),
        ]
    )

    def measure(cfg):
        t0 = clock.monotonic()
        s = step_time_model(args.arch, "train_4k", cfg)
        print(f"  cfg={cfg} -> modelled step {s:.2f}s  "
              f"(trace {clock.monotonic() - t0:.0f}s)")
        return s

    # bo_tpe proposes single configs after its random init batch; the engine
    # driver still routes each batch through measure_batch, and the memoizing
    # wrapper collapses duplicate proposals before they reach a trace.
    m = CachedMeasurement(CallableMeasurement(measure))
    r = make_searcher("bo_tpe", space, seed=0).run(m, args.budget)
    print(f"\nbest distributed config for {args.arch} train_4k: {r.best_config}")
    print(f"modelled step time {r.best_value:.2f}s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
