"""Entry driver ``tune``: one engineer tuning a kernel, a closed loop of
fresh tune calls through the port's public entry.

Each call is ``TuningSession(spec).run()`` with
``spec = TuningSpec(kernel, backend="cuda", searcher, budget, seed,
final_repeats)`` at the configuration's image size: exactly what
``repro_torch.tune(spec)`` runs, with every speed knob at its default (no
pipeline workers, no compile cache, no store).  The session is held so its
``last_record`` can be read: ``provenance.wall_s`` and the measurement's
``stage_s``.  One client: call ``j`` starts when call ``j - 1`` has ended,
takes its seed from ``(--seed, j)``, and no call starts once the window's
seconds have passed.

The traffic file gives ``searcher``, ``searcher_kwargs``, ``budget``,
``final_repeats``, ``warmup_budget`` (the set-up's one call of the same
searcher, at a small budget) and, where the searcher picks its winner among
its last samples, ``winner_among_last``.
"""

from __future__ import annotations

import hashlib
import math
import time

from bench.harness import program


def call_seed(seed: int, j: int) -> int:
    """The seed of call ``j`` of a run seeded ``seed`` (31 bits)."""
    digest = hashlib.sha256(f"{int(seed)}/{int(j)}".encode()).digest()
    return int.from_bytes(digest[:4], "little") & 0x7FFFFFFF


def record_faults(result, budget: int, space: dict, among_last: int | None = None) -> list[str]:
    """What the search loop's record gets wrong: the samples against the
    budget, the winner against the configuration's space, the winner and
    its value against the history: the pair was sampled, and its value is
    the history's least, or the least of its last ``among_last`` samples
    where the searcher's protocol picks the winner among those (the random
    forest's top predictions, paper section III.B)."""
    faults = []
    if result.n_samples != budget or len(result.history_values) != budget:
        faults.append(f"n_samples {result.n_samples} (history "
                      f"{len(result.history_values)}) != budget {budget}")
    cfg = dict(result.best_config)
    if set(cfg) != set(space) or not all(
            float(cfg[k]).is_integer() and lo <= cfg[k] <= hi for k, (lo, hi) in space.items()):
        faults.append(f"winner {cfg} outside the space")
    pool = result.history_values[-among_last:] if among_last else result.history_values
    finite = [v for v in pool if math.isfinite(v)]
    if not math.isfinite(result.best_value) or not finite:
        faults.append(f"winner is a penalty ({result.best_value})")
    elif result.best_value != min(finite):
        faults.append(f"best_value {result.best_value} != least sampled {min(finite)}")
    if not any(dict(c) == cfg and v == result.best_value
               for c, v in zip(result.history_configs, result.history_values)):
        faults.append(f"winner {cfg} at {result.best_value} was never sampled")
    if not (math.isfinite(result.final_value) and result.final_value > 0):
        faults.append(f"final_value {result.final_value}")
    return faults


def one_call(ctx, budget: int, seed: int, telemetry=None) -> dict:
    TuningSpec, TuningSession = program.tuning()
    traffic, config = ctx.cell.traffic, ctx.cell.config
    spec = TuningSpec(
        kernel=config["kernel"],
        backend="cuda",
        backend_kwargs=ctx.backend_kwargs,
        searcher=traffic["searcher"],
        searcher_kwargs=dict(traffic.get("searcher_kwargs", {})),
        budget=budget,
        seed=seed,
        final_repeats=traffic["final_repeats"],
    )
    t0 = time.perf_counter()
    session = TuningSession(spec, telemetry=telemetry)
    result = session.run()
    ctx.synchronize()
    t1 = time.perf_counter()
    record = session.last_record
    prov = record.extra["backend_provenance"]
    return {
        "t0": t0,
        "t1": t1,
        "seed": seed,
        "samples": int(result.n_samples),
        "winner": {k: int(v) for k, v in result.best_config.items()},
        "final_s": float(result.final_value),
        "wall_s": float(record.provenance["wall_s"]),
        "stage_s": dict(prov["stage_s"]),
        "n_invalid": int(prov["n_invalid"]),
        "faults": record_faults(result, budget, config["space"],
                                traffic.get("winner_among_last")),
    }


def setup(ctx) -> dict:
    """Build or load the kernels and make one call of the cell's searcher at
    its warm-up budget: every path the window's calls take (the searcher's
    imports, its surrogate, staging, the kernel's launches) runs once."""
    build_s = program.build_kernels() if ctx.device == "cuda" else 0.0
    warm = one_call(ctx, ctx.cell.traffic["warmup_budget"], call_seed(ctx.seed, -1))
    if warm["faults"]:
        raise RuntimeError(f"the warm-up call failed its checks: {warm['faults']}")
    return {"build_s": build_s, "warmup_call_s": warm["t1"] - warm["t0"]}


def window(ctx, seconds: float, telemetry=None) -> tuple[float, list[dict]]:
    """The closed loop: ``(start, calls)``; no call starts after
    ``start + seconds``."""
    budget = ctx.cell.traffic["budget"]
    calls = []
    start = time.perf_counter()
    while time.perf_counter() - start < seconds:
        calls.append(one_call(ctx, budget, call_seed(ctx.seed, len(calls)), telemetry))
    return start, calls
