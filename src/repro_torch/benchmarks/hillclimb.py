"""§Perf hill-climbing driver (a port of ``benchmarks/hillclimb.py``).

Applies the hypothesis -> change -> re-trace -> re-analyse loop to the
three chosen cells (worst roofline fraction, most collective-bound, most
paper-representative), each a dry run of one step on the fake 256-rank
mesh (``repro_torch.launch.dryrun``):

  H1  cast_bf16       cast fp32 master weights to bf16 BEFORE the layers
                      -> per-layer FSDP all-gathers move half the bytes
  H2  moe_constrain   the reference's shard constraint on the MoE dispatch
                      tensors.  The port runs each MoE block as a local
                      region (``sharding/regions.py``) and keeps
                      ``moe.CONSTRAIN_DISPATCH`` by name only, so H2 runs
                      the program of the variant without it
  H3  head_dim TP     shard attention head_dim over "model" (the rules'
                      ``head_dim``); it moves the weights' placements where
                      the query heads do not divide the model axis
  H4  fsdp_gather     gather each layer's weights over the data axes on
                      entry (``constrain.FSDP_GATHER_WEIGHTS``)

Each run records the three roofline terms (``launch.roofline``, the H100's
constants); results land in results/perf_torch/<arch>_<shape>__<variant>.json
and a summary table prints at the end.  Before the table, one line names the
variants whose step ran the same ops as another variant of the cell (the
same FLOPs and collective bytes), so that no identical row reads as a
finding.

    PYTHONPATH=src python -m repro_torch.benchmarks.hillclimb [--cells yi-34b:train_4k ...]
"""

from __future__ import annotations

import argparse
import json
import os

from ..launch.dryrun import run_cell
from ..launch.mesh import start_fake_process_group
from ..launch.roofline import roofline_row
from ..models import moe as moe_mod
from ..sharding import constrain as constrain_mod
from ..sharding.rules import ShardingRules
from ..train.step import TrainSettings

PERF_DIR = os.path.join("results", "perf_torch")

DEFAULT_CELLS = (
    "olmoe-1b-7b:train_4k",        # worst roofline fraction
    "deepseek-v2-236b:train_4k",   # most collective-bound
    "yi-34b:train_4k",             # canonical dense LM (paper-representative)
)


def _variant(cast_bf16=False, moe_constrain=False, head_dim_tp=False, fsdp_gather=False):
    return dict(cast_bf16=cast_bf16, moe_constrain=moe_constrain,
                head_dim_tp=head_dim_tp, fsdp_gather=fsdp_gather)


VARIANTS = {
    "baseline": _variant(),
    "H1_bf16gather": _variant(cast_bf16=True),
    "H2_moe_dispatch": _variant(moe_constrain=True),
    "H1+H2": _variant(cast_bf16=True, moe_constrain=True),
    "H1+H3_headdim": _variant(cast_bf16=True, head_dim_tp=True),
    "H1+H2+H3": _variant(cast_bf16=True, moe_constrain=True, head_dim_tp=True),
    "H4_fsdp_gather": _variant(fsdp_gather=True),
    "H4+H3": _variant(head_dim_tp=True, fsdp_gather=True),
}

#: what two runs of one cell compare to tell whether they ran the same ops:
#: the counted FLOPs and collective bytes (the traced peak memory is left
#: out: it moves with when Python frees the fake tensors)
_SAME_OPS = ("compute_s", "memory_s", "collective_s", "collectives")


def run_variant(arch: str, shape: str, name: str, v: dict) -> dict:
    moe_mod.CONSTRAIN_DISPATCH = v["moe_constrain"]
    constrain_mod.FSDP_GATHER_WEIGHTS = v.get("fsdp_gather", False)
    rules = ShardingRules()
    if v["head_dim_tp"]:
        rules = rules.with_overrides(head_dim=("model",))
    settings = TrainSettings(remat="dots", accum=1, cast_bf16=v["cast_bf16"])
    try:
        rec = run_cell(arch, shape, multi_pod=False, rules=rules,
                       settings=settings, save=False)
    finally:
        moe_mod.CONSTRAIN_DISPATCH = False
        constrain_mod.FSDP_GATHER_WEIGHTS = False
    row = roofline_row(arch, shape, record=rec)
    out = {
        "variant": name,
        "flags": v,
        "compute_s": row.compute_s,
        "memory_s": row.memory_s,
        "collective_s": row.collective_s,
        "step_s": row.step_s,
        "roofline_fraction": row.roofline_fraction,
        "dominant": row.dominant,
        "collectives": rec["collectives"]["bytes"],
        "peak_gib": row.peak_gib,
    }
    os.makedirs(PERF_DIR, exist_ok=True)
    with open(os.path.join(PERF_DIR, f"{arch}_{shape}__{name.replace('+', '_')}.json"),
              "w") as f:
        json.dump(out, f, indent=2)
    return out


def _skip(arch: str, name: str, v: dict) -> bool:
    """The reference's rules: MoE-only variants run on the MoE cells only."""
    is_moe = arch in ("olmoe-1b-7b", "deepseek-v2-236b")
    if v["moe_constrain"] and not is_moe:
        return True
    return not is_moe and name in ("H2_moe_dispatch", "H1+H2", "H1+H2+H3")


def no_op_variants(summary: list) -> list[str]:
    """``"<cell> :: <variant> (= <earlier variant>)"`` for every run whose
    counted ops equal an earlier run's of the same cell."""
    found, seen = [], {}
    for cell, name, out in summary:
        key = json.dumps([out[k] for k in _SAME_OPS], sort_keys=True)
        first = seen.setdefault((cell, key), name)
        if first != name:
            found.append(f"{cell} :: {name} (= {first})")
    return found


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cells", nargs="*", default=list(DEFAULT_CELLS))
    ap.add_argument("--variants", nargs="*", default=list(VARIANTS))
    args = ap.parse_args(argv)
    start_fake_process_group(256)        # the single pod's ranks, in this process

    summary = []
    for cell in args.cells:
        arch, shape = cell.split(":")
        for name in args.variants:
            v = VARIANTS[name]
            if _skip(arch, name, v):
                continue
            print(f"[hillclimb] {cell} :: {name} ...", flush=True)
            out = run_variant(arch, shape, name, v)
            summary.append((cell, name, out))
            print(
                f"    step={out['step_s']:.3f}s  coll={out['collective_s']:.3f}s "
                f"comp={out['compute_s']:.3f}s  frac={out['roofline_fraction']:.3f} "
                f"dominant={out['dominant']}"
            )

    same = no_op_variants(summary)
    if same:
        print("[hillclimb] variants that change no op of the port: " + "; ".join(same))
    print("\n| cell | variant | step (s) | collective (s) | compute (s) | frac |")
    print("|---|---|---|---|---|---|")
    for cell, name, out in summary:
        print(f"| {cell} | {name} | {out['step_s']:.3f} | "
              f"{out['collective_s']:.3f} | {out['compute_s']:.3f} | "
              f"{out['roofline_fraction']:.3f} |")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
