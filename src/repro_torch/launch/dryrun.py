"""Multi-pod dry run: one step of every (arch x shape x mesh) cell, traced
at full size with nothing allocated (a port of ``repro.launch.dryrun``).

For each cell this builds the step (train_step for train shapes,
prefill/decode for serving shapes) with every parameter, optimizer moment,
batch and cache a DTensor on the placements the logical-axis rules give it,
on a fake process group of 256 (single pod) or 512 (multi-pod) ranks, and
runs it under ``FakeTensorMode`` (shapes only) while counting what one rank
does:

  * per-device memory: the arguments' and outputs' local shards, and the
    peak of the live storages over the step (``MemTracker``; the arguments
    count from the start),
  * per-device dot FLOPs and bytes accessed (``hlo_analysis``),
  * collective bytes and counts by kind: the functional collectives the
    DTensor redistributions issue,

into results/dryrun_torch/<arch>_<shape>_<mesh>.json for the roofline layer
(launch/roofline.py).

Where DTensor has no sharding strategy for an op XLA partitions silently, or
where its propagation of a reshape of sharded dims fails under
``FakeTensorMode`` (a strided shard's ``.tolist()``), the port redistributes
explicitly or runs the block as a local region (``sharding/regions.py``).
Each is a collective the counts include, so the port's collective bytes
differ from XLA's by design:

  1. the embedding gather on a vocab-sharded table: a vocab-parallel lookup
     (each ``model`` rank reads its rows, zeros elsewhere; ``Partial``);
  2. the final norm and ``lm_logits``: one region, the head gathered over
     the data axes, logits sharded over ``model`` on V; the cross entropy:
     each rank's log-sum-exp of its vocab shard and the label logits it
     holds (a region), gathered (two floats a token) and combined;
  3. attention (GQA, MLA): a region per block, split over ``model`` by
     query heads where they divide (K/V heads too where those divide, else
     every rank holds K/V whole and reads the heads its queries use), by
     query rows where only the sequence divides, else replicated;
  4. the MoE sort, dispatch and combine: a region per block, each data
     shard's own groups, the router replicated, each ``model`` rank its
     experts, the combine ``Partial`` over ``model``;
  5. the Mamba-2 mixer (SSD chunk loop, segsum, causal conv), the hybrid's
     shared block and every enc-dec layer: regions replicated over
     ``model``, batch-sharded over the data axes;
  6. decode caches: gathered from their ``kv_seq`` / feature sharding to
     the block's layout, written back in it, and redistributed to the
     rules' placements at the end of the step;
  7. every block's weights: all-gathered over the data axes on entry (the
     FSDP gather) and their gradients reduce-scattered back.

``torch.unbind`` of the stacked ``(L, ...)`` leaves has a DTensor strategy
(the layers dim is never sharded) and needs nothing.

Usage (the fake group is set up here, in a process of its own):
    PYTHONPATH=src python -m repro_torch.launch.dryrun                   # all cells
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-34b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh single     # one mesh
"""

from __future__ import annotations

import argparse
import json
import math
import os
import traceback

import torch

from ..configs import REGISTRY, SHAPES, applicable_shapes
from ..configs.base import ArchConfig, ShapeCfg
from ..core import clock
from ..launch.hlo_analysis import StepCounter
from ..launch.mesh import make_production_mesh, start_fake_process_group
from ..launch.specs import decode_specs, prefill_batch_specs, sds, train_batch_specs
from ..models import abstract_params, build_model, param_axes, param_count
from ..sharding.regions import empty_like_sharded, is_dtensor
from ..sharding.rules import ShardingRules, mesh_shape
from ..train.step import TrainSettings, make_decode_step, make_prefill_step, make_train_step
from ..tree import tree_leaves, tree_map

RESULTS_DIR = os.path.join("results", "dryrun_torch")


def build_step(arch: ArchConfig, shape: ShapeCfg, mesh, rules: ShardingRules,
               settings: TrainSettings | None = None):
    """Returns (step, args): the step function and its DTensor arguments.
    Call it under ``FakeTensorMode`` and nothing is allocated."""
    sizes = mesh_shape(mesh)
    data_shards = math.prod(sizes[a] for a in ("pod", "data") if a in sizes)
    moe_groups = data_shards if shape.global_batch % data_shards == 0 else 1
    model = build_model(arch, moe_groups=moe_groups)
    spec = model.spec()
    aparams = abstract_params(spec)
    p_shard = rules.tree_shardings(param_axes(spec), aparams, mesh)
    put = empty_like_sharded
    params = tree_map(put, aparams, p_shard)

    def batch_put(v):  # batch-leading arrays, divisibility-aware (B=1 long_500k)
        return put(v, rules.sharding_for(("batch",) + (None,) * (v.ndim - 1),
                                         tuple(v.shape), mesh))

    if shape.kind == "train":
        settings = settings or TrainSettings(remat="dots", accum=1)
        step = make_train_step(model, settings, grad_shardings=p_shard)
        moment = lambda: tree_map(put, tree_map(lambda a: sds(a.shape, torch.float32), aparams),
                                  p_shard)
        state = {"params": params,
                 "opt": {"m": moment(), "v": moment(),
                         "step": torch.zeros((), dtype=torch.int32)}}
        batch = {k: batch_put(v) for k, v in train_batch_specs(arch, shape).items()}
        return step, (state, batch)

    if shape.kind == "prefill":
        batch = {k: batch_put(v) for k, v in prefill_batch_specs(arch, shape).items()}
        return make_prefill_step(model), (params, batch)

    decode = make_decode_step(model)
    dspecs = decode_specs(arch, shape, model)
    c_shard = rules.tree_shardings(model.cache_axes(), dspecs["cache"], mesh)

    def step(params, cache, cache_len, tokens):
        logits, new = decode(params, cache, cache_len, tokens)
        # the reference's out_shardings: the new cache on the cache's placements
        return logits, tree_map(lambda t, sh: t.redistribute(sh.mesh, sh.placements),
                                new, c_shard)

    cache = tree_map(put, dspecs["cache"], c_shard)
    return step, (params, cache, batch_put(dspecs["cache_len"]), batch_put(dspecs["tokens"]))


def _local_bytes(tree) -> int:
    leaves = [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]
    return sum((t.to_local() if is_dtensor(t) else t).nbytes for t in leaves)


def _flatten(args) -> list:
    out = []
    for a in args:
        out += tree_leaves(a) if isinstance(a, dict) else [a]
    return out


def measure_step(fn, args) -> dict:
    """One call of ``fn(*args)`` (under the caller's fake mode): dot FLOPs,
    bytes accessed, collectives and memory per device."""
    from torch.distributed._tools.mem_tracker import MemTracker

    tracker = MemTracker()
    flat = _flatten(args)
    tracker.track_external(*flat)
    with tracker, StepCounter() as counter:
        out = fn(*args)
    out_flat = [t for t in _flatten(out if isinstance(out, tuple) else (out,))
                if isinstance(t, torch.Tensor)]
    peak = max(snap["Total"] for snap in tracker.get_tracker_snapshot("peak").values())
    arg_bytes = _local_bytes({str(i): t for i, t in enumerate(flat)})
    return {
        "dots": counter.dots(),
        "bytes_accessed": counter.bytes_accessed,
        "collectives": counter.collectives(),
        "memory": {
            "argument_bytes_per_dev": arg_bytes,
            "output_bytes_per_dev": _local_bytes({str(i): t for i, t in enumerate(out_flat)}),
            # the reference's module-global temp has no counterpart: the
            # peak above the arguments, per device
            "temp_bytes_module": peak - arg_bytes,
            "peak_bytes_per_dev": peak,
        },
    }


def run_cell(arch_name: str, shape_name: str, multi_pod: bool,
             rules: ShardingRules | None = None, save: bool = True,
             settings: TrainSettings | None = None) -> dict:
    from torch._subclasses.fake_tensor import FakeTensorMode

    arch = REGISTRY[arch_name]
    shape = SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod)
    rules = rules or ShardingRules()
    mesh_name = "multipod" if multi_pod else "single"
    t0 = clock.monotonic()
    with FakeTensorMode():
        fn, args = build_step(arch, shape, mesh, rules, settings=settings)
        m = measure_step(fn, args)
    n_dev = mesh.size()
    coll = m["collectives"]
    record = {
        "arch": arch_name,
        "shape": shape_name,
        "mesh": mesh_name,
        "n_devices": n_dev,
        "params": param_count(build_model(arch).spec()),
        # the port counts matmul-class FLOPs only, as the corrected count does
        "flops_total": m["dots"]["flops"],
        "flops_dot_corrected": m["dots"]["flops"],
        "flops_dot_uncorrected": m["dots"]["flops_uncorrected"],
        "bytes_total": m["bytes_accessed"],
        "collectives": coll,
        "memory": m["memory"],
        "wall_s": clock.monotonic() - t0,
    }
    if save:
        os.makedirs(RESULTS_DIR, exist_ok=True)
        path = os.path.join(RESULTS_DIR, f"{arch_name}_{shape_name}_{mesh_name}.json")
        with open(path, "w") as f:
            json.dump(record, f, indent=2)
    print(f"[dryrun] {arch_name:20s} {shape_name:12s} {mesh_name:8s} "
          f"flops={record['flops_total']:.3e} bytes={record['bytes_total']:.3e} "
          f"coll={coll['total_bytes']:.3e} "
          f"peak/dev={record['memory']['peak_bytes_per_dev']/2**30:.2f}GiB "
          f"args/dev={record['memory']['argument_bytes_per_dev']/2**30:.2f}GiB "
          f"({record['wall_s']:.0f}s)", flush=True)
    return record


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=("single", "multipod", "both"), default="both")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    meshes = {"single": [False], "multipod": [True], "both": [False, True]}[args.mesh]
    start_fake_process_group(512 if True in meshes else 256)
    archs = [args.arch] if args.arch else list(REGISTRY)
    failures = []
    for arch_name in archs:
        shapes = (
            [args.shape] if args.shape else applicable_shapes(REGISTRY[arch_name])
        )
        for shape_name in shapes:
            for mp in meshes:
                mesh_name = "multipod" if mp else "single"
                path = os.path.join(
                    RESULTS_DIR, f"{arch_name}_{shape_name}_{mesh_name}.json"
                )
                if os.path.exists(path) and not args.force:
                    print(f"[dryrun] skip existing {path}")
                    continue
                try:
                    run_cell(arch_name, shape_name, mp)
                except Exception as e:  # noqa: BLE001 — record and continue
                    failures.append((arch_name, shape_name, mesh_name, repr(e)))
                    print(f"[dryrun] FAIL {arch_name} {shape_name} {mesh_name}: {e}")
                    traceback.print_exc()
    if failures:
        print(f"\n[dryrun] {len(failures)} FAILURES:")
        for f in failures:
            print("   ", *f[:3], f[3][:200])
        raise SystemExit(1)
    print("\n[dryrun] ALL CELLS PASSED")


if __name__ == "__main__":
    main()
