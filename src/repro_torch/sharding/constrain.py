"""Activation sharding constraints (a port of ``repro.sharding.constrain``:
the sequence-parallel residual stream).

Between layers the residual stream x (B, S, D) is constrained to
    B -> (pod, data),  S -> model,  D -> replicated
i.e. Megatron-style sequence parallelism: the residuals a layer keeps for
its backward shrink by the TP degree.  The all-gather before a block (which
needs the full sequence) is its region's redistribution
(``regions.local_region``); the sum over ``model`` after its output
projection is the region's all-reduce, of which the constraint keeps this
rank's sequence shard.

The mesh is the tensor's own: a DTensor carries its ``device_mesh``.  A plain
tensor has none, and every hook here returns it as it is (the reference's
hooks are identities without an active mesh), so model code calls them
unconditionally.
"""

from __future__ import annotations

import math

from ..tree import tree_map
from .regions import is_dtensor
from .rules import PartitionSpec, ShardingRules, mesh_shape, placements_for

#: FSDP weight-gather mode (the reference's §Perf H4).  When on, each
#: layer's weights are cast to bf16 and then gathered to their sharding
#: without the data axes at the top of the block, so the all-gather moves
#: bf16.  Off, a block's region gathers the fp32 weights and casts them at
#: each product.  Toggled by the hill-climb driver; default off (baseline).
FSDP_GATHER_WEIGHTS = False


def gather_layer_weights(lp_tree, axes_tree):
    """Gather one layer's weights to a no-data-axis sharding, in bf16 (see
    above).

    axes_tree: logical axes per leaf with the leading "layers" dim already
    stripped.  The identity when the flag is off or the leaves are plain
    tensors.
    """
    if not FSDP_GATHER_WEIGHTS:
        return lp_tree
    import torch

    rules = ShardingRules().with_overrides(embed=())

    def one(axes, p):
        if not is_dtensor(p):
            return p
        v = p.to(torch.bfloat16) if p.dtype == torch.float32 else p
        spec = rules.spec_for(tuple(axes), tuple(v.shape), v.device_mesh)
        return v.redistribute(v.device_mesh, placements_for(spec, v.device_mesh))

    return tree_map(one, axes_tree, lp_tree)


def strip_layer_axis(axes_tree):
    """('layers', a, b, ...) -> (a, b, ...) for every leaf."""
    return tree_map(lambda axes: tuple(a for a in axes if a != "layers"), axes_tree)


def constrain_residual(x):
    """x: (B, S, D) residual stream -> batch/data + sequence/model."""
    if not is_dtensor(x) or x.ndim != 3:
        return x
    mesh = x.device_mesh
    sizes = mesh_shape(mesh)
    b, s, _ = x.shape
    batch_axes = tuple(a for a in ("pod", "data") if a in sizes)
    nb = math.prod(sizes[a] for a in batch_axes)
    parts: list = [None, None, None]
    if batch_axes and b % nb == 0:
        parts[0] = batch_axes if len(batch_axes) > 1 else batch_axes[0]
    if "model" in sizes and s > 1 and s % sizes["model"] == 0:
        parts[1] = "model"
    return x.redistribute(mesh, placements_for(PartitionSpec(*parts), mesh))
