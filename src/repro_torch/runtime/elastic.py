"""Elastic rescaling: move a train state between meshes (a port of
``repro.runtime.elastic``).

Shardings are *derived* (logical axes x rules x mesh), never stored, so
elastic scale-down/up is: build the new mesh, recompute the placements,
move the restored state onto them.  ``reshard`` does that; ``degraded_mesh``
builds the standard fallback meshes (lose a pod -> single pod; lose data
rows -> shrink the data axis).
"""

from __future__ import annotations

from ..sharding.regions import distribute, is_dtensor
from ..sharding.rules import ShardingRules
from ..tree import tree_map


def degraded_mesh(ranks, lost_fraction: float = 0.5):
    """The largest (data, model) mesh over the surviving ``ranks`` (any
    array of global ranks; the first ``keep`` survive), with the largest
    power-of-two model split up to 16."""
    import torch
    from torch.distributed.device_mesh import DeviceMesh

    from ..launch.mesh import device_type

    flat = torch.as_tensor(ranks, dtype=torch.int64).reshape(-1)
    keep = max(1, int(len(flat) * (1.0 - lost_fraction)))
    model = 1
    while model * 2 <= min(16, keep) and keep % (model * 2) == 0:
        model *= 2
    data = keep // model
    return DeviceMesh(device_type(), flat[:keep].reshape(data, model),
                      mesh_dim_names=("data", "model"))


def reshard(state, axes_tree, rules: ShardingRules, new_mesh):
    """Every leaf onto the placements recomputed for ``new_mesh``; the values
    are unchanged (a sharded leaf is gathered whole, then split anew)."""

    def one(axes, leaf):
        full = leaf.full_tensor() if is_dtensor(leaf) else leaf
        return distribute(full, rules.sharding_for(tuple(axes), tuple(full.shape), new_mesh))

    return tree_map(one, axes_tree, state)
