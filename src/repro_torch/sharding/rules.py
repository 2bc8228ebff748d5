"""Logical-axis sharding rules (a port of ``repro.sharding.rules``).

Model code annotates every parameter dim with a *logical* axis name
(``repro_torch.models.param``); this module maps logical names to *mesh*
axes and gives each tensor its placements on a ``DeviceMesh``: params,
optimizer state, batches and caches.

Default rule set (single pod mesh ("data", "model") and multi-pod mesh
("pod", "data", "model")):

    batch      -> ("pod", "data")     data parallel across pods x data axis
    vocab      -> "model"             embedding / logits TP
    heads      -> "model"             attention TP
    kv_heads   -> "model"             (falls back to replicated if indivisible,
                                       e.g. MQA kv=1)
    ffn        -> "model"             MLP TP
    experts    -> "model"             expert parallelism
    ssm_inner  -> "model"             Mamba2 inner dim TP
    q_lora/kv_lora/rope_dim -> None   MLA latents replicated (small)
    embed      -> ("pod", "data")     FSDP weight sharding (ZeRO-3); the
                                       optimizer state inherits it
    layers     -> None                the stacked-layer dim, never sharded
    kv_seq     -> "data"              decode KV caches: sequence parallelism
                                       for huge caches (long_500k B=1)

Any dim whose size does not divide its mesh axes falls back to a prefix of
them, then to replicated, and no mesh axis is used twice in one tensor.

``spec_for`` returns the port's own :class:`PartitionSpec`: per tensor dim
``None``, a mesh-axis name, or a tuple of names, equal by value to the
reference's.  :func:`placements_for` turns it into DTensor placements, one
per mesh dim: ``Shard(d)`` where tensor dim ``d`` names that mesh axis,
``Replicate()`` elsewhere.

A tensor dim over two mesh axes, e.g. ``("pod", "data")``, is ``Shard(d)``
on both mesh dims.  DTensor orders such shards by mesh dim, where JAX orders
them by the spec; the two agree when the spec lists its axes in the mesh's
order, which every default rule does (``pod`` before ``data``).  The shard
sizes agree either way.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

from ..tree import tree_map

DEFAULT_RULES: dict[str, tuple[str, ...]] = {
    "batch": ("pod", "data"),
    "vocab": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "head_dim": (),
    "ffn": ("model",),
    "experts": ("model",),
    "ssm_inner": ("model",),
    "ssm_state": (),
    "q_lora": (),
    "kv_lora": (),
    "rope_dim": (),
    # FSDP weight shard over all data-parallel axes (pod included): ZeRO-3
    # across the full replica set.  Params have no batch dim, so there is no
    # conflict with activations' batch -> (pod, data).
    "embed": ("pod", "data"),
    "layers": (),
    "kv_seq": ("data",),
    "seq": (),
    "conv": (),
    # decode-cache axes: where kv_heads does not divide the model axis (GQA
    # kv in {1, 8, 10}) the cache still shards 16-way on its per-head feature
    # dim, which always divides (128 % 16 == 0)
    "kv_head_dim": ("model",),
    "kv_lora_cache": ("model",),
    "rope_cache": ("model",),
}


class PartitionSpec(tuple):
    """Per tensor dim: ``None``, one mesh-axis name or a tuple of them."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


def mesh_shape(mesh) -> dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` (or of any object with a
    ``shape`` mapping, as the reference's tests' shape-only mesh has)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return {name: mesh.size(i) for i, name in enumerate(names)}
    return dict(mesh.shape)


def placements_for(spec: PartitionSpec, mesh, partial: tuple[str, ...] = ()) -> tuple:
    """DTensor placements, one per mesh dim, for ``spec``; ``Partial`` (a
    sum) over the mesh axes in ``partial`` that the spec leaves free."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    by_axis = {axis: Partial() for axis in partial}
    for dim, part in enumerate(spec):
        for axis in (part,) if isinstance(part, str) else (part or ()):
            by_axis[axis] = Shard(dim)
    return tuple(by_axis.get(axis, Replicate()) for axis in mesh_shape(mesh))


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh: the reference's ``jax.sharding.NamedSharding``."""

    mesh: object
    spec: PartitionSpec

    @property
    def placements(self) -> tuple:
        return placements_for(self.spec, self.mesh)


@dataclass(frozen=True)
class ShardingRules:
    rules: dict = field(default_factory=lambda: dict(DEFAULT_RULES))

    def with_overrides(self, **overrides) -> "ShardingRules":
        r = dict(self.rules)
        for k, v in overrides.items():
            r[k] = tuple(v) if v else ()
        return ShardingRules(r)

    def mesh_axes_for(self, logical: str | None, mesh) -> tuple[str, ...]:
        if logical is None:
            return ()
        names = mesh_shape(mesh)
        return tuple(a for a in self.rules.get(logical, ()) if a in names)

    def spec_for(self, axes: tuple, shape: tuple, mesh) -> PartitionSpec:
        """PartitionSpec for one tensor given its logical axes + shape.

        Falls back per dim to a prefix of the mesh axes, then to replication,
        when the dim size does not divide their product, and never assigns
        one mesh axis twice.
        """
        sizes = mesh_shape(mesh)
        used: set[str] = set()
        parts = []
        for dim, logical in zip(shape, axes, strict=False):
            mesh_axes = tuple(a for a in self.mesh_axes_for(logical, mesh) if a not in used)
            # the whole tuple, then shorter prefixes of it (e.g. batch over
            # ("pod", "data") with a batch that divides only "pod")
            for cut in range(len(mesh_axes), 0, -1):
                sub = mesh_axes[:cut]
                if dim % math.prod(sizes[a] for a in sub) == 0:
                    used.update(sub)
                    parts.append(sub if len(sub) > 1 else sub[0])
                    break
            else:
                parts.append(None)
        return PartitionSpec(*parts)

    def sharding_for(self, axes: tuple, shape: tuple, mesh) -> NamedSharding:
        return NamedSharding(mesh, self.spec_for(axes, shape, mesh))

    # -- tree-level helpers ---------------------------------------------------
    def tree_shardings(self, axes_tree, abstract_tree, mesh):
        """Matching trees of logical axes + tensors -> shardings."""
        return tree_map(lambda axes, t: self.sharding_for(tuple(axes), tuple(t.shape), mesh),
                        axes_tree, abstract_tree)


def batch_spec(mesh, extra_dims: int = 1) -> PartitionSpec:
    """(B, S, ...) activations: batch over (pod, data)."""
    axes = tuple(a for a in ("pod", "data") if a in mesh_shape(mesh))
    return PartitionSpec(axes if len(axes) > 1 else axes[0], *([None] * extra_dims))
