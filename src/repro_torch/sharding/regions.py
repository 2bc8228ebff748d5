"""Local regions: DTensor between the blocks, plain tensors inside them.

The reference hands XLA's SPMD partitioner sharding hints and lets it
partition every op.  The port gives each parameter, batch and cache its
DTensor placements from the rules (``rules.py``) and lets DTensor propagate
the glue between blocks op by op: the residual adds, the sequence-parallel
constraint, the loss's combination of its parts.  Each block that
reshapes a sharded dim (attention's head grouping, MoE dispatch, MLA, the
SSD's chunks) runs as a *local region* (``local_region``): its DTensor
inputs are redistributed to the layout the block computes in, the block's
own code runs on the local shards, and its outputs are wrapped back as
DTensors with the placements that layout gives them.  DTensor represents a
reshape that merges a data-sharded dim with a model-sharded one as a
strided shard, and its propagation of those fails under ``FakeTensorMode``
(the dry run's mode), so the regions are where the port decides the layout.

The layouts (Megatron tensor parallelism over ``model``, ZeRO-3 over the
data axes):

* activations enter batch-sharded over ``(pod, data)`` where the batch
  divides, replicated over ``model`` (the all-gather of a sequence-sharded
  residual stream);
* weights enter in the rules' placements without the data axes (the FSDP
  all-gather; ``rules.with_overrides(embed=())``), so heads, ffn and
  experts stay sharded over ``model`` where they divide;
* outputs leave batch-sharded; where a weight was sharded over ``model``
  each rank holds a share of the sum, which the region all-reduces on the
  way out.

An input replicated over a mesh axis that another input is sharded over
gets a ``Partial`` gradient there (each rank's share of the sum), which
DTensor reduces: the data axes' gradient reduce-scatter and the model
axis's all-reduce of an activation's gradient.  No ``Partial`` DTensor is
left in the forward graph: the backward of a redistribution out of
``Partial`` differs between torch releases, so a region reduces its
partial outputs inside one autograd function whose backward it states.
"""

from __future__ import annotations

import torch

from .rules import PartitionSpec, ShardingRules, mesh_shape, placements_for


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def model_rank(mesh) -> int:
    """This rank's coordinate on the ``model`` axis (0 without one)."""
    return mesh.get_local_rank("model") if "model" in mesh_shape(mesh) else 0


def local_region(fn, mesh, args, in_specs, out_specs, split_over: tuple = ()):
    """``fn`` on the local shards of ``args``.

    ``in_specs``: per arg a :class:`PartitionSpec` to redistribute it to
    (a plain tensor is taken as replicated first), or ``None`` to pass it
    as it is.  ``out_specs``: per output a ``(spec, partial_axes)`` pair.
    ``split_over``: mesh axes over which ``fn`` itself splits the work (by
    its rank) though no input is sharded there.  Returns the outputs as
    DTensors (a tuple when ``fn`` returns one).
    """
    from torch.distributed.tensor import DTensor, Partial, Replicate

    names = list(mesh_shape(mesh))
    in_pl = [None if s is None else placements_for(s, mesh) for s in in_specs]
    split = {i for pl in in_pl if pl for i, p in enumerate(pl) if p.is_shard()}
    split |= {names.index(a) for a in split_over}
    local = []
    for a, pl in zip(args, in_pl, strict=True):
        if pl is None:
            local.append(a)
            continue
        if not isinstance(a, DTensor):
            a = DTensor.from_local(a, mesh, [Replicate()] * len(names), run_check=False)
        grad_pl = tuple(Partial() if p.is_replicate() and i in split else p
                        for i, p in enumerate(pl))
        local.append(a.redistribute(mesh, pl).to_local(grad_placements=grad_pl))
    out = fn(*local)
    outs = out if isinstance(out, tuple) else (out,)
    wrapped = tuple(_reduced(o, mesh, placements_for(spec, mesh, partial))
                    for o, (spec, partial) in zip(outs, out_specs, strict=True))
    return wrapped if isinstance(out, tuple) else wrapped[0]


class _Reduced(torch.autograd.Function):
    """A region's local output as a DTensor on ``placements``, its
    ``Partial`` axes all-reduced.  The gradient of each rank's share of a
    sum is the whole gradient: the backward hands back the output's
    gradient on its shards, replicated over the partial axes."""

    @staticmethod
    def forward(ctx, local, mesh, placements, whole):
        from torch.distributed.tensor import DTensor

        ctx.mesh, ctx.whole = mesh, whole
        out = DTensor.from_local(local.detach(), mesh, placements, run_check=False)
        return out.redistribute(mesh, whole) if whole != placements else out

    @staticmethod
    def backward(ctx, grad):
        return grad.redistribute(ctx.mesh, ctx.whole).to_local(), None, None, None


def _reduced(local, mesh, placements):
    from torch.distributed.tensor import Replicate

    whole = tuple(Replicate() if p.is_partial() else p for p in placements)
    return _Reduced.apply(local, mesh, placements, whole)


#: the cache axes a block computes without: a sequence- or feature-sharded
#: cache is gathered for the block (its heads stay sharded where the block's
#: are)
_GATHERED_CACHE_AXES = ("kv_seq", "kv_head_dim", "kv_lora_cache", "rope_cache")


def _model_mapped(rules: ShardingRules, axes) -> bool:
    return any("model" in rules.rules.get(a, ()) for a in axes if a is not None)


def block_region(fn, acts: tuple, weights: dict, axes: dict, *, act_axes: tuple | None = None,
                 out_axes: tuple = (None,), replicate: tuple = (), model_parallel: bool = True,
                 split_over: tuple = ()):
    """One block as a local region: ``fn(*acts_local, weights_local)``.

    ``acts``: batch-leading activations (plain tensors are taken as
    replicated; ``None`` passes through); ``act_axes`` gives an act's
    logical axes where it is not ``("batch", None, ...)`` (a cache).
    ``weights``: one layer's leaves, their logical ``axes`` per key.

    The block is model-parallel when every weight with a model-mapped axis
    (but those in ``replicate``) divides over ``model``; otherwise (or with
    ``model_parallel=False``) it runs replicated over ``model``.  Per
    output, ``out_axes`` holds ``None`` (batch-leading; summed over
    ``model`` in a model-parallel block), the index of the act whose
    placement it takes (a cache written in place), ``(logical axes, global
    shape)``, a :class:`PartitionSpec` as it is, or ``"sum"``: a scalar
    each rank holds its share of (summed over every mesh axis the acts are
    sharded over, and over ``model`` in a model-parallel block).
    ``split_over``: see :func:`local_region`.
    Returns DTensors, none of them ``Partial``.
    """
    mesh = next(t.device_mesh for t in (*acts, *weights.values()) if is_dtensor(t))
    compute = ShardingRules().with_overrides(embed=(), **{a: () for a in _GATHERED_CACHE_AXES})
    tp_keys = [k for k in weights if k not in replicate and _model_mapped(compute, axes[k])]

    def spec(r, ax, t):
        return r.spec_for(tuple(ax), tuple(t.shape), mesh)

    tp = model_parallel and bool(tp_keys) and "model" in mesh_shape(mesh) and all(
        "model" in _axes_of(spec(compute, axes[k], weights[k])) for k in tp_keys)
    if not tp:
        compute = compute.with_overrides(**{k: () for k, v in compute.rules.items()
                                            if "model" in v})
    names = sorted(weights)
    w_specs = [PartitionSpec(*([None] * weights[n].ndim)) if n in replicate
               else spec(compute, axes[n], weights[n]) for n in names]
    act_axes = act_axes or (None,) * len(acts)
    a_specs = [None if a is None else
               spec(compute, ax or ("batch",) + (None,) * (a.ndim - 1), a)
               for a, ax in zip(acts, act_axes, strict=True)]
    b_axes = next(s for s in a_specs if s is not None)[0]
    partial = ("model",) if tp else ()
    used = set().union(*(_axes_of(s) for s in a_specs if s is not None))
    sharded = tuple(a for a in mesh_shape(mesh) if a in used)
    out_specs = tuple((PartitionSpec(b_axes), partial) if o is None
                      else (PartitionSpec(), tuple(dict.fromkeys(sharded + partial))) if o == "sum"
                      else (a_specs[o], ()) if isinstance(o, int)
                      else (o, ()) if isinstance(o, PartitionSpec)
                      else (compute.spec_for(tuple(o[0]), tuple(o[1]), mesh), ())
                      for o in out_axes)

    def local(*xs):
        return fn(*xs[:len(acts)], dict(zip(names, xs[len(acts):], strict=True)))

    return local_region(local, mesh, (*acts, *(weights[n] for n in names)),
                        (*a_specs, *w_specs), out_specs, split_over)


def maybe_region(fn, acts: tuple, weights: dict, axes: dict, keys=None, **kw):
    """``fn(*acts, weights)`` as it is on plain tensors, as a
    :func:`block_region` when any of them is a DTensor; ``keys`` picks the
    leaves of ``weights`` the block reads."""
    if keys is not None:
        weights = {k: weights[k] for k in keys if k in weights}
    if any(is_dtensor(t) for t in (*acts, *weights.values())):
        return block_region(fn, acts, weights, axes, **kw)
    return fn(*acts, weights)


def _axes_of(spec) -> set:
    """The mesh axes a spec shards over."""
    return {a for p in spec for a in ((p,) if isinstance(p, str) else p or ())}


def local_shape(shape: tuple, sharding) -> tuple:
    """The local shard's shape of a tensor of global ``shape`` under
    ``sharding`` (the rules only shard dims that divide)."""
    out = list(shape)
    sizes = mesh_shape(sharding.mesh)
    for axis, p in zip(sizes, sharding.placements, strict=True):
        if p.is_shard():
            out[p.dim] //= sizes[axis]
    return tuple(out)


def empty_like_sharded(t, sharding):
    """An uninitialised DTensor shaped like ``t`` (e.g. a ``meta`` tensor)
    on ``sharding``, its local shard on the CPU: under ``FakeTensorMode``
    nothing is allocated."""
    from torch.distributed.tensor import DTensor

    local = torch.empty(local_shape(tuple(t.shape), sharding), dtype=t.dtype, device="cpu")
    return DTensor.from_local(local, sharding.mesh, sharding.placements, run_check=False)


def distribute(t, sharding):
    """A full tensor (the same on every rank) split onto ``sharding``."""
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(t, sharding.mesh, sharding.placements)
