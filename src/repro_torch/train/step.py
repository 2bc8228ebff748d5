"""Training and serving step functions (a port of ``repro.train.step``).

``make_train_step`` builds a (state, batch) -> (state, metrics) function
with:
  * bf16 compute / fp32 master params & optimizer state,
  * selectable remat policy ("none" | "dots" | "full") around each layer
    block,
  * gradient accumulation over ``accum`` microbatches with a single
    optimizer update,
  * the MoE auxiliary load-balancing loss (zero for the other families).

``make_prefill_step`` / ``make_decode_step`` are the serving entry points
(forward logits only / one token against a KV cache).  An enc-dec batch
(``src_embeds``, ``dec_tokens``, ``dec_labels``) goes to the model whole.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..optim.adamw import AdamWConfig, apply_updates, init_state
from ..sharding.regions import is_dtensor, local_region, model_rank
from ..sharding.rules import PartitionSpec, ShardingRules, mesh_shape, placements_for
from ..tree import tree_from_paths, tree_leaves, tree_map, tree_paths


@dataclass(frozen=True)
class TrainSettings:
    remat: str = "dots"
    accum: int = 1               # gradient-accumulation microbatches
    aux_weight: float = 0.01     # MoE load-balance loss weight
    optimizer: AdamWConfig = AdamWConfig()
    #: cast fp32 master params to bf16 once before the layers, instead of
    #: inside each product (the reference's FSDP-traffic option)
    cast_bf16: bool = False


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean token NLL in fp32.  logits (B, S, V), labels (B, S) integers."""
    if is_dtensor(logits):
        return _sharded_cross_entropy(logits, labels)
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    picked = torch.gather(lf, -1, labels[..., None].long())[..., 0]
    return (lse - picked).mean()


def _sharded_cross_entropy(logits, labels):
    """Vocab-parallel NLL on logits sharded over ``model`` on V: each rank
    takes the log-sum-exp of its vocab shard and the label logits it holds
    (a local region); the ranks' parts are gathered (a few floats a token)
    and combined, and the per-token losses gathered whole for the mean."""
    from torch.distributed.tensor import Replicate

    vocab, mesh = logits.shape[-1], logits.device_mesh
    rules = ShardingRules()
    lab_spec = rules.spec_for(("batch", None), tuple(labels.shape), mesh)
    lf_spec = rules.spec_for(("batch", None, "vocab"), tuple(logits.shape), mesh)
    n_parts = mesh_shape(mesh)["model"] if lf_spec[2] is not None else 1

    def parts(lab, z):
        z, idx = z.float(), lab.long()
        if z.shape[-1] < vocab:
            idx = idx - model_rank(mesh) * z.shape[-1]
            hit = (idx >= 0) & (idx < z.shape[-1])
            picked = torch.gather(z, -1, idx.clamp(0, z.shape[-1] - 1)[..., None])[..., 0] * hit
        else:
            picked = torch.gather(z, -1, idx[..., None])[..., 0]
        return torch.stack([torch.logsumexp(z, dim=-1), picked], dim=-1)[..., None]

    b, s = labels.shape
    out_spec = rules.spec_for(("batch", None, None, "vocab"), (b, s, 2, n_parts), mesh)
    p = local_region(parts, mesh, (labels, logits), (lab_spec, lf_spec), ((out_spec, ()),))
    p = p.redistribute(mesh, placements_for(PartitionSpec(*out_spec[:3]), mesh))
    nll = torch.logsumexp(p[:, :, 0], dim=-1) - p[:, :, 1].sum(-1)
    return nll.redistribute(mesh, [Replicate()] * mesh.ndim).mean()


def _cast_tree_bf16(params):
    return tree_map(lambda p: p.to(torch.bfloat16) if p.dtype == torch.float32 else p, params)


def make_loss_fn(model, settings: TrainSettings):
    def loss_fn(params, batch):
        if settings.cast_bf16:
            params = _cast_tree_bf16(params)
        if "src_embeds" in batch:                               # enc-dec
            logits, aux = model.forward(params, batch, remat=settings.remat)
            labels = batch["dec_labels"]
        else:
            logits, aux = model.forward(params, batch["tokens"], remat=settings.remat)
            labels = batch["labels"]
        loss = cross_entropy(logits, labels)
        return loss + settings.aux_weight * aux, (loss, aux)

    return loss_fn


def init_train_state(model, params) -> dict:
    return {"params": params, "opt": init_state(params)}


def make_grad_fn(model, settings: TrainSettings, grad_shardings=None):
    """(params, batch) -> (grads, loss, aux).  ``grad_shardings`` (a tree of
    ``sharding.rules.NamedSharding`` matching the params) redistributes each
    gradient to its parameter's placements: the counterpart of the
    reference's ``with_sharding_constraint`` on the gradients."""
    loss_fn = make_loss_fn(model, settings)

    def grad_fn(params, batch):
        flat = {k: p.detach().requires_grad_(True) for k, p in tree_paths(params).items()}
        total, (loss, aux) = loss_fn(tree_from_paths(flat), batch)
        # a leaf the loss never reads (a hybrid's shared block below its
        # cadence) gets a zero gradient, as jax.grad gives it
        grads = torch.autograd.grad(total, list(flat.values()), materialize_grads=True)
        grads = tree_from_paths(dict(zip(flat, grads, strict=True)))
        if grad_shardings is not None:
            grads = tree_map(lambda g, sh: g.redistribute(sh.mesh, sh.placements),
                             grads, grad_shardings)
        return grads, loss.detach(), aux.detach()

    return grad_fn


def make_train_step(model, settings: TrainSettings, grad_shardings=None):
    """``grad_shardings``: see :func:`make_grad_fn`."""
    grad_fn = make_grad_fn(model, settings, grad_shardings)

    def train_step(state: dict, batch: dict):
        params = state["params"]
        if settings.accum == 1:
            grads, loss, aux = grad_fn(params, batch)
        else:
            a = settings.accum
            mbs = [tree_map(lambda t, i=i: t.reshape((a, t.shape[0] // a) + t.shape[1:])[i],
                            batch) for i in range(a)]
            grads = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
            loss = aux = torch.zeros((), device=tree_leaves(params)[0].device)
            for mb in mbs:
                g, mb_loss, mb_aux = grad_fn(params, mb)
                grads = tree_map(torch.add, grads, g)
                loss, aux = loss + mb_loss, aux + mb_aux
            grads = tree_map(lambda g: g / a, grads)
            loss, aux = loss / a, aux / a

        new_params, new_opt, om = apply_updates(params, grads, state["opt"], settings.optimizer)
        # sharded scalars come back whole, as plain tensors
        metrics = {k: v.full_tensor() if is_dtensor(v) else v
                   for k, v in {"loss": loss, "aux": aux, **om}.items()}
        return {"params": new_params, "opt": new_opt}, metrics

    return train_step


def make_prefill_step(model, remat: str = "none"):
    @torch.no_grad()
    def prefill_step(params, batch):
        if "src_embeds" in batch:
            enc_out = model.encode(params, batch["src_embeds"], remat=remat)
            return model.decode_train(params, enc_out, batch["dec_tokens"], remat=remat)
        logits, _ = model.forward(params, batch["tokens"], remat=remat)
        return logits

    return prefill_step


def make_decode_step(model):
    @torch.no_grad()
    def decode_step(params, cache, cache_len, tokens):
        return model.decode_step(params, cache, cache_len, tokens)

    return decode_step
