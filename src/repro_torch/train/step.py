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
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    picked = torch.gather(lf, -1, labels[..., None].long())[..., 0]
    return (lse - picked).mean()


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


def make_train_step(model, settings: TrainSettings, grad_shardings=None):
    """``grad_shardings`` constrains gradients to the parameter shardings in
    the reference; the port has no sharding until ROADMAP item 6c."""
    if grad_shardings is not None:
        raise NotImplementedError("grad_shardings needs sharding/ (ROADMAP item 6c)")
    loss_fn = make_loss_fn(model, settings)

    def grad_fn(params, batch):
        flat = {k: p.detach().requires_grad_(True) for k, p in tree_paths(params).items()}
        total, (loss, aux) = loss_fn(tree_from_paths(flat), batch)
        # a leaf the loss never reads (a hybrid's shared block below its
        # cadence) gets a zero gradient, as jax.grad gives it
        grads = torch.autograd.grad(total, list(flat.values()), materialize_grads=True)
        return tree_from_paths(dict(zip(flat, grads, strict=True))), loss.detach(), aux.detach()

    def train_step(state: dict, batch: dict):
        params = state["params"]
        if settings.accum == 1:
            grads, loss, aux = grad_fn(params, batch)
        else:
            a = settings.accum
            mbs = [tree_map(lambda t, i=i: t.reshape((a, t.shape[0] // a) + t.shape[1:])[i],
                            batch) for i in range(a)]
            grads = tree_map(lambda p: torch.zeros(p.shape, device=p.device), params)
            loss = aux = torch.zeros((), device=tree_leaves(params)[0].device)
            for mb in mbs:
                g, mb_loss, mb_aux = grad_fn(params, mb)
                grads = tree_map(torch.add, grads, g)
                loss, aux = loss + mb_loss, aux + mb_aux
            grads = tree_map(lambda g: g / a, grads)
            loss, aux = loss / a, aux / a

        new_params, new_opt, om = apply_updates(params, grads, state["opt"], settings.optimizer)
        metrics = {"loss": loss, "aux": aux, **om}
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
