"""AdamW with global-norm clipping (a port of ``repro.optim.adamw``).

Plain functions on tensor trees under ``torch.no_grad()``, with the
reference's arithmetic: the clip scale is ``min(1, clip / max(norm, 1e-9))``
(``clip_grad_norm_`` divides by ``norm + 1e-6``) and the warmup is linear to
``warmup_steps``.  State (m, v) mirrors the parameter tree in fp32; ``step``
is an int32 scalar.  Updates return new tensors and leave their inputs as
they were.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..tree import tree_leaves, tree_map


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100


def init_state(params) -> dict:
    # zeros_like: a sharded (DTensor) param gets sharded moments
    zeros = lambda t: tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), t)
    device = tree_leaves(params)[0].device
    return {"m": zeros(params), "v": zeros(params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    warm = torch.clamp(step.float() / max(cfg.warmup_steps, 1), max=1.0)
    return cfg.lr * warm


@torch.no_grad()
def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(leaf.float() ** 2) for leaf in tree_leaves(tree)))


@torch.no_grad()
def apply_updates(params, grads, state, cfg: AdamWConfig):
    """Returns (new_params, new_state, metrics)."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    lr = schedule(cfg, step)

    b1, b2 = cfg.beta1, cfg.beta2
    bc1 = 1.0 - torch.pow(b1, step.float())
    bc2 = 1.0 - torch.pow(b2, step.float())

    def upd(p, g, m, v):
        # the reference's expression, one rounding per operation in its
        # order; the in-place steps reuse fresh tensors to hold down the
        # temporaries of the largest leaf (1.2 GB at yi-34b's width)
        g = g.float() * scale
        m_new = b1 * m
        m_new += (1 - b1) * g
        v_new = b2 * v
        v_new += (1 - b2) * g * g
        g = None
        denom = torch.sqrt(v_new / bc2).add_(cfg.eps)
        delta = (m_new / bc1).div_(denom)
        denom = None
        delta += cfg.weight_decay * p.float()
        return (p.float() - delta.mul_(lr)).to(p.dtype), m_new, v_new

    out = tree_map(upd, params, grads, state["m"], state["v"])
    pick = lambda i: tree_map(lambda o: o[i], out)
    return (
        pick(0),
        {"m": pick(1), "v": pick(2), "step": step},
        {"grad_norm": gnorm, "lr": lr},
    )
