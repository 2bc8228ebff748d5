"""Mixture-of-Experts layer with sort-based grouped dispatch (a port of
``repro.models.moe``).

Tokens are reshaped into G groups along a leading axis (the reference maps
one group function over it).  Within each group:

    1. router: softmax top-k over E experts (fp32),
    2. dispatch: stable-argsort the (tokens*k) expert assignments, give each
       assignment a slot within its expert via rank - segment_start, drop
       assignments past the per-expert capacity
       C = ceil(tokens_g * k / E * capacity_factor),
    3. gather to an (E, C, D) buffer (a padded row absorbs drops),
    4. batched expert FFN: ``(E, C, D) @ (E, D, F)`` SwiGLU,
    5. combine: ``index_add`` of outputs * gate weights back to the tokens.

DeepSeek-style shared experts (always-on) are supported via ``n_shared``.
The reference's sharding constraints on the dispatch buffers only annotate
a mesh; the port has none (ROADMAP item 6c).

Every index op here has a deterministic CUDA form (``index_select``,
``scatter``, ``scatter_add``, ``index_add``; no floating ``cumsum``), so a
train step repeats bit for bit under ``torch.use_deterministic_algorithms``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from .layers import silu


@dataclass(frozen=True)
class MoEDims:
    n_experts: int
    top_k: int
    d_model: int
    d_ff: int
    n_shared: int = 0
    capacity_factor: float = 1.25
    groups: int = 1


def router_topk(
    x: torch.Tensor, w_router: torch.Tensor, top_k: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(..., T, D) -> gates (..., T, k) fp32 (renormalized), experts (..., T,
    k) int64, plus the full router probabilities (..., T, E) for the aux
    loss.  Ties go to the lower expert index, as ``jax.lax.top_k`` breaks
    them (a stable descending sort)."""
    logits = x.float() @ w_router.float()
    probs = torch.softmax(logits, dim=-1)
    gates, experts = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, experts = gates[..., :top_k], experts[..., :top_k]
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return gates, experts, probs


def _dispatch_indices(
    experts: torch.Tensor, n_experts: int, capacity: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """experts: (..., A) flat expert assignment per (token, k) pair.

    Returns (slot_table, keep):
      slot_table: (..., E, C) int64 indices into the flat assignment axis
                  (= A, i.e. 'dropped/empty' sentinel points at pad row A),
      keep: (..., A) bool — assignment survived capacity.

    The reference sends every dropped assignment to one index past the
    table; here dropped assignment i writes slot ``E*C + i`` of a table
    ``A`` slots longer, so no two writes share a slot, and the tail is cut.
    """
    a = experts.shape[-1]
    lead = experts.shape[:-1]
    dev = experts.device
    order = torch.argsort(experts, dim=-1, stable=True)             # (..., A)
    sorted_e = torch.gather(experts, -1, order)
    # rank of each sorted element within its expert segment
    pos = torch.arange(a, device=dev)
    bounds = torch.arange(n_experts, device=dev, dtype=sorted_e.dtype).expand(*lead, n_experts)
    seg_start = torch.searchsorted(sorted_e.contiguous(), bounds.contiguous(), side="left")
    rank = pos - torch.gather(seg_start, -1, sorted_e)
    keep_sorted = rank < capacity
    # scatter into (E, C): slot (e, r) <- original assignment index
    n_slots = n_experts * capacity
    flat_slot = torch.where(keep_sorted, sorted_e * capacity + rank, n_slots + pos)
    table = torch.full((*lead, n_slots + a), a, dtype=torch.int64, device=dev)
    table = table.scatter(-1, flat_slot, torch.where(keep_sorted, order, a))
    keep = torch.zeros_like(keep_sorted).scatter(-1, order, keep_sorted)
    return table[..., :n_slots].reshape(*lead, n_experts, capacity), keep


def moe_group_forward(
    x: torch.Tensor,            # (G, T, D) each group's tokens
    w_router: torch.Tensor,     # (D, E)
    w_gate: torch.Tensor,       # (E, D, F)
    w_up: torch.Tensor,         # (E, D, F)
    w_down: torch.Tensor,       # (E, F, D)
    dims: MoEDims,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (out (G, T, D), aux (G,))."""
    g, t, d = x.shape
    e, k = dims.n_experts, dims.top_k
    capacity = math.ceil(t * k / e * dims.capacity_factor)
    capacity = max(8, min(capacity, t))
    dev = x.device

    gates, experts, probs = router_topk(x, w_router, k)
    flat_experts = experts.reshape(g, t * k)                       # (G, T*k)
    slot_table, _ = _dispatch_indices(flat_experts, e, capacity)
    slot_table = slot_table.reshape(g, e * capacity)

    token_of_assignment = torch.cat([
        torch.arange(t, device=dev).repeat_interleave(k),
        torch.tensor([t], device=dev)])                            # (T*k + 1,)
    gate_of_assignment = torch.cat(
        [gates.reshape(g, t * k), gates.new_zeros((g, 1))], dim=1)

    tok_idx = token_of_assignment[slot_table]                     # (G, E*C) in [0..T]
    gate_w = torch.gather(gate_of_assignment, 1, slot_table)      # (G, E*C) fp32
    # one flat row index per slot: group g's padded rows are g*(T+1) ...
    rows = (tok_idx + torch.arange(g, device=dev)[:, None] * (t + 1)).flatten()

    x_pad = torch.cat([x, x.new_zeros((g, 1, d))], dim=1).reshape(g * (t + 1), d)
    xs = x_pad.index_select(0, rows).reshape(g, e, capacity, d)
    xs = xs.transpose(0, 1).reshape(e, g * capacity, d)           # experts lead

    gg = torch.bmm(xs, w_gate.to(x.dtype))
    u = torch.bmm(xs, w_up.to(x.dtype))
    ys = torch.bmm(silu(gg) * u, w_down.to(x.dtype))              # (E, G*C, D)
    ys = ys.reshape(e, g, capacity, d).transpose(0, 1).reshape(g * e * capacity, d)
    ys = ys * gate_w.reshape(-1, 1).to(x.dtype)

    out = x.new_zeros((g * (t + 1), d)).index_add(0, rows, ys)
    out = out.reshape(g, t + 1, d)[:, :t]

    # load-balancing auxiliary loss (Switch-style): E * sum_e f_e * p_e
    counts = torch.zeros((g, e), device=dev).scatter_add(
        1, flat_experts, torch.ones(flat_experts.shape, device=dev))
    frac_tokens = counts / (t * k)
    mean_probs = probs.mean(dim=1)
    aux = e * torch.sum(frac_tokens * mean_probs, dim=-1)
    return out, aux


def moe_forward(
    x: torch.Tensor,            # (B, S, D)
    params: dict,               # router, gate, up, down [, shared_*]
    dims: MoEDims,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, S, D) -> (out, aux): the groups' mean aux loss."""
    b, s, d = x.shape
    g = dims.groups
    tokens = b * s
    if tokens % g != 0:
        raise ValueError(f"token count {tokens} not divisible by group {g}")
    out, aux = moe_group_forward(
        x.reshape(g, tokens // g, d),
        params["router"], params["gate"], params["up"], params["down"], dims)
    out = out.reshape(b, s, d)

    if dims.n_shared:
        gsh = x @ params["shared_gate"].to(x.dtype)
        ush = x @ params["shared_up"].to(x.dtype)
        out = out + (silu(gsh) * ush) @ params["shared_down"].to(x.dtype)
    return out, aux.mean()
