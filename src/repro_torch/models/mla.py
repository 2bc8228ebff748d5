"""Multi-head Latent Attention (DeepSeek-V2, arXiv:2405.04434; a port of
``repro.models.mla``).

Prefill: standard formulation —
    c_q  = W_dq x             (q_lora)         q = W_uq RMSNorm(c_q)
    c_kv = W_dkv x            (kv_lora)        k_nope, v = W_uk/W_uv RMSNorm(c_kv)
    k_rope = RoPE(W_kr x)     (d_rope, shared across heads)
    score = q_nope . k_nope + q_rope . k_rope, scale 1/sqrt(d_nope + d_rope)

Decode: the *absorbed* formulation — the KV cache stores only the latent
``c_kv`` (kv_lora) and ``k_rope`` per token.  W_uk is absorbed into the
query and W_uv into the output so no per-step (S, H, d) K/V tensors are
materialized:
    q_lat  = einsum(q_nope, W_uk)        (B, 1, H, kv_lora)
    score  = q_lat . norm(c_kv) + q_rope . k_rope
    o_lat  = probs . norm(c_kv)          (B, 1, H, kv_lora)
    out    = einsum(o_lat, W_uv)         (B, 1, H, d_v)

Scores and context run in fp32 end to end in both, as the reference's do:
the two factorize the same products differently, and bf16 rounding of the
intermediates would make decode drift from prefill.  The (B, H, Sq, S) fp32
score tensor is updated in place (add, scale, mask) so that at most two of
its size live at once: 8.6 GB each at deepseek-v2's 128 heads and S = 4096.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from .layers import MASK_VALUE, apply_rope, rms_norm

MLA_CHUNK_THRESHOLD = 8192
MLA_Q_CHUNK = 2048


@dataclass(frozen=True)
class MLADims:
    n_heads: int
    q_lora: int = 1536
    kv_lora: int = 512
    d_nope: int = 128
    d_rope: int = 64
    d_v: int = 128

    @property
    def scale(self) -> float:
        return 1.0 / math.sqrt(self.d_nope + self.d_rope)


def _queries(x, p, dims: MLADims, positions, rope_theta):
    dn = dims.d_nope
    cq = rms_norm(x @ p["w_dq"].to(x.dtype), p["q_norm"])
    q_lora, h, e = p["w_uq"].shape
    q = (cq @ p["w_uq"].reshape(q_lora, h * e).to(x.dtype)).unflatten(-1, (h, e))
    return q[..., :dn], apply_rope(q[..., dn:], positions, rope_theta)


def _k_rope(x, p, positions, rope_theta):
    k_rope = x @ p["w_kr"].to(x.dtype)
    return apply_rope(k_rope[:, :, None, :], positions, rope_theta)[:, :, 0]


def mla_prefill(
    x: torch.Tensor,          # (B, S, D)
    p: dict,
    dims: MLADims,
    positions: torch.Tensor,  # (B, S)
    rope_theta: float = 10000.0,
) -> tuple[torch.Tensor, dict]:
    """Returns (attn_out (B,S,D), cache {c_kv, k_rope})."""
    b, s, d = x.shape
    q_nope, q_rope = _queries(x, p, dims, positions, rope_theta)

    c_kv = x @ p["w_dkv"].to(x.dtype)
    c_kv_n = rms_norm(c_kv, p["kv_norm"]).float()
    k_nope = torch.einsum("bsr,rhe->bshe", c_kv_n, p["w_uk"].float())
    v = torch.einsum("bsr,rhe->bshe", c_kv_n, p["w_uv"].float())
    k_rope = _k_rope(x, p, positions, rope_theta)
    k_rope_f = k_rope.float()

    def attend(q_nope_c, q_rope_c, q_off):
        """One query chunk against the full K/V (fp32 throughout)."""
        sq = q_nope_c.shape[1]
        scores = torch.einsum("bqhe,bkhe->bhqk", q_nope_c.float(), k_nope)
        scores = scores.add_(torch.einsum("bqhe,bke->bhqk", q_rope_c.float(), k_rope_f))
        scores = scores.mul_(dims.scale)
        mask = (torch.arange(sq, device=x.device)[:, None] + q_off) >= torch.arange(
            s, device=x.device)[None, :]
        scores = scores.masked_fill_(~mask, MASK_VALUE)
        probs = torch.softmax(scores, dim=-1)
        del scores
        return torch.einsum("bhqk,bkhe->bqhe", probs, v).to(x.dtype)

    if s > MLA_CHUNK_THRESHOLD:
        # query-chunked dataflow: peak scores memory (B, H, chunk, S)
        if s % MLA_Q_CHUNK != 0:
            raise ValueError(f"seq len {s} not divisible by q chunk {MLA_Q_CHUNK}")
        ctx = torch.cat([attend(q_nope[:, i:i + MLA_Q_CHUNK], q_rope[:, i:i + MLA_Q_CHUNK], i)
                         for i in range(0, s, MLA_Q_CHUNK)], dim=1)
    else:
        ctx = attend(q_nope, q_rope, 0)                    # (B,S,H,dv)
    h, dv, _ = p["w_o"].shape
    out = ctx.flatten(2) @ p["w_o"].reshape(h * dv, d).to(x.dtype)
    return out, {"c_kv": c_kv, "k_rope": k_rope}


def mla_decode(
    x: torch.Tensor,          # (B, 1, D)
    p: dict,
    dims: MLADims,
    cache: dict,              # c_kv (B, S, kv_lora), k_rope (B, S, d_rope)
    cache_len: torch.Tensor,  # (B,) current lengths (new token goes at this pos)
    rope_theta: float = 10000.0,
) -> tuple[torch.Tensor, dict]:
    b, _, d = x.shape
    s_max = cache["c_kv"].shape[1]
    positions = cache_len[:, None]                          # (B, 1)
    q_nope, q_rope = _queries(x, p, dims, positions, rope_theta)

    c_kv_new = x @ p["w_dkv"].to(x.dtype)
    k_rope_new = _k_rope(x, p, positions, rope_theta)

    # insert at cache_len by the reference's one-hot add
    oh = F.one_hot(cache_len.long(), s_max).to(cache["c_kv"].dtype)[..., None]   # (B, S, 1)
    c_kv = cache["c_kv"] + oh * c_kv_new
    k_rope = cache["k_rope"] + oh * k_rope_new

    # absorbed attention in latent space, fp32 throughout
    c_kv_n = rms_norm(c_kv, p["kv_norm"]).float()
    q_lat = torch.einsum("bshe,rhe->bshr", q_nope.float(), p["w_uk"].float())
    scores = (
        torch.einsum("bshr,bkr->bhsk", q_lat, c_kv_n)
        + torch.einsum("bshe,bke->bhsk", q_rope.float(), k_rope.float())
    ) * dims.scale
    valid = torch.arange(s_max, device=x.device)[None, :] <= cache_len[:, None]
    scores = torch.where(valid[:, None, None], scores, MASK_VALUE)
    probs = torch.softmax(scores, dim=-1)
    o_lat = torch.einsum("bhsk,bkr->bshr", probs, c_kv_n)
    ctx = torch.einsum("bshr,rhe->bshe", o_lat, p["w_uv"].float()).to(x.dtype)
    h, dv, _ = p["w_o"].shape
    out = ctx.flatten(2) @ p["w_o"].reshape(h * dv, d).to(x.dtype)
    return out, {"c_kv": c_kv, "k_rope": k_rope}
