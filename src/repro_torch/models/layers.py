"""Core transformer layers (a port of ``repro.models.layers``): norms, RoPE,
GQA attention (dense + query-chunked for long prefill), SwiGLU/GELU MLPs,
embeddings.

All functions are pure: (params, inputs) -> outputs, with the reference's
precision: the residual stream is ``COMPUTE_DTYPE`` (bf16) from the
embedding on; each weight is cast to the activation dtype at its product;
norms and softmax run in fp32 and cast back.

Weight products are ``x @ w`` on a 2-D weight, which lowers to ``aten.mm``;
the attention products are ``torch.einsum``, which lowers to ``aten.bmm``.
The ``dots`` remat policy (``decoder.py``) saves the one and recomputes the
other, as JAX's ``checkpoint_dots_with_no_batch_dims`` does.
"""

from __future__ import annotations

import math

import torch

from ..sharding.regions import maybe_region, model_rank

COMPUTE_DTYPE = torch.bfloat16

#: the reference's mask value: a fully masked row (``kv_len`` 0) softmaxes
#: to uniform, where ``-inf`` would give NaN
MASK_VALUE = -1e30

# ---------------------------------------------------------------- norms


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * scale.float()).to(x.dtype)


def layer_norm(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5
) -> torch.Tensor:
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * scale.float() + bias.float()).to(x.dtype)


# ---------------------------------------------------------------- rope


def rope_freqs(head_dim: int, theta: float = 10000.0, device=None) -> torch.Tensor:
    return 1.0 / (
        theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim)
    )


def apply_rope(
    x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0
) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S) integers.  Rotates the two halves
    of the last dim (not interleaved pairs), as the reference does."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)             # (D/2,)
    angles = positions[..., None].float() * freqs                # (B, S, D/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------- attention


def _dense_attn(
    q: torch.Tensor,      # (B, Sq, H, D)
    k: torch.Tensor,      # (B, Sk, Hkv, D)
    v: torch.Tensor,      # (B, Sk, Hkv, D)
    *,
    causal: bool,
    q_offset: torch.Tensor | int = 0,
    kv_len: torch.Tensor | None = None,
) -> torch.Tensor:
    """Reference attention with GQA head grouping; scores in fp32."""
    b, sq, h, d = q.shape
    hkv = k.shape[2]
    group = h // hkv
    qg = q.reshape(b, sq, hkv, group, d)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k).float()
    scores = scores * (1.0 / math.sqrt(d))
    sk = k.shape[1]
    if causal:
        qpos = torch.arange(sq, device=q.device)[:, None] + q_offset
        kpos = torch.arange(sk, device=q.device)[None, :]
        mask = qpos >= kpos
        scores = torch.where(mask[None, None, None], scores, MASK_VALUE)
    if kv_len is not None:
        valid = torch.arange(sk, device=q.device)[None, :] < kv_len[:, None]   # (B, Sk)
        scores = torch.where(valid[:, None, None, None], scores, MASK_VALUE)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v)
    return out.reshape(b, sq, h, d)


def _chunked_attn(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool, q_chunk: int
) -> torch.Tensor:
    """Query-chunked attention: peak score memory is (B, H, q_chunk, Sk)
    instead of (B, H, Sq, Sk).  Used for long prefill (Sq > LONG_SEQ_THRESHOLD)."""
    sq = q.shape[1]
    if sq % q_chunk != 0:
        raise ValueError(f"seq len {sq} not divisible by q_chunk {q_chunk}")
    return torch.cat([
        _dense_attn(q[:, i:i + q_chunk], k, v, causal=causal, q_offset=i)
        for i in range(0, sq, q_chunk)
    ], dim=1)


LONG_SEQ_THRESHOLD = 8192
ATTN_Q_CHUNK = 2048


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    q_offset: torch.Tensor | int = 0,
    kv_len: torch.Tensor | None = None,
) -> torch.Tensor:
    """GQA attention; switches to query-chunked dataflow for long prefill."""
    sq, sk = q.shape[1], k.shape[1]
    if sq > LONG_SEQ_THRESHOLD and sq == sk and kv_len is None:
        return _chunked_attn(q, k, v, causal=causal, q_chunk=ATTN_Q_CHUNK)
    return _dense_attn(q, k, v, causal=causal, q_offset=q_offset, kv_len=kv_len)


# ---------------------------------------------------------------- mlps
# ``jax.nn.silu`` / ``jax.nn.gelu`` written out: each step rounds to the
# input dtype, as JAX's do (``F.silu`` / ``F.gelu`` round once, from fp32)


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * (1.0 / (1.0 + torch.exp(-x)))


def gelu(x: torch.Tensor) -> torch.Tensor:
    """The tanh approximation, ``jax.nn.gelu``'s default."""
    cdf = 0.5 * (1.0 + torch.tanh(math.sqrt(2 / math.pi) * (x + 0.044715 * x ** 3)))
    return x * cdf


def swiglu(x: torch.Tensor, w_gate, w_up, w_down) -> torch.Tensor:
    g = x @ w_gate.to(x.dtype)
    u = x @ w_up.to(x.dtype)
    return (silu(g) * u) @ w_down.to(x.dtype)


def gelu_mlp(x: torch.Tensor, w_up, b_up, w_down, b_down) -> torch.Tensor:
    h = x @ w_up.to(x.dtype) + b_up.to(x.dtype)
    return gelu(h) @ w_down.to(x.dtype) + b_down.to(x.dtype)


# ---------------------------------------------------------------- embed / head


def embed(tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Sharded, a vocab-parallel lookup: each ``model`` rank reads the rows
    it holds and zeros for the rest (a sum over ``model``; replicated where
    the vocab does not divide)."""
    vocab = table.shape[0]

    def lookup(tok, w):
        t = w["table"]
        if t.shape[0] == vocab:
            return t[tok].to(COMPUTE_DTYPE)
        idx = tok - model_rank(table.device_mesh) * t.shape[0]
        hit = (idx >= 0) & (idx < t.shape[0])
        return (t[idx.clamp(0, t.shape[0] - 1)] * hit[..., None]).to(COMPUTE_DTYPE)

    return maybe_region(lookup, (tokens,), {"table": table}, {"table": ("vocab", "embed")})


_HEAD_AXES = {"head": ("embed", "vocab"), "scale": ("embed",), "bias": ("embed",)}


def lm_logits(x: torch.Tensor, head: torch.Tensor, norm: tuple = ()) -> torch.Tensor:
    """``x @ head``, after the final norm when ``norm`` holds its weights:
    ``(scale,)`` an RMS norm, ``(scale, bias)`` a layer norm.  Sharded, the
    norm and a vocab-parallel head are one region: logits (B, S, V) sharded
    over ``model`` on V."""
    b, s, _ = x.shape
    return maybe_region(lambda h, w: _norm_head(h, w["head"], w.get("scale"), w.get("bias")),
                        (x,), {"head": head, **dict(zip(("scale", "bias"), norm))}, _HEAD_AXES,
                        out_axes=((("batch", None, "vocab"), (b, s, head.shape[1])),))


def _norm_head(x, head, scale=None, bias=None):
    if scale is not None:
        x = rms_norm(x, scale) if bias is None else layer_norm(x, scale, bias)
    return x @ head.to(x.dtype)
