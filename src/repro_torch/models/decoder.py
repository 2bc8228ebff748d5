"""Decoder-only LM (a port of ``repro.models.decoder``) for the dense and
vlm families.

Per-layer parameters are stacked on a leading ``layers`` dim, as in the
reference, which scans a block over them.  Here each stacked leaf is
``torch.unbind`` once per call and the block runs in a Python loop: indexing
``p[l]`` inside the loop would make each index's backward allocate a full
``(L, ...)`` zero gradient.  The remat policy wraps the block.

Early-fusion VLM (chameleon) is this same class: its VQ image tokens are
ordinary vocabulary entries (the tokenizer frontend is a stub).

``spec()`` also describes the MoE and MLA leaves (olmoe, deepseek-v2), so a
full-size spec of those families can be counted; ``forward`` and
``decode_step`` on them raise ``NotImplementedError`` (ROADMAP item 6b).
Without a mesh the reference's sharding constraints are identities; the
port has none until 6b.
"""

from __future__ import annotations

from functools import partial

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from ..configs.base import ArchConfig
from .layers import (
    COMPUTE_DTYPE,
    apply_rope,
    attention,
    embed,
    lm_logits,
    rms_norm,
    swiglu,
)
from .param import P

#: the weight products (``x @ w``): what ``dots`` keeps, as JAX's
#: ``checkpoint_dots_with_no_batch_dims`` keeps dots without batch dims
_SAVED_BY_DOTS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.addmm.default})


def _dots_policy(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _SAVED_BY_DOTS else CheckpointPolicy.PREFER_RECOMPUTE


REMAT_POLICIES = ("none", "dots", "full")


def _maybe_remat(fn, remat: str):
    if remat not in REMAT_POLICIES:
        raise ValueError(f"unknown remat {remat!r}; have {REMAT_POLICIES}")
    if remat == "none":
        return fn
    kw = {}
    if remat == "dots":
        kw["context_fn"] = partial(create_selective_checkpoint_contexts, _dots_policy)
    return lambda *args: checkpoint(fn, *args, use_reentrant=False, **kw)


def _unstack(layers: dict) -> list[dict]:
    """The stacked ``(L, ...)`` leaves as L per-layer dicts (one unbind each)."""
    names = sorted(layers)
    return [dict(zip(names, ts, strict=True))
            for ts in zip(*(torch.unbind(layers[n]) for n in names), strict=True)]


def _proj_in(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bsd,dhe->bshe", h, w)`` as one ``mm``."""
    d, nh, e = w.shape
    return (h @ w.reshape(d, nh * e).to(h.dtype)).unflatten(-1, (nh, e))


def _proj_out(o: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bshe,hed->bsd", o, w)`` as one ``mm``."""
    nh, e, d = w.shape
    return o.flatten(2) @ w.reshape(nh * e, d).to(o.dtype)


class DecoderLM:
    def __init__(self, cfg: ArchConfig):
        self.cfg = cfg

    # ------------------------------------------------------------- spec
    def spec(self) -> dict:
        c = self.cfg
        L, D, V = c.n_layers, c.d_model, c.vocab
        hd = c.head_dim
        layers: dict = {
            "attn_norm": P((L, D), ("layers", "embed"), init="ones"),
            "mlp_norm": P((L, D), ("layers", "embed"), init="ones"),
        }
        if c.mla:
            m = c.mla
            H = c.n_heads
            layers.update(
                w_dq=P((L, D, m.q_lora), ("layers", "embed", "q_lora"), init="scaled"),
                q_norm=P((L, m.q_lora), ("layers", "q_lora"), init="ones"),
                w_uq=P((L, m.q_lora, H, m.d_nope + m.d_rope),
                       ("layers", "q_lora", "heads", "head_dim"), init="scaled"),
                w_dkv=P((L, D, m.kv_lora), ("layers", "embed", "kv_lora"), init="scaled"),
                kv_norm=P((L, m.kv_lora), ("layers", "kv_lora"), init="ones"),
                w_uk=P((L, m.kv_lora, H, m.d_nope),
                       ("layers", "kv_lora", "heads", "head_dim"), init="scaled"),
                w_uv=P((L, m.kv_lora, H, m.d_v),
                       ("layers", "kv_lora", "heads", "head_dim"), init="scaled"),
                w_kr=P((L, D, m.d_rope), ("layers", "embed", "rope_dim"), init="scaled"),
                w_o=P((L, H, m.d_v, D), ("layers", "heads", "head_dim", "embed"),
                      init="scaled"),
            )
        else:
            H, Hkv = c.n_heads, c.n_kv_heads
            layers.update(
                wq=P((L, D, H, hd), ("layers", "embed", "heads", "head_dim"),
                     init="scaled"),
                wk=P((L, D, Hkv, hd), ("layers", "embed", "kv_heads", "head_dim"),
                     init="scaled"),
                wv=P((L, D, Hkv, hd), ("layers", "embed", "kv_heads", "head_dim"),
                     init="scaled"),
                wo=P((L, H, hd, D), ("layers", "heads", "head_dim", "embed"),
                     init="scaled"),
            )
        if c.moe:
            e, f = c.moe.n_experts, c.moe.d_ff_expert
            layers.update(
                router=P((L, D, e), ("layers", "embed", "experts"), init="scaled"),
                gate=P((L, e, D, f), ("layers", "experts", "embed", "ffn"),
                       init="scaled"),
                up=P((L, e, D, f), ("layers", "experts", "embed", "ffn"),
                     init="scaled"),
                down=P((L, e, f, D), ("layers", "experts", "ffn", "embed"),
                       init="scaled"),
            )
            if c.moe.n_shared:
                sf = c.moe.n_shared * f
                layers.update(
                    shared_gate=P((L, D, sf), ("layers", "embed", "ffn"), init="scaled"),
                    shared_up=P((L, D, sf), ("layers", "embed", "ffn"), init="scaled"),
                    shared_down=P((L, sf, D), ("layers", "ffn", "embed"), init="scaled"),
                )
        else:
            F_ = c.d_ff
            layers.update(
                w_gate=P((L, D, F_), ("layers", "embed", "ffn"), init="scaled"),
                w_up=P((L, D, F_), ("layers", "embed", "ffn"), init="scaled"),
                w_down=P((L, F_, D), ("layers", "ffn", "embed"), init="scaled"),
            )
        spec = {
            "embed": P((V, D), ("vocab", "embed")),
            "layers": layers,
            "final_norm": P((D,), ("embed",), init="ones"),
        }
        if not c.tie_embeddings:
            spec["lm_head"] = P((D, V), ("embed", "vocab"))
        return spec

    def _require_dense(self) -> None:
        if self.cfg.moe or self.cfg.mla:
            raise NotImplementedError(
                f"{self.cfg.name}: MoE and MLA blocks are not ported yet (ROADMAP item 6b)")

    def _head(self, params: dict) -> torch.Tensor:
        return params["embed"].T if self.cfg.tie_embeddings else params["lm_head"]

    # ------------------------------------------------------------- blocks
    def _qkv(self, lp: dict, x, positions):
        c = self.cfg
        h = rms_norm(x, lp["attn_norm"])
        q = apply_rope(_proj_in(h, lp["wq"]), positions, c.rope_theta)
        k = apply_rope(_proj_in(h, lp["wk"]), positions, c.rope_theta)
        return q, k, _proj_in(h, lp["wv"])

    def _mlp_block(self, lp: dict, x):
        h = rms_norm(x, lp["mlp_norm"])
        return swiglu(h, lp["w_gate"], lp["w_up"], lp["w_down"])

    # ------------------------------------------------------------- forward
    def forward(
        self, params: dict, tokens: torch.Tensor, remat: str = "none"
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """tokens (B, S) -> (logits (B, S, V) bf16, aux_loss fp32 scalar)."""
        self._require_dense()
        b, s = tokens.shape
        x = embed(tokens, params["embed"])
        positions = torch.arange(s, dtype=torch.int32, device=tokens.device).expand(b, s)
        names = sorted(params["layers"])

        def block(x, *leaves):
            lp = dict(zip(names, leaves, strict=True))
            q, k, v = self._qkv(lp, x, positions)
            x = x + _proj_out(attention(q, k, v, causal=True), lp["wo"])
            return x + self._mlp_block(lp, x)

        block = _maybe_remat(block, remat)
        for lp in _unstack(params["layers"]):
            x = block(x, *(lp[n] for n in names))
        x = rms_norm(x, params["final_norm"])
        return lm_logits(x, self._head(params)), torch.zeros((), device=x.device)

    # ------------------------------------------------------------- decode
    def cache_axes(self) -> dict:
        if self.cfg.mla:
            return {
                "c_kv": ("layers", "batch", "kv_seq", "kv_lora_cache"),
                "k_rope": ("layers", "batch", "kv_seq", "rope_cache"),
            }
        return {
            "k": ("layers", "batch", "kv_seq", "kv_heads", "kv_head_dim"),
            "v": ("layers", "batch", "kv_seq", "kv_heads", "kv_head_dim"),
        }

    def init_cache(self, batch: int, max_len: int, device="cuda") -> dict:
        self._require_dense()
        c = self.cfg
        shape = (c.n_layers, batch, max_len, c.n_kv_heads, c.head_dim)
        return {"k": torch.zeros(shape, dtype=COMPUTE_DTYPE, device=device),
                "v": torch.zeros(shape, dtype=COMPUTE_DTYPE, device=device)}

    def decode_step(
        self,
        params: dict,
        cache: dict,
        cache_len: torch.Tensor,     # (B,)
        tokens: torch.Tensor,        # (B, 1)
    ):
        """One decode step; returns (logits (B, 1, V), new_cache)."""
        self._require_dense()
        x = embed(tokens, params["embed"])
        positions = cache_len[:, None]
        s_max = cache["k"].shape[2]
        # the slot is written by the reference's one-hot add, which equals an
        # indexed write only where the slot still holds zeros
        oh = F.one_hot(cache_len.long(), s_max)[:, :, None, None].to(COMPUTE_DTYPE)
        ks, vs = [], []
        for lp, k_l, v_l in zip(_unstack(params["layers"]), torch.unbind(cache["k"]),
                                torch.unbind(cache["v"]), strict=True):
            q, k, v = self._qkv(lp, x, positions)
            k_all = k_l + oh * k
            v_all = v_l + oh * v
            # single-token decode: the kv_len mask IS the causal mask
            o = attention(q, k_all, v_all, causal=False, kv_len=cache_len + 1)
            x = x + _proj_out(o, lp["wo"])
            x = x + self._mlp_block(lp, x)
            ks.append(k_all)
            vs.append(v_all)
        x = rms_norm(x, params["final_norm"])
        return lm_logits(x, self._head(params)), {"k": torch.stack(ks), "v": torch.stack(vs)}
