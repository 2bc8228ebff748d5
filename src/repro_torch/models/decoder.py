"""Decoder-only LM (a port of ``repro.models.decoder``) for the dense, moe,
mla_moe and vlm families.

Per-layer parameters are stacked on a leading ``layers`` dim, as in the
reference, which scans a block over them.  Here each stacked leaf is
``torch.unbind`` once per call and the block runs in a Python loop: indexing
``p[l]`` inside the loop would make each index's backward allocate a full
``(L, ...)`` zero gradient.  The remat policy wraps the block.

Early-fusion VLM (chameleon) is this same class: its VQ image tokens are
ordinary vocabulary entries (the tokenizer frontend is a stub).

MoE layers (olmoe, deepseek-v2) route through ``moe.moe_forward`` with one
dispatch group (``MoEDims.groups`` is set only by the reference's dry-run
tool, ROADMAP item 6c); ``forward`` returns the mean of the layers' aux
losses.  MLA layers (deepseek-v2) attend through ``mla.mla_prefill`` and
decode against a latent cache ``{c_kv, k_rope}``.  Without a mesh the
reference's sharding constraints are identities; the port has none (6c).
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
from .mla import MLADims, mla_decode, mla_prefill
from .moe import MoEDims, moe_forward
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

    def _head(self, params: dict) -> torch.Tensor:
        return params["embed"].T if self.cfg.tie_embeddings else params["lm_head"]

    def _mla_dims(self) -> MLADims:
        m = self.cfg.mla
        return MLADims(n_heads=self.cfg.n_heads, q_lora=m.q_lora, kv_lora=m.kv_lora,
                       d_nope=m.d_nope, d_rope=m.d_rope, d_v=m.d_v)

    # ------------------------------------------------------------- blocks
    def _qkv(self, lp: dict, x, positions):
        c = self.cfg
        h = rms_norm(x, lp["attn_norm"])
        q = apply_rope(_proj_in(h, lp["wq"]), positions, c.rope_theta)
        k = apply_rope(_proj_in(h, lp["wk"]), positions, c.rope_theta)
        return q, k, _proj_in(h, lp["wv"])

    def _attn_block(self, lp: dict, x, positions):
        c = self.cfg
        if c.mla:
            out, _ = mla_prefill(rms_norm(x, lp["attn_norm"]), lp, self._mla_dims(),
                                 positions, c.rope_theta)
            return out
        q, k, v = self._qkv(lp, x, positions)
        return _proj_out(attention(q, k, v, causal=True), lp["wo"])

    def _mlp_block(self, lp: dict, x):
        """(out, aux): aux is the MoE load-balance loss, 0 for a dense MLP."""
        c = self.cfg
        h = rms_norm(x, lp["mlp_norm"])
        if c.moe:
            dims = MoEDims(
                n_experts=c.moe.n_experts,
                top_k=c.moe.top_k,
                d_model=c.d_model,
                d_ff=c.moe.d_ff_expert,
                n_shared=c.moe.n_shared,
                capacity_factor=c.moe.capacity_factor,
            )
            return moe_forward(h, lp, dims)
        return swiglu(h, lp["w_gate"], lp["w_up"], lp["w_down"]), torch.zeros((), device=x.device)

    # ------------------------------------------------------------- forward
    def forward(
        self, params: dict, tokens: torch.Tensor, remat: str = "none"
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """tokens (B, S) -> (logits (B, S, V) bf16, aux_loss fp32 scalar:
        the mean over layers)."""
        b, s = tokens.shape
        x = embed(tokens, params["embed"])
        positions = torch.arange(s, dtype=torch.int32, device=tokens.device).expand(b, s)
        names = sorted(params["layers"])

        def block(x, *leaves):
            lp = dict(zip(names, leaves, strict=True))
            x = x + self._attn_block(lp, x, positions)
            mlp_out, aux = self._mlp_block(lp, x)
            return x + mlp_out, aux

        block = _maybe_remat(block, remat)
        auxs = []
        for lp in _unstack(params["layers"]):
            x, aux = block(x, *(lp[n] for n in names))
            auxs.append(aux)
        x = rms_norm(x, params["final_norm"])
        return lm_logits(x, self._head(params)), torch.stack(auxs).mean()

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
        c = self.cfg
        L = c.n_layers
        if c.mla:
            m = c.mla
            return {
                "c_kv": torch.zeros((L, batch, max_len, m.kv_lora), dtype=COMPUTE_DTYPE,
                                    device=device),
                "k_rope": torch.zeros((L, batch, max_len, m.d_rope), dtype=COMPUTE_DTYPE,
                                      device=device),
            }
        shape = (L, batch, max_len, c.n_kv_heads, c.head_dim)
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
        c = self.cfg
        x = embed(tokens, params["embed"])
        positions = cache_len[:, None]
        names = sorted(cache)
        s_max = cache[names[0]].shape[2]
        # the slot is written by the reference's one-hot add, which equals an
        # indexed write only where the slot still holds zeros
        oh = F.one_hot(cache_len.long(), s_max)[:, :, None, None].to(COMPUTE_DTYPE)
        new = {n: [] for n in names}
        for lp, *cache_l in zip(_unstack(params["layers"]),
                                *(torch.unbind(cache[n]) for n in names), strict=True):
            cache_l = dict(zip(names, cache_l, strict=True))
            if c.mla:
                out, cache_l = mla_decode(rms_norm(x, lp["attn_norm"]), lp, self._mla_dims(),
                                          cache_l, cache_len, c.rope_theta)
            else:
                q, k, v = self._qkv(lp, x, positions)
                cache_l = {"k": cache_l["k"] + oh * k, "v": cache_l["v"] + oh * v}
                # single-token decode: the kv_len mask IS the causal mask
                out = _proj_out(attention(q, cache_l["k"], cache_l["v"], causal=False,
                                          kv_len=cache_len + 1), lp["wo"])
            x = x + out
            x = x + self._mlp_block(lp, x)[0]
            for n in names:
                new[n].append(cache_l[n])
        x = rms_norm(x, params["final_norm"])
        return lm_logits(x, self._head(params)), {n: torch.stack(v) for n, v in new.items()}

