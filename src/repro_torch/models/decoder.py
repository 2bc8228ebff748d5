"""Decoder-only LM (a port of ``repro.models.decoder``) for the dense, moe,
mla_moe and vlm families.

Per-layer parameters are stacked on a leading ``layers`` dim, as in the
reference, which scans a block over them.  Here each stacked leaf is
``torch.unbind`` once per call and the block runs in a Python loop: indexing
``p[l]`` inside the loop would make each index's backward allocate a full
``(L, ...)`` zero gradient.  The remat policy wraps the block.

Early-fusion VLM (chameleon) is this same class: its VQ image tokens are
ordinary vocabulary entries (the tokenizer frontend is a stub).

MoE layers (olmoe, deepseek-v2) route through ``moe.moe_forward`` in
``moe_groups`` dispatch groups (the dry run sets it to the data-parallel
shard count); ``forward`` returns the mean of the layers' aux losses.  MLA
layers (deepseek-v2) attend through ``mla.mla_prefill`` and decode against a
latent cache ``{c_kv, k_rope}``.

Sharded (DTensor params, ``repro_torch.sharding``): each block gathers its
layer's weights (``gather_layer_weights``), its attention and its MLP/MoE
run as local regions (``sharding.regions.block_region``: heads, ffn and
experts over ``model`` where they divide), and the residual stream is
constrained to batch/data + sequence/model after each block
(``constrain_residual``).  On plain tensors these hooks are identities.
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
from ..sharding.constrain import constrain_residual, gather_layer_weights, strip_layer_axis
from ..sharding.regions import is_dtensor, maybe_region, model_rank
from ..sharding.rules import PartitionSpec, ShardingRules, mesh_shape
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
from .param import P, param_axes

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


_MLA_KEYS = ("attn_norm", "w_dq", "q_norm", "w_uq", "w_dkv", "kv_norm", "w_uk", "w_uv",
             "w_kr", "w_o")
_ATTN_KEYS = ("attn_norm", "wq", "wk", "wv", "wo")
_MLP_KEYS = ("mlp_norm", "w_gate", "w_up", "w_down", "router", "gate", "up", "down",
             "shared_gate", "shared_up", "shared_down")


class DecoderLM:
    def __init__(self, cfg: ArchConfig, moe_groups: int = 1):
        self.cfg = cfg
        self.moe_groups = moe_groups
        self._layer_axes = None

    @property
    def layer_axes(self) -> dict:
        """Each layer leaf's logical axes, the ``layers`` dim stripped."""
        if self._layer_axes is None:
            self._layer_axes = strip_layer_axis(param_axes(self.spec()["layers"]))
        return self._layer_axes

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

    def _attn_split(self, x) -> tuple[str, dict]:
        """How a sharded attention block splits over ``model``, and the
        region's keywords: by query ``heads`` where they divide (K/V heads
        too where those divide, else every rank holds K/V whole and reads
        the heads its queries use), else by query ``rows`` where the
        sequence divides (K/V whole on every rank), else not at all."""
        m = mesh_shape(x.device_mesh).get("model", 1)
        c = self.cfg
        if c.n_heads % m == 0:
            return "heads", {"replicate": ("wk", "wv") if c.n_kv_heads % m else ()}
        if x.shape[1] > 1 and x.shape[1] % m == 0:
            return "rows", {"model_parallel": False, "split_over": ("model",)}
        return "replicated", {"model_parallel": False}

    def _attn_block(self, lp: dict, x, positions):
        if not is_dtensor(x):
            return self._attn_local(lp, x, positions)
        keys = _MLA_KEYS if self.cfg.mla else _ATTN_KEYS
        mesh = x.device_mesh
        rank, m = model_rank(mesh), mesh_shape(mesh).get("model", 1)
        split, kw = self._attn_split(x)
        if split == "rows":
            b_axes = ShardingRules().spec_for(("batch",), (x.shape[0],), mesh)[0]
            return maybe_region(lambda h, pos, w: self._attn_rows(w, h, pos, rank, m),
                                (x, positions), lp, self.layer_axes, keys,
                                out_axes=(PartitionSpec(b_axes, "model"),), **kw)
        return maybe_region(lambda h, pos, w: self._attn_local(w, h, pos, rank),
                            (x, positions), lp, self.layer_axes, keys, **kw)

    def _attn_local(self, lp: dict, x, positions, rank: int = 0):
        c = self.cfg
        if c.mla:
            out, _ = mla_prefill(rms_norm(x, lp["attn_norm"]), lp, self._mla_dims(),
                                 positions, c.rope_theta)
            return out
        q, k, v = self._qkv(lp, x, positions)
        return _proj_out(attention(q, *self._kv_read(q, k, v, rank), causal=True), lp["wo"])

    def _kv_read(self, q, k, v, rank: int):
        """Where the query heads are split over ``model`` and K/V are whole
        (``kv_heads`` that do not divide it; MQA), the K/V head each of this
        rank's query heads reads, one per query head; else K/V as they are."""
        h_local = q.shape[2]
        if h_local == self.cfg.n_heads or k.shape[2] < self.cfg.n_kv_heads:
            return k, v
        group = self.cfg.n_heads // self.cfg.n_kv_heads
        idx = torch.arange(rank * h_local, (rank + 1) * h_local, device=k.device) // group
        return k.index_select(2, idx), v.index_select(2, idx)

    def _attn_rows(self, lp: dict, x, positions, rank: int, m: int):
        """This rank's 1/m of the query rows against every key (the heads do
        not divide ``model``): (B, S/m, D), causal from the rows' offset."""
        c = self.cfg
        n = x.shape[1] // m
        rows = slice(rank * n, (rank + 1) * n)
        h = rms_norm(x, lp["attn_norm"])
        q = apply_rope(_proj_in(h[:, rows], lp["wq"]), positions[:, rows], c.rope_theta)
        k = apply_rope(_proj_in(h, lp["wk"]), positions, c.rope_theta)
        o = attention(q, k, _proj_in(h, lp["wv"]), causal=True, q_offset=rank * n)
        return _proj_out(o, lp["wo"])

    def _moe_dims(self, groups: int) -> MoEDims:
        c = self.cfg
        return MoEDims(
            n_experts=c.moe.n_experts,
            top_k=c.moe.top_k,
            d_model=c.d_model,
            d_ff=c.moe.d_ff_expert,
            n_shared=c.moe.n_shared,
            capacity_factor=c.moe.capacity_factor,
            groups=groups,
        )

    def _mlp_block(self, lp: dict, x):
        """(out, aux): aux is the MoE load-balance loss, 0 for a dense MLP."""
        if self.cfg.moe:
            return self._moe_block(lp, x)
        out = maybe_region(lambda h, w: swiglu(rms_norm(h, w["mlp_norm"]), w["w_gate"],
                                               w["w_up"], w["w_down"]),
                           (x,), lp, self.layer_axes, _MLP_KEYS)
        return out, torch.zeros((), device=x.device)

    def _moe_block(self, lp: dict, x):
        """Sharded, a local region: each data shard dispatches its own groups
        (``moe_groups`` over the batch's shards) and each ``model`` rank runs
        the experts it holds.  The aux loss (a mean over groups) comes from
        the full routing, which every ``model`` rank computes: each data
        shard carries its share of the mean on ``model`` rank 0, the others
        add zero."""
        b_global, e = x.shape[0], self.cfg.moe.n_experts

        def block(h, w):
            groups = self.moe_groups * h.shape[0] // b_global
            if groups * b_global != self.moe_groups * h.shape[0]:
                raise ValueError(f"moe_groups={self.moe_groups} does not divide over the "
                                 f"batch's {b_global // h.shape[0]} shards")
            e_local = w["gate"].shape[0]
            lo = model_rank(x.device_mesh) * e_local if e_local < e else 0
            out, aux = moe_forward(rms_norm(h, w["mlp_norm"]), w, self._moe_dims(groups),
                                   expert_range=(lo, lo + e_local))
            if h.shape[0] < b_global:
                aux = aux * (h.shape[0] / b_global)
            return out, (aux if lo == 0 else aux * 0)

        return maybe_region(block, (x,), lp, self.layer_axes, _MLP_KEYS,
                            out_axes=(None, "sum"), replicate=("router",))

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
            lp = gather_layer_weights(dict(zip(names, leaves, strict=True)), self.layer_axes)
            x = x + self._attn_block(lp, x, positions)
            mlp_out, aux = self._mlp_block(lp, x)
            return constrain_residual(x + mlp_out), aux

        block = _maybe_remat(block, remat)
        auxs = []
        for lp in _unstack(params["layers"]):
            x, aux = block(x, *(lp[n] for n in names))
            auxs.append(aux)
        logits = lm_logits(x, self._head(params), norm=(params["final_norm"],))
        return logits, torch.stack(auxs).mean()

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
        x = embed(tokens, params["embed"])
        names = sorted(cache)
        axes = self.cache_axes()
        keys = _MLA_KEYS if self.cfg.mla else _ATTN_KEYS

        rank = model_rank(x.device_mesh) if is_dtensor(x) else 0

        def attend(x, cache_len, *rest):
            *cache_l, lp = rest
            out, cache_l = self._decode_attn(lp, x, cache_len, dict(zip(names, cache_l,
                                                                        strict=True)), rank)
            return (out, *(cache_l[n] for n in names))

        kw = self._attn_split(x)[1] if is_dtensor(x) else {}
        new = {n: [] for n in names}
        for lp, *cache_l in zip(_unstack(params["layers"]),
                                *(torch.unbind(cache[n]) for n in names), strict=True):
            out, *cache_l = maybe_region(
                attend, (x, cache_len, *cache_l), lp, self.layer_axes, keys,
                act_axes=(None, None, *(axes[n][1:] for n in names)),
                out_axes=(None, *range(2, 2 + len(names))), **kw)
            x = x + out
            x = x + self._mlp_block(lp, x)[0]
            for n, t in zip(names, cache_l, strict=True):
                new[n].append(t)
        logits = lm_logits(x, self._head(params), norm=(params["final_norm"],))
        return logits, {n: torch.stack(v) for n, v in new.items()}

    def _decode_attn(self, lp: dict, x, cache_len, cache_l: dict, rank: int = 0):
        """One layer's attention against its cache: (out, new cache)."""
        c = self.cfg
        if c.mla:
            return mla_decode(rms_norm(x, lp["attn_norm"]), lp, self._mla_dims(), cache_l,
                              cache_len, c.rope_theta)
        # the slot is written by the reference's one-hot add, which equals an
        # indexed write only where the slot still holds zeros
        oh = F.one_hot(cache_len.long(), cache_l["k"].shape[1])[:, :, None, None]
        oh = oh.to(COMPUTE_DTYPE)
        q, k, v = self._qkv(lp, x, cache_len[:, None])
        cache_l = {"k": cache_l["k"] + oh * k, "v": cache_l["v"] + oh * v}
        # single-token decode: the kv_len mask IS the causal mask
        k, v = self._kv_read(q, cache_l["k"], cache_l["v"], rank)
        out = _proj_out(attention(q, k, v, causal=False, kv_len=cache_len + 1), lp["wo"])
        return out, cache_l
