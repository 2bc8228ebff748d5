"""Hybrid Mamba2 + shared-attention LM (zamba2-1.2b, arXiv:2411.15242; a
port of ``repro.models.hybrid``).

Layer pattern: runs of ``shared_attn_every`` Mamba2 blocks, punctuated by a
single *weight-shared* GQA attention block (one transformer block's weights
reused at every insertion point; each insertion keeps its own KV cache, and
the shared weights get one gradient summed over all insertions).  38 = 6 x 6
+ 2 for zamba2-1.2b: six (6-mamba + shared-attn) groups, then a 2-mamba tail.

Simplification vs the released checkpoints (the reference's): Zamba2
concatenates the original embedding into the shared block input and adds
per-invocation LoRA deltas; the shared block here runs on the hidden state
directly.  The remat policy wraps the Mamba blocks, as the reference's does.

Sharded (DTensor params), the Mamba blocks are ``ssm.mamba_block``'s
regions and the shared block runs as one local region replicated over
``model`` (its residual adds sit inside it), batch-sharded over the data
axes.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from ..sharding.regions import maybe_region
from .decoder import _maybe_remat, _proj_in, _proj_out, _unstack
from .layers import COMPUTE_DTYPE, apply_rope, attention, embed, lm_logits, rms_norm, swiglu
from .param import P, param_axes
from .ssm import mamba_block, mamba_cache, mamba_decode_block, mamba_layer_spec, ssm_dims


class HybridLM:
    def __init__(self, cfg: ArchConfig, moe_groups: int = 1):
        if cfg.shared_attn_every <= 0:
            raise ValueError("shared_attn_every must be > 0")
        self.cfg = cfg
        self.dims = ssm_dims(cfg)
        self.n_groups = cfg.n_layers // cfg.shared_attn_every
        self.tail = cfg.n_layers - self.n_groups * cfg.shared_attn_every

    # ------------------------------------------------------------- spec
    def spec(self) -> dict:
        c = self.cfg
        hd = c.head_dim
        shared = {
            "attn_norm": P((c.d_model,), ("embed",), init="ones"),
            "wq": P((c.d_model, c.n_heads, hd), ("embed", "heads", "head_dim"),
                    init="scaled"),
            "wk": P((c.d_model, c.n_kv_heads, hd), ("embed", "kv_heads", "head_dim"),
                    init="scaled"),
            "wv": P((c.d_model, c.n_kv_heads, hd), ("embed", "kv_heads", "head_dim"),
                    init="scaled"),
            "wo": P((c.n_heads, hd, c.d_model), ("heads", "head_dim", "embed"),
                    init="scaled"),
            "mlp_norm": P((c.d_model,), ("embed",), init="ones"),
            "w_gate": P((c.d_model, c.d_ff), ("embed", "ffn"), init="scaled"),
            "w_up": P((c.d_model, c.d_ff), ("embed", "ffn"), init="scaled"),
            "w_down": P((c.d_ff, c.d_model), ("ffn", "embed"), init="scaled"),
        }
        return {
            "embed": P((c.vocab, c.d_model), ("vocab", "embed")),
            "mamba": mamba_layer_spec(c.n_layers, self.dims),
            "shared_attn": shared,
            "final_norm": P((c.d_model,), ("embed",), init="ones"),
            "lm_head": P((c.d_model, c.vocab), ("embed", "vocab")),
        }

    # ------------------------------------------------------------- helpers
    def _attends_after(self, i: int) -> bool:
        """Whether the shared block follows Mamba layer ``i`` (not in the tail)."""
        every = self.cfg.shared_attn_every
        return (i + 1) % every == 0 and (i + 1) // every <= self.n_groups

    def _shared_attn_block(self, sp, x, positions, cache=None, cache_len=None):
        axes = param_axes(self.spec()["shared_attn"])
        if cache is None:
            return maybe_region(lambda h, pos, w: self._shared_attn_local(w, h, pos)[0],
                                (x, positions), sp, axes, model_parallel=False), None
        kv = ("batch", "kv_seq", "kv_heads", "kv_head_dim")

        def step(h, pos, k, v, cl, w):
            h, new = self._shared_attn_local(w, h, pos, {"k": k, "v": v}, cl)
            return h, new["k"], new["v"]

        x, k, v = maybe_region(step, (x, positions, cache["k"], cache["v"], cache_len), sp, axes,
                               act_axes=(None, None, kv, kv, None), out_axes=(None, 2, 3),
                               model_parallel=False)
        return x, {"k": k, "v": v}

    def _shared_attn_local(self, sp, x, positions, cache=None, cache_len=None):
        c = self.cfg
        h = rms_norm(x, sp["attn_norm"])
        q = apply_rope(_proj_in(h, sp["wq"]), positions, c.rope_theta)
        k = apply_rope(_proj_in(h, sp["wk"]), positions, c.rope_theta)
        v = _proj_in(h, sp["wv"])
        if cache is None:
            o = attention(q, k, v, causal=True)
            new_cache = None
        else:
            s_max = cache["k"].shape[1]
            oh = F.one_hot(cache_len.long(), s_max)[:, :, None, None].to(k.dtype)
            k_all = cache["k"] + oh * k
            v_all = cache["v"] + oh * v
            o = attention(q, k_all, v_all, causal=False, kv_len=cache_len + 1)
            new_cache = {"k": k_all, "v": v_all}
        x = x + _proj_out(o, sp["wo"])
        m = rms_norm(x, sp["mlp_norm"])
        x = x + swiglu(m, sp["w_gate"], sp["w_up"], sp["w_down"])
        return x, new_cache

    # ------------------------------------------------------------- forward
    def forward(self, params, tokens, remat: str = "none"):
        b, s = tokens.shape
        x = embed(tokens, params["embed"])
        positions = torch.arange(s, dtype=torch.int32, device=tokens.device).expand(b, s)
        sp = params["shared_attn"]
        names = sorted(params["mamba"])
        block = _maybe_remat(mamba_block(self.dims, names), remat)
        for i, lp in enumerate(_unstack(params["mamba"])):
            x = block(x, *(lp[n] for n in names))
            if self._attends_after(i):
                x, _ = self._shared_attn_block(sp, x, positions)
        logits = lm_logits(x, params["lm_head"], norm=(params["final_norm"],))
        return logits, torch.zeros((), device=x.device)

    # ------------------------------------------------------------- decode
    def cache_axes(self) -> dict:
        return {
            "conv": ("layers", "batch", None, "ssm_inner"),
            "ssm": ("layers", "batch", "heads", None, None),
            "attn_k": (None, "batch", "kv_seq", "kv_heads", "kv_head_dim"),
            "attn_v": (None, "batch", "kv_seq", "kv_heads", "kv_head_dim"),
        }

    def init_cache(self, batch: int, max_len: int, device="cuda"):
        c = self.cfg
        shape = (self.n_groups, batch, max_len, c.n_kv_heads, c.head_dim)
        return {
            **mamba_cache(self.dims, c.n_layers, batch, device),
            "attn_k": torch.zeros(shape, dtype=COMPUTE_DTYPE, device=device),
            "attn_v": torch.zeros(shape, dtype=COMPUTE_DTYPE, device=device),
        }

    def decode_step(self, params, cache, cache_len, tokens):
        x = embed(tokens, params["embed"])
        positions = cache_len[:, None]
        sp = params["shared_attn"]
        attn = zip(torch.unbind(cache["attn_k"]), torch.unbind(cache["attn_v"]), strict=True)
        new = {n: [] for n in cache}
        for i, (lp, conv, ssm) in enumerate(zip(
                _unstack(params["mamba"]), torch.unbind(cache["conv"]),
                torch.unbind(cache["ssm"]), strict=True)):
            x, m = mamba_decode_block(self.dims, lp, x, {"conv": conv, "ssm": ssm})
            new["conv"].append(m["conv"])
            new["ssm"].append(m["ssm"])
            if self._attends_after(i):
                k, v = next(attn)
                x, a = self._shared_attn_block(sp, x, positions, cache={"k": k, "v": v},
                                               cache_len=cache_len)
                new["attn_k"].append(a["k"])
                new["attn_v"].append(a["v"])
        logits = lm_logits(x, params["lm_head"], norm=(params["final_norm"],))
        # a config with no insertion (fewer layers than the cadence) keeps
        # its empty attention caches
        return logits, {n: torch.stack(v) if v else cache[n] for n, v in new.items()}
