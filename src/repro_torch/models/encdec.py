"""Encoder-decoder transformer backbone (whisper-medium, arXiv:2212.04356; a
port of ``repro.models.encdec``).

The audio conv frontend is a stub, as in the reference: ``src_embeds``
feeds precomputed frame embeddings (B, S_frames, D) straight into the
encoder (learned positional embeddings added).  The decoder is a causal
transformer with cross-attention; LayerNorm + GELU MLPs + biases, logits
tied to the decoder token embedding — whisper conventions.

Serve path: the encoder output is projected ONCE into per-layer cross K/V at
cache init (cross-attention K/V never change during decode), then each
decode step runs self-attention against its growing cache plus frozen
cross-attention reads.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from .decoder import _maybe_remat, _proj_in, _proj_out, _unstack
from .layers import COMPUTE_DTYPE, attention, gelu_mlp, layer_norm, lm_logits
from .param import P


def _attn_proj_spec(L: int, D: int, H: int, hd: int, prefix: str) -> dict:
    return {
        f"{prefix}wq": P((L, D, H, hd), ("layers", "embed", "heads", "head_dim"),
                         init="scaled"),
        f"{prefix}wk": P((L, D, H, hd), ("layers", "embed", "kv_heads", "head_dim"),
                         init="scaled"),
        f"{prefix}wv": P((L, D, H, hd), ("layers", "embed", "kv_heads", "head_dim"),
                         init="scaled"),
        f"{prefix}wo": P((L, H, hd, D), ("layers", "heads", "head_dim", "embed"),
                         init="scaled"),
        f"{prefix}bq": P((L, H, hd), ("layers", "heads", "head_dim"), init="zeros"),
        f"{prefix}bv": P((L, H, hd), ("layers", "heads", "head_dim"), init="zeros"),
        f"{prefix}bo": P((L, D), ("layers", "embed"), init="zeros"),
    }


def _ln_spec(L: int, D: int, name: str) -> dict:
    return {
        f"{name}_scale": P((L, D), ("layers", "embed"), init="ones"),
        f"{name}_bias": P((L, D), ("layers", "embed"), init="zeros"),
    }


def _mlp_spec(L: int, D: int, F_: int) -> dict:
    return {
        "w_up": P((L, D, F_), ("layers", "embed", "ffn"), init="scaled"),
        "b_up": P((L, F_), ("layers", "ffn"), init="zeros"),
        "w_down": P((L, F_, D), ("layers", "ffn", "embed"), init="scaled"),
        "b_down": P((L, D), ("layers", "embed"), init="zeros"),
    }


def _q(lp, prefix, x):
    return _proj_in(x, lp[f"{prefix}wq"]) + lp[f"{prefix}bq"].to(x.dtype)


def _kv(lp, prefix, x):
    k = _proj_in(x, lp[f"{prefix}wk"])
    v = _proj_in(x, lp[f"{prefix}wv"]) + lp[f"{prefix}bv"].to(x.dtype)
    return k, v


def _out(lp, prefix, o):
    return _proj_out(o, lp[f"{prefix}wo"]) + lp[f"{prefix}bo"].to(o.dtype)


def _mlp(lp, x):
    return gelu_mlp(x, lp["w_up"], lp["b_up"], lp["w_down"], lp["b_down"])


class EncDecLM:
    def __init__(self, cfg: ArchConfig):
        self.cfg = cfg
        self.ed = cfg.encdec

    # ------------------------------------------------------------- spec
    def spec(self) -> dict:
        c, ed = self.cfg, self.ed
        D, H, hd, F_ = c.d_model, c.n_heads, c.head_dim, c.d_ff
        enc_layers = {
            **_ln_spec(ed.n_enc_layers, D, "ln1"),
            **_attn_proj_spec(ed.n_enc_layers, D, H, hd, ""),
            **_ln_spec(ed.n_enc_layers, D, "ln2"),
            **_mlp_spec(ed.n_enc_layers, D, F_),
        }
        dec_layers = {
            **_ln_spec(ed.n_dec_layers, D, "ln1"),
            **_attn_proj_spec(ed.n_dec_layers, D, H, hd, "self_"),
            **_ln_spec(ed.n_dec_layers, D, "ln2"),
            **_attn_proj_spec(ed.n_dec_layers, D, H, hd, "cross_"),
            **_ln_spec(ed.n_dec_layers, D, "ln3"),
            **_mlp_spec(ed.n_dec_layers, D, F_),
        }
        return {
            "enc_pos": P((ed.max_src_len, D), (None, "embed")),
            "enc_layers": enc_layers,
            "enc_final_scale": P((D,), ("embed",), init="ones"),
            "enc_final_bias": P((D,), ("embed",), init="zeros"),
            "dec_embed": P((c.vocab, D), ("vocab", "embed")),
            "dec_pos": P((ed.dec_len, D), (None, "embed")),
            "dec_layers": dec_layers,
            "dec_final_scale": P((D,), ("embed",), init="ones"),
            "dec_final_bias": P((D,), ("embed",), init="zeros"),
        }

    # ------------------------------------------------------------- encoder
    def encode(self, params, src_embeds: torch.Tensor, remat: str = "none"):
        """src_embeds: (B, S, D) precomputed frame embeddings (stub frontend)."""
        s = src_embeds.shape[1]
        x = src_embeds.to(COMPUTE_DTYPE) + params["enc_pos"][:s].to(COMPUTE_DTYPE)
        names = sorted(params["enc_layers"])

        def block(x, *leaves):
            lp = dict(zip(names, leaves, strict=True))
            h = layer_norm(x, lp["ln1_scale"], lp["ln1_bias"])
            o = attention(_q(lp, "", h), *_kv(lp, "", h), causal=False)
            x = x + _out(lp, "", o)
            h = layer_norm(x, lp["ln2_scale"], lp["ln2_bias"])
            return x + _mlp(lp, h)

        block = _maybe_remat(block, remat)
        for lp in _unstack(params["enc_layers"]):
            x = block(x, *(lp[n] for n in names))
        return layer_norm(x, params["enc_final_scale"], params["enc_final_bias"])

    # ------------------------------------------------------------- decoder
    def decode_train(self, params, enc_out, dec_tokens, remat: str = "none"):
        t = dec_tokens.shape[1]
        x = params["dec_embed"][dec_tokens].to(COMPUTE_DTYPE)
        x = x + params["dec_pos"][:t].to(COMPUTE_DTYPE)
        names = sorted(params["dec_layers"])

        def block(x, enc_out, *leaves):
            lp = dict(zip(names, leaves, strict=True))
            h = layer_norm(x, lp["ln1_scale"], lp["ln1_bias"])
            o = attention(_q(lp, "self_", h), *_kv(lp, "self_", h), causal=True)
            x = x + _out(lp, "self_", o)
            h = layer_norm(x, lp["ln2_scale"], lp["ln2_bias"])
            o = attention(_q(lp, "cross_", h), *_kv(lp, "cross_", enc_out), causal=False)
            x = x + _out(lp, "cross_", o)
            h = layer_norm(x, lp["ln3_scale"], lp["ln3_bias"])
            return x + _mlp(lp, h)

        block = _maybe_remat(block, remat)
        for lp in _unstack(params["dec_layers"]):
            x = block(x, enc_out, *(lp[n] for n in names))
        x = layer_norm(x, params["dec_final_scale"], params["dec_final_bias"])
        return lm_logits(x, params["dec_embed"].T)

    def forward(self, params, batch: dict, remat: str = "none"):
        """batch: src_embeds (B, S, D), dec_tokens (B, T)."""
        enc_out = self.encode(params, batch["src_embeds"], remat)
        logits = self.decode_train(params, enc_out, batch["dec_tokens"], remat)
        return logits, torch.zeros((), device=logits.device)

    # ------------------------------------------------------------- serving
    def cache_axes(self) -> dict:
        return {
            "self_k": ("layers", "batch", None, "heads", "kv_head_dim"),
            "self_v": ("layers", "batch", None, "heads", "kv_head_dim"),
            "cross_k": ("layers", "batch", "kv_seq", "heads", "kv_head_dim"),
            "cross_v": ("layers", "batch", "kv_seq", "heads", "kv_head_dim"),
        }

    def init_cache(self, params, enc_out: torch.Tensor, batch: int):
        """Cross K/V projected once; an empty growing self cache, on
        ``enc_out``'s device."""
        ed, c = self.ed, self.cfg
        cross = [_kv(lp, "cross_", enc_out) for lp in _unstack(params["dec_layers"])]
        shape = (ed.n_dec_layers, batch, ed.dec_len, c.n_heads, c.head_dim)
        return {
            "self_k": torch.zeros(shape, dtype=COMPUTE_DTYPE, device=enc_out.device),
            "self_v": torch.zeros(shape, dtype=COMPUTE_DTYPE, device=enc_out.device),
            "cross_k": torch.stack([k for k, _ in cross]),
            "cross_v": torch.stack([v for _, v in cross]),
        }

    def decode_step(self, params, cache, cache_len, tokens):
        x = params["dec_embed"][tokens].to(COMPUTE_DTYPE)
        x = x + params["dec_pos"][cache_len].to(COMPUTE_DTYPE)[:, None, :]
        names = sorted(cache)
        s_max = cache["self_k"].shape[2]
        oh = F.one_hot(cache_len.long(), s_max)[:, :, None, None].to(COMPUTE_DTYPE)
        new = {n: [] for n in names}
        for lp, *cache_l in zip(_unstack(params["dec_layers"]),
                                *(torch.unbind(cache[n]) for n in names), strict=True):
            cache_l = dict(zip(names, cache_l, strict=True))
            h = layer_norm(x, lp["ln1_scale"], lp["ln1_bias"])
            k, v = _kv(lp, "self_", h)
            cache_l["self_k"] = cache_l["self_k"] + oh * k
            cache_l["self_v"] = cache_l["self_v"] + oh * v
            o = attention(_q(lp, "self_", h), cache_l["self_k"], cache_l["self_v"],
                          causal=False, kv_len=cache_len + 1)
            x = x + _out(lp, "self_", o)
            h = layer_norm(x, lp["ln2_scale"], lp["ln2_bias"])
            o = attention(_q(lp, "cross_", h), cache_l["cross_k"], cache_l["cross_v"],
                          causal=False)
            x = x + _out(lp, "cross_", o)
            h = layer_norm(x, lp["ln3_scale"], lp["ln3_bias"])
            x = x + _mlp(lp, h)
            for n in names:
                new[n].append(cache_l[n])
        x = layer_norm(x, params["dec_final_scale"], params["dec_final_bias"])
        return lm_logits(x, params["dec_embed"].T), {n: torch.stack(v) for n, v in new.items()}
