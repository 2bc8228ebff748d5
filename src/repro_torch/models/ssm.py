"""Pure-SSM LM (mamba2-130m; a port of ``repro.models.ssm``): embedding ->
L x Mamba2/SSD blocks -> head.

Attention-free: the SSD chunk size takes the place of the attention tile
as the tuned dimension.  Sub-quadratic -> runs long_500k.

Sharded (DTensor params), each Mamba-2 mixer runs as a local region
replicated over ``model`` (``in_proj`` packs z, x, B, C and dt on one
``ssm_inner`` dim, which no split over ranks keeps whole), batch-sharded
over the data axes, with the reference's hooks around it
(``gather_layer_weights``, ``constrain_residual``).
"""

from __future__ import annotations

import torch

from ..configs.base import ArchConfig
from ..sharding.constrain import constrain_residual, gather_layer_weights, strip_layer_axis
from ..sharding.regions import maybe_region
from .decoder import _maybe_remat, _unstack
from .layers import COMPUTE_DTYPE, embed, lm_logits, rms_norm
from .mamba2 import SSMDims, mamba2_decode, mamba2_forward
from .param import P, param_axes


def ssm_dims(cfg: ArchConfig) -> SSMDims:
    s = cfg.ssm
    return SSMDims(
        d_model=cfg.d_model,
        d_state=s.d_state,
        d_conv=s.d_conv,
        expand=s.expand,
        head_dim=s.head_dim,
        n_groups=s.n_groups,
        chunk=s.chunk,
    )


def mamba_layer_spec(L: int, dims: SSMDims) -> dict:
    return {
        "pre_norm": P((L, dims.d_model), ("layers", "embed"), init="ones"),
        "in_proj": P((L, dims.d_model, dims.in_proj_dim),
                     ("layers", "embed", "ssm_inner"), init="scaled"),
        "conv_w": P((L, dims.d_conv, dims.conv_dim),
                    ("layers", None, "ssm_inner"), init="scaled"),
        "dt_bias": P((L, dims.n_heads), ("layers", "heads"), init="zeros"),
        "a_log": P((L, dims.n_heads), ("layers", "heads"), init="zeros"),
        "d_skip": P((L, dims.n_heads), ("layers", "heads"), init="ones"),
        "norm": P((L, dims.d_inner), ("layers", "ssm_inner"), init="ones"),
        "out_proj": P((L, dims.d_inner, dims.d_model),
                      ("layers", "ssm_inner", "embed"), init="scaled"),
    }


def mamba_axes(dims: SSMDims) -> dict:
    """One Mamba-2 layer's logical axes, the ``layers`` dim stripped."""
    return strip_layer_axis(param_axes(mamba_layer_spec(1, dims)))


def mamba_block(dims: SSMDims, names: list[str]):
    """The residual Mamba-2 block over one layer's leaves, given in
    ``names`` order (the form ``_maybe_remat`` wraps)."""
    axes = mamba_axes(dims)

    def block(x, *leaves):
        lp = gather_layer_weights(dict(zip(names, leaves, strict=True)), axes)
        out = maybe_region(lambda h, w: mamba2_forward(rms_norm(h, w["pre_norm"]), w, dims),
                           (x,), lp, axes, model_parallel=False)
        return constrain_residual(x + out)
    return block


_CACHE_AXES = {"conv": ("batch", None, "ssm_inner"), "ssm": ("batch", "heads", None, None)}


def mamba_decode_block(dims: SSMDims, lp: dict, x, cache_l: dict):
    def step(x, conv, ssm, w):
        out, new = mamba2_decode(rms_norm(x, w["pre_norm"]), w, dims, {"conv": conv, "ssm": ssm})
        return x + out, new["conv"], new["ssm"]

    x, conv, ssm = maybe_region(step, (x, cache_l["conv"], cache_l["ssm"]), lp, mamba_axes(dims),
                                act_axes=(None, _CACHE_AXES["conv"], _CACHE_AXES["ssm"]),
                                out_axes=(None, 1, 2), model_parallel=False)
    return x, {"conv": conv, "ssm": ssm}


def mamba_cache(dims: SSMDims, L: int, batch: int, device) -> dict:
    return {
        "conv": torch.zeros((L, batch, dims.d_conv - 1, dims.conv_dim), dtype=COMPUTE_DTYPE,
                            device=device),
        "ssm": torch.zeros((L, batch, dims.n_heads, dims.head_dim, dims.d_state),
                           dtype=torch.float32, device=device),
    }


class SSMLM:
    def __init__(self, cfg: ArchConfig, moe_groups: int = 1):
        self.cfg = cfg
        self.dims = ssm_dims(cfg)

    def spec(self) -> dict:
        c = self.cfg
        return {
            "embed": P((c.vocab, c.d_model), ("vocab", "embed")),
            "layers": mamba_layer_spec(c.n_layers, self.dims),
            "final_norm": P((c.d_model,), ("embed",), init="ones"),
            "lm_head": P((c.d_model, c.vocab), ("embed", "vocab")),
        }

    def forward(self, params, tokens, remat: str = "none"):
        x = embed(tokens, params["embed"])
        names = sorted(params["layers"])
        block = _maybe_remat(mamba_block(self.dims, names), remat)
        for lp in _unstack(params["layers"]):
            x = block(x, *(lp[n] for n in names))
        logits = lm_logits(x, params["lm_head"], norm=(params["final_norm"],))
        return logits, torch.zeros((), device=x.device)

    def cache_axes(self) -> dict:
        return {
            "conv": ("layers", "batch", None, "ssm_inner"),
            "ssm": ("layers", "batch", "heads", None, None),
        }

    def init_cache(self, batch: int, max_len: int, device="cuda"):
        return mamba_cache(self.dims, self.cfg.n_layers, batch, device)

    def decode_step(self, params, cache, cache_len, tokens):
        x = embed(tokens, params["embed"])
        convs, ssms = [], []
        for lp, conv, ssm in zip(_unstack(params["layers"]), torch.unbind(cache["conv"]),
                                 torch.unbind(cache["ssm"]), strict=True):
            x, new = mamba_decode_block(self.dims, lp, x, {"conv": conv, "ssm": ssm})
            convs.append(new["conv"])
            ssms.append(new["ssm"])
        logits = lm_logits(x, params["lm_head"], norm=(params["final_norm"],))
        return logits, {"conv": torch.stack(convs), "ssm": torch.stack(ssms)}
