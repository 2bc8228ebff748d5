"""Abstract inputs for every (arch x shape) dry-run cell (a port of
``repro.launch.specs``): ``meta`` tensors, so nothing is ever allocated.

``input_specs`` of the reference's docstring is the three functions below,
selected by the shape kind (train / prefill / decode).  Modality frontends
are stubs as in the reference: whisper gets precomputed frame embeddings,
chameleon gets VQ token ids (ordinary vocab entries).  Tokens are int64 and
``cache_len`` int32, as the port's batches and decode loop hold them.
"""

from __future__ import annotations

import torch

from ..configs.base import ArchConfig, ShapeCfg
from ..models import abstract_params
from ..models.layers import COMPUTE_DTYPE


def sds(shape, dtype) -> torch.Tensor:
    """The reference's ``ShapeDtypeStruct``: a ``meta`` tensor."""
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def train_batch_specs(arch: ArchConfig, shape: ShapeCfg) -> dict:
    b, s = shape.global_batch, shape.seq_len
    if arch.family == "encdec":
        return {
            "src_embeds": sds((b, s, arch.d_model), torch.float32),
            "dec_tokens": sds((b, arch.encdec.dec_len), torch.int64),
            "dec_labels": sds((b, arch.encdec.dec_len), torch.int64),
        }
    return {
        "tokens": sds((b, s), torch.int64),
        "labels": sds((b, s), torch.int64),
    }


def prefill_batch_specs(arch: ArchConfig, shape: ShapeCfg) -> dict:
    b, s = shape.global_batch, shape.seq_len
    if arch.family == "encdec":
        return {
            "src_embeds": sds((b, s, arch.d_model), torch.float32),
            "dec_tokens": sds((b, arch.encdec.dec_len), torch.int64),
        }
    return {"tokens": sds((b, s), torch.int64)}


def decode_specs(arch: ArchConfig, shape: ShapeCfg, model) -> dict:
    """Abstract (cache, cache_len, tokens) for one decode step with a KV
    cache of shape.seq_len tokens."""
    b, s = shape.global_batch, shape.seq_len
    if arch.family == "encdec":
        enc_out = sds((b, s, arch.d_model), COMPUTE_DTYPE)
        cache = model.init_cache(abstract_params(model.spec()), enc_out, b)
    else:
        cache = model.init_cache(b, s, device="meta")
    return {
        "cache": cache,
        "cache_len": sds((b,), torch.int32),
        "tokens": sds((b, 1), torch.int64),
    }
