"""Deterministic synthetic LM data pipeline (a port of ``repro.data.pipeline``).

Batches are a pure function of (seed, step): resume-after-failure replays
exactly the right data (the checkpoint stores only the step number).  The
draws are the reference's numpy draws, ``SeedSequence([seed, step,
crc32(tag)])``, so token values equal the reference's; tokens are ``int64``
tensors (the reference's are int32) on an explicit device.

Token streams are drawn from a Zipfian-ish distribution so the loss curve
is non-trivial (uniform tokens make CE flat at log V from step 0).
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass

import numpy as np
import torch

from ..configs.base import ArchConfig


@dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    zipf_a: float = 1.2


def _tokens_for(
    cfg: DataConfig, vocab: int, shape: tuple, step: int, tag: str
) -> np.ndarray:
    rng = np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, zlib.crc32(tag.encode())])
    )
    draw = rng.zipf(cfg.zipf_a, size=shape).astype(np.int64)
    return draw % vocab


def make_train_batch(
    cfg: DataConfig, arch: ArchConfig, seq_len: int, batch: int, step: int, device="cuda"
) -> dict:
    """Next-token LM batch: labels are tokens shifted left."""
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    if arch.family == "encdec":
        frames = _tokens_for(cfg, 997, (batch, seq_len), step, "frames")
        # frame embeddings via a fixed random projection of frame ids (stub
        # frontend: deterministic, cheap, well-conditioned)
        rng = np.random.default_rng(cfg.seed + 1)
        table = rng.normal(0, 0.02, size=(997, arch.d_model)).astype(np.float32)
        dec = _tokens_for(cfg, arch.vocab, (batch, arch.encdec.dec_len + 1), step, "dec")
        return {
            "src_embeds": put(table[frames]),
            "dec_tokens": put(dec[:, :-1]),
            "dec_labels": put(dec[:, 1:]),
        }
    toks = _tokens_for(cfg, arch.vocab, (batch, seq_len + 1), step, "lm")
    return {"tokens": put(toks[:, :-1]), "labels": put(toks[:, 1:])}


def make_decode_inputs(
    cfg: DataConfig, arch: ArchConfig, batch: int, step: int, fill: int, device="cuda"
) -> dict:
    tok = _tokens_for(cfg, arch.vocab, (batch, 1), step, "decode")
    return {
        "tokens": torch.from_numpy(tok).to(device),
        "cache_len": torch.full((batch,), fill, dtype=torch.int32, device=device),
    }
