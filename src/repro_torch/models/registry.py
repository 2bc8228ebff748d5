"""Model registry (a port of ``repro.models.registry``): ArchConfig -> model."""

from __future__ import annotations

from ..configs.base import ArchConfig
from .decoder import DecoderLM
from .encdec import EncDecLM
from .hybrid import HybridLM
from .ssm import SSMLM

FAMILIES = {
    "dense": DecoderLM,
    "moe": DecoderLM,
    "mla_moe": DecoderLM,
    "vlm": DecoderLM,
    "ssm": SSMLM,
    "hybrid": HybridLM,
    "encdec": EncDecLM,
}


def build_model(cfg: ArchConfig):
    if cfg.family not in FAMILIES:
        raise KeyError(f"unknown family {cfg.family}")
    return FAMILIES[cfg.family](cfg)
