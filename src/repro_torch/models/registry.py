"""Model registry (a port of ``repro.models.registry``): ArchConfig -> model."""

from __future__ import annotations

from ..configs.base import ArchConfig
from .decoder import DecoderLM

FAMILIES = {"dense": DecoderLM, "vlm": DecoderLM}
#: the reference's other families; their models land with ROADMAP item 6b
NOT_PORTED = ("moe", "mla_moe", "ssm", "hybrid", "encdec")


def build_model(cfg: ArchConfig):
    if cfg.family in NOT_PORTED:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet (ROADMAP item 6b)")
    if cfg.family not in FAMILIES:
        raise KeyError(f"unknown family {cfg.family}")
    return FAMILIES[cfg.family](cfg)
