"""Assigned-architecture registry (a copy of the reference's): ``--arch <id>`` resolves here."""

from .base import SHAPES, ArchConfig, ShapeCfg, applicable_shapes
from .chameleon_34b import CONFIG as CHAMELEON_34B
from .deepseek_coder_33b import CONFIG as DEEPSEEK_CODER_33B
from .deepseek_v2_236b import CONFIG as DEEPSEEK_V2_236B
from .granite_34b import CONFIG as GRANITE_34B
from .mamba2_130m import CONFIG as MAMBA2_130M
from .olmoe_1b_7b import CONFIG as OLMOE_1B_7B
from .phi3_medium_14b import CONFIG as PHI3_MEDIUM_14B
from .whisper_medium import CONFIG as WHISPER_MEDIUM
from .yi_34b import CONFIG as YI_34B
from .zamba2_1_2b import CONFIG as ZAMBA2_1_2B

REGISTRY: dict[str, ArchConfig] = {
    c.name: c
    for c in (
        YI_34B,
        GRANITE_34B,
        PHI3_MEDIUM_14B,
        DEEPSEEK_CODER_33B,
        WHISPER_MEDIUM,
        ZAMBA2_1_2B,
        OLMOE_1B_7B,
        DEEPSEEK_V2_236B,
        MAMBA2_130M,
        CHAMELEON_34B,
    )
}


def get_arch(name: str) -> ArchConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(REGISTRY)}")
    return REGISTRY[name]


__all__ = ["REGISTRY", "get_arch", "ArchConfig", "ShapeCfg", "SHAPES", "applicable_shapes"]
