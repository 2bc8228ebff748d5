"""OLMoE-1B-7B: 64-expert top-8 MoE [arXiv:2409.02060; hf]."""
from .base import ArchConfig, MoECfg

CONFIG = ArchConfig(
    name="olmoe-1b-7b", family="moe",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=0, vocab=50304, head_dim=128,
    moe=MoECfg(n_experts=64, top_k=8, d_ff_expert=1024),
    source="arXiv:2409.02060",
)
