"""Zamba2-1.2B: Mamba2 backbone + weight-shared attention blocks
[arXiv:2411.15242; hf].  38 mamba layers, shared GQA block every 6."""
from .base import ArchConfig, SSMCfg

CONFIG = ArchConfig(
    name="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab=32000, head_dim=64,
    ssm=SSMCfg(d_state=64, d_conv=4, expand=2, head_dim=64, n_groups=1, chunk=256),
    shared_attn_every=6,
    source="arXiv:2411.15242",
)
