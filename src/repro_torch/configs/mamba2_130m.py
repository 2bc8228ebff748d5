"""Mamba2-130M: pure SSM (SSD) [arXiv:2405.21060; unverified].
Attention-free: flash-attention tuning inapplicable — SSD chunk size is
the tuned kernel dimension instead (DESIGN.md section 4)."""
from .base import ArchConfig, SSMCfg

CONFIG = ArchConfig(
    name="mamba2-130m", family="ssm",
    n_layers=24, d_model=768, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab=50280,
    ssm=SSMCfg(d_state=128, d_conv=4, expand=2, head_dim=64, n_groups=1, chunk=256),
    source="arXiv:2405.21060",
)
