"""Yi-34B: llama-arch dense GQA [arXiv:2403.04652; hf]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="yi-34b", family="dense",
    n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8,
    d_ff=20480, vocab=64000, head_dim=128, rope_theta=5e6,
    source="arXiv:2403.04652",
)
