"""Granite-34B-code: 88-layer MQA (kv=1) dense [arXiv:2405.04324; hf]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="granite-34b", family="dense",
    n_layers=88, d_model=6144, n_heads=48, n_kv_heads=1,
    d_ff=24576, vocab=49152, head_dim=128,
    source="arXiv:2405.04324",
)
