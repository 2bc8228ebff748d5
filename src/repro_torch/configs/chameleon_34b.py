"""Chameleon-34B: early-fusion VLM backbone; VQ image tokens are ordinary
vocab entries, the VQ tokenizer frontend is STUBBED per the task spec
[arXiv:2405.09818; unverified]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="chameleon-34b", family="vlm",
    n_layers=48, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=22016, vocab=65536, head_dim=128,
    frontend="vq_image",
    source="arXiv:2405.09818",
)
