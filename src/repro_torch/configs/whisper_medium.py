"""Whisper-medium: enc-dec audio backbone; conv frontend STUBBED —
input_specs provides precomputed frame embeddings [arXiv:2212.04356]."""
from .base import ArchConfig, EncDecCfg

CONFIG = ArchConfig(
    name="whisper-medium", family="encdec",
    n_layers=48,  # 24 enc + 24 dec
    d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=4096, vocab=51865, head_dim=64,
    norm="ln", act="gelu", tie_embeddings=True,
    encdec=EncDecCfg(n_enc_layers=24, n_dec_layers=24, max_src_len=32768, dec_len=448),
    frontend="audio",
    source="arXiv:2212.04356",
)
