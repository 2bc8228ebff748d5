"""DeepSeek-V2-236B: MLA (kv_lora=512) + 160-expert top-6 MoE with 2
shared experts [arXiv:2405.04434; hf].

Deviation noted in DESIGN.md: the released model keeps the first layer's
FFN dense; we use MoE in every layer (changes <0.5% of params)."""
from .base import ArchConfig, MLACfg, MoECfg

CONFIG = ArchConfig(
    name="deepseek-v2-236b", family="mla_moe",
    n_layers=60, d_model=5120, n_heads=128, n_kv_heads=128,
    d_ff=0, vocab=102400, head_dim=128,
    mla=MLACfg(q_lora=1536, kv_lora=512, d_nope=128, d_rope=64, d_v=128),
    moe=MoECfg(n_experts=160, top_k=6, d_ff_expert=1536, n_shared=2),
    source="arXiv:2405.04434",
)
