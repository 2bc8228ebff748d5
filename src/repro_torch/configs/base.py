"""Architecture configuration system (a copy of ``repro.configs.base``).

One :class:`ArchConfig` describes every assigned architecture (``--arch
<id>`` resolves through :data:`repro_torch.configs.REGISTRY`).
``reduced()`` returns the family-preserving small config used by the CPU
tests; a full config is counted without allocation through
``repro_torch.models.abstract_params`` (``meta`` tensors).
"""

from __future__ import annotations

from dataclasses import dataclass, replace


@dataclass(frozen=True)
class MoECfg:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0
    capacity_factor: float = 1.25


@dataclass(frozen=True)
class MLACfg:
    q_lora: int = 1536
    kv_lora: int = 512
    d_nope: int = 128
    d_rope: int = 64
    d_v: int = 128


@dataclass(frozen=True)
class SSMCfg:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 256


@dataclass(frozen=True)
class EncDecCfg:
    n_enc_layers: int
    n_dec_layers: int
    max_src_len: int = 32768     # frame embeddings (frontend stub)
    dec_len: int = 448           # whisper decoder context


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # dense | moe | mla_moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    vocab: int
    n_heads: int = 0
    n_kv_heads: int = 0
    d_ff: int = 0
    head_dim: int = 128
    rope_theta: float = 10000.0
    norm: str = "rms"            # rms | ln
    act: str = "swiglu"          # swiglu | gelu
    tie_embeddings: bool = False
    moe: MoECfg | None = None
    mla: MLACfg | None = None
    ssm: SSMCfg | None = None
    encdec: EncDecCfg | None = None
    shared_attn_every: int = 0   # hybrid: shared attn block cadence
    frontend: str | None = None  # 'audio' | 'vq_image' — STUB per task spec
    source: str = ""             # public citation

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch run long_500k? (SSM / hybrid families only)."""
        return self.family in ("ssm", "hybrid")

    @property
    def has_decode(self) -> bool:
        return True  # all zoo members are (or contain) decoders

    def reduced(self) -> "ArchConfig":
        """Family-preserving smoke-test config."""
        kw: dict = dict(
            n_layers=min(self.n_layers, 2),
            d_model=256,
            vocab=512,
            d_ff=512 if self.d_ff else 0,
            head_dim=64,
            n_heads=4 if self.n_heads else 0,
        )
        if self.n_kv_heads:
            kw["n_kv_heads"] = min(self.n_kv_heads, 2) if self.n_kv_heads < self.n_heads else 4
        if self.moe:
            kw["moe"] = replace(
                self.moe, n_experts=min(self.moe.n_experts, 8),
                top_k=min(self.moe.top_k, 2), d_ff_expert=128,
            )
        if self.mla:
            kw["mla"] = MLACfg(q_lora=128, kv_lora=64, d_nope=32, d_rope=16, d_v=32)
            kw["head_dim"] = 32
        if self.ssm:
            kw["ssm"] = replace(self.ssm, d_state=16, head_dim=32, chunk=64)
        if self.encdec:
            kw["encdec"] = replace(
                self.encdec, n_enc_layers=2, n_dec_layers=2,
                max_src_len=128, dec_len=32,
            )
        return replace(self, **kw)


@dataclass(frozen=True)
class ShapeCfg:
    name: str
    seq_len: int
    global_batch: int
    kind: str                    # train | prefill | decode

    @property
    def is_train(self) -> bool:
        return self.kind == "train"


SHAPES: dict[str, ShapeCfg] = {
    "train_4k": ShapeCfg("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCfg("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCfg("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCfg("long_500k", 524288, 1, "decode"),
}


def applicable_shapes(cfg: ArchConfig) -> list[str]:
    """The dry-run cells for this arch (DESIGN.md section 4)."""
    out = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.sub_quadratic:
        out.append("long_500k")
    return out
