"""Roofline analysis from the dry-run records (a port of
``repro.launch.roofline``, with the H100's constants).

Per (arch x shape) cell, three terms in seconds:

    compute    = FLOPs / (chips * 989e12)      [dense bf16 tensor-core peak,
                                                H100 SXM data sheet]
    memory     = HBM bytes / (chips * 3.35e12) [HBM3, H100 SXM data sheet]
    collective = per-device collective bytes / 450e9
                                               [NVLink 4, one direction of
                                                the data sheet's 900 GB/s]

The record's chip count scales the compute and memory terms and the
roofline fraction (the reference divides the fraction by a fixed 256; at
the single-pod mesh the two agree).  An H100 NVLink domain holds 8 cards, so
a 16-wide ``model`` axis spans two domains and its collectives cross the
slower inter-node network: the collective term is a lower bound there.
Every second here is modelled from data-sheet constants, not measured.

Sources:
  * FLOPs: the per-device dot-FLOP count of the dry run's step
    (``repro_torch.launch.hlo_analysis.dot_flops``); global = x chips.
  * HBM bytes: the analytic traffic model below (the reference's).
  * collective bytes: the dry run's per-device result-byte sum of the
    functional collectives its DTensor redistributions issue
    (``hlo_analysis.collective_stats``).

MODEL_FLOPS = 6*N*D for training (N = matmul-visible params, D = tokens),
2*N*D for prefill, 2*N*B per decode step (+ attention cache terms) — the
'useful' FLOPs.  The ratio MODEL_FLOPS / counted FLOPs exposes remat
recompute (~4/3 for gradient checkpointing) and any redundancy.

Memory-traffic model (per device, per step):
  train:   (2+2+2) * N_bytes_bf16 / chips        fwd + remat + bwd weight reads
           + 16 * N * 4 / chips                   AdamW fp32 m,v,p read+write
           + A * activation_bytes / chips         residual-stream traffic
  prefill: 2 * N / chips * bf16  + activations
  decode:  (2 * N * bf16 + cache_bytes) / chips   weights + full KV cache read
"""

from __future__ import annotations

import argparse
import json
import os
from dataclasses import dataclass

from ..configs import REGISTRY, SHAPES, applicable_shapes
from ..configs.base import ArchConfig, ShapeCfg
from ..models import build_model, param_count

#: H100 SXM (NVIDIA data sheet): dense bf16 tensor-core FLOP/s, HBM3 B/s
PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
#: the chip-to-chip link (the reference's name): NVLink 4, 450 GB/s each way
ICI_BW = 450e9
RESULTS_DIR = os.path.join("results", "dryrun_torch")


# --------------------------------------------------------------- analytics
def matmul_params(arch: ArchConfig) -> tuple[int, int]:
    """(total matmul-visible params, active matmul params per token)."""
    total = param_count(build_model(arch).spec())
    # embedding table is a gather (no flops); head matmul counts (tied or not)
    embed = arch.vocab * arch.d_model
    total_matmul = total - embed if not arch.tie_embeddings else total
    if arch.moe is None:
        return total_matmul, total_matmul
    m = arch.moe
    expert_p = 3 * arch.d_model * m.d_ff_expert
    routed_total = arch.n_layers * m.n_experts * expert_p
    routed_active = arch.n_layers * m.top_k * expert_p
    return total_matmul, total_matmul - routed_total + routed_active


def attention_flops_per_token(arch: ArchConfig, s: int) -> float:
    """2 * (scores + pv) per token with causal 1/2 factor."""
    if arch.family == "ssm":
        return 0.0
    if arch.mla:
        e = arch.mla.d_nope + arch.mla.d_rope + arch.mla.d_v
    else:
        e = 2 * arch.head_dim
    if arch.family == "hybrid":
        L = arch.n_layers // arch.shared_attn_every  # shared-attn insertions
    elif arch.family == "encdec":
        L = arch.encdec.n_enc_layers
    else:
        L = arch.n_layers
    return 2.0 * L * arch.n_heads * e * (s / 2.0)


def model_flops(arch: ArchConfig, shape: ShapeCfg) -> float:
    """Global 'useful' FLOPs for one step (MODEL_FLOPS)."""
    _, n_active = matmul_params(arch)
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        tokens = b * (s if arch.family != "encdec" else s + arch.encdec.dec_len)
        return 6.0 * n_active * tokens + 3.0 * b * s * attention_flops_per_token(arch, s)
    if shape.kind == "prefill":
        tokens = b * s
        return 2.0 * n_active * tokens + b * s * attention_flops_per_token(arch, s)
    # decode: one token per sequence, attends to the full cache
    return 2.0 * n_active * b + b * 2.0 * attention_flops_per_token(arch, s)


def cache_bytes(arch: ArchConfig, shape: ShapeCfg) -> float:
    """KV/state cache bytes read per decode step (global)."""
    b, s = shape.global_batch, shape.seq_len
    if arch.family == "ssm":
        d = arch.ssm
        di = d.expand * arch.d_model
        return b * arch.n_layers * (di // d.head_dim) * d.head_dim * d.d_state * 4
    if arch.family == "hybrid":
        d = arch.ssm
        di = d.expand * arch.d_model
        ssm = b * arch.n_layers * (di // d.head_dim) * d.head_dim * d.d_state * 4
        n_apps = arch.n_layers // arch.shared_attn_every
        attn = b * n_apps * s * arch.n_kv_heads * arch.head_dim * 2 * 2
        return ssm + attn
    if arch.mla:
        return b * arch.n_layers * s * (arch.mla.kv_lora + arch.mla.d_rope) * 2
    if arch.family == "encdec":
        ed = arch.encdec
        self_c = b * ed.n_dec_layers * ed.dec_len * arch.n_heads * arch.head_dim * 2 * 2
        cross_c = b * ed.n_dec_layers * s * arch.n_heads * arch.head_dim * 2 * 2
        return self_c + cross_c
    return b * arch.n_layers * s * arch.n_kv_heads * arch.head_dim * 2 * 2


def memory_bytes(arch: ArchConfig, shape: ShapeCfg) -> float:
    """Global HBM traffic estimate for one step (documented in module doc)."""
    n_total, _ = matmul_params(arch)
    b, s = shape.global_batch, shape.seq_len
    d = arch.d_model
    if shape.kind == "train":
        weights = 6 * n_total            # bf16 reads: fwd + remat + bwd
        opt = 16 * n_total               # fp32 p,m,v read + p,m,v write
        act_layers = arch.n_layers
        acts = 12 * b * s * d * act_layers  # residual stream r/w, bf16, few ops
        return weights + opt + acts
    if shape.kind == "prefill":
        return 2 * n_total + 8 * b * s * d * arch.n_layers
    return 2 * n_total + cache_bytes(arch, shape) + 4 * b * d * arch.n_layers


# --------------------------------------------------------------- terms
@dataclass
class RooflineRow:
    arch: str
    shape: str
    compute_s: float
    memory_s: float
    collective_s: float
    model_flops: float
    hlo_flops: float
    useful_ratio: float
    peak_gib: float
    dominant: str

    @property
    def step_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    chips: int = 256

    @property
    def roofline_fraction(self) -> float:
        """useful-compute time / modelled step time (MFU-style score), over
        the record's chips."""
        ideal = self.model_flops / (self.chips * PEAK_FLOPS)
        return ideal / self.step_s if self.step_s else 0.0


def load_record(arch: str, shape: str, mesh: str = "single") -> dict:
    path = os.path.join(RESULTS_DIR, f"{arch}_{shape}_{mesh}.json")
    with open(path) as f:
        return json.load(f)


def roofline_row(arch_name: str, shape_name: str, record: dict | None = None) -> RooflineRow:
    arch = REGISTRY[arch_name]
    shape = SHAPES[shape_name]
    rec = record or load_record(arch_name, shape_name)
    chips = rec["n_devices"]
    mf = model_flops(arch, shape)
    # per-device dot flops -> global
    hlo_flops = rec.get("flops_dot_corrected", 0.0) * chips
    compute_s = hlo_flops / (chips * PEAK_FLOPS)
    memory_s = memory_bytes(arch, shape) / (chips * HBM_BW)
    collective_s = rec["collectives"]["total_bytes"] / ICI_BW
    terms = {"compute": compute_s, "memory": memory_s, "collective": collective_s}
    dominant = max(terms, key=terms.get)
    return RooflineRow(
        arch=arch_name,
        shape=shape_name,
        compute_s=compute_s,
        memory_s=memory_s,
        collective_s=collective_s,
        model_flops=mf,
        hlo_flops=hlo_flops,
        useful_ratio=mf / hlo_flops if hlo_flops else 0.0,
        peak_gib=rec["memory"]["peak_bytes_per_dev"] / 2**30,
        dominant=dominant,
        chips=chips,
    )


def all_rows() -> list[RooflineRow]:
    rows = []
    for arch_name, arch in REGISTRY.items():
        for shape_name in applicable_shapes(arch):
            try:
                rows.append(roofline_row(arch_name, shape_name))
            except FileNotFoundError:
                pass
    return rows


def markdown_table(rows: list[RooflineRow]) -> str:
    hdr = (
        "| arch | shape | compute (s) | memory (s) | collective (s) | dominant | "
        "MODEL_FLOPS | HLO_FLOPs | useful | roofline frac | peak GiB/dev |\n"
        "|---|---|---|---|---|---|---|---|---|---|---|\n"
    )
    body = "".join(
        f"| {r.arch} | {r.shape} | {r.compute_s:.4g} | {r.memory_s:.4g} | "
        f"{r.collective_s:.4g} | **{r.dominant}** | {r.model_flops:.3e} | "
        f"{r.hlo_flops:.3e} | {r.useful_ratio:.2f} | {r.roofline_fraction:.3f} | "
        f"{r.peak_gib:.2f} |\n"
        for r in rows
    )
    return hdr + body


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join("results", "roofline_torch.md"))
    args = ap.parse_args(argv)
    rows = all_rows()
    md = markdown_table(rows)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        f.write(md)
    print(md)
    if rows:
        worst = min(rows, key=lambda r: r.roofline_fraction)
        coll = max(rows, key=lambda r: r.collective_s / max(r.step_s, 1e-12))
        print(f"\nworst roofline fraction : {worst.arch} {worst.shape} "
              f"({worst.roofline_fraction:.3f})")
        print(f"most collective-bound   : {coll.arch} {coll.shape} "
              f"(coll {coll.collective_s:.4g}s vs step {coll.step_s:.4g}s)")


if __name__ == "__main__":
    main()
