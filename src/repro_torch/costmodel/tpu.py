"""TPU chip models (a copy of ``repro.costmodel.tpu``): inputs of the
analytic cost model, not figures of the card the port runs on.

The paper compares three GPU architectures (RTX Titan 2019, Titan V 2017,
GTX 980 2014).  Our TPU adaptation uses three chip generations in the same
role: v5e (the roofline target mandated for this repo), a v4-class chip and
a v3-class chip.  Numbers are public spec-sheet values; the per-step DMA
overheads are calibrated so relative kernel behaviour (memory-bound add,
stencil harris, compute-bound mandelbrot) is plausible — the *absolute*
seconds only matter up to the monotone transformations the paper's
statistics use (medians, ranks, speedup ratios).
"""

from __future__ import annotations

from dataclasses import dataclass

MiB = 1024 * 1024


@dataclass(frozen=True)
class ChipModel:
    name: str
    peak_flops_bf16: float      # MXU, FLOP/s
    vpu_flops_f32: float        # vector unit, FLOP/s (stencils/fractals live here)
    hbm_bw: float               # bytes/s
    vmem_bytes: int             # per-core VMEM (the paper's workgroup<=256 analogue)
    ici_bw: float               # bytes/s per link (used by the distributed tuner)
    dma_setup_s: float          # per-grid-step DMA/program overhead
    launch_s: float             # per-kernel launch overhead
    mxu_dim: int = 128
    sublanes: int = 8
    lanes: int = 128


# v5e: 197 TFLOP/s bf16, 819 GB/s HBM, 128 MiB VMEM, ~50 GB/s/link ICI
V5E = ChipModel(
    name="v5e",
    peak_flops_bf16=197e12,
    vpu_flops_f32=4.1e12,
    hbm_bw=819e9,
    vmem_bytes=128 * MiB,
    ici_bw=50e9,
    dma_setup_s=0.4e-6,
    launch_s=2.0e-6,
)

# v4-class: 275 TFLOP/s bf16, 1228 GB/s HBM
V4 = ChipModel(
    name="v4",
    peak_flops_bf16=275e12,
    vpu_flops_f32=4.3e12,
    hbm_bw=1228e9,
    vmem_bytes=128 * MiB,
    ici_bw=45e9,
    dma_setup_s=0.5e-6,
    launch_s=2.5e-6,
)

# v3-class: 123 TFLOP/s bf16, 900 GB/s HBM, much smaller VMEM —
# plays the GTX 980 role: older part, different constraint surface.
V3 = ChipModel(
    name="v3",
    peak_flops_bf16=123e12,
    vpu_flops_f32=1.9e12,
    hbm_bw=900e9,
    vmem_bytes=32 * MiB,
    ici_bw=35e9,
    dma_setup_s=0.9e-6,
    launch_s=4.0e-6,
)

CHIPS: dict[str, ChipModel] = {c.name: c for c in (V5E, V4, V3)}
