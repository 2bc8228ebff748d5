"""Analytical TPU pipeline cost model for the tunable image kernels (a copy
of ``repro.costmodel.kernel_cost``).

The reference's deterministic measurement function for the paper's matrix:
its values are modelled TPU seconds, never a time of the card, and the port
keeps it so that one spec gives one matrix in both packages on a machine
without a card.  It models a Pallas TPU kernel as
a sequential grid of pipeline steps, each step DMAing one VMEM block from HBM
and computing on the VPU, with the 6 tunable parameters:

    t_x -> block rows        bm = 8 * t_x
    t_y -> block cols        bn = 128 * t_y
    t_z -> row coarsening    (row-tiles computed per grid step)
    w_x -> row-region split
    w_y -> col-region split
    w_z -> pipeline depth    (multi-buffering in VMEM)

Model terms (per step):
    dma_t     = block_bytes / (hbm_bw * dma_eff) + dma_setup
    compute_t = elems * flops_per_elem / vpu_flops
    step_t    = dma_t + compute_t                 (w_z == 1, no overlap)
              = max(dma_t, compute_t) * (1 + bubble(w_z))   otherwise
plus kernel-launch overhead, a pipeline warm-up of w_z DMA steps, padding
waste when block geometry does not divide the image, region-switch costs,
and a per-chip core count (v3 has two tensor cores -> w_x*w_y = 2 pays off
there, mirroring how the paper's optimal workgroup depends on GPU
generation).

The *executability constraint* — the TPU analogue of the paper's
"prod(workgroup) <= 256 threads" rule — is the VMEM footprint:
``vmem_bytes(cfg) <= chip.vmem_bytes``.  Non-SMBO methods receive a space
constrained to executable configs (paper section V.C); SMBO methods may
propose non-executable configs and observe a failure penalty.

All absolute constants are plausible-order calibrations; the paper's
statistics (medians, ranks, speedups, CLES) are invariant to monotone
rescaling per benchmark.
"""

from __future__ import annotations

from dataclasses import dataclass
from math import ceil

import numpy as np

from ..core.measurement import BaseMeasurement
from ..core.space import Config, Param, SearchSpace
from .noise import lognormal_noise
from .tpu import ChipModel

FAILURE_RUNTIME = 0.25  # seconds: 'kernel failed to fit / compile' penalty
ROW_DESCRIPTOR_S = 20e-9  # per-row DMA descriptor cost (strided HBM access)


@dataclass(frozen=True)
class KernelWorkload:
    name: str
    x: int = 8192
    y: int = 8192
    bpe: int = 4
    n_inputs: int = 1
    n_outputs: int = 1
    flops_per_elem: float = 1.0
    halo: int = 0            # stencil halo (rows AND cols), e.g. 2 for harris
    scratch_tiles: int = 0   # per-step intermediate (bm, bn) tiles in VMEM
    noise_sigma: float = 0.03

    def n_cores_for(self, chip: ChipModel) -> int:
        return 2 if chip.name == "v3" else 1


ADD = KernelWorkload(
    name="add", n_inputs=2, flops_per_elem=1.0, scratch_tiles=0, noise_sigma=0.05
)
HARRIS = KernelWorkload(
    name="harris",
    n_inputs=1,
    flops_per_elem=60.0,
    halo=2,
    scratch_tiles=5,
    noise_sigma=0.03,
)
MANDELBROT = KernelWorkload(
    name="mandelbrot",
    n_inputs=0,
    flops_per_elem=256 * 10.0,  # fixed-trip escape loop on the VPU
    scratch_tiles=2,
    noise_sigma=0.02,
)

WORKLOADS: dict[str, KernelWorkload] = {
    w.name: w for w in (ADD, HARRIS, MANDELBROT)
}


def geometry(cfg: Config) -> tuple[int, int, int, int, int, int]:
    return (
        8 * cfg["t_x"],
        128 * cfg["t_y"],
        cfg["t_z"],
        cfg["w_x"],
        cfg["w_y"],
        cfg["w_z"],
    )


def vmem_bytes(w: KernelWorkload, cfg: Config) -> int:
    bm, bn, tz, _, _, wz = geometry(cfg)
    rows = bm * tz
    in_block = w.n_inputs * (rows + 2 * w.halo) * (bn + 2 * w.halo) * w.bpe
    out_block = w.n_outputs * rows * bn * w.bpe
    scratch = w.scratch_tiles * bm * bn * w.bpe
    return (in_block + out_block) * wz + scratch


def is_executable(w: KernelWorkload, chip: ChipModel, cfg: Config) -> bool:
    return vmem_bytes(w, cfg) <= chip.vmem_bytes


def runtime_model(w: KernelWorkload, chip: ChipModel, cfg: Config) -> float:
    """Noise-free modelled runtime in seconds (FAILURE_RUNTIME if invalid)."""
    if not is_executable(w, chip, cfg):
        return FAILURE_RUNTIME
    bm, bn, tz, wx, wy, wz = geometry(cfg)
    rows_step = bm * tz

    # region split -> per-region padded step counts
    region_rows = ceil(w.x / wx)
    region_cols = ceil(w.y / wy)
    steps_r = ceil(region_rows / rows_step)
    steps_c = ceil(region_cols / bn)
    n_steps = wx * wy * steps_r * steps_c

    # per-step work (padded blocks do full work — padding waste is real)
    elems = rows_step * bn
    in_bytes = w.n_inputs * (rows_step + 2 * w.halo) * (bn + 2 * w.halo) * w.bpe
    out_bytes = w.n_outputs * elems * w.bpe

    # DMA efficiency: each block row is a strided HBM access -> per-row
    # descriptor cost; narrow blocks (small bn) are badly inefficient.
    n_rows_dma = w.n_inputs * (rows_step + 2 * w.halo) + w.n_outputs * rows_step
    dma_t = (
        (in_bytes + out_bytes) / chip.hbm_bw
        + n_rows_dma * ROW_DESCRIPTOR_S
        + chip.dma_setup_s
    )
    compute_t = elems * w.flops_per_elem / chip.vpu_flops_f32

    if wz == 1:
        step_t = dma_t + compute_t
    else:
        bubble = {2: 0.05, 3: 0.02}.get(wz, 0.01)
        step_t = max(dma_t, compute_t) * (1.0 + bubble)

    # multiple cores (v3): independent regions run in parallel across cores
    cores = w.n_cores_for(chip)
    parallel = min(wx * wy, cores)
    total = n_steps * step_t / parallel

    # region switching breaks DMA streaming locality
    switches = wx * wy - 1
    total += switches * 8.0 * chip.dma_setup_s
    # pipeline warm-up: wz blocks in flight before first compute retires
    total += wz * dma_t + chip.launch_s
    return float(total)


PARAM_ORDER = ("t_x", "t_y", "t_z", "w_x", "w_y", "w_z")


class CostModelMeasurement(BaseMeasurement):
    """Vectorized measurement backend: modelled runtime x log-normal noise.

    Each instance owns a *counter-based* noise stream (one per experiment in
    the runner), so experiments see independent noise — and ``measure_final``
    re-draws noise, reproducing the paper's 10x final re-measurement
    semantics.  Noise for sample ``i`` depends only on ``(seed, i)``
    (see :mod:`repro_torch.costmodel.noise`), so a batched dispatch through
    :meth:`measure_batch` and a sequential one-at-a-time run produce
    IDENTICAL values — the property the engine's parity audits rely on.
    ``measure_batch`` evaluates the whole batch through the vectorized
    ``runtime_model_batch`` in ONE Python-level dispatch.
    """

    def __init__(
        self,
        workload: KernelWorkload,
        chip: ChipModel,
        seed: int = 0,
        noise: bool = True,
    ):
        super().__init__()
        self.workload = workload
        self.chip = chip
        self.noise = noise
        self.seed = seed
        self._draws = 0  # per-sample noise counter (advances hit or miss)

    def _noise_factors(self, n: int) -> np.ndarray:
        start = self._draws
        self._draws += n
        return lognormal_noise(self.seed, start, n, self.workload.noise_sigma)

    def skip_samples(self, n: int) -> None:
        self._draws += n

    def _measure_one(self, config: Config) -> float:
        base = runtime_model(self.workload, self.chip, config)
        if not self.noise:
            return base
        return base * float(self._noise_factors(1)[0])

    def measure_batch(self, configs) -> np.ndarray:
        if len(configs) == 0:
            return np.zeros(0, dtype=np.float64)
        self.n_samples += len(configs)
        self.n_dispatches += 1
        arr = np.array(
            [[c[k] for k in PARAM_ORDER] for c in configs], dtype=np.int64
        )
        base = runtime_model_batch(self.workload, self.chip, arr)
        if self.noise:
            base = base * self._noise_factors(len(configs))
        return np.asarray(base, dtype=np.float64)

    def measure_final(self, config: Config, repeats: int = 10) -> float:
        base = runtime_model(self.workload, self.chip, config)
        if not self.noise:
            return base
        return float(np.median(base * self._noise_factors(repeats)))

    def provenance(self) -> dict:
        return {
            "backend": "costmodel",
            "kernel": self.workload.name,
            "chip": self.chip.name,
            "noise": bool(self.noise),
            "timer": "analytical",
        }


def executable_space(w: KernelWorkload, chip: ChipModel) -> SearchSpace:
    """The paper's 6-param space constrained to executable configs
    (given to non-SMBO methods only)."""
    params = [
        Param.int_range("t_x", 1, 16),
        Param.int_range("t_y", 1, 16),
        Param.int_range("t_z", 1, 16),
        Param.int_range("w_x", 1, 8),
        Param.int_range("w_y", 1, 8),
        Param.int_range("w_z", 1, 8),
    ]
    def fn(cfg: Config) -> bool:
        return is_executable(w, chip, cfg)

    # stable id so TuningSpec serialization can rebuild this space by name
    fn.constraint_id = f"vmem:{w.name}:{chip.name}"
    return SearchSpace(params, constraint=fn)


def true_optimum(w: KernelWorkload, chip: ChipModel) -> tuple[Config, float]:
    """Exhaustive noise-free optimum over the full 2,097,152-config space —
    used as the denominator of 'percentage of optimum' (paper Fig. 2).

    Vectorized sweep; ~2M model evaluations.
    """
    tx = np.arange(1, 17)
    ty = np.arange(1, 17)
    tz = np.arange(1, 17)
    wx = np.arange(1, 9)
    wy = np.arange(1, 9)
    wzv = np.arange(1, 9)
    TX, TY, TZ, WX, WY, WZ = np.meshgrid(tx, ty, tz, wx, wy, wzv, indexing="ij")
    flat = np.stack([a.ravel() for a in (TX, TY, TZ, WX, WY, WZ)], axis=1)
    times = runtime_model_batch(w, chip, flat)
    j = int(np.argmin(times))
    cfg = dict(zip(("t_x", "t_y", "t_z", "w_x", "w_y", "w_z"), map(int, flat[j]), strict=True))
    return cfg, float(times[j])


def mean_runtime_estimate(
    w: KernelWorkload, chip: ChipModel, n_probe: int = 256, seed: int = 0
) -> float:
    """Deterministic mean modelled runtime over a pseudo-random probe of the
    full 6-parameter grid — the per-sample duration scale the work-unit
    scheduler uses to predict unit costs before anything has run.

    A seeded generator over a fixed probe size makes the estimate a pure
    function of ``(workload, chip, n_probe, seed)``: two processes planning
    the same matrix predict identical unit costs and therefore build
    identical unit decompositions.  Invalid geometries contribute their
    ``FAILURE_RUNTIME`` penalty, exactly as a random searcher pays it.
    """
    rng = np.random.default_rng(seed)
    probe = np.stack(
        [
            rng.integers(1, 17, size=n_probe),   # t_x
            rng.integers(1, 17, size=n_probe),   # t_y
            rng.integers(1, 17, size=n_probe),   # t_z
            rng.integers(1, 9, size=n_probe),    # w_x
            rng.integers(1, 9, size=n_probe),    # w_y
            rng.integers(1, 9, size=n_probe),    # w_z
        ],
        axis=1,
    )
    return float(np.mean(runtime_model_batch(w, chip, probe)))


def runtime_model_batch(
    w: KernelWorkload, chip: ChipModel, params: np.ndarray
) -> np.ndarray:
    """Vectorized ``runtime_model`` over rows of (t_x,t_y,t_z,w_x,w_y,w_z).

    Keep in exact agreement with ``runtime_model`` (property-tested)."""
    p = np.asarray(params, dtype=np.float64)
    bm, bn, tz, wx, wy, wz = (
        8 * p[:, 0],
        128 * p[:, 1],
        p[:, 2],
        p[:, 3],
        p[:, 4],
        p[:, 5],
    )
    rows_step = bm * tz
    in_block = w.n_inputs * (rows_step + 2 * w.halo) * (bn + 2 * w.halo) * w.bpe
    out_block = w.n_outputs * rows_step * bn * w.bpe
    scratch = w.scratch_tiles * bm * bn * w.bpe
    vmem = (in_block + out_block) * wz + scratch
    ok = vmem <= chip.vmem_bytes

    region_rows = np.ceil(w.x / wx)
    region_cols = np.ceil(w.y / wy)
    steps_r = np.ceil(region_rows / rows_step)
    steps_c = np.ceil(region_cols / bn)
    n_steps = wx * wy * steps_r * steps_c

    elems = rows_step * bn
    in_bytes = in_block
    out_bytes = out_block
    n_rows_dma = w.n_inputs * (rows_step + 2 * w.halo) + w.n_outputs * rows_step
    dma_t = (
        (in_bytes + out_bytes) / chip.hbm_bw
        + n_rows_dma * ROW_DESCRIPTOR_S
        + chip.dma_setup_s
    )
    compute_t = elems * w.flops_per_elem / chip.vpu_flops_f32

    bubble = np.where(wz == 2, 0.05, np.where(wz == 3, 0.02, 0.01))
    step_t = np.where(
        wz == 1, dma_t + compute_t, np.maximum(dma_t, compute_t) * (1.0 + bubble)
    )
    cores = w.n_cores_for(chip)
    parallel = np.minimum(wx * wy, cores)
    total = n_steps * step_t / parallel
    total += (wx * wy - 1) * 8.0 * chip.dma_setup_s
    total += wz * dma_t + chip.launch_s
    return np.where(ok, total, FAILURE_RUNTIME)
