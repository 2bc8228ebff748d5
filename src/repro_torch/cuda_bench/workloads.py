"""Workload plumbing: materialize deterministic per-kernel problems (a port
of ``repro.pallas_bench.workloads``).

A :class:`CudaWorkload` binds one kernel's :class:`KernelBenchSpec` to a
concrete image size and input seed.  Inputs are drawn exactly as the
reference draws them — ``np.random.default_rng(stable_seed("pallas_inputs",
name, x, y, input_seed))``, ``standard_normal``, cast to float32 — and only
then become tensors, so :meth:`CudaWorkload.materialize` is byte-identical to
the reference's for the same fields.  The measurement stages them in an
``inputs`` stage of its own; ``materialize(device, timings)`` splits that
stage into the numpy draw and the copy to the device.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..core.clock import monotonic
from ..core.measurement import fence
from ..core.runner import stable_seed
from ..kernels import KERNEL_BENCHES
from ..kernels.common import Config, KernelBenchSpec

#: default problem size on the card: 8192x8192 f32, the image of the cost
#: model's KernelWorkload.  Each array is 268 MB, well past the 50 MB L2.
DEFAULT_X = 8192
DEFAULT_Y = 8192


@dataclass(frozen=True)
class CudaWorkload:
    """One kernel bound to a concrete problem: the unit cuda_bench measures."""

    bench: KernelBenchSpec = field(repr=False)
    x: int = DEFAULT_X
    y: int = DEFAULT_Y
    input_seed: int = 0

    @property
    def name(self) -> str:
        return self.bench.name

    def arrays(self) -> tuple[np.ndarray, ...]:
        """Deterministic numpy inputs (pure function of the workload fields)."""
        seed = stable_seed("pallas_inputs", self.name, self.x, self.y, self.input_seed)
        return tuple(self.bench.make_inputs(self.x, self.y, seed))

    def materialize(self, device, timings: dict | None = None) -> tuple[torch.Tensor, ...]:
        """The inputs as tensors on ``device``, the copy waited for (always
        named: a caller who forgets it must not land on the CPU without a
        word).

        ``timings``, when given, receives ``draw_s`` (the numpy draw,
        :meth:`arrays`) and ``copy_s`` (the copy to ``device``); the tensors
        are the same either way."""
        t0 = monotonic()
        arrays = self.arrays()
        t1 = monotonic()
        out = tuple(torch.from_numpy(a).to(device) for a in arrays)
        for t in out:
            fence(t)
        if timings is not None:
            timings.update(draw_s=t1 - t0, copy_s=monotonic() - t1)
        return out

    def run(self, inputs: tuple, cfg: Config, device):
        """Launch the kernel; returns its (possibly in-flight) output.  The
        measurement layer owns fencing and timing."""
        return self.bench.run(inputs, cfg, self.x, self.y, device)


def make_workload(
    kernel: str,
    x: int = DEFAULT_X,
    y: int = DEFAULT_Y,
    input_seed: int = 0,
) -> CudaWorkload:
    """Resolve a kernel id to a measurable workload."""
    if kernel not in KERNEL_BENCHES:
        raise KeyError(
            f"unknown kernel {kernel!r}; have {sorted(KERNEL_BENCHES)}"
        )
    if x < 8 or y < 128:
        raise ValueError(
            f"problem size ({x}, {y}) below the minimum f32 tile (8, 128)"
        )
    return CudaWorkload(bench=KERNEL_BENCHES[kernel], x=int(x), y=int(y),
                        input_seed=int(input_seed))
