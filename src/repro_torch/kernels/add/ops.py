"""Public wrapper for the tunable add kernel (``csrc/add.cu``).

``add(a, b, config)`` takes the paper's 6-param config (a missing param is
1).  On CUDA tensors it launches the hand-written kernel, and raises if the
launch is refused; on CPU tensors it computes the plain version ``add_ref``.
"""

from __future__ import annotations

import numpy as np
import torch

from .._build import launch
from ..common import Config, KernelBenchSpec, LaunchCounter, geometry_from_config, launch_plan
from .ref import add_ref

DTYPES = (torch.float32, torch.bfloat16)
_LAUNCHERS = {torch.float32: "repro_add_f32", torch.bfloat16: "repro_add_bf16"}

#: launches of the CUDA kernel (never counts the CPU path)
launches = LaunchCounter()


def _check(a: torch.Tensor, b: torch.Tensor) -> None:
    if a.device != b.device:
        raise ValueError(f"add: inputs on {a.device} and {b.device}")
    if a.dtype != b.dtype or a.dtype not in DTYPES:
        raise TypeError(f"add: dtypes {a.dtype}, {b.dtype}; need one of {DTYPES}")
    if a.dim() != 2 or a.shape != b.shape or a.numel() == 0:
        raise ValueError(f"add: need two equal non-empty 2-D shapes, got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("add: inputs must be contiguous")


def add(a: torch.Tensor, b: torch.Tensor, config: Config | None = None) -> torch.Tensor:
    """Tunable-config elementwise add: config holds the paper's 6 params."""
    _check(a, b)
    if a.device.type == "cpu":
        return add_ref(a, b)
    if not a.is_cuda:
        raise ValueError(f"add: unsupported device {a.device}")
    x, y = a.shape
    plan = launch_plan(geometry_from_config(config or {}), x, y)
    out = torch.empty_like(a)
    launch(
        _LAUNCHERS[a.dtype],
        a.data_ptr(), b.data_ptr(), out.data_ptr(), x, y,
        plan.bm, plan.tz, plan.cols, plan.nblk_r, plan.nblk_c, *plan.grid,
        a.device.index, torch.cuda.current_stream(a.device).cuda_stream,
    )
    launches.add()
    return out


def _bench_inputs(x: int, y: int, seed: int) -> tuple:
    rng = np.random.default_rng(seed)
    return (
        rng.standard_normal((x, y)).astype(np.float32),
        rng.standard_normal((x, y)).astype(np.float32),
    )


#: input model for the measurement backend (cuda_bench)
BENCH = KernelBenchSpec(
    name="add",
    n_inputs=2,
    make_inputs=_bench_inputs,
    run=lambda inputs, cfg, x, y, device: add(inputs[0], inputs[1], cfg),
)
