"""Public wrapper for the tunable add kernel (``csrc/add.cu``).

``add(a, b, config)`` takes the paper's 6-param config (a missing param is
1).  On CUDA tensors it launches the hand-written kernel, and raises if the
launch is refused; on CPU tensors it computes the plain version ``add_ref``.
The kernel moves 16 bytes per access where every row starts 16-byte
aligned (:func:`vector_path`) and one element per access elsewhere; both
paths are the same launch.
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


def vector_path(a: torch.Tensor, b: torch.Tensor, out: torch.Tensor) -> bool:
    """Whether the kernel may move 16 bytes per access: every row of the
    three (contiguous) arrays starts 16-byte aligned, so all three pointers
    are aligned and a row holds a whole number of 16-byte vectors."""
    per_vector = 16 // a.element_size()
    return (a.shape[-1] % per_vector == 0
            and all(t.data_ptr() % 16 == 0 for t in (a, b, out)))


def launch_args(x: int, y: int, config: Config | None, vector: bool) -> tuple[int, ...]:
    """The integer arguments of ``repro_add_*`` between the pointers and the
    device: the image, the launch plan of ``config`` and the path."""
    plan = launch_plan(geometry_from_config(config or {}), x, y)
    return (x, y, plan.bm, plan.tz, plan.cols, plan.nblk_r, plan.nblk_c,
            *plan.grid, int(vector))


def add(a: torch.Tensor, b: torch.Tensor, config: Config | None = None) -> torch.Tensor:
    """Tunable-config elementwise add: config holds the paper's 6 params."""
    _check(a, b)
    if a.device.type == "cpu":
        return add_ref(a, b)
    if not a.is_cuda:
        raise ValueError(f"add: unsupported device {a.device}")
    out = torch.empty_like(a)
    launch(
        _LAUNCHERS[a.dtype],
        a.data_ptr(), b.data_ptr(), out.data_ptr(),
        *launch_args(*a.shape, config, vector_path(a, b, out)),
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
