"""Public wrapper for the tunable Harris kernel (``csrc/harris.cu``).

On CUDA tensors ``harris(img, config)`` launches the hand-written kernel,
which masks the ragged edge itself (the reference pads rows to the band
height instead); on CPU tensors it computes the plain version.  Unlike the
reference's full-width bands, the kernel tiles both axes, so t_y and w_y
shape its launch.  The kernel itself chooses 16-byte or 4-byte copies from
the image's row width and alignment.
"""

from __future__ import annotations

import numpy as np
import torch

from .._build import launch
from ..common import Config, KernelBenchSpec, LaunchCounter, geometry_from_config, launch_plan
from .ref import HARRIS_K, harris_ref

#: static shared memory of one block: a ring of 4 groups of 4 staged input
#: rows, each 128 + 2 * 4 f32 wide (checked against the compiled kernel on
#: the card)
SMEM_BYTES = 4 * (4 * 4 * 136)

launches = LaunchCounter()


def launch_args(x: int, y: int, config: Config | None) -> tuple[int, ...]:
    """The integer arguments of ``repro_harris_f32`` between the pointers and
    ``k``: the image and the launch plan of ``config``."""
    plan = launch_plan(geometry_from_config(config or {}), x, y)
    return (x, y, plan.rows, plan.cols, plan.nblk_r, plan.nblk_c, *plan.grid)


def harris(img: torch.Tensor, config: Config | None = None, k: float = HARRIS_K) -> torch.Tensor:
    if img.dtype != torch.float32:
        raise TypeError(f"harris: dtype {img.dtype}; need torch.float32")
    if img.dim() != 2 or img.numel() == 0:
        raise ValueError(f"harris: need a non-empty 2-D image, got {tuple(img.shape)}")
    if not img.is_contiguous():
        raise ValueError("harris: image must be contiguous")
    if img.device.type == "cpu":
        return harris_ref(img, k)
    if not img.is_cuda:
        raise ValueError(f"harris: unsupported device {img.device}")
    out = torch.empty_like(img)
    launch(
        "repro_harris_f32",
        img.data_ptr(), out.data_ptr(), *launch_args(*img.shape, config), float(k),
        img.device.index, torch.cuda.current_stream(img.device).cuda_stream,
    )
    launches.add()
    return out


def _bench_inputs(x: int, y: int, seed: int) -> tuple:
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((x, y)).astype(np.float32),)


#: input model for the measurement backend (cuda_bench)
BENCH = KernelBenchSpec(
    name="harris",
    n_inputs=1,
    make_inputs=_bench_inputs,
    run=lambda inputs, cfg, x, y, device: harris(inputs[0], cfg),
    smem_bytes=SMEM_BYTES,
)
