"""Public wrapper for the tunable Mandelbrot kernel (``csrc/mandelbrot.cu``).

The kernel has no input tensor, so ``device`` says where the image is made:
on a CUDA device ``mandelbrot`` launches the hand-written kernel, on the CPU
it computes the plain version.
"""

from __future__ import annotations

import numpy as np
import torch

from .._build import launch
from ..common import Config, KernelBenchSpec, LaunchCounter, geometry_from_config, launch_plan
from .ref import MAX_ITER, VIEW, mandelbrot_ref

launches = LaunchCounter()


def launch_args(x: int, y: int, config: Config | None, max_iter: int = MAX_ITER) -> tuple:
    """The arguments of ``repro_mandelbrot_f32`` between the output pointer
    and the device: the image, the launch plan of ``config``, the trip
    count and the view."""
    plan = launch_plan(geometry_from_config(config or {}), x, y)
    xmin, xmax, ymin, ymax = VIEW
    return (
        x, y, plan.bm, plan.tz, plan.cols, plan.nblk_r, plan.nblk_c, *plan.grid,
        int(max_iter),
        # the view's steps in f32, as the reference's weak-typed
        # python floats meet its f32 iota
        float(np.float32(xmin)), float(np.float32(ymin)),
        float(np.float32((xmax - xmin) / y)), float(np.float32((ymax - ymin) / x)),
    )


def mandelbrot(x: int, y: int, config: Config | None = None,
               max_iter: int = MAX_ITER, device="cuda") -> torch.Tensor:
    device = torch.device(device)
    if x < 1 or y < 1:
        raise ValueError(f"mandelbrot: need a non-empty image, got ({x}, {y})")
    if device.type == "cpu":
        return mandelbrot_ref(x, y, max_iter, device=device)
    if device.type != "cuda":
        raise ValueError(f"mandelbrot: unsupported device {device}")
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    out = torch.empty((x, y), dtype=torch.float32, device=device)
    launch(
        "repro_mandelbrot_f32", out.data_ptr(), *launch_args(x, y, config, max_iter),
        device.index, torch.cuda.current_stream(device).cuda_stream,
    )
    launches.add()
    return out


#: generator kernel — no input arrays; the image size IS the problem
BENCH = KernelBenchSpec(
    name="mandelbrot",
    n_inputs=0,
    make_inputs=lambda x, y, seed: (),
    run=lambda inputs, cfg, x, y, device: mandelbrot(x, y, cfg, device=device),
)
