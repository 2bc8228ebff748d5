"""Plain reference of the Harris corner response (paper section V.D), frozen
from its definition: 3x3 Sobel gradients of the image zero-extended by 2,
the structure tensor's products, their 3x3 box sums, and
R = det(M) - k * trace(M)^2 with k = 0.04.  Written with slices in float32
(no convolution library, so no TF32 path exists); imports nothing of the
program.

``make_inputs`` is the benchmark's image, drawn on the device from the
run's seed; ``control`` is this reference in bfloat16, the nearest
precision below the configuration's float32: it must fail the comparison.
"""

from __future__ import annotations

import torch

K = 0.04
#: the number compared: max |out - ref| / max |ref| over the image
CHECK = "harris_rel_err"
#: set between the sound runs' largest reading and the bf16 control's
#: smallest, at the cell's size (PERF.md section 2)
LIMIT = 1e-4


def make_inputs(x: int, y: int, gen: torch.Generator, device) -> tuple:
    return (torch.randn((x, y), generator=gen, device=device, dtype=torch.float32),)


def _response(img: torch.Tensor) -> torch.Tensor:
    x, y = img.shape
    p = torch.zeros((x + 4, y + 4), dtype=img.dtype, device=img.device)
    p[2:-2, 2:-2] = img
    # Sobel as cross-correlations over the (x+2, y+2) ring
    left, right = p[:, :-2], p[:, 2:]
    dx = right - left                                   # (x+4, y+2)
    ix = dx[:-2] + 2 * dx[1:-1] + dx[2:]
    top, bottom = p[:-2], p[2:]
    dy = bottom - top                                   # (x+2, y+4)
    iy = dy[:, :-2] + 2 * dy[:, 1:-1] + dy[:, 2:]
    del p, dx, dy, left, right, top, bottom

    def box(a: torch.Tensor) -> torch.Tensor:
        rows = a[:-2] + a[1:-1] + a[2:]
        return rows[:, :-2] + rows[:, 1:-1] + rows[:, 2:]

    sxx = box(ix * ix)
    syy = box(iy * iy)
    sxy = box(ix * iy)
    del ix, iy
    trace = sxx + syy
    return (sxx * syy - sxy * sxy) - K * trace * trace


def reference(inputs: tuple, x: int, y: int, device) -> torch.Tensor:
    (img,) = inputs
    return _response(img.to(torch.float32))


def control(inputs: tuple, x: int, y: int, device) -> torch.Tensor:
    (img,) = inputs
    return _response(img.to(torch.bfloat16)).to(torch.float32)


def error(out: torch.Tensor, ref: torch.Tensor) -> float:
    scale = ref.abs().max()
    return float(((out - ref).abs().max() / scale).item())


def counts(x: int, y: int, ref: torch.Tensor) -> tuple[float, float]:
    """(bytes, f32 operations) the response needs: the image read once and
    the response written once; 15 operations a pixel of the (x+2)(y+2)
    gradient ring (two Sobels and three products) and 31 a pixel of the
    response (three 3x3 box sums and R)."""
    n = x * y
    return 2 * 4 * n, 15 * (x + 2) * (y + 2) + 31 * n
