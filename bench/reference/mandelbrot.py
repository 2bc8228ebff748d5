"""Plain reference of the Mandelbrot benchmark (paper section V.D), frozen
from its definition: escape counts over the view [-2.5, 1] x [-1.25, 1.25]
at pixel centres, at most 64 trips, z <- z^2 + c while |z|^2 < 4, every
operation rounded to float32 in the written order.  Imports nothing of the
program.

The kernel has no input: ``make_inputs`` returns none.  ``control`` is the
same loop in bfloat16, the nearest precision below the configuration's
float32: it must fail the comparison.
"""

from __future__ import annotations

import torch

VIEW = (-2.5, 1.0, -1.25, 1.25)  # xmin, xmax, ymin, ymax
MAX_ITER = 64
#: the number compared: pixels whose count differs from the reference's
CHECK = "mandelbrot_mismatch"
#: an exact comparison
LIMIT = 0


def make_inputs(x: int, y: int, gen: torch.Generator, device) -> tuple:
    return ()


def _counts(x: int, y: int, dtype, device) -> torch.Tensor:
    xmin, xmax, ymin, ymax = VIEW
    f32 = torch.float32
    re = xmin + (torch.arange(y, dtype=f32, device=device) + 0.5) * ((xmax - xmin) / y)
    im = ymin + (torch.arange(x, dtype=f32, device=device) + 0.5) * ((ymax - ymin) / x)
    cre = re.to(dtype)[None, :].expand(x, y)
    cim = im.to(dtype)[:, None].expand(x, y)
    zr = torch.zeros((x, y), dtype=dtype, device=device)
    zi = torch.zeros((x, y), dtype=dtype, device=device)
    count = torch.zeros((x, y), dtype=f32, device=device)
    for _ in range(MAX_ITER):
        alive = zr * zr + zi * zi < 4.0
        zr2 = zr * zr - zi * zi + cre
        zi2 = 2.0 * zr * zi + cim
        zr = torch.where(alive, zr2, zr)
        zi = torch.where(alive, zi2, zi)
        count = count + alive.to(f32)
    return count


def reference(inputs: tuple, x: int, y: int, device) -> torch.Tensor:
    return _counts(x, y, torch.float32, device)


def control(inputs: tuple, x: int, y: int, device) -> torch.Tensor:
    return _counts(x, y, torch.bfloat16, device)


def error(out: torch.Tensor, ref: torch.Tensor) -> float:
    return float((out != ref).sum().item())


def counts(x: int, y: int, ref: torch.Tensor) -> tuple[float, float]:
    """(bytes, f32 operations) these counts need: the image written once;
    7 operations a trip a pixel is alive (zr*zr, zi*zi, their difference,
    + cre, 2*zr, * zi, + cim) and 4 for the test an escaping pixel fails
    (its two squares, their sum, the compare)."""
    alive_trips = float(ref.double().sum().item())
    escaped = float((ref < MAX_ITER).sum().item())
    return 4 * x * y, 7 * alive_trips + 4 * escaped
