"""Plain reference of the Add benchmark (paper section V.D: a vector
addition, which ImageCL treats as 2-D images), frozen from its definition:
C = A + B element by element in float32, one rounding a sum.  Imports
nothing of the program.

``make_inputs`` is the benchmark's two images, drawn on the device from
the run's seed; ``control`` is the same sum in bfloat16, the nearest
precision below the configuration's float32: it must fail the comparison.
"""

from __future__ import annotations

import torch

#: the number compared: elements whose value differs from the reference's
CHECK = "add_mismatch"
#: an exact comparison: the kernel rounds each sum once in float32, as the
#: plain sum does
LIMIT = 0


def make_inputs(x: int, y: int, gen: torch.Generator, device) -> tuple:
    return tuple(torch.randn((x, y), generator=gen, device=device, dtype=torch.float32)
                 for _ in range(2))


def reference(inputs: tuple, x: int, y: int, device) -> torch.Tensor:
    a, b = inputs
    return a.to(torch.float32) + b.to(torch.float32)


def control(inputs: tuple, x: int, y: int, device) -> torch.Tensor:
    a, b = inputs
    return (a.to(torch.bfloat16) + b.to(torch.bfloat16)).to(torch.float32)


def error(out: torch.Tensor, ref: torch.Tensor) -> float:
    return float((out != ref).sum().item())


def counts(x: int, y: int, ref: torch.Tensor) -> tuple[float, float]:
    """(bytes, f32 operations) the sum needs: two images read once and one
    written once, 4 bytes an element each; one addition an element."""
    n = x * y
    return 3 * 4 * n, n
