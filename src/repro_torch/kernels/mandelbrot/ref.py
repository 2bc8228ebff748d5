"""Plain PyTorch version of the Mandelbrot benchmark (paper section V.D),
mirroring ``repro.kernels.mandelbrot.ref.mandelbrot_ref``: escape-iteration
counts over the classic view window, vectorized over the whole image with a
fixed-trip-count loop (escaped pixels freeze; no early exit)."""

from __future__ import annotations

import torch

VIEW = (-2.5, 1.0, -1.25, 1.25)  # xmin, xmax, ymin, ymax
MAX_ITER = 64


def mandelbrot_ref(x: int, y: int, max_iter: int = MAX_ITER, view=VIEW,
                   device="cpu") -> torch.Tensor:
    xmin, xmax, ymin, ymax = view
    f32 = torch.float32
    re = xmin + (torch.arange(y, dtype=f32, device=device) + 0.5) * ((xmax - xmin) / y)
    im = ymin + (torch.arange(x, dtype=f32, device=device) + 0.5) * ((ymax - ymin) / x)
    cre = re[None, :].expand(x, y)
    cim = im[:, None].expand(x, y)
    zr = torch.zeros((x, y), dtype=f32, device=device)
    zi = torch.zeros((x, y), dtype=f32, device=device)
    count = torch.zeros((x, y), dtype=f32, device=device)
    for _ in range(max_iter):
        alive = zr * zr + zi * zi < 4.0
        zr2 = zr * zr - zi * zi + cre
        zi2 = 2.0 * zr * zi + cim
        zr = torch.where(alive, zr2, zr)
        zi = torch.where(alive, zi2, zi)
        count = count + alive.to(f32)
    return count
