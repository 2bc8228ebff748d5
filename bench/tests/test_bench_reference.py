"""The plain references against hand-worked small cases, their controls
against the references, and the roofline counts at 8192 x 8192."""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from bench.harness import layout, runner

HARRIS = layout.reference("harris")
MANDEL = layout.reference("mandelbrot")
H100 = layout.peaks()["NVIDIA H100 80GB HBM3"]


def harris_loops(img: np.ndarray, k: float = 0.04) -> np.ndarray:
    """The response written pixel by pixel in float64: zero extension by 2,
    Sobel cross-correlations, 3x3 box sums of the products, det - k tr^2."""
    x, y = img.shape
    p = np.zeros((x + 4, y + 4))
    p[2:-2, 2:-2] = img
    sx = ((-1, 0, 1), (-2, 0, 2), (-1, 0, 1))
    ix = np.zeros((x + 2, y + 2))
    iy = np.zeros((x + 2, y + 2))
    for i in range(x + 2):
        for j in range(y + 2):
            for a in range(3):
                for b in range(3):
                    ix[i, j] += sx[a][b] * p[i + a, j + b]
                    iy[i, j] += sx[b][a] * p[i + a, j + b]
    out = np.zeros((x, y))
    for i in range(x):
        for j in range(y):
            xx = (ix[i:i + 3, j:j + 3] ** 2).sum()
            yy = (iy[i:i + 3, j:j + 3] ** 2).sum()
            xy = (ix[i:i + 3, j:j + 3] * iy[i:i + 3, j:j + 3]).sum()
            out[i, j] = xx * yy - xy * xy - k * (xx + yy) ** 2
    return out


def test_harris_ramp_by_hand():
    """I[i, j] = j: inside, Ix = 8 (Sobel of a unit ramp), Iy = 0, so
    Sxx = 9 * 64, Syy = Sxy = 0 and R = 0 - (0.04 * 576) * 576, rounded
    to float32 as written."""
    img = torch.arange(12, dtype=torch.float32).repeat(10, 1)
    r = HARRIS.reference((img,), 10, 12, "cpu")
    assert r.shape == (10, 12)
    want = 0 - torch.tensor(0.04) * 576.0 * 576.0
    assert torch.all(r[2:-2, 2:-2] == want)


def test_harris_zero_image_and_transpose():
    assert torch.all(HARRIS.reference((torch.zeros(8, 9),), 8, 9, "cpu") == 0)
    img = torch.randn(9, 13, generator=torch.Generator().manual_seed(3))
    r = HARRIS.reference((img,), 9, 13, "cpu")
    rt = HARRIS.reference((img.T.contiguous(),), 13, 9, "cpu")
    assert torch.allclose(r.T, rt, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("shape", [(5, 7), (8, 3), (6, 6)])
def test_harris_against_loops(shape):
    img = torch.randn(*shape, generator=torch.Generator().manual_seed(sum(shape)))
    got = HARRIS.reference((img,), *shape, "cpu").double().numpy()
    want = harris_loops(img.double().numpy())
    assert np.max(np.abs(got - want)) / np.max(np.abs(want)) < 1e-5


def test_harris_control_fails_its_limit():
    img = torch.randn(64, 256, generator=torch.Generator().manual_seed(5))
    ref = HARRIS.reference((img,), 64, 256, "cpu")
    assert HARRIS.error(ref, ref) == 0
    assert HARRIS.error(HARRIS.control((img,), 64, 256, "cpu"), ref) > 100 * HARRIS.LIMIT


def mandel_loop(x: int, y: int) -> np.ndarray:
    """Escape counts pixel by pixel, each operation rounded to float32."""
    f = np.float32
    xmin, xmax, ymin, ymax = MANDEL.VIEW
    out = np.zeros((x, y))
    for i in range(x):
        for j in range(y):
            cr = f(xmin) + (f(j) + f(0.5)) * f((xmax - xmin) / y)
            ci = f(ymin) + (f(i) + f(0.5)) * f((ymax - ymin) / x)
            zr = zi = f(0)
            n = 0
            for _ in range(MANDEL.MAX_ITER):
                if not (zr * zr + zi * zi < f(4)):
                    break
                zr, zi = zr * zr - zi * zi + cr, f(2) * zr * zi + ci
                n += 1
            out[i, j] = n
    return out


def test_mandelbrot_by_hand():
    """2 x 2: the top-left centre is c = -1.625 - 0.625i; |z|^2 reads 0,
    3.03, 2.37 and then 11.6, so it counts 3.  The top-right centre,
    c = 0.125 - 0.625i, lies in the set and counts all 64 trips."""
    r = MANDEL.reference((), 2, 2, "cpu")
    assert r[0, 0].item() == 3 and r[0, 1].item() == 64
    assert r[1, 0].item() == 3 and r[1, 1].item() == 64  # conjugate rows


@pytest.mark.parametrize("shape", [(3, 4), (7, 5)])
def test_mandelbrot_against_loop(shape):
    assert np.array_equal(MANDEL.reference((), *shape, "cpu").numpy(), mandel_loop(*shape))


def test_mandelbrot_control_fails_its_limit():
    ref = MANDEL.reference((), 64, 256, "cpu")
    assert MANDEL.error(ref, ref) == 0
    assert MANDEL.error(MANDEL.control((), 64, 256, "cpu"), ref) > MANDEL.LIMIT


def test_harris_bound_at_8192():
    """chip_smoke.py's bound: 2 x 4 bytes a pixel at 3.35 TB/s, 0.1603 ms."""
    nbytes, ops = HARRIS.counts(8192, 8192, None)
    ms, by = runner.roofline_bound(nbytes, ops, H100)
    assert by == "bytes" and math.isclose(ms, 0.16026, rel_tol=1e-4)


def test_mandelbrot_counts_by_hand():
    """Counts [[3, 64]]: 67 alive trips and one escape, 7 * 67 + 4 operations
    and 4 bytes a pixel."""
    nbytes, ops = MANDEL.counts(1, 2, torch.tensor([[3.0, 64.0]]))
    assert (nbytes, ops) == (8, 7 * 67 + 4)


@pytest.mark.cuda
def test_mandelbrot_bound_at_8192(cuda):
    """chip_smoke.py's PR 12 count on the card's reference: 0.1085 ms,
    bound by operations."""
    counts = MANDEL.reference((), 8192, 8192, "cuda")
    ms, by = runner.roofline_bound(*MANDEL.counts(8192, 8192, counts), H100)
    assert by == "operations" and math.isclose(ms, 0.1085, rel_tol=5e-3)
