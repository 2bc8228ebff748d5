"""The port's mandelbrot against the reference's Pallas mandelbrot
(interpret mode), with the reference's discrete-boundary tolerance: escape
counts are chaotic at the set boundary, so >= 99.5% of pixels must agree
exactly and none may differ by more than 4 iterations."""

import numpy as np
import pytest

from repro.kernels import mandelbrot as jax_mandelbrot
from repro_torch.kernels import mandelbrot

CONFIGS = [
    {},
    dict(t_x=2, t_y=1, t_z=2, w_x=2, w_y=2, w_z=2),
    dict(t_x=1, t_y=2, t_z=3, w_x=3, w_y=1, w_z=1),
    dict(t_x=4, t_y=1, t_z=1, w_x=1, w_y=4, w_z=4),
]


@pytest.mark.parametrize("shape", [(64, 128), (96, 256), (50, 130)])
@pytest.mark.parametrize("cfg", CONFIGS)
def test_mandelbrot_matches_reference(shape, cfg):
    x, y = shape
    ref = np.asarray(jax_mandelbrot(x, y, cfg))
    out = mandelbrot(x, y, cfg, device="cpu").numpy()
    assert out.shape == shape and out.dtype == np.float32
    assert (out == ref).mean() >= 0.995
    assert np.abs(out - ref).max() <= 4


def test_mandelbrot_interior_is_max_iter():
    out = mandelbrot(64, 64, max_iter=32, device="cpu").numpy()
    ref = np.asarray(jax_mandelbrot(64, 64, max_iter=32))
    # the middle of the classic view contains the set -> full iteration count
    assert out.max() == ref.max() == 32


def test_mandelbrot_rejects_an_empty_image():
    with pytest.raises(ValueError):
        mandelbrot(0, 128, device="cpu")
