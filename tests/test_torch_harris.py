"""The port's harris against the reference's Pallas harris (interpret mode),
on the same seeded numpy inputs, over the reference tests' sweep and
tolerance (max|out - ref| / max|ref| < 1e-5)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import harris as jax_harris
from repro.kernels import harris_ref as jax_harris_ref
from repro_torch.kernels import harris

CONFIGS = [
    {},
    dict(t_x=2, t_y=1, t_z=2, w_x=2, w_y=2, w_z=2),
    dict(t_x=1, t_y=2, t_z=3, w_x=3, w_y=1, w_z=1),
    dict(t_x=4, t_y=1, t_z=1, w_x=1, w_y=4, w_z=4),
]
SHAPES = [(64, 128), (128, 256), (96, 384), (40, 128)]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("cfg", CONFIGS)
def test_harris_matches_reference(shape, cfg):
    rng = np.random.default_rng(1)
    img = rng.normal(size=shape).astype(np.float32)
    ref = np.asarray(jax_harris(jnp.asarray(img), cfg))
    out = harris(torch.from_numpy(img), cfg).numpy()
    assert out.shape == shape
    assert np.abs(out - ref).max() / np.abs(ref).max() < 1e-5


@pytest.mark.parametrize("shape", [(56, 200), (8, 130)])
def test_harris_ragged_matches_reference_oracle(shape):
    rng = np.random.default_rng(3)
    img = rng.normal(size=shape).astype(np.float32)
    ref = np.asarray(jax_harris_ref(jnp.asarray(img)))
    out = harris(torch.from_numpy(img), dict(t_x=3, t_y=2, w_y=3)).numpy()
    assert np.abs(out - ref).max() / np.abs(ref).max() < 1e-5


def test_harris_rejects_other_dtypes():
    with pytest.raises(TypeError):
        harris(torch.ones(8, 128, dtype=torch.float64))
