"""The port's add against the reference's Pallas add (interpret mode), on the
same seeded numpy inputs, over the reference tests' shape x config sweep and
tolerance (rtol = atol = 1e-6).  On CPU tensors the port's wrapper computes
its plain version; the CUDA kernel itself is held to that plain version on
the card (tests/test_torch_cuda.py, chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import add as jax_add
from repro_torch.interop import inputs_from_numpy
from repro_torch.kernels import LAUNCHES, add

CONFIGS = [
    {},
    dict(t_x=2, t_y=1, t_z=2, w_x=2, w_y=2, w_z=2),
    dict(t_x=1, t_y=2, t_z=3, w_x=3, w_y=1, w_z=1),
    dict(t_x=4, t_y=1, t_z=1, w_x=1, w_y=4, w_z=4),
]
SHAPES = [(64, 128), (128, 256), (96, 384), (40, 128)]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("cfg", CONFIGS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_add_matches_reference(shape, cfg, dtype):
    rng = np.random.default_rng(0)
    a = jnp.asarray(rng.normal(size=shape), dtype)
    b = jnp.asarray(rng.normal(size=shape), dtype)
    ref = np.asarray(jax_add(a, b, cfg), np.float32)
    ta, tb = inputs_from_numpy([np.asarray(a), np.asarray(b)], "cpu")
    assert ta.dtype == getattr(torch, dtype)
    out = add(ta, tb, cfg)
    assert out.dtype == ta.dtype and out.shape == shape
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=1e-6, atol=1e-6)


def test_add_odd_shape_matches_reference():
    rng = np.random.default_rng(2)
    a = rng.normal(size=(56, 200)).astype(np.float32)
    b = rng.normal(size=(56, 200)).astype(np.float32)
    cfg = dict(t_x=3, t_y=1, t_z=2, w_x=2, w_y=3)
    ref = np.asarray(jax_add(jnp.asarray(a), jnp.asarray(b), cfg))
    out = add(torch.from_numpy(a), torch.from_numpy(b), cfg)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6)


def test_add_cpu_path_is_not_counted_as_a_launch():
    before = LAUNCHES["add"].n
    add(torch.ones(8, 128), torch.ones(8, 128))
    assert LAUNCHES["add"].n == before


@pytest.mark.parametrize(
    "a, b, err",
    [
        (torch.ones(8, 128), torch.ones(8, 128, dtype=torch.float64), TypeError),
        (torch.ones(8, 128, dtype=torch.int32), torch.ones(8, 128, dtype=torch.int32), TypeError),
        (torch.ones(8, 128), torch.ones(8, 256), ValueError),
        (torch.ones(8, 128, 2), torch.ones(8, 128, 2), ValueError),
        (torch.ones(128, 8).T, torch.ones(128, 8).T, ValueError),
        (torch.ones(0, 128), torch.ones(0, 128), ValueError),
    ],
)
def test_add_rejects_what_the_kernel_does_not_take(a, b, err):
    with pytest.raises(err):
        add(a, b)
