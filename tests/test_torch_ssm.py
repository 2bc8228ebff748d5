"""The port's Mamba-2 / SSD layer (``repro_torch.models.mamba2``) against the
reference's, on numpy-seeded inputs on the CPU.

Tolerances:
* ``_segsum``: below the diagonal max|Δ| <= 1e-6 of max|ref|, -inf above it
  exactly; its ``exp`` has finite gradients;
* ``softplus``: 1e-6 relative to ``jax.nn.softplus``;
* ``ssd_chunked``: against the reference max|Δ|/max|ref| <= 1e-5, and
  against the naive per-token recurrence (float64) at the reference test's
  rtol / atol 2e-3;
* the causal depthwise conv in fp32: equal to the reference's, bit for bit;
* ``mamba2_forward`` in fp32: max|Δ|/max|ref| <= 1e-5; ``mamba2_decode``
  steps against the reference's steps <= 1e-5 (conv tail and state <= 1e-5
  of their largest values) and against the port's own forward at the reference test's
  rtol / atol 5e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.mamba2 as RM
import repro_torch.models.mamba2 as TM
from repro.models.param import init_params as ref_init
from repro.models.ssm import mamba_layer_spec as ref_layer_spec
from repro_torch.interop import params_from_numpy
from repro_torch.models.ssm import mamba_layer_spec


def rel(got: torch.Tensor, ref) -> float:
    got, ref = got.detach().float().numpy(), np.asarray(ref, np.float32)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def test_segsum_matches_and_masks_before_exp():
    x = np.random.default_rng(0).uniform(-2, 0, size=(2, 3, 16)).astype(np.float32)
    ref = np.asarray(RM._segsum(jnp.asarray(x)))
    got = TM._segsum(torch.from_numpy(x)).numpy()
    below = np.isfinite(ref)
    assert np.array_equal(below, np.isfinite(got))
    assert np.array_equal(below, np.broadcast_to(np.tri(16, dtype=bool), below.shape))
    assert np.abs(got[below] - ref[below]).max() <= 1e-6 * np.abs(ref[below]).max()
    assert (got[~below] == -np.inf).all()
    # large steps overflow an exp taken before masking; masked first, the
    # gradient stays finite
    tx = (torch.from_numpy(x) * 50).requires_grad_(True)
    torch.exp(TM._segsum(tx)).sum().backward()
    assert torch.isfinite(tx.grad).all()


def test_softplus_is_jax_softplus():
    x = np.linspace(-40, 40, 1001).astype(np.float32)
    ref = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    got = TM.softplus(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)


def ssd_inputs(seq, seed=0, bs=2, h=3, p=8, n=4, g=1):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(bs, seq, h, p)).astype(np.float32),
            rng.uniform(0.01, 0.2, size=(bs, seq, h)).astype(np.float32),
            rng.uniform(-1, 0.5, size=(h,)).astype(np.float32),
            rng.normal(size=(bs, seq, g, n)).astype(np.float32),
            rng.normal(size=(bs, seq, g, n)).astype(np.float32))


def naive_ssm_recurrence(x, dt, a_log, b, c):
    """The reference test's per-token state-space recurrence (float64)."""
    bs, s, h, p = x.shape
    A = -np.exp(a_log.astype(np.float64))
    state = np.zeros((bs, h, p, b.shape[-1]))
    out = np.zeros(x.shape)
    for t in range(s):
        decay = np.exp(dt[:, t].astype(np.float64) * A[None, :])
        upd = np.einsum("bh,bhp,bn->bhpn", dt[:, t], x[:, t], b[:, t, 0])
        state = state * decay[..., None, None] + upd
        out[:, t] = np.einsum("bhpn,bn->bhp", state, c[:, t, 0])
    return out


@pytest.mark.parametrize("seq,chunk", [(64, 16), (96, 32), (128, 128)])
def test_ssd_chunked_matches_reference_and_recurrence(seq, chunk):
    args = ssd_inputs(seq)
    ref = np.asarray(RM.ssd_chunked(*map(jnp.asarray, args), chunk))
    got = TM.ssd_chunked(*map(torch.from_numpy, args), chunk)
    assert got.dtype == torch.float32 and rel(got, ref) <= 1e-5
    np.testing.assert_allclose(got.numpy().astype(np.float64), naive_ssm_recurrence(*args),
                               rtol=2e-3, atol=2e-3)


def test_ssd_chunked_groups_and_bf16():
    """Two B/C groups over four heads; bf16 inputs come back bf16 from the
    fp32 islands, within bf16's rounding of the reference's."""
    args = ssd_inputs(64, seed=1, h=4, g=2)
    ref = RM.ssd_chunked(*map(jnp.asarray, args), 16)
    got = TM.ssd_chunked(*map(torch.from_numpy, args), 16)
    assert rel(got, ref) <= 1e-5
    x16 = torch.from_numpy(args[0]).to(torch.bfloat16)
    ref16 = RM.ssd_chunked(jnp.asarray(args[0], jnp.bfloat16), *map(jnp.asarray, args[1:]), 16)
    got16 = TM.ssd_chunked(x16, *map(torch.from_numpy, args[1:]), 16)
    assert got16.dtype == torch.bfloat16 and rel(got16, ref16) <= 1e-2
    with pytest.raises(ValueError, match="divisible"):
        TM.ssd_chunked(*map(torch.from_numpy, args), 24)


@pytest.mark.parametrize("dtype", [np.float32, "bf16"])
def test_causal_conv_is_exact_in_fp32(dtype):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 13, 40)).astype(np.float32)
    w = rng.normal(size=(4, 40)).astype(np.float32)
    if dtype != np.float32:
        x = np.asarray(jnp.asarray(x, jnp.bfloat16))
    ref = np.asarray(RM._causal_depthwise_conv(jnp.asarray(x), jnp.asarray(w)))
    got = TM._causal_depthwise_conv(params_from_numpy(x, "cpu"), torch.from_numpy(w))
    assert got.dtype == torch.float32 and np.array_equal(got.numpy(), ref)


DIMS = dict(d_model=32, d_state=8, d_conv=4, expand=2, head_dim=8, n_groups=1, chunk=16)


def layer_params(dims, seed=42):
    """Layer 0 of the reference's ``mamba_layer_spec`` init, with ``a_log``,
    ``dt_bias`` and ``d_skip`` drawn so every term matters, and both packages'
    specs equal."""
    spec = ref_layer_spec(1, RM.SSMDims(**dims))
    assert {k: (p.shape, p.axes, p.init) for k, p in spec.items()} == {
        k: (p.shape, p.axes, p.init) for k, p in mamba_layer_spec(1, TM.SSMDims(**dims)).items()}
    params = {k: np.asarray(v)[0] for k, v in ref_init(spec, jax.random.PRNGKey(seed)).items()}
    rng = np.random.default_rng(seed)
    h = params["a_log"].shape[0]
    params["a_log"] = rng.uniform(-1, 0.5, h).astype(np.float32)
    params["dt_bias"] = rng.uniform(-2, 0, h).astype(np.float32)
    params["d_skip"] = rng.uniform(0.5, 1.5, h).astype(np.float32)
    params.pop("pre_norm")
    return params


@pytest.mark.parametrize("seq", [32, 40])
def test_mamba2_forward_matches(seq):
    """seq 40 is not a multiple of the chunk: the reference calls the SSD with
    min(chunk, S) only, so S = 40 > 16 raises in both."""
    params = layer_params(DIMS)
    x = (np.random.default_rng(3).normal(size=(2, seq, 32)) * 0.3).astype(np.float32)
    tp = params_from_numpy(params, "cpu")
    if seq % DIMS["chunk"]:
        with pytest.raises(ValueError, match="divisible"):
            TM.mamba2_forward(torch.from_numpy(x), tp, TM.SSMDims(**DIMS))
        return
    ref = RM.mamba2_forward(jnp.asarray(x), params, RM.SSMDims(**DIMS))
    got = TM.mamba2_forward(torch.from_numpy(x), tp, TM.SSMDims(**DIMS))
    assert got.shape == (2, seq, 32) and rel(got, ref) <= 1e-5


@pytest.mark.parametrize("n_groups", [1, 2])
def test_mamba2_decode_steps_match_reference_and_forward(n_groups):
    dims = dict(DIMS, n_groups=n_groups)
    params = layer_params(dims, seed=7)
    rd, td = RM.SSMDims(**dims), TM.SSMDims(**dims)
    bs, s = 2, 32
    x = (np.random.default_rng(4).normal(size=(bs, s, 32)) * 0.3).astype(np.float32)
    ref_cache = {"conv": jnp.zeros((bs, 3, rd.conv_dim)),
                 "ssm": jnp.zeros((bs, rd.n_heads, rd.head_dim, rd.d_state))}
    cache = {"conv": torch.zeros((bs, 3, td.conv_dim)),
             "ssm": torch.zeros((bs, td.n_heads, td.head_dim, td.d_state))}
    tp = params_from_numpy(params, "cpu")
    step = jax.jit(lambda x, c: RM.mamba2_decode(x, params, rd, c))
    outs = []
    for t in range(s):
        ref, ref_cache = step(jnp.asarray(x[:, t:t + 1]), ref_cache)
        got, cache = TM.mamba2_decode(torch.from_numpy(x[:, t:t + 1]), tp, td, cache)
        assert rel(got, ref) <= 1e-5
        outs.append(got)
    assert rel(cache["ssm"], ref_cache["ssm"]) <= 1e-5
    assert rel(cache["conv"], ref_cache["conv"]) <= 1e-5
    full = TM.mamba2_forward(torch.from_numpy(x), tp, td)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), full.numpy(), rtol=5e-3, atol=5e-3)
