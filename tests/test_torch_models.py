"""The port's model stack (configs, specs, layers, the dense decoder) against
the reference's, at small sizes on the CPU.

Weights are the reference's ``init_params`` carried across byte for byte
(``repro_torch.interop.params_from_numpy``); inputs are drawn with numpy
from a seed.

Tolerances:
* configs, spec paths / shapes / axes / init kinds, ``param_count`` at full
  size: equal;
* layer functions: fp32 paths to 1e-5 relative, bf16 paths to
  max|Δ|/max|ref| <= 2e-2;
* whole-model forward and decode logits: in fp32 (both packages'
  ``COMPUTE_DTYPE`` set to float32) max|Δ|/max|ref| <= 5e-4, which holds the
  math; in bf16 per position (max over the vocabulary of |Δ| / max|ref|) a
  median <= 5e-3 and a max <= 0.15.  The reduced configs' attention is
  saturated (the ``scaled`` init divides ``wq`` by sqrt(heads), so scores
  run to ~1e2): most positions agree to bf16's rounding of the logits
  (2^-8 of the largest), and where one product rounds a last bit
  differently (the two packages' matmuls sum in different orders) a
  softmax can change its winner and move that position by a few percent;
* the port's own prefill/decode equivalence: the reference test's top-1 >=
  0.99 and correlation > 0.99; remat none/dots/full: rtol 1e-5.
"""

import collections
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import repro.configs as ref_configs
import repro.models.decoder as ref_decoder
import repro.models.layers as RL
import repro_torch.models.decoder as decoder
import repro_torch.models.layers as TL
from repro.models import build_model as ref_build
from repro.models import init_params as ref_init
from repro.models import param_count as ref_param_count
from repro.models.decoder import DecoderLM as RefDecoderLM
from repro.models.param import is_leaf as ref_is_leaf
from repro_torch import configs
from repro_torch.interop import inputs_from_numpy, params_from_numpy
from repro_torch.models import (
    DecoderLM,
    abstract_params,
    build_model,
    init_params,
    param_axes,
    param_count,
)
from repro_torch.tree import tree_from_paths, tree_leaves, tree_paths

RNG = jax.random.PRNGKey(42)
FORWARD_ARCHS = ["yi-34b", "granite-34b", "phi3-medium-14b", "chameleon-34b"]
DENSE_SPECS = ["yi-34b", "granite-34b", "phi3-medium-14b", "deepseek-coder-33b",
               "chameleon-34b"]


def rel(got: torch.Tensor, ref) -> float:
    got, ref = got.float().numpy(), np.asarray(ref, np.float32)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def per_position(got: torch.Tensor, ref) -> np.ndarray:
    got, ref = got.float().numpy(), np.asarray(ref, np.float32)
    return np.abs(got - ref).max(-1) / np.abs(ref).max()


def assert_bf16_positions(err: np.ndarray) -> None:
    assert np.median(err) <= 5e-3 and err.max() <= 0.15, np.round(err, 4)


def carried(name: str):
    """A reduced config's reference model and params, and the port's."""
    cfg = ref_configs.REGISTRY[name].reduced()
    ref_model = ref_build(cfg)
    ref_params = ref_init(ref_model.spec(), RNG)
    ours = params_from_numpy(jax.tree_util.tree_map(np.asarray, ref_params), "cpu")
    return ref_model, ref_params, build_model(configs.REGISTRY[name].reduced()), ours


@pytest.fixture
def fp32(monkeypatch):
    """Both packages compute in fp32: what is left is the math."""
    for mod in (RL, ref_decoder):
        monkeypatch.setattr(mod, "COMPUTE_DTYPE", jnp.float32)
    for mod in (TL, decoder):
        monkeypatch.setattr(mod, "COMPUTE_DTYPE", torch.float32)


# ---------------------------------------------------------------- configs


@pytest.mark.parametrize("name", sorted(ref_configs.REGISTRY))
def test_config_is_the_reference_config(name):
    ours, ref = configs.get_arch(name), ref_configs.get_arch(name)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert dataclasses.asdict(ours.reduced()) == dataclasses.asdict(ref.reduced())
    assert (ours.sub_quadratic, ours.has_decode) == (ref.sub_quadratic, ref.has_decode)
    assert configs.applicable_shapes(ours) == ref_configs.applicable_shapes(ref)


def test_registry_and_shapes_are_the_references():
    assert list(configs.REGISTRY) == list(ref_configs.REGISTRY)
    assert {k: dataclasses.asdict(v) for k, v in configs.SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in ref_configs.SHAPES.items()}
    with pytest.raises(KeyError, match="unknown arch"):
        configs.get_arch("gpt-5")


# ---------------------------------------------------------------- specs


@pytest.mark.parametrize("name", DENSE_SPECS + ["olmoe-1b-7b", "deepseek-v2-236b"])
def test_full_size_spec_is_the_references(name):
    ref_spec = RefDecoderLM(ref_configs.REGISTRY[name]).spec()
    spec = DecoderLM(configs.REGISTRY[name]).spec()
    ref_flat = {
        "/".join(str(k.key) for k in path): p
        for path, p in jax.tree_util.tree_flatten_with_path(ref_spec, is_leaf=ref_is_leaf)[0]
    }
    flat = tree_paths(spec)
    assert list(flat) == list(ref_flat)
    for key, p in flat.items():
        r = ref_flat[key]
        assert (p.shape, p.axes, p.init) == (r.shape, r.axes, r.init), key
        assert str(p.dtype).removeprefix("torch.") == np.dtype(r.dtype).name
    assert tree_paths(param_axes(spec)) == {
        k: p.axes for k, p in ref_flat.items()}
    metas = abstract_params(spec)
    assert all(t.device.type == "meta" for t in tree_leaves(metas))
    assert sum(t.numel() for t in tree_leaves(metas)) == param_count(spec)
    assert param_count(spec) == ref_param_count(ref_spec)
    if name == "yi-34b":     # 60 layers of 557,856,768 + embedding and head
        assert param_count(spec) == 60 * 557_856_768 + 2 * 458_752_000 + 7168


def test_init_params_draws_from_the_generator():
    spec = DecoderLM(configs.REGISTRY["yi-34b"].reduced()).spec()
    a = init_params(spec, torch.Generator().manual_seed(0), "cpu")
    b = init_params(spec, torch.Generator().manual_seed(0), "cpu")
    c = init_params(spec, torch.Generator().manual_seed(1), "cpu")
    for key, t in tree_paths(a).items():
        assert t.shape == tuple(tree_paths(spec)[key].shape) and t.dtype == torch.float32
        assert torch.equal(t, tree_paths(b)[key])
    assert not torch.equal(a["embed"], c["embed"])
    assert torch.equal(a["final_norm"], torch.ones(256))
    assert abs(a["embed"].std().item() - 0.02) < 2e-3


@pytest.mark.parametrize("name", ["mamba2-130m", "zamba2-1.2b", "whisper-medium",
                                  "olmoe-1b-7b", "deepseek-v2-236b"])
def test_unported_families_raise(name):
    cfg = configs.REGISTRY[name].reduced()
    with pytest.raises(NotImplementedError, match="6b"):
        build_model(cfg)
    if cfg.family in ("moe", "mla_moe"):
        model = DecoderLM(cfg)
        with pytest.raises(NotImplementedError, match="6b"):
            model.forward({}, torch.zeros((1, 4), dtype=torch.int64))
        with pytest.raises(NotImplementedError, match="6b"):
            model.init_cache(1, 4, device="cpu")


# ---------------------------------------------------------------- layers


def draws(seed, *shapes, dtype=np.float32, scale=1.0):
    rng = np.random.default_rng(seed)
    out = [(rng.normal(size=s) * scale).astype(np.float32) for s in shapes]
    if dtype != np.float32:
        out = [np.asarray(jnp.asarray(a, jnp.bfloat16)) for a in out]
    return out


@pytest.mark.parametrize("dtype", [np.float32, "bf16"])
def test_norms_match(dtype):
    x, s, b = draws(0, (2, 8, 64), (64,), (64,), dtype=dtype, scale=3.0)
    tx, ts, tb = inputs_from_numpy([x, s, b])
    tol = 1e-5 if dtype == np.float32 else 2e-2
    assert rel(TL.rms_norm(tx, ts), RL.rms_norm(x, s)) <= tol
    assert rel(TL.layer_norm(tx, ts, tb), RL.layer_norm(x, s, b)) <= tol
    assert TL.rms_norm(tx, ts).dtype == tx.dtype


@pytest.mark.parametrize("theta", [5e6, 1e5])
def test_rope_rotates_halves_like_the_reference(theta):
    (q,) = draws(1, (2, 16, 4, 64))
    pos = np.stack([np.arange(16), np.arange(16) + 7]).astype(np.int32)
    (tq,) = inputs_from_numpy([q])
    got = TL.apply_rope(tq, torch.from_numpy(pos).long(), theta)
    assert rel(got, RL.apply_rope(q, pos, theta)) <= 1e-5
    assert rel(TL.rope_freqs(64, theta), RL.rope_freqs(64, theta)) <= 1e-6


#: (heads, kv heads): GQA groups 1, 2 and 4, and MQA
HEADS = [(8, 8), (8, 4), (8, 2), (8, 1)]
#: (causal, q_offset, kv_len): kv_len 0 softmaxes to uniform, as -1e30 does
MASKS = [(True, 0, None), (True, 5, None), (False, 0, (7, 0)), (True, 3, (9, 1))]


@pytest.mark.parametrize("heads", HEADS)
@pytest.mark.parametrize("mask", MASKS)
@pytest.mark.parametrize("dtype", [np.float32, "bf16"])
def test_attention_matches(heads, mask, dtype):
    (h, hkv), (causal, q_offset, kv_len) = heads, mask
    q, k, v = draws(2, (2, 6, h, 32), (2, 12, hkv, 32), (2, 12, hkv, 32), dtype=dtype)
    kvl = None if kv_len is None else np.asarray(kv_len, np.int32)
    ref = RL.attention(q, k, v, causal=causal, q_offset=q_offset,
                       kv_len=None if kvl is None else jnp.asarray(kvl))
    tq, tk, tv = inputs_from_numpy([q, k, v])
    got = TL.attention(tq, tk, tv, causal=causal, q_offset=q_offset,
                       kv_len=None if kvl is None else torch.from_numpy(kvl))
    assert got.dtype == tq.dtype and torch.isfinite(got).all()
    assert rel(got, ref) <= (1e-5 if dtype == np.float32 else 2e-2)


def test_chunked_attention_matches():
    q, k, v = draws(3, (2, 32, 4, 16), (2, 32, 2, 16), (2, 32, 2, 16))
    ref = RL._chunked_attn(q, k, v, causal=True, q_chunk=8)
    tq, tk, tv = inputs_from_numpy([q, k, v])
    got = TL._chunked_attn(tq, tk, tv, causal=True, q_chunk=8)
    assert rel(got, ref) <= 1e-5
    assert rel(got, RL._dense_attn(q, k, v, causal=True)) <= 1e-5
    with pytest.raises(ValueError, match="divisible"):
        TL._chunked_attn(tq, tk, tv, causal=True, q_chunk=7)


@pytest.mark.parametrize("dtype", [np.float32, "bf16"])
def test_mlps_embed_and_head_match(dtype):
    x, wg, wu, wd, bu, bd = draws(4, (2, 8, 64), (64, 96), (64, 96), (96, 64), (96,),
                                  (64,), scale=0.5)
    if dtype != np.float32:
        (x,) = (np.asarray(jnp.asarray(x, jnp.bfloat16)),)
    tx, twg, twu, twd, tbu, tbd = inputs_from_numpy([x, wg, wu, wd, bu, bd])
    tol = 1e-5 if dtype == np.float32 else 2e-2
    assert rel(TL.swiglu(tx, twg, twu, twd), RL.swiglu(x, wg, wu, wd)) <= tol
    assert rel(TL.gelu_mlp(tx, twu, tbu, twd, tbd), RL.gelu_mlp(x, wu, bu, wd, bd)) <= tol
    table, head = draws(5, (50, 64), (64, 50))
    toks = np.random.default_rng(6).integers(0, 50, (2, 8))
    got = TL.embed(torch.from_numpy(toks), torch.from_numpy(table))
    ref = RL.embed(jnp.asarray(toks, jnp.int32), table)
    assert got.dtype == torch.bfloat16 and rel(got, ref) == 0.0
    assert rel(TL.lm_logits(tx, torch.from_numpy(head)), RL.lm_logits(x, head)) <= tol


# ---------------------------------------------------------------- the model


def tokens(cfg, seed=5, shape=(2, 16)):
    return np.random.default_rng(seed).integers(0, cfg.vocab, shape)


@pytest.mark.parametrize("name", FORWARD_ARCHS)
def test_forward_matches_the_reference(name):
    ref_model, ref_params, model, params = carried(name)
    toks = tokens(model.cfg)
    ref, ref_aux = ref_model.forward(ref_params, jnp.asarray(toks, jnp.int32))
    got, aux = model.forward(params, torch.from_numpy(toks))
    assert got.dtype == torch.bfloat16 and got.shape == (2, 16, model.cfg.vocab)
    assert float(aux) == float(ref_aux) == 0.0
    assert_bf16_positions(per_position(got, ref))


@pytest.mark.parametrize("name", ["yi-34b", "granite-34b"])
def test_forward_math_matches_in_fp32(name, fp32):
    ref_model, ref_params, model, params = carried(name)
    toks = tokens(model.cfg)
    ref, _ = ref_model.forward(ref_params, jnp.asarray(toks, jnp.int32))
    got, _ = model.forward(params, torch.from_numpy(toks))
    assert got.dtype == torch.float32 and rel(got, ref) <= 5e-4


@pytest.mark.parametrize("name", ["yi-34b", "granite-34b"])
def test_decode_steps_match_the_reference(name):
    ref_model, ref_params, model, params = carried(name)
    toks = tokens(model.cfg, seed=3, shape=(2, 10))
    ref_cache, cache = ref_model.init_cache(2, 16), model.init_cache(2, 16, device="cpu")
    assert {k: v.shape for k, v in cache.items()} == {
        k: v.shape for k, v in ref_cache.items()}
    assert model.cache_axes() == ref_model.cache_axes()
    step = jax.jit(ref_model.decode_step)
    errs = []
    for t in range(toks.shape[1]):
        ref, ref_cache = step(ref_params, ref_cache, jnp.full((2,), t, jnp.int32),
                              jnp.asarray(toks[:, t:t + 1], jnp.int32))
        with torch.no_grad():
            got, cache = model.decode_step(params, cache, torch.full((2,), t, dtype=torch.int32),
                                           torch.from_numpy(toks[:, t:t + 1]))
        errs.append(per_position(got, ref))
        assert cache["k"].dtype == torch.bfloat16
    assert_bf16_positions(np.concatenate(errs))
    assert rel(cache["k"], ref_cache["k"]) <= 2e-2


@pytest.mark.parametrize("name", ["yi-34b", "granite-34b", "chameleon-34b"])
def test_prefill_decode_equivalence(name):
    """Feeding tokens one at a time through decode_step reproduces
    forward()'s last-position logits (the reference test's criteria)."""
    model = build_model(configs.REGISTRY[name].reduced())
    params = init_params(model.spec(), torch.Generator().manual_seed(3), "cpu")
    toks = torch.from_numpy(tokens(model.cfg, seed=3, shape=(2, 12)))
    with torch.no_grad():
        full, _ = model.forward(params, toks)
        cache = model.init_cache(2, 16, device="cpu")
        for t in range(12):
            last, cache = model.decode_step(params, cache, torch.full((2,), t), toks[:, t:t + 1])
    got, want = last[:, 0].float().numpy(), full[:, -1].float().numpy()
    assert (got.argmax(-1) == want.argmax(-1)).mean() >= 0.99
    assert np.corrcoef(got.ravel(), want.ravel())[0, 1] > 0.99


def test_decode_writes_its_slot_by_the_one_hot_add():
    """The slot at ``cache_len`` is cache + k: an indexed write where the
    slot holds zeros, a sum where it does not (as in the reference)."""
    model = build_model(configs.REGISTRY["granite-34b"].reduced())
    params = init_params(model.spec(), torch.Generator().manual_seed(0), "cpu")
    tok = torch.tensor([[3], [4]])
    with torch.no_grad():
        _, fresh = model.decode_step(params, model.init_cache(2, 8, device="cpu"),
                                     torch.tensor([2, 5]), tok)
        _, twice = model.decode_step(params, fresh, torch.tensor([2, 5]), tok)
    for b, slot in enumerate((2, 5)):
        written = fresh["k"][:, b, slot]
        assert written.abs().sum() > 0
        others = [s for s in range(8) if s != slot]
        assert not fresh["k"][:, b, others].any()
        # layer 0's k depends on the token alone; later layers' see the cache
        assert torch.equal(twice["k"][0, b, slot], written[0] + written[0])


def loss_and_grads(model, params, toks, remat):
    flat = {k: p.detach().requires_grad_(True) for k, p in tree_paths(params).items()}
    logits, _ = model.forward(tree_from_paths(flat), toks, remat=remat)
    loss = logits.float().square().mean()
    return logits, dict(zip(flat, torch.autograd.grad(loss, list(flat.values())), strict=True))


REMATS = ("none", "dots", "full")


@pytest.mark.parametrize("remat", ["dots", "full"])
def test_remat_policies_agree(remat):
    model = build_model(configs.REGISTRY["yi-34b"].reduced())
    params = init_params(model.spec(), torch.Generator().manual_seed(0), "cpu")
    toks = torch.arange(32).reshape(2, 16) % model.cfg.vocab
    base, base_g = loss_and_grads(model, params, toks, "none")
    out, g = loss_and_grads(model, params, toks, remat)
    torch.testing.assert_close(out.float(), base.float(), rtol=1e-5, atol=1e-5)
    for key in base_g:
        torch.testing.assert_close(g[key], base_g[key], rtol=1e-5, atol=1e-5)


class OpCounter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.counts = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.counts[func] += 1
        return func(*args, **(kwargs or {}))


def backward_ops(model, params, toks, remat) -> collections.Counter:
    flat = {k: p.detach().requires_grad_(True) for k, p in tree_paths(params).items()}
    logits, _ = model.forward(tree_from_paths(flat), toks, remat=remat)
    loss = logits.float().square().mean()
    with OpCounter() as ops:
        torch.autograd.grad(loss, list(flat.values()))
    return ops.counts


def test_dots_saves_weight_products_and_recomputes_attention():
    """What each policy's backward runs again: ``dots`` the attention (its
    two einsums, ``bmm``, and the softmax) but none of the 7 weight products
    (``mm``) a layer; ``full`` the attention and 6 products (recomputation
    stops before ``w_down``, whose output no gradient needs)."""
    model = build_model(configs.REGISTRY["yi-34b"].reduced())
    params = init_params(model.spec(), torch.Generator().manual_seed(0), "cpu")
    toks = torch.zeros((1, 8), dtype=torch.int64)
    none, dots, full = (backward_ops(model, params, toks, r) for r in REMATS)
    mm, bmm, softmax = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
                        torch.ops.aten._softmax.default)
    layers = model.cfg.n_layers
    assert none[softmax] == 0 and dots[softmax] == full[softmax] == layers
    assert dots[bmm] == full[bmm] == none[bmm] + 2 * layers
    assert dots[mm] == none[mm] and full[mm] == none[mm] + 6 * layers
    with pytest.raises(ValueError, match="unknown remat"):
        model.forward(params, toks, remat="some")
