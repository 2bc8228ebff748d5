"""The port's training layer (loss, AdamW, the train step, the data pipeline)
against the reference's, on reduced yi-34b on the CPU.

Tolerances:
* ``cross_entropy``: uniform logits give log V to 1e-5; parity 1e-6;
* ``global_norm``, ``schedule`` and ``apply_updates`` fed identical numpy
  gradients: rtol 1e-6, for a leaf of params, m or v elementwise with an
  atol of 1e-6 of its largest value (never one cross-framework step from gradients each
  package computed: at step 1 Adam moves each element by lr * sign(g), so a
  gradient element near 0 whose sign differs moves its weight by 2 lr);
* gradients of ``make_loss_fn`` against ``jax.grad``, per leaf by
  ||Δg|| / ||g_ref||: in fp32 (both packages' ``COMPUTE_DTYPE`` float32)
  <= 1e-3; in bf16 <= 0.35, where the reduced config's saturated attention
  (see ``tests/test_torch_models.py``) turns last-bit differences in the
  products into different softmax winners at a few positions (the
  reference's own bf16 gradients are 0.12-0.85 from its fp32 ones);
* the loss of one ``make_train_step`` step: rel 1e-3;
* the families this slice adds (olmoe, deepseek-v2, mamba2, zamba2 and
  whisper, through the enc-dec batch form): fp32 gradients of
  ``make_loss_fn`` (MoE aux loss included) <= 1e-3 per leaf (whisper: or
  twice the reference's own change when its frames are scaled by
  1 + 2^-20, whichever is larger), loss rel 1e-5 and aux 1e-5; a bf16
  train step's loss rel 1e-2 (whisper, whose reduced config is chaotic in
  bf16: 5e-2);
* within the port: accum 2 against accum 1 at the reference test's rtol
  2e-4 / atol 2e-5; overfitting one batch lowers the loss by 20 %;
* batches: token values equal the reference's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.decoder as ref_decoder
import repro.models.encdec as ref_encdec
import repro.models.hybrid as ref_hybrid
import repro.models.layers as RL
import repro.models.ssm as ref_ssm
import repro_torch.models.decoder as decoder
import repro_torch.models.encdec as encdec
import repro_torch.models.hybrid as hybrid
import repro_torch.models.layers as TL
import repro_torch.models.ssm as ssm
from repro.configs import REGISTRY as REF_REGISTRY
from repro.data import DataConfig as RefDataConfig
from repro.data import make_decode_inputs as ref_decode_inputs
from repro.data import make_train_batch as ref_train_batch
from repro.models import build_model as ref_build
from repro.models import init_params as ref_init
from repro.optim import AdamWConfig as RefAdamWConfig
from repro.optim import apply_updates as ref_apply_updates
from repro.optim import global_norm as ref_global_norm
from repro.optim import init_state as ref_init_state
from repro.optim import schedule as ref_schedule
from repro.train import TrainSettings as RefTrainSettings
from repro.train import cross_entropy as ref_cross_entropy
from repro.train import make_loss_fn as ref_make_loss_fn
from repro_torch.configs import REGISTRY
from repro_torch.data import DataConfig, make_decode_inputs, make_train_batch
from repro_torch.interop import params_from_numpy, params_to_numpy
from repro_torch.models import build_model, init_params
from repro_torch.optim import AdamWConfig, apply_updates, global_norm, init_state, schedule
from repro_torch.train import (
    TrainSettings,
    cross_entropy,
    init_train_state,
    make_decode_step,
    make_loss_fn,
    make_prefill_step,
    make_train_step,
)
from repro_torch.tree import tree_from_paths, tree_leaves, tree_paths

CPU = "cpu"


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def carried(name="yi-34b"):
    cfg = REF_REGISTRY[name].reduced()
    ref_model = ref_build(cfg)
    ref_params = ref_init(ref_model.spec(), jax.random.PRNGKey(0))
    return (ref_model, ref_params, build_model(REGISTRY[name].reduced()),
            params_from_numpy(numpy_tree(ref_params), "cpu"))


def batch_pair(cfg, seq=16, batch=2, step=0):
    ref = ref_train_batch(RefDataConfig(seed=1), REF_REGISTRY[cfg.name].reduced(), seq, batch,
                          step)
    return ref, make_train_batch(DataConfig(seed=1), cfg, seq, batch, step, device=CPU)


def leaf_errors(got: dict, ref) -> dict:
    ref = tree_paths(numpy_tree(ref))
    return {k: float(np.linalg.norm(g.numpy() - ref[k]) / np.linalg.norm(ref[k]))
            for k, g in tree_paths(got).items()}


def port_grads(model, params, batch, settings):
    flat = {k: p.detach().requires_grad_(True) for k, p in tree_paths(params).items()}
    total, (loss, _) = make_loss_fn(model, settings)(tree_from_paths(flat), batch)
    grads = torch.autograd.grad(total, list(flat.values()))
    return float(loss), tree_from_paths(dict(zip(flat, grads, strict=True)))


# ---------------------------------------------------------------- loss


def test_cross_entropy_uniform_is_log_vocab():
    v = 64
    logits = torch.zeros((2, 8, v))
    labels = torch.zeros((2, 8), dtype=torch.int64)
    assert float(cross_entropy(logits, labels)) == pytest.approx(np.log(v), rel=1e-5)


@pytest.mark.parametrize("dtype", [np.float32, "bf16"])
def test_cross_entropy_matches_the_reference(dtype):
    rng = np.random.default_rng(0)
    logits = (rng.normal(size=(2, 8, 100)) * 4).astype(np.float32)
    labels = rng.integers(0, 100, (2, 8))
    ref_logits = jnp.asarray(logits, jnp.float32 if dtype == np.float32 else jnp.bfloat16)
    ours = torch.from_numpy(logits).to(torch.float32 if dtype == np.float32 else torch.bfloat16)
    ref = float(ref_cross_entropy(ref_logits, jnp.asarray(labels, jnp.int32)))
    assert float(cross_entropy(ours, torch.from_numpy(labels))) == pytest.approx(ref, rel=1e-6)


# ---------------------------------------------------------------- optimizer


def test_global_norm_and_schedule_match():
    t = {"a": torch.tensor([3.0]), "b": torch.tensor([4.0])}
    assert float(global_norm(t)) == pytest.approx(5.0)
    rng = np.random.default_rng(1)
    tree = {"x": rng.normal(size=(64, 33)).astype(np.float32),
            "y": {"z": rng.normal(size=(7,)).astype(np.float32) * 1e3}}
    assert float(global_norm(params_from_numpy(tree, "cpu"))) == pytest.approx(
        float(ref_global_norm(tree)), rel=1e-6)
    for warmup in (1, 10):
        for step in (0, 1, 5, 10, 100):
            assert float(schedule(AdamWConfig(lr=0.5, warmup_steps=warmup),
                                  torch.tensor(step, dtype=torch.int32))) == pytest.approx(
                float(ref_schedule(RefAdamWConfig(lr=0.5, warmup_steps=warmup),
                                   jnp.asarray(step, jnp.int32))), rel=1e-6)


@pytest.mark.parametrize("cfg_kw", [dict(), dict(lr=0.1, clip_norm=1e-3, warmup_steps=1),
                                    dict(lr=1e-2, weight_decay=0.0, warmup_steps=2)])
def test_apply_updates_on_identical_gradients(cfg_kw):
    """Three steps of both optimizers fed the same numpy gradients: params,
    m, v, step, grad_norm and lr to rtol 1e-6."""
    rng = np.random.default_rng(2)
    params = {"w": rng.normal(size=(16, 8)).astype(np.float32),
              "b": {"c": rng.normal(size=(8,)).astype(np.float32)}}
    ref_params, ref_state = params, ref_init_state(params)
    ours = params_from_numpy(params, "cpu")
    state = init_state(ours)
    assert state["step"].dtype == torch.int32 and state["step"].shape == ()
    for _ in range(3):
        grads = jax.tree_util.tree_map(
            lambda p: (rng.normal(size=p.shape) * 10).astype(np.float32), params)
        ref_params, ref_state, ref_m = ref_apply_updates(
            ref_params, grads, ref_state, RefAdamWConfig(**cfg_kw))
        ours, state, m = apply_updates(ours, params_from_numpy(grads, "cpu"), state,
                                       AdamWConfig(**cfg_kw))
        got = params_to_numpy({"params": ours, "m": state["m"], "v": state["v"]})
        want = numpy_tree({"params": ref_params, "m": ref_state["m"], "v": ref_state["v"]})
        for key, value in tree_paths(got).items():
            ref = tree_paths(want)[key]       # m = 0.9 m + 0.1 g may cancel: scale by the leaf
            np.testing.assert_allclose(value, ref, rtol=1e-6, atol=1e-6 * np.abs(ref).max(),
                                       err_msg=key)
        assert int(state["step"]) == int(ref_state["step"])
        for k in ("grad_norm", "lr"):
            assert float(m[k]) == pytest.approx(float(ref_m[k]), rel=1e-6)


def test_adamw_clipping_and_decay():
    params = {"w": torch.ones(4)}
    cfg = AdamWConfig(lr=0.1, clip_norm=1.0, weight_decay=0.0, warmup_steps=1)
    new_p, new_state, metrics = apply_updates(params, {"w": torch.full((4,), 100.0)},
                                              init_state(params), cfg)
    assert float(metrics["grad_norm"]) == pytest.approx(200.0)
    assert int(new_state["step"]) == 1
    assert (new_p["w"] - 1.0).abs().max() <= 0.11
    assert torch.equal(params["w"], torch.ones(4))      # inputs left as they were


# ---------------------------------------------------------------- gradients


@pytest.fixture
def fp32(monkeypatch):
    for mod in (RL, ref_decoder, ref_ssm, ref_hybrid, ref_encdec):
        monkeypatch.setattr(mod, "COMPUTE_DTYPE", jnp.float32)
    for mod in (TL, decoder, ssm, hybrid, encdec):
        monkeypatch.setattr(mod, "COMPUTE_DTYPE", torch.float32)


def reference_grads(ref_model, ref_params, ref_batch):
    fn = jax.value_and_grad(ref_make_loss_fn(ref_model, RefTrainSettings(remat="none")),
                            has_aux=True)
    (_, (loss, _)), grads = fn(ref_params, ref_batch)
    return float(loss), grads


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_gradients_match_jax_grad(precision, request):
    if precision == "fp32":
        request.getfixturevalue("fp32")
    ref_model, ref_params, model, params = carried()
    ref_batch, batch = batch_pair(model.cfg)
    ref_loss, ref_g = reference_grads(ref_model, ref_params, ref_batch)
    loss, grads = port_grads(model, params, batch, TrainSettings(remat="none"))
    errs = leaf_errors(grads, ref_g)
    assert set(errs) == set(tree_paths(params))
    bound = 1e-3 if precision == "fp32" else 0.35
    assert max(errs.values()) <= bound, errs
    assert loss == pytest.approx(ref_loss, rel=1e-5 if precision == "fp32" else 1e-3)


def test_train_step_loss_matches_the_reference():
    ref_model, ref_params, model, params = carried()
    ref_batch, batch = batch_pair(model.cfg, step=3)
    ref_loss, _ = reference_grads(ref_model, ref_params, ref_batch)
    step = make_train_step(model, TrainSettings(remat="dots"))
    state, metrics = step(init_train_state(model, params), batch)
    assert float(metrics["loss"]) == pytest.approx(ref_loss, rel=1e-3)
    assert float(metrics["aux"]) == 0.0 and int(state["opt"]["step"]) == 1
    assert set(metrics) == {"loss", "aux", "grad_norm", "lr"}


NEW_FAMILIES = ["olmoe-1b-7b", "deepseek-v2-236b", "mamba2-130m", "zamba2-1.2b",
                "whisper-medium"]


@pytest.mark.parametrize("name", NEW_FAMILIES)
def test_family_gradients_match_jax_grad(name, fp32):
    ref_model, ref_params, model, params = carried(name)
    ref_batch, batch = batch_pair(model.cfg)
    fn = jax.value_and_grad(ref_make_loss_fn(ref_model, RefTrainSettings(remat="none")),
                            has_aux=True)
    (_, (ref_loss, ref_aux)), ref_g = fn(ref_params, ref_batch)
    flat = {k: p.detach().requires_grad_(True) for k, p in tree_paths(params).items()}
    total, (loss, aux) = make_loss_fn(model, TrainSettings(remat="none"))(
        tree_from_paths(flat), batch)
    grads = dict(zip(flat, torch.autograd.grad(total, list(flat.values()),
                                               materialize_grads=True), strict=True))
    # reduced zamba2 has no shared-attention insertion: those leaves' gradients are 0
    unused = [k for k, g in tree_paths(numpy_tree(ref_g)).items() if not g.any()]
    assert all(not grads[k].any() for k in unused) and unused == (
        [k for k in grads if k.startswith("shared_attn/")] if name == "zamba2-1.2b" else [])
    errs = leaf_errors(tree_from_paths({k: g for k, g in grads.items() if k not in unused}),
                       {k: g for k, g in tree_paths(ref_g).items() if k not in unused})
    bound = dict.fromkeys(errs, 1e-3)
    if name == "whisper-medium":
        # its encoder's saturated attention makes even fp32 gradients turn
        # on last bits: scaling the frames by 1 + 2^-20 moves the reference's
        # own encoder gradients by up to 4 %; each leaf stays within twice
        # the reference's own move
        nudged = dict(ref_batch, src_embeds=ref_batch["src_embeds"] * (1 + 2 ** -20))
        own = leaf_errors(params_from_numpy(numpy_tree(fn(ref_params, nudged)[1]), "cpu"), ref_g)
        bound = {k: max(1e-3, 2 * own[k]) for k in errs}
    assert all(errs[k] <= bound[k] for k in errs), {k: (errs[k], bound[k]) for k in errs}
    assert float(loss) == pytest.approx(float(ref_loss), rel=1e-5)
    assert abs(float(aux) - float(ref_aux)) <= 1e-5 and (float(aux) > 0) == bool(model.cfg.moe)


@pytest.mark.parametrize("name", NEW_FAMILIES)
def test_family_train_step_matches_the_reference_loss(name):
    ref_model, ref_params, model, params = carried(name)
    ref_batch, batch = batch_pair(model.cfg, step=3)
    ref_loss, _ = reference_grads(ref_model, ref_params, ref_batch)
    state, metrics = make_train_step(model, TrainSettings(remat="full"))(
        init_train_state(model, params), batch)
    rel = 5e-2 if name == "whisper-medium" else 1e-2
    assert float(metrics["loss"]) == pytest.approx(ref_loss, rel=rel)
    assert int(state["opt"]["step"]) == 1
    assert all(torch.isfinite(t).all() for t in tree_leaves(state["params"]))


def test_encdec_prefill_step_is_the_decoder_over_the_encoder():
    _, _, model, params = carried("whisper-medium")
    batch = make_train_batch(DataConfig(seed=0), model.cfg, 24, 2, 0, device=CPU)
    logits = make_prefill_step(model)(params, batch)
    assert logits.shape == (2, model.cfg.encdec.dec_len, model.cfg.vocab)
    assert not logits.requires_grad
    with torch.no_grad():
        want, _ = model.forward(params, batch)
    assert torch.equal(logits, want)


def test_state_from_numpy_carries_the_reference_train_state():
    ref_model, ref_params, model, _ = carried()
    ref_state = {"params": ref_params, "opt": ref_init_state(ref_params)}
    state = params_from_numpy(numpy_tree(ref_state), "cpu")
    assert state["opt"]["step"].dtype == torch.int32 and state["opt"]["step"].shape == ()
    for key, value in tree_paths(numpy_tree(ref_state)).items():
        assert np.array_equal(tree_paths(state)[key].numpy(), value), key


# ---------------------------------------------------------------- the port's step


def port_state(name="yi-34b", seed=0):
    model = build_model(REGISTRY[name].reduced())
    params = init_params(model.spec(), torch.Generator().manual_seed(seed), CPU)
    return model, init_train_state(model, params)


def test_grad_accum_matches_single_batch():
    """accum=2 over a batch == accum=1 on the same batch (same update)."""
    model, state = port_state()
    batch = make_train_batch(DataConfig(seed=1), model.cfg, 16, 4, 0, device=CPU)
    st1, m1 = make_train_step(model, TrainSettings(remat="none", accum=1))(state, batch)
    st2, m2 = make_train_step(model, TrainSettings(remat="none", accum=2))(state, batch)
    assert float(m1["loss"]) == pytest.approx(float(m2["loss"]), rel=1e-4)
    for a, b in zip(tree_leaves(st1["params"]), tree_leaves(st2["params"]), strict=True):
        torch.testing.assert_close(a, b, rtol=2e-4, atol=2e-5)


def test_loss_decreases_when_overfitting_one_batch():
    model, state = port_state()
    step = make_train_step(model, TrainSettings(
        remat="none", optimizer=AdamWConfig(lr=3e-3, warmup_steps=1)))
    batch = make_train_batch(DataConfig(seed=0), model.cfg, 32, 4, 0, device=CPU)
    losses = []
    for _ in range(12):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0] * 0.8, losses


def test_cast_bf16_runs():
    model, state = port_state("granite-34b")
    batch = make_train_batch(DataConfig(), model.cfg, 16, 2, 0, device=CPU)
    _, base = make_train_step(model, TrainSettings(remat="none"))(state, batch)
    new, metrics = make_train_step(model, TrainSettings(remat="full", cast_bf16=True))(
        state, batch)
    assert np.isfinite(float(metrics["loss"]))
    assert float(metrics["loss"]) == pytest.approx(float(base["loss"]), rel=1e-2)
    assert all(t.dtype == torch.float32 for t in tree_leaves(new["params"]))


def test_prefill_and_decode_steps():
    model, state = port_state()
    params = state["params"]
    toks = make_train_batch(DataConfig(), model.cfg, 8, 2, 0, device=CPU)
    logits = make_prefill_step(model)(params, toks)
    assert logits.shape == (2, 8, model.cfg.vocab) and not logits.requires_grad
    inputs = make_decode_inputs(DataConfig(), model.cfg, 2, 0, fill=3, device=CPU)
    out, cache = make_decode_step(model)(params, model.init_cache(2, 8, device=CPU),
                                         inputs["cache_len"], inputs["tokens"])
    assert out.shape == (2, 1, model.cfg.vocab) and cache["k"][:, :, 3].any()


# ---------------------------------------------------------------- data


@pytest.mark.parametrize("name", ["yi-34b", "whisper-medium"])
@pytest.mark.parametrize("step", [0, 7])
def test_batches_are_the_references(name, step):
    cfg, ref_cfg = REGISTRY[name].reduced(), REF_REGISTRY[name].reduced()
    ref = ref_train_batch(RefDataConfig(seed=2), ref_cfg, 16, 3, step)
    ours = make_train_batch(DataConfig(seed=2), cfg, 16, 3, step, device=CPU)
    assert sorted(ours) == sorted(ref)
    for key, value in ours.items():
        assert value.device.type == "cpu"
        assert value.dtype == (torch.float32 if key == "src_embeds" else torch.int64)
        assert np.array_equal(value.numpy(), np.asarray(ref[key])), key
    ref_d = ref_decode_inputs(RefDataConfig(seed=2), ref_cfg, 3, step, fill=5)
    ours_d = make_decode_inputs(DataConfig(seed=2), cfg, 3, step, fill=5, device=CPU)
    assert np.array_equal(ours_d["tokens"].numpy(), np.asarray(ref_d["tokens"]))
    assert ours_d["cache_len"].dtype == torch.int32
    assert np.array_equal(ours_d["cache_len"].numpy(), np.asarray(ref_d["cache_len"]))


def test_batches_are_a_pure_function_of_the_step():
    cfg = REGISTRY["yi-34b"].reduced()
    b1, b2, b3 = (make_train_batch(DataConfig(seed=0), cfg, 16, 2, s, device=CPU)
                  for s in (3, 3, 4))
    assert torch.equal(b1["tokens"], b2["tokens"])
    assert not torch.equal(b1["tokens"], b3["tokens"])
    assert torch.equal(b1["tokens"][:, 1:], b1["labels"][:, :-1])
