"""The port's MoE and MLA layers (``repro_torch.models.moe`` / ``mla``)
against the reference's, on numpy-seeded inputs on the CPU.

Tolerances:
* ``_dispatch_indices``: slot tables and keep masks equal (integer work);
* ``router_topk``: experts equal, gates <= 1e-6 absolute, probabilities
  <= 1e-6;
* ``moe_forward`` in fp32 with router weights at scale 0.5 (the k-th and
  (k+1)-th probabilities of every token then differ by more than 1e-4,
  which the test checks, so a last-bit difference in the router logits
  cannot move an assignment): outputs max|Δ|/max|ref| <= 1e-5, aux <= 1e-6;
* at the init scale (``scaled``: router / sqrt(D)) the top-k margins are
  small; the test counts the assignments routed differently and holds the
  tokens that route alike to 1e-5;
* the reference's own properties on the port (dense per-token oracle with
  ample capacity rtol 2e-3, partial capacity drops finite, G=1 against G=2
  rtol 1e-4): ``tests/test_models.py``;
* ``mla_prefill`` (unchunked and query-chunked) and ``mla_decode`` steps in
  fp32: max|Δ|/max|ref| <= 1e-5 (outputs) and caches equal to 1e-6;
* gradients of the MoE layer against ``jax.grad`` in fp32: ||Δg||/||g|| <=
  1e-4 per input.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.mla as RM
import repro.models.moe as RE
import repro_torch.models.mla as TM
import repro_torch.models.moe as TE
from repro_torch.interop import params_from_numpy

E, K, D, F = 8, 2, 16, 24


def rel(got: torch.Tensor, ref) -> float:
    got, ref = got.detach().float().numpy(), np.asarray(ref, np.float32)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def moe_params(seed, d=D, f=F, e=E, router_scale=0.5, shared=0):
    rng = np.random.default_rng(seed)
    p = {
        "router": rng.normal(size=(d, e)) * router_scale,
        "gate": rng.normal(size=(e, d, f)) * 0.2,
        "up": rng.normal(size=(e, d, f)) * 0.2,
        "down": rng.normal(size=(e, f, d)) * 0.2,
    }
    if shared:
        p.update(shared_gate=rng.normal(size=(d, shared * f)) * 0.2,
                 shared_up=rng.normal(size=(d, shared * f)) * 0.2,
                 shared_down=rng.normal(size=(shared * f, d)) * 0.2)
    return {k: v.astype(np.float32) for k, v in p.items()}


def both_dims(**kw):
    return RE.MoEDims(**kw), TE.MoEDims(**kw)


# ---------------------------------------------------------------- dispatch


@pytest.mark.parametrize("a,e,cap", [(16, 4, 8), (64, 4, 5), (96, 8, 3), (24, 8, 24), (7, 3, 1)])
@pytest.mark.parametrize("seed", [0, 1])
def test_dispatch_indices_are_exact(a, e, cap, seed):
    """Skewed draws, so some experts overflow their capacity and drop."""
    rng = np.random.default_rng(seed)
    experts = rng.choice(e, size=a, p=np.arange(1, e + 1) / (e * (e + 1) / 2))
    ref_table, ref_keep = RE._dispatch_indices(jnp.asarray(experts, jnp.int32), e, cap)
    table, keep = TE._dispatch_indices(torch.from_numpy(experts), e, cap)
    assert table.shape == (e, cap) and keep.dtype == torch.bool
    assert np.array_equal(table.numpy(), np.asarray(ref_table))
    assert np.array_equal(keep.numpy(), np.asarray(ref_keep))


def test_dispatch_indices_over_a_group_axis_are_each_groups():
    rng = np.random.default_rng(2)
    experts = rng.integers(0, 4, size=(3, 20))
    table, keep = TE._dispatch_indices(torch.from_numpy(experts), 4, 4)
    for g in range(3):
        ref_table, ref_keep = RE._dispatch_indices(jnp.asarray(experts[g], jnp.int32), 4, 4)
        assert np.array_equal(table[g].numpy(), np.asarray(ref_table))
        assert np.array_equal(keep[g].numpy(), np.asarray(ref_keep))


@pytest.mark.parametrize("top_k", [1, 2, 6])
def test_router_topk_matches(top_k):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(40, D)).astype(np.float32)
    w = (rng.normal(size=(D, E)) * 0.5).astype(np.float32)
    ref_g, ref_e, ref_p = RE.router_topk(jnp.asarray(x), jnp.asarray(w), top_k)
    g, e, p = TE.router_topk(torch.from_numpy(x), torch.from_numpy(w), top_k)
    assert np.array_equal(e.numpy(), np.asarray(ref_e))
    assert np.abs(g.numpy() - np.asarray(ref_g)).max() <= 1e-6
    assert np.abs(p.numpy() - np.asarray(ref_p)).max() <= 1e-6
    assert g.dtype == torch.float32


def test_router_topk_breaks_ties_toward_the_lower_expert():
    x = torch.zeros((3, D))                       # every logit 0: all experts tie
    g, e, _ = TE.router_topk(x, torch.ones((D, E)), 3)
    ref_g, ref_e, _ = RE.router_topk(jnp.zeros((3, D)), jnp.ones((D, E)), 3)
    assert np.array_equal(e.numpy(), np.asarray(ref_e)) and e[0].tolist() == [0, 1, 2]
    assert torch.allclose(g, torch.full((3, 3), 1 / 3))


# ---------------------------------------------------------------- the layer


def margins(x, router, k):
    """Per token, the gap between the k-th and (k+1)-th probability."""
    _, _, probs = RE.router_topk(jnp.asarray(x.reshape(-1, x.shape[-1])), jnp.asarray(router), k)
    top = np.sort(np.asarray(probs), -1)[:, ::-1]
    return top[:, k - 1] - top[:, k]


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("shared", [0, 2])
@pytest.mark.parametrize("cf", [1.25, 0.5])
def test_moe_forward_matches(groups, shared, cf):
    params = moe_params(4, shared=shared)
    x = np.random.default_rng(5).normal(size=(2, 24, D)).astype(np.float32)
    assert margins(x, params["router"], K).min() > 1e-4
    ref_dims, dims = both_dims(n_experts=E, top_k=K, d_model=D, d_ff=F, n_shared=shared,
                               capacity_factor=cf, groups=groups)
    ref, ref_aux = RE.moe_forward(jnp.asarray(x), params, ref_dims)
    got, aux = TE.moe_forward(torch.from_numpy(x), params_from_numpy(params, "cpu"), dims)
    assert got.shape == (2, 24, D) and got.dtype == torch.float32
    assert rel(got, ref) <= 1e-5
    assert abs(float(aux) - float(ref_aux)) <= 1e-6


def test_moe_at_init_scale_routes_alike_but_for_counted_flips():
    """Router weights at the ``scaled`` init (N(0, 1) / sqrt(D)): top-k
    margins shrink toward the last bits, so an assignment can flip between
    frameworks.  The flips are counted (and printed); every token whose k
    assignments agree matches to 1e-5 (ample capacity, so no drop couples
    tokens)."""
    d, t = 64, 256
    params = moe_params(6, d=d, router_scale=1 / np.sqrt(d))
    x = np.random.default_rng(7).normal(size=(1, t, d)).astype(np.float32)
    ref_dims, dims = both_dims(n_experts=E, top_k=K, d_model=d, d_ff=F, capacity_factor=8.0)
    _, ref_e, _ = RE.router_topk(jnp.asarray(x[0]), jnp.asarray(params["router"]), K)
    _, e, _ = TE.router_topk(torch.from_numpy(x[0]), torch.from_numpy(params["router"]), K)
    alike = (e.numpy() == np.asarray(ref_e)).all(-1)
    print(f"assignments routed differently: {int((e.numpy() != np.asarray(ref_e)).sum())} "
          f"of {t * K}; smallest top-k margin {margins(x, params['router'], K).min():.3g}")
    assert alike.mean() >= 0.95
    ref, _ = RE.moe_forward(jnp.asarray(x), params, ref_dims)
    got, _ = TE.moe_forward(torch.from_numpy(x), params_from_numpy(params, "cpu"), dims)
    ref = np.asarray(ref)[0][alike]
    assert np.abs(got[0].numpy()[alike] - ref).max() / np.abs(ref).max() <= 1e-5


def naive_moe(x, params, top_k):
    """The reference test's per-token oracle, in float64."""
    logits = x.astype(np.float64) @ params["router"].astype(np.float64)
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    out = np.zeros(x.shape)
    order = np.argsort(-probs, axis=-1, kind="stable")[:, :top_k]
    for i in range(x.shape[0]):
        gates = probs[i, order[i]] / probs[i, order[i]].sum()
        for gate, e in zip(gates, order[i], strict=True):
            h = x[i].astype(np.float64)
            g = h @ params["gate"][e]
            u = h @ params["up"][e]
            out[i] += gate * ((g / (1.0 + np.exp(-g)) * u) @ params["down"][e])
    return out


def test_moe_matches_dense_oracle():
    params = moe_params(0, e=4, router_scale=0.5)
    x = np.random.default_rng(0).normal(size=(1, 32, D)).astype(np.float32)
    dims = TE.MoEDims(n_experts=4, top_k=2, d_model=D, d_ff=F, capacity_factor=8.0)
    out, aux = TE.moe_forward(torch.from_numpy(x), params_from_numpy(params, "cpu"), dims)
    np.testing.assert_allclose(out[0].numpy(), naive_moe(x[0], params, 2), rtol=2e-3, atol=2e-3)
    assert np.isfinite(float(aux))


def test_moe_capacity_drops_are_partial_not_corrupt():
    params = moe_params(1, d=8, f=8, e=4, router_scale=1.0)
    x = np.random.default_rng(1).normal(size=(2, 32, 8)).astype(np.float32)
    dims = TE.MoEDims(n_experts=4, top_k=2, d_model=8, d_ff=8, capacity_factor=0.25)
    flat = torch.from_numpy(x).reshape(64, 8)
    _, experts, _ = TE.router_topk(flat, torch.from_numpy(params["router"]), 2)
    _, keep = TE._dispatch_indices(experts.reshape(-1), 4, 8)
    assert 0 < int((~keep).sum()) < keep.numel()           # some drop, some survive
    out, _ = TE.moe_forward(torch.from_numpy(x), params_from_numpy(params, "cpu"), dims)
    assert torch.isfinite(out).all()
    # a token whose assignments all dropped gets a zero update
    dropped_tokens = (~keep.reshape(64, 2)).all(-1)
    assert dropped_tokens.any() and not out.reshape(64, 8)[dropped_tokens].any()


def test_moe_grouping_invariance():
    params = moe_params(2, d=8, f=8, e=4, router_scale=1.0)
    x = torch.from_numpy(np.random.default_rng(2).normal(size=(2, 32, 8)).astype(np.float32))
    p = params_from_numpy(params, "cpu")
    o1, _ = TE.moe_forward(x, p, TE.MoEDims(4, 2, 8, 8, capacity_factor=8.0, groups=1))
    o2, _ = TE.moe_forward(x, p, TE.MoEDims(4, 2, 8, 8, capacity_factor=8.0, groups=2))
    torch.testing.assert_close(o1, o2, rtol=1e-4, atol=1e-5)
    with pytest.raises(ValueError, match="divisible"):
        TE.moe_forward(x, p, TE.MoEDims(4, 2, 8, 8, groups=5))


def test_moe_gradients_match_jax_grad():
    params = moe_params(8, shared=1)
    x = np.random.default_rng(9).normal(size=(2, 16, D)).astype(np.float32)
    ref_dims, dims = both_dims(n_experts=E, top_k=K, d_model=D, d_ff=F, n_shared=1)
    assert margins(x, params["router"], K).min() > 1e-4

    def ref_loss(p, x):
        out, aux = RE.moe_forward(x, p, ref_dims)
        return jnp.sum(out ** 2) + aux

    ref_gp, ref_gx = jax.grad(ref_loss, argnums=(0, 1))(params, jnp.asarray(x))
    p = {k: v.requires_grad_(True) for k, v in params_from_numpy(params, "cpu").items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    out, aux = TE.moe_forward(tx, p, dims)
    (out.square().sum() + aux).backward()
    for key, g in [*((k, v.grad) for k, v in p.items()), ("x", tx.grad)]:
        ref = np.asarray(ref_gx if key == "x" else ref_gp[key])
        assert np.linalg.norm(g.numpy() - ref) <= 1e-4 * np.linalg.norm(ref), key


# ---------------------------------------------------------------- MLA


MLA_DIMS = dict(n_heads=4, q_lora=32, kv_lora=24, d_nope=16, d_rope=8, d_v=12)


def mla_params(seed, d=48):
    rng = np.random.default_rng(seed)
    h, ql, kl, dn, dr, dv = (MLA_DIMS[k] for k in ("n_heads", "q_lora", "kv_lora", "d_nope",
                                                     "d_rope", "d_v"))
    shapes = {"w_dq": (d, ql), "q_norm": (ql,), "w_uq": (ql, h, dn + dr), "w_dkv": (d, kl),
              "kv_norm": (kl,), "w_uk": (kl, h, dn), "w_uv": (kl, h, dv), "w_kr": (d, dr),
              "w_o": (h, dv, d)}
    return {k: (1.0 + 0.1 * rng.normal(size=s) if k.endswith("norm")
                else rng.normal(size=s) / np.sqrt(s[0])).astype(np.float32)
            for k, s in shapes.items()}


@pytest.mark.parametrize("chunked", [False, True])
def test_mla_prefill_matches(chunked, monkeypatch):
    """The query-chunked path is taken by lowering both packages' threshold
    and chunk (S = 24 > 16, chunks of 8)."""
    if chunked:
        for mod in (RM, TM):
            monkeypatch.setattr(mod, "MLA_CHUNK_THRESHOLD", 16)
            monkeypatch.setattr(mod, "MLA_Q_CHUNK", 8)
    params = mla_params(0)
    b, s = 2, 24
    x = np.random.default_rng(1).normal(size=(b, s, 48)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s), (b, s)).astype(np.int32)
    ref, ref_cache = RM.mla_prefill(jnp.asarray(x), params, RM.MLADims(**MLA_DIMS),
                                    jnp.asarray(pos), 500.0)
    got, cache = TM.mla_prefill(torch.from_numpy(x), params_from_numpy(params, "cpu"),
                                TM.MLADims(**MLA_DIMS), torch.from_numpy(pos), 500.0)
    assert rel(got, ref) <= 1e-5
    for k in ("c_kv", "k_rope"):
        assert np.abs(cache[k].numpy() - np.asarray(ref_cache[k])).max() <= 1e-6
    if chunked:     # the chunked dataflow computes the unchunked result
        monkeypatch.setattr(TM, "MLA_CHUNK_THRESHOLD", 8192)
        whole, _ = TM.mla_prefill(torch.from_numpy(x), params_from_numpy(params, "cpu"),
                                  TM.MLADims(**MLA_DIMS), torch.from_numpy(pos), 500.0)
        torch.testing.assert_close(got, whole, rtol=1e-6, atol=1e-6)
        monkeypatch.setattr(TM, "MLA_CHUNK_THRESHOLD", 16)
        monkeypatch.setattr(TM, "MLA_Q_CHUNK", 7)
        with pytest.raises(ValueError, match="divisible"):
            TM.mla_prefill(torch.from_numpy(x), params_from_numpy(params, "cpu"),
                           TM.MLADims(**MLA_DIMS), torch.from_numpy(pos), 500.0)


def test_mla_decode_steps_match_and_track_prefill():
    """Absorbed decode, one token at a time into a cache of 16, against the
    reference's steps; the last step's output also equals the port's own
    prefill at that position (same math, two factorizations)."""
    params = mla_params(2)
    b, s, s_max = 2, 10, 16
    x = np.random.default_rng(3).normal(size=(b, s, 48)).astype(np.float32)
    rdims, dims = RM.MLADims(**MLA_DIMS), TM.MLADims(**MLA_DIMS)
    ref_cache = {"c_kv": jnp.zeros((b, s_max, 24)), "k_rope": jnp.zeros((b, s_max, 8))}
    cache = {"c_kv": torch.zeros((b, s_max, 24)), "k_rope": torch.zeros((b, s_max, 8))}
    tp = params_from_numpy(params, "cpu")
    outs = []
    for t in range(s):
        ref, ref_cache = RM.mla_decode(jnp.asarray(x[:, t:t + 1]), params, rdims, ref_cache,
                                       jnp.full((b,), t, jnp.int32))
        got, cache = TM.mla_decode(torch.from_numpy(x[:, t:t + 1]), tp, dims, cache,
                                   torch.full((b,), t, dtype=torch.int32))
        assert rel(got, ref) <= 1e-5
        outs.append(got)
    for k in cache:
        assert np.abs(cache[k].numpy() - np.asarray(ref_cache[k])).max() <= 1e-6
    pos = torch.arange(s).expand(b, s)
    full, _ = TM.mla_prefill(torch.from_numpy(x), tp, dims, pos)
    torch.testing.assert_close(torch.cat(outs, 1), full, rtol=1e-4, atol=1e-5)
