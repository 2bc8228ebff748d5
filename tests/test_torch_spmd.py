"""Real collectives on the CPU: the port's sharded model stack in 4 ``gloo``
processes on a 2 x 2 ("data", "model") mesh against the unsharded step.

One job of four processes (this file run as a script, each with its own
timeout) computes every case and rank 0 writes the results; each test
checks one of them:

* one train step of reduced yi-34b (dense; also with 3 heads, which split
  attention by query rows), granite-34b (MQA), olmoe with ``moe_groups=2``,
  deepseek-v2 (MLA's head split, and MoE with shared experts), mamba2-130m
  (the Mamba-2 mixer), zamba2 (the hybrid's shared block, after every
  layer) and whisper-medium (the enc-dec layers and the tied
  ``dec_embed.T`` head), in fp32 (every module's ``COMPUTE_DTYPE``): loss
  within 1e-5 relative of the unsharded single-process step, every
  gradient leaf (||d|| / ||ref||) and every updated parameter within 1e-4,
  and each gradient on its parameter's placements;
* three decode steps of each of those models from an empty cache (batch
  entries at different cache lengths), the caches on the rules' placements
  and redistributed to them after each step (the dry run's decode step):
  every step's logits and every final cache leaf within 1e-4 of the
  unsharded ``decode_step``'s.  At batch 4 the caches are batch-sharded
  over ``data``; at batch 3 (which does not divide it) they are
  sequence-sharded over ``data`` (``kv_seq``), so each block gathers,
  writes and hands back a sequence-sharded cache;
* ``gather_layer_weights`` on or off (``FSDP_GATHER_WEIGHTS``) gives the
  same bf16 logits bit for bit (every product casts its weight to bf16
  anyway), and ``constrain_residual`` on or off (the decoder's hook patched
  to the identity) the same fp32 logits within 1e-6 of their largest (it
  moves where the ``model`` ranks' partial sums meet the residual, so only
  the association of those adds changes);
* ``reshard`` from the 2 x 2 mesh to 4 x 1 leaves every ``full_tensor()``
  equal;
* ``AsyncCheckpointer.save`` of sharded parameters from all four ranks
  (every rank joins each leaf's gather, rank 0 alone keeps a host copy and
  writes) restores onto the same placements with every value equal.

Nothing here imports the reference: the file runs on a host without JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
PROC_TIMEOUT_S = 240
LOSS_REL = 1e-5
GRAD_REL = 1e-4


def _fp32():
    import torch

    from repro_torch.models import decoder, encdec, hybrid, layers, ssm

    for mod in (layers, decoder, ssm, hybrid, encdec):
        mod.COMPUTE_DTYPE = torch.float32


def _rel(a, b) -> float:
    return float((a.double() - b.double()).norm() / b.double().norm().clamp(min=1e-30))


#: the cases: (config, moe groups, overrides of the reduced config).
#: On the 2 x 2 mesh reduced yi splits attention by heads (4 query, 2 K/V
#: heads), granite by query heads with its one K/V head whole on each rank
#: (MQA), yi with 3 heads by query rows (in decode, one row: replicated);
#: olmoe and deepseek-v2 dispatch two groups; zamba2 runs its shared block
#: after every layer (the reduced config's cadence of 6 would skip it)
CASES = {
    "yi-34b": ("yi-34b", 1, {}),
    "olmoe-1b-7b": ("olmoe-1b-7b", 2, {}),
    "granite-34b": ("granite-34b", 1, {}),
    "yi-34b-3-heads": ("yi-34b", 1, {"n_heads": 3, "n_kv_heads": 1}),
    "deepseek-v2-236b": ("deepseek-v2-236b", 2, {}),
    "mamba2-130m": ("mamba2-130m", 1, {}),
    "zamba2-1.2b": ("zamba2-1.2b", 1, {"shared_attn_every": 1}),
    "whisper-medium": ("whisper-medium", 1, {}),
}
DECODE_STEPS = 3
DECODE_BATCHES = (4, 3)


def _setup(name: str, groups: int, mesh, **over):
    import dataclasses

    import torch

    from repro_torch.configs import REGISTRY
    from repro_torch.data import DataConfig, make_train_batch
    from repro_torch.models import build_model, init_params, param_axes
    from repro_torch.sharding import ShardingRules
    from repro_torch.sharding.regions import distribute
    from repro_torch.tree import tree_map

    cfg = dataclasses.replace(REGISTRY[name].reduced(), **over)
    model = build_model(cfg, moe_groups=groups)
    spec = model.spec()
    full = init_params(spec, torch.Generator().manual_seed(0), "cpu")
    batch = make_train_batch(DataConfig(seed=0), cfg, 16, 4, 0, device="cpu")
    rules = ShardingRules()
    shardings = rules.tree_shardings(param_axes(spec), full, mesh)
    params = tree_map(distribute, full, shardings)
    dbatch = {k: distribute(v, rules.sharding_for(("batch",) + (None,) * (v.ndim - 1),
                                                  tuple(v.shape), mesh))
              for k, v in batch.items()}
    return model, full, batch, shardings, params, dbatch


def _train_case(name: str, groups: int, over: dict, mesh) -> dict:
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import TrainSettings, init_train_state, make_train_step
    from repro_torch.train.step import make_grad_fn
    from repro_torch.tree import tree_leaves, tree_paths

    model, full, batch, shardings, params, dbatch = _setup(name, groups, mesh, **over)
    settings = TrainSettings(remat="dots", optimizer=AdamWConfig(lr=1e-3, warmup_steps=1))
    g_ref, loss_ref, _ = make_grad_fn(model, settings)(full, batch)
    g, loss, _ = make_grad_fn(model, settings, grad_shardings=shardings)(params, dbatch)
    s_ref, m_ref = make_train_step(model, settings)(init_train_state(model, full), batch)
    s, m = make_train_step(model, settings, grad_shardings=shardings)(
        init_train_state(model, params), dbatch)
    placed = all(gl.placements == sh.placements for gl, sh in
                 zip(tree_leaves(g), tree_leaves(shardings), strict=True))
    grads = {k: _rel(v.full_tensor(), tree_paths(g_ref)[k]) for k, v in tree_paths(g).items()}
    new = {k: _rel(v.full_tensor(), tree_paths(s_ref["params"])[k])
           for k, v in tree_paths(s["params"]).items()}
    return {"loss": float(loss.full_tensor()), "loss_ref": float(loss_ref),
            "step_loss": float(m["loss"]), "step_loss_ref": float(m_ref["loss"]),
            "grads": grads, "params": new, "placed": placed}


def _decode_case(name: str, groups: int, over: dict, mesh, b: int) -> dict:
    import torch

    from repro_torch.models import layers
    from repro_torch.sharding import ShardingRules
    from repro_torch.sharding.regions import distribute
    from repro_torch.train.step import make_decode_step
    from repro_torch.tree import tree_leaves, tree_map, tree_paths

    # the dry run's moe_groups: the data shards where the batch divides
    model, full, _, _, params, _ = _setup(name, groups if b % 2 == 0 else 1, mesh, **over)
    cfg = model.cfg
    g = torch.Generator().manual_seed(1)
    if cfg.family == "encdec":
        enc_out = torch.randn((b, 16, cfg.d_model), generator=g).to(layers.COMPUTE_DTYPE)
        cache = model.init_cache(full, enc_out, b)
    else:
        cache = model.init_cache(b, 8, device="cpu")
    rules = ShardingRules()
    c_shard = rules.tree_shardings(model.cache_axes(), cache, mesh)
    dcache = tree_map(distribute, cache, c_shard)

    def put(v):
        return distribute(v, rules.sharding_for(("batch",) + (None,) * (v.ndim - 1),
                                                tuple(v.shape), mesh))

    decode = make_decode_step(model)
    tokens = torch.randint(0, cfg.vocab, (DECODE_STEPS, b, 1), generator=g)
    offset = torch.arange(b, dtype=torch.int32) % 2
    logits = []
    for t in range(DECODE_STEPS):
        cache_len = offset + t
        ref, cache = decode(full, cache, cache_len, tokens[t])
        out, dcache = decode(params, dcache, put(cache_len), put(tokens[t]))
        dcache = tree_map(lambda x, sh: x.redistribute(sh.mesh, sh.placements), dcache, c_shard)
        logits.append(_rel(out.full_tensor(), ref))
    placed = all(c.placements == sh.placements for c, sh in
                 zip(tree_leaves(dcache), tree_leaves(c_shard), strict=True))
    return {"logits": logits, "placed": placed,
            "cache": {k: _rel(v.full_tensor(), tree_paths(cache)[k])
                      for k, v in tree_paths(dcache).items()}}


def _hooks_case(mesh, hook: str) -> dict:
    from repro_torch.models import decoder
    from repro_torch.sharding import constrain

    model, _, _, _, params, dbatch = _setup("yi-34b", 1, mesh)
    logits = lambda: model.forward(params, dbatch["tokens"])[0].full_tensor()
    base = logits()
    if hook == "constrain_residual":
        saved, decoder.constrain_residual = decoder.constrain_residual, lambda x: x
    else:
        saved, constrain.FSDP_GATHER_WEIGHTS = constrain.FSDP_GATHER_WEIGHTS, True
    try:
        other = logits()
    finally:
        if hook == "constrain_residual":
            decoder.constrain_residual = saved
        else:
            constrain.FSDP_GATHER_WEIGHTS = saved
    return {"max_abs": float((other - base).abs().max()), "scale": float(base.abs().max())}


def _reshard_case(mesh) -> dict:
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import param_axes
    from repro_torch.runtime import reshard
    from repro_torch.sharding import ShardingRules
    from repro_torch.tree import tree_leaves

    model, _, _, _, params, _ = _setup("yi-34b", 1, mesh)
    new_mesh = make_host_mesh(model_parallel=1)
    moved = reshard(params, param_axes(model.spec()), ShardingRules(), new_mesh)
    same = all(bool((a.full_tensor() == b.full_tensor()).all())
               for a, b in zip(tree_leaves(params), tree_leaves(moved), strict=True))
    return {"mesh": list(new_mesh.mesh.shape), "equal": same,
            "placements": sorted({str(t.placements) for t in tree_leaves(moved)})}


def _checkpoint_case(mesh, ckpt_dir: str) -> dict:
    import torch.distributed as dist

    from repro_torch.checkpoint import AsyncCheckpointer, restore
    from repro_torch.tree import tree_leaves

    _, _, _, _, params, _ = _setup("olmoe-1b-7b", 2, mesh)
    ckpt = AsyncCheckpointer(ckpt_dir)
    ckpt.save(3, params)
    ckpt.wait()
    dist.barrier()
    back, step = restore(ckpt_dir, params)
    pairs = list(zip(tree_leaves(params), tree_leaves(back), strict=True))
    return {"step": step,
            "equal": all(bool((a.full_tensor() == b.full_tensor()).all()) for a, b in pairs),
            "placed": all(a.placements == b.placements for a, b in pairs)}


def _worker(rank: int, init: str, out: str) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=WORLD)
    from repro_torch.launch.mesh import make_host_mesh

    mesh = make_host_mesh(model_parallel=2)
    results = {"gather_layer_weights": _hooks_case(mesh, "gather_layer_weights"),
               "reshard": _reshard_case(mesh),
               "checkpoint": _checkpoint_case(mesh, os.path.join(os.path.dirname(out), "ckpt"))}
    _fp32()
    results["constrain_residual"] = _hooks_case(mesh, "constrain_residual")
    results.update({case: _train_case(*CASES[case], mesh) for case in CASES})
    results.update({f"decode {case} B={b}": _decode_case(*CASES[case], mesh, b)
                    for case in CASES for b in DECODE_BATCHES})
    if rank == 0:
        with open(out, "w") as f:
            json.dump(results, f)
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def spmd(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("spmd")
    out = str(tmp / "results.json")
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src"), "OMP_NUM_THREADS": "1"}
    # a file store: no port to race for
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(r),
                               f"file://{tmp / 'store'}", out], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=PROC_TIMEOUT_S)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    assert all(p.returncode == 0 for p in procs), "\n".join(log[-3000:] for log in logs)
    with open(out) as f:
        return json.load(f)


@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_train_step_matches_unsharded(spmd, name):
    r = spmd[name]
    assert abs(r["loss"] - r["loss_ref"]) <= LOSS_REL * abs(r["loss_ref"]), r
    assert abs(r["step_loss"] - r["step_loss_ref"]) <= LOSS_REL * abs(r["step_loss_ref"]), r
    for what in ("grads", "params"):
        bad = {k: v for k, v in r[what].items() if not v <= GRAD_REL}
        assert not bad, (what, bad)
    assert r["placed"]


@pytest.mark.parametrize("b", DECODE_BATCHES)
@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_decode_step_matches_unsharded(spmd, name, b):
    r = spmd[f"decode {name} B={b}"]
    assert all(v <= GRAD_REL for v in r["logits"]), r
    bad = {k: v for k, v in r["cache"].items() if not v <= GRAD_REL}
    assert not bad, bad
    assert r["placed"]


@pytest.mark.parametrize("hook,rel", [("gather_layer_weights", 0.0),
                                      ("constrain_residual", 1e-6)])
def test_hooks_on_or_off_give_equal_values(spmd, hook, rel):
    r = spmd[hook]
    assert r["max_abs"] <= rel * r["scale"], r


def test_reshard_keeps_every_value(spmd):
    r = spmd["reshard"]
    assert r["mesh"] == [4, 1] and r["equal"], r


def test_sharded_checkpoint_round_trips(spmd):
    r = spmd["checkpoint"]
    assert r["step"] == 3 and r["equal"] and r["placed"], r


if __name__ == "__main__":
    _worker(int(sys.argv[1]), sys.argv[2], sys.argv[3])
