"""The port's sharding rules, meshes, roofline and step accounting against
the reference's (``repro.sharding``, ``repro.launch``), on the CPU.

* ``spec_for``: ``tests/test_sharding.py``'s cases (divisible dims, the
  indivisible fallback, no axis reused, the multi-axis prefix, overrides),
  then every parameter and cache leaf of all ten configs on both production
  meshes, equal by value.  The reference reads a shape-only mesh; the port a
  ``DeviceMesh`` of 256 or 512 ranks on a fake process group (this module's
  fixture, torn down after it).
* DTensor shards a dim over ("pod", "data") in mesh order, JAX in spec
  order: every default rule lists them in mesh order, and the shard sizes
  agree.
* The roofline's analytic functions equal the reference's (relative error
  <= 1e-12) for every config x applicable shape.
* ``dot_flops`` of a reduced dense config and of reduced mamba2 on a 1 x 1
  mesh is within 1 % of the reference's count of its compiled HLO; a
  4-layer count minus a 2-layer count is twice the per-layer count.
* ``degraded_mesh`` over 256 ranks at ``lost_fraction`` 0.5 has the
  reference's (data, model) shape; ``make_production_mesh`` and the
  ``launch.specs`` inputs have the reference's shapes and the port's dtypes.
"""

from __future__ import annotations

import dataclasses
import math

import jax
import numpy as np
import pytest
import torch

import repro.launch.roofline as ref_roofline
from repro.configs import REGISTRY as REF_REGISTRY
from repro.launch import specs as ref_specs
from repro.launch.hlo_analysis import shape_bytes as ref_shape_bytes
from repro.models import abstract_params as ref_abstract
from repro.models import build_model as ref_build
from repro.models import param_axes as ref_param_axes
from repro.runtime.elastic import degraded_mesh as ref_degraded_mesh
from repro.sharding import ShardingRules as RefRules
from repro_torch.configs import REGISTRY, SHAPES, applicable_shapes
from repro_torch.configs.base import ShapeCfg
from repro_torch.launch import roofline, specs
from repro_torch.launch.hlo_analysis import dot_flops, shape_bytes
from repro_torch.launch.mesh import make_production_mesh, start_fake_process_group
from repro_torch.models import abstract_params, build_model, param_axes
from repro_torch.runtime import degraded_mesh
from repro_torch.sharding import DEFAULT_RULES, ShardingRules, batch_spec
from repro_torch.sharding.regions import local_shape
from repro_torch.sharding.rules import PartitionSpec
from repro_torch.tree import tree_paths

CONFIGS = sorted(REGISTRY)
MESHES = ("single", "multipod")


class _FakeMesh:
    """``tests/test_sharding.py``'s shape-only mesh, for the reference."""

    def __init__(self, shape: dict):
        self.shape = shape
        self.axis_names = tuple(shape)


REF_MESHES = {"single": _FakeMesh({"data": 16, "model": 16}),
              "multipod": _FakeMesh({"pod": 2, "data": 16, "model": 16})}


@pytest.fixture(scope="module")
def meshes():
    import torch.distributed as dist

    start_fake_process_group(512)
    yield {"single": make_production_mesh(multi_pod=False),
           "multipod": make_production_mesh(multi_pod=True)}
    dist.destroy_process_group()


def _same(ref_spec, ours) -> bool:
    return tuple(ref_spec) == tuple(ours)


# ---------------------------------------------------------------- spec_for


def test_spec_for_divisible_dims(meshes):
    args = (("vocab", "embed"), (64000, 7168))
    ours = ShardingRules().spec_for(*args, meshes["single"])
    assert ours == PartitionSpec("model", "data")
    assert _same(RefRules().spec_for(*args, REF_MESHES["single"]), ours)


def test_spec_for_indivisible_falls_back(meshes):
    args = (("embed", "heads", "head_dim"), (7168, 56, 128))
    ours = ShardingRules().spec_for(*args, meshes["single"])
    assert ours[1] is None
    assert _same(RefRules().spec_for(*args, REF_MESHES["single"]), ours)


def test_spec_for_never_reuses_axis(meshes):
    args = (("batch", "kv_seq"), (128, 32768))
    ours = ShardingRules().spec_for(*args, meshes["single"])
    assert ours[0] == "data" and ours[1] is None
    assert _same(RefRules().spec_for(*args, REF_MESHES["single"]), ours)


@pytest.mark.parametrize("batch,want", [(2, ("pod",)), (1, (None,)), (64, (("pod", "data"),))])
def test_spec_for_multi_axis_prefix(meshes, batch, want):
    ours = ShardingRules().spec_for(("batch",), (batch,), meshes["multipod"])
    assert ours == PartitionSpec(*want)
    assert _same(RefRules().spec_for(("batch",), (batch,), REF_MESHES["multipod"]), ours)


def test_overrides(meshes):
    ours = ShardingRules().with_overrides(kv_seq=()).spec_for(("kv_seq",), (32768,),
                                                              meshes["single"])
    ref = RefRules().with_overrides(kv_seq=()).spec_for(("kv_seq",), (32768,),
                                                        REF_MESHES["single"])
    assert ours == PartitionSpec(None) and _same(ref, ours)
    for name in MESHES:
        assert _same(RefRules().mesh_axes_for("embed", REF_MESHES[name]),
                     ShardingRules().mesh_axes_for("embed", meshes[name]))


def test_batch_spec_and_default_rules(meshes):
    from repro.sharding.rules import DEFAULT_RULES as REF_DEFAULT
    from repro.sharding.rules import batch_spec as ref_batch_spec

    assert DEFAULT_RULES == REF_DEFAULT
    for name in MESHES:
        for extra in (1, 2):
            assert _same(ref_batch_spec(REF_MESHES[name], extra), batch_spec(meshes[name], extra))


def _cache_leaves(name: str, shape_name: str, ref: bool):
    """(axes, shape) per cache leaf of one decode cell."""
    shape = SHAPES[shape_name]
    if ref:
        model = ref_build(REF_REGISTRY[name])
        cache = ref_specs.decode_specs(REF_REGISTRY[name], shape, model)["cache"]
        flat = {k: tuple(v.shape) for k, v in tree_paths(cache).items()}
    else:
        model = build_model(REGISTRY[name])
        flat = {k: tuple(v.shape) for k, v in tree_paths(
            specs.decode_specs(REGISTRY[name], shape, model)["cache"]).items()}
    axes = tree_paths(model.cache_axes())
    return {k: (tuple(axes[k]), flat[k]) for k in flat}


def _decode_shapes(name: str) -> list[str]:
    return [s for s in applicable_shapes(REGISTRY[name]) if SHAPES[s].kind == "decode"]


@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("name", CONFIGS)
def test_spec_for_every_leaf_of_every_config(meshes, name, mesh_name):
    ours, ref = ShardingRules(), RefRules()
    mesh, ref_mesh = meshes[mesh_name], REF_MESHES[mesh_name]
    spec = build_model(REGISTRY[name]).spec()
    r_spec = ref_build(REF_REGISTRY[name]).spec()
    p_axes = tree_paths(param_axes(spec))
    shapes = {k: tuple(v.shape) for k, v in tree_paths(abstract_params(spec)).items()}
    r_axes = tree_paths(ref_param_axes(r_spec))
    r_shapes = {k: tuple(v.shape) for k, v in tree_paths(ref_abstract(r_spec)).items()}
    assert p_axes == {k: tuple(v) for k, v in r_axes.items()} and shapes == r_shapes
    leaves = {f"params/{k}": (p_axes[k], shapes[k]) for k in p_axes}
    for shape_name in _decode_shapes(name):
        got = _cache_leaves(name, shape_name, ref=False)
        assert got == _cache_leaves(name, shape_name, ref=True)
        leaves.update({f"{shape_name}/{k}": v for k, v in got.items()})
    bad = {k: (ref.spec_for(a, s, ref_mesh), ours.spec_for(a, s, mesh))
           for k, (a, s) in leaves.items()
           if not _same(ref.spec_for(a, s, ref_mesh), ours.spec_for(a, s, mesh))}
    assert not bad, bad
    # DTensor's local shard: each sharded dim split by its axes' product,
    # multi-axis dims listed in mesh order (DTensor's order) by every rule
    order = list(mesh.mesh_dim_names)
    for k, (a, s) in leaves.items():
        sh = ours.sharding_for(a, s, mesh)
        want = tuple(d // math.prod(dict(zip(order, mesh.mesh.shape, strict=True))[x]
                                    for x in ((p,) if isinstance(p, str) else p or ()))
                     for d, p in zip(s, tuple(sh.spec) + (None,) * (len(s) - len(sh.spec)),
                                     strict=True))
        assert local_shape(s, sh) == want, k
        for p in sh.spec:
            if isinstance(p, tuple):
                assert list(p) == sorted(p, key=order.index), (k, p)


def test_shape_bytes_matches_the_reference():
    assert shape_bytes(torch.float32, (128, 256)) == ref_shape_bytes("f32[128,256]{1,0}")
    assert shape_bytes(torch.bfloat16, (2, 2)) + shape_bytes(torch.int32, ()) == \
        ref_shape_bytes("(bf16[2,2], s32[])")


def test_degraded_mesh_matches_the_reference(meshes):
    ref = ref_degraded_mesh(np.asarray(jax.devices() * 256), 0.5)
    ours = degraded_mesh(list(range(256)), 0.5)
    assert tuple(ours.mesh.shape) == (ref.shape["data"], ref.shape["model"])
    assert ours.mesh_dim_names == ("data", "model")


def test_production_meshes(meshes):
    assert tuple(meshes["single"].mesh.shape) == (16, 16)
    assert meshes["multipod"].mesh_dim_names == ("pod", "data", "model")


def test_input_specs_match_the_reference():
    for name in ("yi-34b", "whisper-medium"):
        for shape_name, fn, ref_fn in (("train_4k", specs.train_batch_specs,
                                        ref_specs.train_batch_specs),
                                       ("prefill_32k", specs.prefill_batch_specs,
                                        ref_specs.prefill_batch_specs)):
            ours = fn(REGISTRY[name], SHAPES[shape_name])
            ref = ref_fn(REF_REGISTRY[name], SHAPES[shape_name])
            assert {k: tuple(v.shape) for k, v in ours.items()} == \
                {k: tuple(v.shape) for k, v in ref.items()}
            assert all(v.device.type == "meta" for v in ours.values())
            assert all(v.dtype == (torch.float32 if k == "src_embeds" else torch.int64)
                       for k, v in ours.items())


# ---------------------------------------------------------------- roofline


@pytest.mark.parametrize("name", CONFIGS)
def test_roofline_analytics_match_the_reference(name):
    assert roofline.matmul_params(REGISTRY[name]) == ref_roofline.matmul_params(REF_REGISTRY[name])
    for shape_name in applicable_shapes(REGISTRY[name]):
        for fn in ("model_flops", "cache_bytes", "memory_bytes"):
            ours = getattr(roofline, fn)(REGISTRY[name], SHAPES[shape_name])
            ref = getattr(ref_roofline, fn)(REF_REGISTRY[name], SHAPES[shape_name])
            assert abs(ours - ref) <= 1e-12 * abs(ref), (fn, shape_name, ours, ref)


def test_roofline_row_holds_no_tpu_constant():
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.ICI_BW) == (989e12, 3.35e12, 450e9)
    rec = {"n_devices": 512, "flops_dot_corrected": 1e12, "collectives": {"total_bytes": 9e9},
           "memory": {"peak_bytes_per_dev": 2**30}}
    row = roofline.roofline_row("yi-34b", "train_4k", rec)
    assert row.chips == 512 and row.collective_s == 9e9 / 450e9
    ideal = row.model_flops / (512 * 989e12)
    assert row.roofline_fraction == pytest.approx(ideal / row.step_s, rel=1e-12)
    assert "yi-34b" in roofline.markdown_table([row])


# ---------------------------------------------------------------- dot FLOPs


TINY = ShapeCfg("tiny_train", seq_len=64, global_batch=2, kind="train")


def _one_by_one():
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh("cpu", torch.zeros((1, 1), dtype=torch.int64),
                      mesh_dim_names=("data", "model"))


def _port_flops(cfg) -> float:
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch.dryrun import build_step

    mesh = _one_by_one()
    with FakeTensorMode():
        fn, args = build_step(cfg, TINY, mesh, ShardingRules())
        return dot_flops(fn, *args)["flops"]


def _ref_flops(cfg) -> float:
    from jax.sharding import Mesh

    from repro.launch.dryrun import build_step as ref_build_step
    from repro.launch.hlo_analysis import dot_flops as ref_dot_flops

    mesh = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    with mesh:
        fn, args = ref_build_step(cfg, TINY, mesh, RefRules())
        return ref_dot_flops(fn.lower(*args).compile().as_text())["flops"]


@pytest.mark.parametrize("name", ["yi-34b", "mamba2-130m"])
def test_dot_flops_match_the_reference_on_one_device(meshes, name):
    ours = _port_flops(REGISTRY[name].reduced())
    ref = _ref_flops(REF_REGISTRY[name].reduced())
    assert abs(ours - ref) <= 0.01 * ref, (ours, ref)


def test_dot_flops_scale_with_depth(meshes):
    base = REGISTRY["yi-34b"].reduced()
    two, three, four = (_port_flops(dataclasses.replace(base, n_layers=n)) for n in (2, 3, 4))
    assert three > two and four - two == 2 * (three - two)


def test_dot_flops_count_local_shards(meshes):
    """On the 16 x 16 mesh a sharded matmul counts one rank's share."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.sharding.regions import empty_like_sharded

    mesh = meshes["single"]
    rules = ShardingRules()
    with FakeTensorMode():
        meta = lambda *s: torch.empty(s, device="meta")
        x = empty_like_sharded(meta(256, 7168), rules.sharding_for(("batch", None), (256, 7168),
                                                                    mesh))
        w = empty_like_sharded(meta(7168, 64000), rules.sharding_for(
            (None, "vocab"), (7168, 64000), mesh))
        got = dot_flops(lambda a, b: a @ b, x, w)["flops"]
    assert got == 2 * 256 * 7168 * 64000 / 256


def test_propagation_hook_missing_raises(monkeypatch):
    """Without DTensor's private fake-mode hook the counts would turn global:
    the counter refuses to run rather than count them."""
    import torch.distributed.tensor._sharding_prop as prop

    from repro_torch.launch.hlo_analysis import propagation_off_the_books

    monkeypatch.delattr(prop, "detect_fake_mode")
    with pytest.raises(RuntimeError, match="detect_fake_mode"):
        with propagation_off_the_books():
            pass
