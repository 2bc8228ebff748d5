"""The port's tuning loop as a whole against the reference's.

* ``repro_torch.tune`` on the cuda backend (plain versions on the CPU)
  proposes the same configs as ``repro.tune`` on the pallas backend at the
  same seed and budget, and penalises the same ones;
* GA through both packages' ``callable`` backend, on one deterministic
  objective, gives identical histories and winners;
* run records name the device the numbers came from;
* a measurement store written by the reference loads in the port;
* the port imports neither jax nor anything of the reference.
"""

import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest

import repro
import repro_torch
from repro.core import MeasurementStore as RefStore
from repro.core import TuningSession as RefSession
from repro.core import TuningSpec as RefSpec
from repro.core import config_key as ref_config_key
from repro.core.space import paper_space as ref_paper_space
from repro_torch.core import TuningSession, TuningSpec, config_key
from repro_torch.core.space import paper_space
from repro_torch.interop import load_reference_store

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = {"x": 64, "y": 128, "repeats": 1, "warmup": 1}


@pytest.mark.parametrize("constrained", [True, False])
def test_rs_proposes_and_penalises_like_the_reference(constrained):
    common = dict(kernel="add", searcher="rs", budget=10, seed=3, final_repeats=1)
    ref = RefSession(RefSpec(
        backend="pallas", backend_kwargs=SMALL,
        space=None if constrained else ref_paper_space(constrained=False), **common))
    ours = TuningSession(TuningSpec(
        backend="cuda", backend_kwargs={**SMALL, "device": "cpu"},
        space=None if constrained else paper_space(constrained=False), **common))
    r_ref, r_ours = ref.run(), ours.run()
    assert r_ours.history_configs == r_ref.history_configs
    bad_ref = np.isinf(r_ref.history_values)
    bad_ours = np.isinf(r_ours.history_values)
    assert bad_ours.tolist() == bad_ref.tolist()
    assert bad_ours.any() != constrained
    for cfg, bad in zip(r_ours.history_configs, bad_ours, strict=True):
        if bad:
            rule_ours = ours.measurement.reason_for(cfg).split(":")[:2]
            rule_ref = ref.measurement.reason_for(cfg).split(":")[:2]
            assert rule_ours == rule_ref == ["validity", "block"]
    assert math.isfinite(r_ours.final_value)


def _objective(cfg):
    """A deterministic stand-in for a kernel's runtime, with ties."""
    target = dict(t_x=5, t_y=3, t_z=9, w_x=2, w_y=6, w_z=4)
    return 1.0 + sum((cfg[k] - v) ** 2 for k, v in target.items()) / 64.0


@pytest.mark.parametrize("seed", [0, 11])
@pytest.mark.parametrize("dispatch", ["batch", "one"])
def test_ga_trajectory_is_the_reference_trajectory(seed, dispatch):
    common = dict(kernel="objective", searcher="ga", backend="callable",
                  backend_kwargs={"fn": _objective}, budget=150, seed=seed,
                  dispatch=dispatch, final_repeats=1)
    r_ref = repro.tune(RefSpec(space=ref_paper_space(), **common))
    r_ours = repro_torch.tune(TuningSpec(space=paper_space(), **common))
    assert r_ours.history_configs == r_ref.history_configs
    assert r_ours.history_values == r_ref.history_values
    assert r_ours.best_config == r_ref.best_config
    assert r_ours.final_value == r_ref.final_value
    assert r_ours.n_samples == r_ref.n_samples == 150


def test_run_record_names_the_cpu_and_claims_no_gpu(tmp_path):
    path = str(tmp_path / "record.json")
    spec = TuningSpec(kernel="harris", searcher="rs", backend="cuda",
                      backend_kwargs={**SMALL, "device": "cpu"}, budget=4,
                      final_repeats=2)
    spec.to_json()
    result = repro_torch.tune(spec, record_path=path)
    rec = repro_torch.RunRecord.load(path)
    prov = rec.extra["backend_provenance"]
    assert prov["backend"] == "cuda" and prov["device"] == "cpu"
    assert prov["capability"] is None
    assert "CPU" in prov["timer"]
    assert not {"nvcc", "cuda", "build_s"} & set(prov)
    assert not any(w in prov["device_kind"].upper() for w in ("NVIDIA", "H100", "GPU"))
    assert prov["launches"] == 0 and prov["n_compiles"] >= 1
    assert rec.result["final_value"] == result.final_value
    assert len(rec.result["final_repeat_times"]) == 2
    assert rec.spec["backend_kwargs"]["device"] == "cpu"


def test_warm_store_rerun_serves_every_sample(tmp_path):
    spec = TuningSpec(kernel="mandelbrot", searcher="ga", backend="cuda",
                      backend_kwargs={**SMALL, "device": "cpu"}, budget=12,
                      final_repeats=1, store="json",
                      store_path=str(tmp_path / "store.json"))
    cold = TuningSession(spec)
    r1 = cold.run()
    warm = TuningSession(spec)
    r2 = warm.run()
    assert r2.history_configs == r1.history_configs
    assert r2.history_values == r1.history_values
    assert warm.measurement.n_misses == 0


@pytest.mark.parametrize("fmt", [1, 2, 3])
def test_reference_store_loads_in_the_port(tmp_path, fmt):
    path = str(tmp_path / "ref_store.json")
    ref = RefStore(path, autosave_every=0)
    cfgs = paper_space(constrained=False).sample_batch(np.random.default_rng(fmt), 25)
    for i, cfg in enumerate(cfgs):
        key = f"add/pallas/seed=0|{ref_config_key(cfg)}"
        ref.put(key, float("inf") if i % 5 == 0 else 1e-3 * (i + 1))
        if fmt >= 2 and i % 5 == 0:
            ref.put_meta(key, "validity:block:(64,256) exceeds padded image (64,128)")
    if fmt == 3:
        ref.put_winner("add|64x128", json.dumps({"config": cfgs[1], "value": 2e-3}))
    ref.save()
    with open(path) as f:
        raw = json.load(f)
    assert raw.get("__format__", 1) == fmt

    ours = load_reference_store(path)
    assert len(ours) == len(ref) == 25
    assert {k: v for k, v in ours.items()} == {k: v for k, v in ref.items()}
    assert sum(math.isinf(v) for _, v in ours.items()) == 5
    assert dict(ours.meta_items()) == dict(ref.meta_items())
    assert dict(ours.winner_items()) == dict(ref.winner_items())
    for cfg in cfgs:
        assert config_key(cfg) == ref_config_key(cfg)
        assert ours.get(f"add/pallas/seed=0|{config_key(cfg)}") is not None
    with open(path) as f:
        assert json.load(f) == raw           # loading never rewrites the file


#: modules the matrix slice added; the walk below must reach each of them
MATRIX_MODULES = (
    "repro_torch.core.dataset", "repro_torch.core.executors",
    "repro_torch.core.experiment", "repro_torch.core.runner",
    "repro_torch.core.stores", "repro_torch.core.workunits",
    "repro_torch.costmodel", "repro_torch.costmodel.kernel_cost",
    "repro_torch.costmodel.noise", "repro_torch.costmodel.tpu",
)


def test_port_imports_neither_jax_nor_the_reference():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        f"missing = [m for m in {MATRIX_MODULES!r} if m not in sys.modules]\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or n.startswith('jax.')\n"
        "             or n == 'repro' or n.startswith('repro.'))\n"
        "print(len([n for n in sys.modules if n.startswith('repro_torch')]), bad, missing)\n"
        "sys.exit(1 if bad or missing else 0)\n"
    )
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    n_modules = int(out.stdout.split()[0])
    assert n_modules >= 30, out.stdout
