"""The port's persistent cross-process compile cache
(``repro_torch.cuda_bench.compile_cache``) and its integration into
``CudaMeasurement``, against the reference's.

The reference's file-protocol tests run against the port's class (atomic
entries, fingerprint misses, claim/steal/wait, exactly-once ``compute``,
two processes on one directory), then the integration: a cold process
re-running against a warm directory fills nothing, the ``cuda`` backend
(``device="cpu"``) matches the reference's ``pallas`` backend cold and warm
with both clocks ticking 1.0 a reading, a matrix's warm rerun reports zero
compiles as the reference's does, the knob never reaches provenance
namespaces, and only a launch refused for its geometry is ever published.
"""

import itertools
import json
import os
import pickle
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from repro_torch.core import ExperimentDesign, TuningSession, TuningSpec
from repro_torch.core import clock as port_clock
from repro_torch.cuda_bench import CudaMeasurement, make_workload
from repro_torch.cuda_bench.compile_cache import (
    FORMAT_VERSION,
    CompileCache,
    deserialize_compiled,
    library_name,
    runtime_fingerprint,
    serialize_compiled,
)
from repro_torch.kernels import LAUNCHES, _build
from repro_torch.telemetry import for_run_dir, read_run

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")

#: explicit fingerprint so protocol tests need no device
FP = {"format": FORMAT_VERSION, "torch": "test", "cuda": None,
      "device_kind": "fake", "capability": None, "library": "lib.so"}


def cache(tmp_path, **kw) -> CompileCache:
    kw.setdefault("fingerprint", dict(FP))
    return CompileCache(str(tmp_path / "cc"), **kw)


def subprocess_env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    return env


def ticks():
    t = itertools.count()
    return lambda: float(next(t))


@pytest.fixture
def ticking_clocks():
    """Both packages' clocks tick 1.0 a reading, so measured values agree."""
    from repro.core import clock as ref_clock

    ref_clock.set_timer(ticks())
    port_clock.set_timer(ticks())
    try:
        yield
    finally:
        ref_clock.set_timer(None)
        port_clock.set_timer(None)


# ------------------------------------------------------------------ keys


def test_key_stable_and_sensitive(tmp_path):
    c = cache(tmp_path)
    k = c.key(kernel="add", x=64, y=128, geometry=[2, 1, 2])
    assert k == c.key(kernel="add", x=64, y=128, geometry=[2, 1, 2])
    assert len(k) == 32 and int(k, 16) >= 0
    assert k != c.key(kernel="add", x=64, y=128, geometry=[2, 1, 4])
    assert k != c.key(kernel="harris", x=64, y=128, geometry=[2, 1, 2])
    # the runtime fingerprint is part of every key
    other = CompileCache(c.root, fingerprint={**FP, "torch": "other"})
    assert k != other.key(kernel="add", x=64, y=128, geometry=[2, 1, 2])


def test_key_equals_the_reference_under_one_fingerprint(tmp_path):
    from repro.pallas_bench.compile_cache import CompileCache as RefCache

    ours = cache(tmp_path)
    ref = RefCache(str(tmp_path / "ref"), fingerprint=dict(FP))
    for identity in (dict(kernel="add", x=64, y=128, geometry=[16, 128, 1, 1, 1]),
                     dict(kernel="harris", x=8192, y=8192, input_seed=3,
                          device="cpu", geometry=[8, 256, 2, 1, 1])):
        assert ours.key(**identity) == ref.key(**identity)


def test_runtime_fingerprint_has_torch_identity():
    import torch

    fp = runtime_fingerprint("cpu")
    assert fp["format"] == FORMAT_VERSION
    assert fp["torch"] == torch.__version__ and fp["device_kind"] == "cpu"
    assert fp["capability"] is None
    # the library's name comes from the sources' digest: nothing is built
    assert fp["library"] == f"librepro_torch_kernels-{_build._digest()}.so"
    assert fp["library"] == library_name() and not _build._loaded
    if not torch.cuda.is_available():
        assert runtime_fingerprint() == fp


def test_artifact_names_the_library_and_refuses_another():
    blob = serialize_compiled({"kernel": "add", "geometry": [8, 128, 1, 1, 1]})
    art = deserialize_compiled(blob)
    assert art == {"kernel": "add", "geometry": [8, 128, 1, 1, 1],
                   "library": library_name()}
    stale = pickle.dumps({**art, "library": "librepro_torch_kernels-0000.so"})
    with pytest.raises(ValueError, match="library"):
        deserialize_compiled(stale)


# --------------------------------------------------------------- entries


def test_put_get_roundtrip_and_fingerprint_mismatch(tmp_path):
    c = cache(tmp_path)
    assert c.get("k") is None
    c.put("k", status="ok", artifact=b"blob")
    entry = c.get("k")
    assert entry["status"] == "ok" and entry["artifact"] == b"blob"
    c.put("bad", status="invalid", reason="smem:9 > 1", stage="compile")
    assert c.get("bad")["reason"] == "smem:9 > 1"
    # an entry written under a different runtime is a miss, never served
    other = CompileCache(c.root, fingerprint={**FP, "device_kind": "real"})
    assert other.get("k") is None
    assert c.get("k") is not None  # and the entry itself is untouched


def test_corrupt_entry_is_miss(tmp_path):
    c = cache(tmp_path)
    c.put("k", status="ok")
    with open(c._entry_path("k"), "wb") as f:
        f.write(b"\x80\x04 torn pickle")
    assert c.get("k") is None


# ---------------------------------------------------------------- claims


def test_claim_is_exclusive_until_released(tmp_path):
    c = cache(tmp_path)
    assert c.claim("k") is True
    assert c.claim("k") is False      # held
    c.release("k")
    assert c.claim("k") is True       # reclaimable after release
    c.release("k")
    c.release("k")                    # double-release is harmless


def test_stale_claim_is_stolen(tmp_path):
    c = cache(tmp_path, claim_timeout_s=0.05)
    assert c.claim("k")
    old = time.time() - 60
    os.utime(c._claim_path("k"), (old, old))
    # the dead holder's claim is removed and the caller inherits the compile
    assert c.claim("k") is True


def test_wait_times_out_then_serves_published_entry(tmp_path):
    c = cache(tmp_path, poll_s=0.01)
    assert c.claim("k")
    assert c.wait("k", timeout_s=0.05) is None   # holder never published

    def publish():
        time.sleep(0.05)
        c.put("k", status="ok")
        c.release("k")

    t = threading.Thread(target=publish)
    t.start()
    entry = c.wait("k", timeout_s=5.0)
    t.join()
    assert entry is not None and entry["status"] == "ok"


def test_wait_returns_when_holder_vanishes_without_entry(tmp_path):
    c = cache(tmp_path, poll_s=0.01)
    assert c.claim("k")

    def vanish():
        time.sleep(0.05)
        c.release("k")                 # died without ever publishing

    t = threading.Thread(target=vanish)
    t.start()
    assert c.wait("k", timeout_s=5.0) is None
    t.join()


# --------------------------------------------------------------- compute


def test_compute_serves_and_computes_exactly_once(tmp_path):
    c = cache(tmp_path)
    calls = []

    def fn():
        calls.append(1)
        return {"status": "ok", "artifact": b"x"}

    entry, computed = c.compute("k", fn)
    assert computed is True and entry["artifact"] == b"x"
    entry, computed = c.compute("k", fn)
    assert computed is False and entry["artifact"] == b"x"
    assert len(calls) == 1
    assert not os.path.exists(c._claim_path("k"))  # claim released


def test_compute_double_checks_under_the_claim(tmp_path):
    """Another process publishes (and releases) the key between our miss
    and our successful claim: the post-claim re-read serves that entry."""
    c = cache(tmp_path)
    c.put("k", status="ok", artifact=b"theirs")

    class RacyCache(CompileCache):
        """First ``get`` misses — as if the entry landed a moment later."""

        missed = False

        def get(self, key):
            if not RacyCache.missed:
                RacyCache.missed = True
                return None
            return super().get(key)

    racy = RacyCache(c.root, fingerprint=dict(FP))
    entry, computed = racy.compute(
        "k", lambda: pytest.fail("recomputed a published key")
    )
    assert computed is False and entry["artifact"] == b"theirs"


def test_compute_falls_back_locally_when_holder_wedges(tmp_path):
    c = cache(tmp_path, poll_s=0.01)
    assert c.claim("k")               # a wedged holder that never publishes
    fast = CompileCache(c.root, fingerprint=dict(FP), poll_s=0.01,
                        claim_timeout_s=0.05)
    entry, computed = fast.compute("k", lambda: {"status": "ok"})
    assert computed is True and entry["status"] == "ok"
    assert fast.get("k") is None      # nothing published over the claim


CONTENTION_SCRIPT = """
import json, sys, time
from repro_torch.cuda_bench.compile_cache import CompileCache
FP = json.loads(sys.argv[2])
cc = CompileCache(sys.argv[1], fingerprint=FP, poll_s=0.01)
computed = 0
for i in range(6):
    def fn(i=i):
        time.sleep(0.2)
        return {"status": "ok", "artifact": ("art%d" % i).encode()}
    entry, here = cc.compute("key%d" % i, fn)
    assert entry["artifact"] == ("art%d" % i).encode(), entry
    computed += bool(here)
print(json.dumps(computed))
"""


def run_procs(script: str, *argv: str, n: int = 2) -> list[dict]:
    procs = [
        subprocess.Popen([sys.executable, "-c", script, *argv],
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         text=True, cwd=REPO, env=subprocess_env())
        for _ in range(n)
    ]
    outs = [p.communicate(timeout=120) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    return [json.loads(out.strip().splitlines()[-1]) for out, _ in outs]


def test_two_processes_share_the_cache_without_double_compiles(tmp_path):
    root = str(tmp_path / "cc")
    computed = run_procs(CONTENTION_SCRIPT, root, json.dumps(FP))
    assert sum(computed) == 6, computed
    cc = CompileCache(root, fingerprint=dict(FP))
    for i in range(6):
        assert cc.get(f"key{i}")["artifact"] == f"art{i}".encode()
        assert not os.path.exists(cc._claim_path(f"key{i}"))


# ------------------------------------------ cuda integration, cold process

CONFIGS = [
    dict(t_x=2, t_y=1, t_z=2, w_x=1, w_y=1, w_z=1),
    dict(t_x=1, t_y=1, t_z=1, w_x=1, w_y=1, w_z=1),
]

CUDA_SCRIPT = """
import itertools, json, sys, time
from repro_torch.cuda_bench import CudaMeasurement, make_workload
from repro_torch.kernels import LAUNCHES
ticks = itertools.count()
m = CudaMeasurement(
    make_workload("add", x=64, y=128), repeats=1, warmup=1, device="cpu",
    compile_cache=sys.argv[1], timer=lambda: float(next(ticks)),
)
cfgs = json.loads(sys.argv[2])
if len(sys.argv) > 3:     # a slow first launch, so the processes contend
    run = m.workload.bench.run
    m.workload = type(m.workload)(bench=type(m.workload.bench)(
        name="add", n_inputs=2, make_inputs=m.workload.bench.make_inputs,
        run=lambda *a: (time.sleep(0.2), run(*a))[1]), x=64, y=128)
vals = m.measure_batch(cfgs).tolist()
prov = m.provenance()
print(json.dumps({
    "n_compiles": m.n_compiles, "hits": m.run_pcache_hits, "vals": vals,
    "prov_cache": prov["compile_cache"], "prov_hits": prov["n_pcache_hits"],
}))
"""


def test_cold_process_rerun_against_warm_cache_compiles_nothing(tmp_path):
    root = str(tmp_path / "cc")
    [first] = run_procs(CUDA_SCRIPT, root, json.dumps(CONFIGS), n=1)
    assert first["n_compiles"] == 2 and first["hits"] == 0
    [second] = run_procs(CUDA_SCRIPT, root, json.dumps(CONFIGS), n=1)
    assert second["n_compiles"] == 0, second
    assert second["hits"] == 2
    assert second["vals"] == first["vals"]   # deterministic timer: identical
    assert second["prov_cache"] is True and second["prov_hits"] == 2


def test_two_cuda_processes_fill_each_geometry_once(tmp_path):
    """Two processes measuring the same four geometries on one directory:
    each geometry is filled once in all, the loser of each claim waits and
    is served."""
    cfgs = [dict(t_x=tx, t_y=1, t_z=tz, w_x=1, w_y=1, w_z=1)
            for tx in (1, 2) for tz in (1, 2)]
    outs = run_procs(CUDA_SCRIPT, str(tmp_path / "cc"), json.dumps(cfgs), "slow")
    assert sum(o["n_compiles"] for o in outs) == 4, outs
    assert sum(o["hits"] for o in outs) == 4, outs
    assert outs[0]["vals"] == outs[1]["vals"]


def test_cuda_cache_matches_the_reference_cold_and_warm(tmp_path, ticking_clocks):
    """``CudaMeasurement(device="cpu")`` against ``PallasMeasurement`` at
    64x128, both on a cache: equal values, fills and pcache hits, cold and
    then warm in a fresh instance."""
    from repro.pallas_bench import PallasMeasurement
    from repro.pallas_bench import make_workload as ref_workload

    got = {}
    for run in ("cold", "warm"):
        ours = CudaMeasurement(make_workload("add", x=64, y=128), repeats=3,
                               device="cpu", compile_cache=str(tmp_path / "port"))
        ref = PallasMeasurement(ref_workload("add", x=64, y=128), repeats=3,
                                compile_cache=str(tmp_path / "ref"))
        got[run] = [(m.measure_batch(CONFIGS).tolist(), m.measure_final(CONFIGS[0], 5),
                     m.n_compiles, m.n_pcache_hits) for m in (ours, ref)]
        assert got[run][0] == got[run][1], (run, got[run])
    assert got["cold"][0][2:] == (2, 0)
    assert got["warm"][0][2:] == (0, 2)


def test_invalid_entries_are_served_without_a_launch(tmp_path):
    """A launch refused for its geometry is published as ``invalid`` and a
    fresh instance serves the same compile-stage penalty without launching."""
    calls = []

    def refuse(self, inputs, cfg, device):
        calls.append(dict(cfg))
        raise _build.LaunchError("repro_add_f32", 9, "invalid configuration argument")

    root = str(tmp_path / "cc")
    cfg = CONFIGS[0]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(type(make_workload("add")), "run", refuse)
        cold = CudaMeasurement(make_workload("add", x=64, y=128), device="cpu",
                               compile_cache=root)
        assert np.isinf(cold.measure(cfg))
        assert cold.n_compiles == 1 and len(calls) == 1
        warm = CudaMeasurement(make_workload("add", x=64, y=128), device="cpu",
                               compile_cache=root)
        assert np.isinf(warm.measure(cfg))
    assert len(calls) == 1                       # no launch for the warm one
    assert warm.n_compiles == 0 and warm.run_pcache_hits == 1
    assert warm.reason_for(cfg) == cold.reason_for(cfg)
    assert warm.reason_for(cfg).startswith("compile:LaunchError")


def test_non_config_errors_raise_and_are_never_published(tmp_path):
    """Any other launch error raises and leaves no entry and no claim: a
    poisoned cache would penalise a good geometry in every later process."""
    def boom(self, inputs, cfg, device):
        raise RuntimeError("the library failed to load")

    root = str(tmp_path / "cc")
    m = CudaMeasurement(make_workload("add", x=64, y=128), device="cpu",
                        compile_cache=root)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(type(m.workload), "run", boom)
        with pytest.raises(RuntimeError, match="failed to load"):
            m.measure(CONFIGS[0])
    assert not [f for f in os.listdir(root) if f.endswith((".pkl", ".claim"))]
    # the next process fills the geometry and measures it
    fresh = CudaMeasurement(make_workload("add", x=64, y=128), device="cpu",
                            compile_cache=root)
    assert np.isfinite(fresh.measure(CONFIGS[0])) and fresh.n_compiles == 1


def test_entry_of_another_library_is_a_miss(tmp_path):
    """An ``ok`` entry whose artifact names another library is filled again
    (the fingerprint names the library too; this is the artifact's own
    check)."""
    root = str(tmp_path / "cc")
    first = CudaMeasurement(make_workload("add", x=64, y=128), device="cpu",
                            compile_cache=root)
    first.measure(CONFIGS[0])
    key = first._pcache_key(first._geom_key(CONFIGS[0]))
    first.pcache.put(key, status="ok", artifact=pickle.dumps(
        {"kernel": "add", "geometry": [], "library": "another.so"}))
    again = CudaMeasurement(make_workload("add", x=64, y=128), device="cpu",
                            compile_cache=root)
    n = LAUNCHES["add"].n
    assert np.isfinite(again.measure(CONFIGS[0]))
    assert again.n_compiles == 1 and again.run_pcache_hits == 0
    assert LAUNCHES["add"].n == n  # CPU tensors: the plain version, no launch


# ------------------------------------------------- provenance exclusions


def matrix_spec(store_path: str, pkg: str = "port"):
    """The reference test's matrix spec: ``cuda`` (``device="cpu"``) in the
    port, ``pallas`` in the reference."""
    if pkg == "port":
        from repro_torch.core.space import Param, SearchSpace
        spec_cls, backend = TuningSpec, "cuda"
        kwargs = {"x": 64, "y": 128, "repeats": 1, "warmup": 1, "device": "cpu"}
    else:
        from repro.core import TuningSpec as spec_cls
        from repro.core.space import Param, SearchSpace
        backend, kwargs = "pallas", {"x": 64, "y": 128, "repeats": 1, "warmup": 1}
    space = SearchSpace(
        [
            Param.int_range("t_x", 1, 2),
            Param.choice("t_y", (1,)),
            Param.int_range("t_z", 1, 2),
            Param.choice("w_x", (1,)),
            Param.choice("w_y", (1,)),
            Param.choice("w_z", (1,)),
        ]
    )
    return spec_cls(
        kernel="add",
        searcher="rs",
        backend=backend,
        backend_kwargs=kwargs,
        space=space,
        algorithms=("rs",),
        design=ExperimentDesign(
            sample_sizes=(3,), n_experiments=(2,), final_repeats=1
        ),
        seed=0,
        store="json",
        store_path=store_path,
    )


def test_compile_cache_knob_never_reaches_provenance_namespaces(tmp_path):
    from repro_torch.analysis.report import _spec_fingerprint

    plain = matrix_spec(str(tmp_path / "a.json"))
    knobbed = plain.replace(
        backend_kwargs={**plain.backend_kwargs,
                        "compile_cache": str(tmp_path / "cc"),
                        "pipeline_workers": 2}
    )
    assert knobbed.default_cache_key() == plain.default_cache_key()
    s_plain, s_knobbed = TuningSession(plain), TuningSession(knobbed)
    assert s_knobbed.cache_key == s_plain.cache_key
    ns_plain, ns_knobbed = (
        s_plain.journal_namespace(), s_knobbed.journal_namespace()
    )
    assert ns_plain is not None
    assert ns_knobbed == ns_plain
    assert _spec_fingerprint(knobbed.to_dict()) == _spec_fingerprint(plain.to_dict())


def test_matrix_warm_cache_rerun_reports_zero_compiles(tmp_path, ticking_clocks):
    """End to end through ``run_matrix(compile_cache=...)`` on fresh stores:
    the second run fills nothing, and the counters equal the reference's
    ``pallas`` matrix run the same way."""
    from repro.core import TuningSession as RefSession
    from repro.telemetry import for_run_dir as ref_run_dir
    from repro.telemetry import read_run as ref_read

    counters = {}
    for run in ("cold", "warm"):
        tel = for_run_dir(str(tmp_path / f"port_{run}"))
        ours = TuningSession(matrix_spec(str(tmp_path / f"{run}.json")), telemetry=tel)
        res = ours.run_matrix(compile_cache=str(tmp_path / "port_cc"))
        tel.close()
        rtel = ref_run_dir(str(tmp_path / f"ref_{run}"))
        ref = RefSession(matrix_spec(str(tmp_path / f"ref_{run}.json"), "ref"),
                         telemetry=rtel)
        ref_res = ref.run_matrix(compile_cache=str(tmp_path / "ref_cc"))
        rtel.close()
        keys = ("compiles", "pcache.hits", "pcache.stores", "pcache.misses")
        got = [e for e in read_run(str(tmp_path / f"port_{run}"))
               if e["ev"] == "totals"][-1]["counters"]
        want = [e for e in ref_read(str(tmp_path / f"ref_{run}"))
                if e["ev"] == "totals"][-1]["counters"]
        counters[run] = {k: got.get(k, 0) for k in keys}
        assert counters[run] == {k: want.get(k, 0) for k in keys}, (run, got, want)
        assert set(res.cells) == set(ref_res.cells)
        for key in res.cells:
            np.testing.assert_array_equal(res.cells[key].final_values,
                                          ref_res.cells[key].final_values)
    assert counters["cold"]["compiles"] > 0 and counters["cold"]["pcache.stores"] > 0
    assert counters["warm"]["compiles"] == 0 and counters["warm"]["pcache.hits"] > 0


def test_compile_cache_requires_staged_backend(tmp_path):
    from repro_torch.core.space import Param, SearchSpace

    spec = TuningSpec(
        kernel="k", backend="callable",
        space=SearchSpace([Param("a", (1, 2))]),
        algorithms=("rs",),
        design=ExperimentDesign(sample_sizes=(2,), n_experiments=(1,)),
    )
    with pytest.raises(ValueError, match="compile_cache"):
        TuningSession(spec).run_matrix(compile_cache=str(tmp_path / "cc"))
