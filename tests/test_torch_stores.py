"""The port's store layer and wrapper backends against the reference's, on
the CPU.

* ``SqliteMeasurementStore``: one seeded sequence of puts, metadata,
  winners and ``best_item`` queries (prefixes holding ``%``, ``_`` and
  ``\\``) leaves both packages' stores equal; a JSON -> sqlite -> JSON
  absorb loses nothing;
* the cost-model matrix (the reference's executor-test spec: harris on
  v5e, rs/rf/ga, S=25, E=4) on ``store="sqlite"`` gives the store values of
  the reference's sqlite run and of the port's JSON run byte for byte, on
  the serial loop and on the device executor (two CPU devices patched in
  for the cards), leaves no shard file, replays warm from a JSON store
  copied into sqlite, and recovers a killed run's sqlite shard;
* the ``cached``, ``disk`` and ``timing`` backends over a ``callable``
  inner backend measure, count and store as the reference's do.
"""

import itertools
import json
import os
import shutil

import numpy as np
import pytest
import torch

from repro.core import ExperimentDesign as RefDesign
from repro.core import TuningSession as RefSession
from repro.core import TuningSpec as RefSpec
from repro.core import clock as ref_clock
from repro.core import make_measurement as ref_make_measurement
from repro.core.stores import SqliteMeasurementStore as RefSqlite
from repro.core.stores import make_store as ref_make_store
from repro_torch import STORES, ExperimentDesign, TuningSession, TuningSpec, make_store
from repro_torch.core import clock as port_clock
from repro_torch.core import executors, make_measurement
from repro_torch.core.executors import absorb_store, shard_store_path
from repro_torch.core.stores import SqliteMeasurementStore

SPEC_KW = dict(
    kernel="harris", backend="costmodel", backend_kwargs={"chip": "v5e"},
    algorithms=("rs", "rf", "ga"), seed=11, dataset_size=200,
)
DESIGN_KW = dict(sample_sizes=(25,), n_experiments=(4,), final_repeats=3)


def port_spec(**kw):
    return TuningSpec(**{**SPEC_KW, "design": ExperimentDesign(**DESIGN_KW), **kw})


def ref_spec(**kw):
    return RefSpec(**{**SPEC_KW, "design": RefDesign(**DESIGN_KW), **kw})


def values_bytes(store) -> bytes:
    """Canonical bytes of a store's measurement VALUES (journal entries in
    the metadata carry wall-clocks, which vary run to run)."""
    return json.dumps(sorted(store.items()), sort_keys=True).encode()


def contents(store) -> tuple:
    return (sorted(store.items()), sorted(store.meta_items()),
            sorted(store.winner_items()))


def shard_files(d) -> list[str]:
    return sorted(f for f in os.listdir(d) if ".shard" in f)


@pytest.fixture
def two_cpu_devices(monkeypatch):
    monkeypatch.setattr(executors, "cuda_devices",
                        lambda: [torch.device("cpu"), torch.device("cpu")])


# ------------------------------------------------------------- the store


#: prefixes whose LIKE patterns need escaping, and ones that look alike
#: once ``%`` / ``_`` act as wildcards
PREFIXES = ("k_1/", "k%1/", "kx1/", "k\\1/", "k_", "k", "")


def _apply(store, rng: np.random.Generator) -> list:
    """One seeded sequence of writes and queries; returns what the queries
    answered."""
    keys = [f"{p}seed={i}|cfg{j}" for p in PREFIXES[:4] for i in range(3) for j in range(4)]
    answers = []
    for step in range(200):
        key = keys[int(rng.integers(len(keys)))]
        op = int(rng.integers(5))
        if op == 0:
            v = float(rng.choice([rng.random(), np.inf, -np.inf, 0.5]))
            store.put(key, v)
        elif op == 1:
            store.put_meta(key, f"note {step} {rng.random()!r}")
        elif op == 2:
            store.put_winner(key, json.dumps({"value": float(rng.random()), "fresh": step}))
        elif op == 3:
            prefix = PREFIXES[int(rng.integers(len(PREFIXES)))]
            contains = [None, "|cfg1", "_", "%"][int(rng.integers(4))]
            answers.append(store.best_item(prefix, contains))
        else:
            answers.append((store.get(key), store.get_meta(key), store.get_winner(key)))
        if step % 37 == 0:
            store.update([(f"bulk/{step}", float(step))])
            store.update_meta([(f"bulk/{step}", "m")])
            store.update_winners([(f"bulk/{step}", "w")])
    prefix_meta = [sorted(store.meta_items(p)) for p in PREFIXES]
    return answers + prefix_meta + [len(store)]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("autosave_every", [0, 7])
def test_sqlite_store_equals_the_reference(tmp_path, seed, autosave_every):
    ours = SqliteMeasurementStore(str(tmp_path / "ours.sqlite"), autosave_every=autosave_every)
    ref = RefSqlite(str(tmp_path / "ref.sqlite"), autosave_every=autosave_every)
    assert _apply(ours, np.random.default_rng(seed)) == _apply(ref, np.random.default_rng(seed))
    assert contents(ours) == contents(ref)
    ours.close()
    ref.close()
    # what was written survives a reopen, in either package
    assert contents(make_store("sqlite", str(tmp_path / "ours.sqlite"))) == \
        contents(ref_make_store("sqlite", str(tmp_path / "ref.sqlite"))) == \
        contents(ref_make_store("sqlite", str(tmp_path / "ours.sqlite")))


def test_json_to_sqlite_to_json_is_lossless(tmp_path):
    assert set(STORES) == {"json", "sqlite"}
    src = make_store("json", str(tmp_path / "a.json"))
    _apply(src, np.random.default_rng(5))
    src.save()
    lite = make_store("sqlite", str(tmp_path / "b.sqlite"))
    absorb_store(lite, "json", str(tmp_path / "a.json"))
    lite.save()
    back = make_store("json", str(tmp_path / "c.json"))
    absorb_store(back, "sqlite", str(tmp_path / "b.sqlite"))
    back.save()
    want = contents(make_store("json", str(tmp_path / "a.json")))
    assert contents(lite) == want
    assert contents(make_store("json", str(tmp_path / "c.json"))) == want


# ------------------------------------------------------ the matrix on sqlite


@pytest.fixture(scope="module")
def reference_sqlite_values(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ref") / "ref.sqlite")
    session = RefSession(ref_spec(store="sqlite", store_path=path))
    session.run_matrix()
    session.store.close()
    return values_bytes(ref_make_store("sqlite", path)), session.last_record.result["cells"]


@pytest.mark.parametrize("run", [
    dict(),
    dict(executor="device", max_workers=2),
    dict(executor="device", max_workers=2, scheduler="static"),
])
def test_sqlite_matrix_equals_the_reference_and_json(tmp_path, two_cpu_devices,
                                                     reference_sqlite_values, run):
    ref_bytes, ref_cells = reference_sqlite_values
    lite = TuningSession(port_spec(store="sqlite", store_path=str(tmp_path / "m.sqlite")))
    lite.run_matrix(**run)
    js = TuningSession(port_spec(store="json", store_path=str(tmp_path / "m.json")))
    js.run_matrix()
    assert isinstance(lite.store, SqliteMeasurementStore)
    assert values_bytes(lite.store) == values_bytes(js.store) == ref_bytes
    assert lite.last_record.result["cells"] == ref_cells
    lite.store.close()
    assert shard_files(tmp_path) == []


def test_sqlite_warm_replay_and_resume_from_a_json_store(tmp_path, two_cpu_devices,
                                                          monkeypatch):
    """The card's phase on the cost model: a cold JSON store copied into
    sqlite (values, the unit journal, winners) replays on the device
    executor with no miss and the same cells, then resumes with no unit."""
    cold = TuningSession(port_spec(store="json", store_path=str(tmp_path / "cold.json")))
    cold_res = cold.run_matrix()
    spec = port_spec(store="sqlite", store_path=str(tmp_path / "warm.sqlite"))
    lite = make_store("sqlite", spec.store_path)
    absorb_store(lite, "json", cold.spec.store_path)
    lite.close()

    misses = []
    orig = executors._run_state_unit

    def counting(state, unit_dict):
        out = orig(state, unit_dict)
        misses.append(state["session"].measurement.n_misses)
        return out

    monkeypatch.setattr(executors, "_run_state_unit", counting)
    warm = TuningSession(spec)
    warm_res = warm.run_matrix(executor="device", max_workers=2)
    assert misses and set(misses) == {0}
    for key in cold_res.cells:
        np.testing.assert_array_equal(warm_res.cells[key].final_values,
                                      cold_res.cells[key].final_values)
    assert values_bytes(warm.store) == values_bytes(cold.store)
    assert shard_files(tmp_path) == []

    resumed = TuningSession(spec)
    resumed.run_matrix(resume=True)
    assert resumed.measurement is None              # no unit ran


def test_sqlite_shards_recover_like_json_ones(tmp_path, monkeypatch):
    """A killed run's sqlite shard (the store and its -wal companion) is
    absorbed by a resume, which then runs nothing that finished."""
    spec = port_spec(algorithms=("rs", "ga"), store="sqlite",
                     store_path=str(tmp_path / "c.sqlite"))
    ghost = TuningSession(spec.replace(store_path=str(tmp_path / "ghost.sqlite")))
    ghost_res = ghost.run_matrix()
    resumed = TuningSession(spec)
    shard = shard_store_path(resumed, 3)
    # the ghost's connection stays open, as a killed worker's would: the
    # shard holds its committed pages, partly in the -wal companion
    for suffix in ("", "-wal", "-shm"):
        if os.path.exists(ghost.spec.store_path + suffix):
            shutil.copy(ghost.spec.store_path + suffix, shard + suffix)
    assert executors.recover_shard_stores(resumed) == 1
    assert shard_files(tmp_path) == []
    ran = []
    orig = TuningSession.run_unit
    monkeypatch.setattr(TuningSession, "run_unit",
                        lambda self, u: ran.append(u) or orig(self, u))
    res = resumed.run_matrix(resume=True)
    assert ran == []
    for key in ghost_res.cells:
        np.testing.assert_array_equal(res.cells[key].final_values,
                                      ghost_res.cells[key].final_values)


# ------------------------------------------------------- wrapper backends


def _objective(cfg):
    return 1.0 + sum((v - 3) ** 2 for v in cfg.values()) / 64.0


def _configs(n=9):
    keys = ("t_x", "t_y", "t_z", "w_x", "w_y", "w_z")
    grid = list(itertools.product(range(1, 4), repeat=2))
    return [dict(zip(keys, (a, b, a, b, 1, 1), strict=True)) for a, b in grid[:n]]


def test_cached_backend_equals_the_reference():
    cfgs = _configs()
    batch = cfgs[:5] + cfgs[:3] + cfgs[5:]
    calls = {"ours": 0, "ref": 0}

    def counted(name):
        def fn(cfg):
            calls[name] += 1
            return _objective(cfg)
        return fn

    ours = make_measurement("cached", kernel="k", inner="callable",
                            inner_kwargs={"fn": counted("ours")})
    ref = ref_make_measurement("cached", kernel="k", inner="callable",
                               inner_kwargs={"fn": counted("ref")})
    for m in (ours, ref):
        m.out = [m.measure_batch(batch).tolist(), m.measure(cfgs[0]),
                 m.measure(cfgs[-1]), m.measure_final(cfgs[1], 3)]
    assert ours.out == ref.out
    assert (ours.n_samples, ours.n_dispatches) == (ref.n_samples, ref.n_dispatches)
    assert calls["ours"] == calls["ref"] == len(cfgs) + 3
    ours.reset()
    assert ours.n_samples == 0 and ours.measure(cfgs[0]) == ref.measure(cfgs[0])
    with pytest.raises(TypeError, match="inner must be"):
        make_measurement("cached", inner=3)


@pytest.mark.parametrize("kind", ["json", "sqlite"])
def test_disk_backend_equals_the_reference(tmp_path, kind):
    # no config repeats within one batch: there the port measures once and
    # the reference each time (a deliberate divergence, test_torch_matrix)
    cfgs = _configs()
    batches = (cfgs[:6], cfgs[:2] + cfgs[6:])
    kw = dict(kernel="harris", seed=4, inner="callable", inner_kwargs={"fn": _objective},
              store=kind)
    ours = make_measurement("disk", store_path=str(tmp_path / f"ours.{kind}"), **kw)
    ref = ref_make_measurement("disk", store_path=str(tmp_path / f"ref.{kind}"), **kw)
    for batch in batches:
        assert ours.measure_batch(batch).tolist() == ref.measure_batch(batch).tolist()
    assert ours.measure(cfgs[7]) == ref.measure(cfgs[7])
    assert ours.measure_final(cfgs[2], 3) == ref.measure_final(cfgs[2], 3)
    assert (ours.n_samples, ours.n_misses) == (ref.n_samples, ref.n_misses) == (12, 9)
    ours.save()
    ref.save()
    assert values_bytes(ours._store) == values_bytes(ref._store)
    assert sorted(k for k, _ in ours._store.items())[0].startswith("harris/seed=4|")
    # warm: a second measurement on the same file serves every config
    warm = make_measurement("disk", store_path=str(tmp_path / f"ours.{kind}"), **kw)
    assert warm.measure_batch(cfgs).tolist() == ref.measure_batch(cfgs).tolist()
    assert warm.n_misses == 0


def test_timing_backend_equals_the_reference():
    """With both packages' clocks ticking 1.0 a reading, the timing backend
    warms each config once, fences, and reads the same values."""
    calls = {"ours": [], "ref": []}

    def runner(name):
        def run(cfg):
            calls[name].append(cfg["t_x"])
            return torch.zeros(2) if name == "ours" else None
        return run

    def ticker():
        t = [0.0]

        def tick():
            t[0] += 1.0
            return t[0]
        return tick

    cfgs = _configs(4)
    prev = (port_clock.set_timer(ticker()), ref_clock.set_timer(ticker()))
    try:
        ours = make_measurement("timing", runner=runner("ours"), warmup=2)
        ref = ref_make_measurement("timing", runner=runner("ref"), warmup=2)
        for m in (ours, ref):
            m.out = [m.measure_batch(cfgs + cfgs[:1]).tolist(),
                     m.measure(cfgs[1]), m.measure_final(cfgs[2], 3)]
    finally:
        port_clock.set_timer(prev[0])
        ref_clock.set_timer(prev[1])
    assert ours.out == ref.out
    assert set(ours.out[0]) == {1.0}
    assert calls["ours"] == calls["ref"]
    assert len(calls["ours"]) == 4 * 2 + 5 + 1 + 3      # 2 warm-ups per config
    assert (ours.n_samples, ours.n_dispatches) == (ref.n_samples, ref.n_dispatches)
