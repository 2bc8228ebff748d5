"""The port's experiment matrix against the reference's, on the CPU.

* the cost model (``repro_torch.costmodel``): measured values, the
  executable space and the true optimum equal the reference's exactly for
  every kernel and chip;
* the building blocks: ``BatchedForest.fit(bootstrap_idx=...)``,
  ``SampleDataset`` (generation, chunks with wrap-around, the cache file),
  ``build_units``' unit plans and ``ExperimentDesign``/``TuningSpec`` JSON;
* the store layer serves a config repeated within one batch as it stores
  it (a deliberate divergence, so a warm replay equals its cold run);
* ``tune_matrix`` as a whole: on the reference's executor-test spec (harris
  on the cost model's v5e, rs/rf/ga) the cells, the run record's cells and
  the serial store's values equal the reference's exactly; on the port's
  ``cuda`` backend with ``device="cpu"`` a small matrix equals the
  reference's ``pallas`` backend with both packages' clocks swapped for one
  that reads one second more each time;
* each experiment's winner (``best_indices``, the port's own): on the cost
  model, each equals the winner the reference's own paths find at the
  experiment's seed (its dataset chunks, batched forest and searchers),
  each searcher's equals a single ``TuningSession.run`` at that seed and
  budget, each ``rs`` row is its dataset chunk's least, and ``save`` /
  ``load`` keep them (a file without them loads as ``None``).
"""

import itertools
import json

import numpy as np
import pytest

import repro
import repro_torch
from repro.core import ExperimentDesign as RefDesign
from repro.core import MatrixResults as RefMatrixResults
from repro.core import MeasurementStore as RefStore
from repro.core import SampleDataset as RefDataset
from repro.core import TuningSession as RefSession
from repro.core import TuningSpec as RefSpec
from repro.core import build_units as ref_build_units
from repro.core import clock as ref_clock
from repro.core.surrogates.forest_batched import BatchedForest as RefForest
from repro.costmodel import CHIPS as REF_CHIPS
from repro.costmodel import WORKLOADS as REF_WORKLOADS
from repro.costmodel import CostModelMeasurement as RefCostModel
from repro.costmodel import executable_space as ref_executable_space
from repro.costmodel import mean_runtime_estimate as ref_mean_runtime
from repro.costmodel import true_optimum as ref_true_optimum
from repro_torch import ExperimentDesign, SampleDataset, TuningSession, TuningSpec, build_units
from repro_torch.core import MeasurementStore
from repro_torch.core import clock as port_clock
from repro_torch.core.surrogates.forest_batched import BatchedForest
from repro_torch.costmodel import CHIPS, WORKLOADS, CostModelMeasurement, executable_space
from repro_torch.costmodel import mean_runtime_estimate, true_optimum

KERNELS = ("add", "harris", "mandelbrot")
CHIP_NAMES = ("v5e", "v4", "v3")

#: the reference's executor-test spec (tests/test_executors.py)
SPEC_KW = dict(
    kernel="harris", backend="costmodel", backend_kwargs={"chip": "v5e"},
    algorithms=("rs", "rf", "ga"), seed=11, dataset_size=200,
)
DESIGN_KW = dict(sample_sizes=(25,), n_experiments=(4,), final_repeats=3)


def ref_spec(**kw):
    return RefSpec(**{**SPEC_KW, "design": RefDesign(**DESIGN_KW), **kw})


def port_spec(**kw):
    return TuningSpec(**{**SPEC_KW, "design": ExperimentDesign(**DESIGN_KW), **kw})


def assert_same_cells(a, b):
    assert set(a.cells) == set(b.cells)
    for key in a.cells:
        for name in ("final_values", "search_best_values", "n_samples_used"):
            np.testing.assert_array_equal(getattr(a.cells[key], name),
                                          getattr(b.cells[key], name))


def store_values_bytes(store) -> bytes:
    """Canonical bytes of a store's measurement VALUES (journal entries carry
    wall-clocks, which vary run to run)."""
    return json.dumps(sorted(store.items()), sort_keys=True).encode()


# ---------------------------------------------------------------- cost model


@pytest.mark.parametrize("chip", CHIP_NAMES)
@pytest.mark.parametrize("kernel", KERNELS)
def test_cost_model_equals_the_reference(kernel, chip):
    w, c = WORKLOADS[kernel], CHIPS[chip]
    rw, rc = REF_WORKLOADS[kernel], REF_CHIPS[chip]
    space, ref_space = executable_space(w, c), ref_executable_space(rw, rc)
    assert space.constraint.constraint_id == ref_space.constraint.constraint_id
    assert space.cardinalities.tolist() == ref_space.cardinalities.tolist()
    idx = space.sample_indices(np.random.default_rng(3), 300)
    np.testing.assert_array_equal(idx, ref_space.sample_indices(np.random.default_rng(3), 300))
    raw = space.unconstrained().sample_batch(np.random.default_rng(4), 400)
    assert [space.is_valid(cfg) for cfg in raw] == [ref_space.is_valid(cfg) for cfg in raw]

    ours, ref = CostModelMeasurement(w, c, seed=5), RefCostModel(rw, rc, seed=5)
    cfgs = space.decode_batch(idx)
    np.testing.assert_array_equal(ours.measure_batch(cfgs[:200]), ref.measure_batch(cfgs[:200]))
    assert [ours.measure(cfg) for cfg in raw[:20]] == [ref.measure(cfg) for cfg in raw[:20]]
    ours.skip_samples(7)
    ref.skip_samples(7)
    assert ours.measure_final(cfgs[0], 10) == ref.measure_final(cfgs[0], 10)
    assert ours.provenance() == ref.provenance()
    quiet, ref_quiet = CostModelMeasurement(w, c, noise=False), RefCostModel(rw, rc, noise=False)
    assert quiet.measure_final(cfgs[1], 3) == ref_quiet.measure_final(cfgs[1], 3)

    assert true_optimum(w, c) == ref_true_optimum(rw, rc)
    assert mean_runtime_estimate(w, c) == ref_mean_runtime(rw, rc)


# ----------------------------------------------------------- building blocks


@pytest.mark.parametrize("lo,hi", [(0, 3), (1, 3), (2, 3)])
def test_batched_forest_with_bootstrap_rows_predicts_as_the_reference(lo, hi):
    """A slice of a 3-forest cell fit with the full cell's bootstrap rows,
    as a work unit fits it: the port's predictions equal the reference's,
    and equal the whole cell's fit on the slice's forests."""
    rng = np.random.default_rng(0)
    cards = np.array([16, 16, 16, 8, 8, 8])
    n, trees = 15, 20
    X = np.stack([rng.integers(0, cards, size=(n, 6)) for _ in range(hi)])
    y = rng.standard_normal((hi, n))
    pool = rng.integers(0, cards, size=(64, 6))
    boot = np.random.default_rng(11).integers(0, n, size=(hi * trees, n))
    ours = BatchedForest(cards, n_estimators=trees, seed=11).fit(
        X[lo:], y[lo:], bootstrap_idx=boot[lo * trees:])
    ref = RefForest(cards, n_estimators=trees, seed=11).fit(
        X[lo:], y[lo:], bootstrap_idx=boot[lo * trees:])
    np.testing.assert_array_equal(ours.predict(pool), ref.predict(pool))
    whole = BatchedForest(cards, n_estimators=trees, seed=11).fit(X, y)
    np.testing.assert_array_equal(ours.predict(pool), whole.predict(pool)[lo:])
    with pytest.raises(ValueError, match="bootstrap_idx shape"):
        BatchedForest(cards, n_estimators=trees).fit(X, y, bootstrap_idx=boot[:-1])


def test_sample_dataset_equals_the_reference(tmp_path):
    w, c = WORKLOADS["harris"], CHIPS["v5e"]
    rw, rc = REF_WORKLOADS["harris"], REF_CHIPS["v5e"]
    path = str(tmp_path / "dataset.npz")
    ours = SampleDataset.generate(executable_space(w, c), CostModelMeasurement(w, c, seed=2),
                                  n=50, seed=7, cache_path=path)
    ref = RefDataset.generate(ref_executable_space(rw, rc), RefCostModel(rw, rc, seed=2),
                              n=50, seed=7)
    np.testing.assert_array_equal(ours.indices, ref.indices)
    np.testing.assert_array_equal(ours.values, ref.values)
    assert ours.optimum == ref.optimum and len(ours) == 50
    # 30-sample chunks of 50: experiment 1 wraps around the end
    for e, size in ((0, 30), (1, 30), (3, 30), (4, 12)):
        for a, b in zip(ours.chunk(e, size), ref.chunk(e, size), strict=True):
            np.testing.assert_array_equal(a, b)
    # a matching cache file is served without a measurement
    again = SampleDataset.generate(executable_space(w, c), _NoMeasure(), n=50, seed=7,
                                   cache_path=path)
    np.testing.assert_array_equal(again.values, ref.values)


class _NoMeasure:
    def measure_batch(self, configs):
        raise AssertionError("the cached dataset was measured again")


@pytest.mark.parametrize("cap", [None, 1, 3])
@pytest.mark.parametrize("min_units", [1, 3, 6])
def test_unit_plans_equal_the_reference(min_units, cap):
    cells = [("rs", 25, 8), ("rf", 25, 8), ("ga", 50, 4), ("bo_gp", 100, 3)]
    for chip in CHIP_NAMES:
        spec_kw = dict(backend_kwargs={"chip": chip}, dataset_size=None)
        cost = TuningSession(port_spec(**spec_kw))._unit_cost()
        ref_cost = RefSession(ref_spec(**spec_kw))._unit_cost()
        ours = build_units(cells, min_units=min_units, max_unit_experiments=cap, cost=cost)
        ref = ref_build_units(cells, min_units=min_units, max_unit_experiments=cap,
                              cost=ref_cost)
        assert [u.key for u in ours] == [u.key for u in ref]
    # the cuda backend names no chip: its units are weighted as on v5e
    cuda = TuningSession(TuningSpec(kernel="harris", backend="cuda",
                                    design=ExperimentDesign(**DESIGN_KW),
                                    backend_kwargs={"device": "cpu", "x": 64, "y": 128}))
    ref_cost = RefSession(ref_spec(dataset_size=None))._unit_cost()
    assert [u.key for u in build_units(cells, min_units=6, cost=cuda._unit_cost())] == \
        [u.key for u in ref_build_units(cells, min_units=6, cost=ref_cost)]


def test_specs_round_trip_as_the_reference():
    kw = dict(searcher_kwargs={"pop_size": 8}, store="json", store_path="s.json",
              dataset_cache="d.npz", dataset_gen_seed=5)
    ours, ref = port_spec(**kw), ref_spec(**kw)
    assert ours.to_dict() == ref.to_dict()
    assert TuningSpec.from_json(ours.to_json()) == ours
    assert ours.design.total_search_samples == ref.design.total_search_samples == 100
    assert ours.default_cache_key() == ref.default_cache_key() == "harris/v5e"
    assert ours.replace(algorithms=None).matrix_algorithms == ("ga",)
    for name in ("paper", "smoke"):
        assert getattr(ExperimentDesign, name)().to_dict() == getattr(RefDesign, name)().to_dict()
    assert ExperimentDesign.scaled(500).rows() == RefDesign.scaled(500).rows()
    assert port_spec(store="sqlite").to_dict() == ref_spec(store="sqlite").to_dict()
    with pytest.raises(KeyError, match="unknown store"):
        port_spec(store="parquet")


def test_a_config_repeated_in_a_batch_is_served_as_stored(tmp_path):
    """A deliberate divergence: the port's store layer measures a config
    that repeats within one batch once and serves the repeat the stored
    value, so a warm replay serves what the cold run served; the reference
    measures every occurrence (another noise draw) and stores the last.
    Every other sample keeps the reference's value and noise index."""
    from repro.core import DiskCachedMeasurement as RefDisk
    from repro_torch.core import DiskCachedMeasurement, config_key

    w, c = WORKLOADS["harris"], CHIPS["v5e"]
    cfgs = executable_space(w, c).sample_batch(np.random.default_rng(0), 3)
    batch = [cfgs[0], cfgs[1], cfgs[0], cfgs[2]]
    store = MeasurementStore(str(tmp_path / "store.json"))
    cold = DiskCachedMeasurement(CostModelMeasurement(w, c, seed=1), store, prefix="p")
    vals = cold.measure_batch(batch)
    assert vals[0] == vals[2] == store.get(f"p|{config_key(cfgs[0])}")
    assert cold.n_misses == 3 and cold.n_samples == 4
    warm = DiskCachedMeasurement(CostModelMeasurement(w, c, seed=1), store, prefix="p")
    np.testing.assert_array_equal(warm.measure_batch(batch), vals)
    assert warm.n_misses == 0

    ref = RefDisk(RefCostModel(REF_WORKLOADS["harris"], REF_CHIPS["v5e"], seed=1),
                  RefStore(None), prefix="p")
    ref_vals = ref.measure_batch(batch)
    assert ref_vals[2] != ref_vals[0]
    np.testing.assert_array_equal(ref_vals[[0, 1, 3]], vals[[0, 1, 3]])


# -------------------------------------------------------------- the matrix


def test_tune_matrix_equals_the_reference(tmp_path):
    ours_path, ref_path = str(tmp_path / "ours.json"), str(tmp_path / "ref.json")
    ours_session = TuningSession(port_spec(store="json", store_path=ours_path))
    ref_session = RefSession(ref_spec(store="json", store_path=ref_path))
    ours, ref = ours_session.run_matrix(), ref_session.run_matrix()
    assert_same_cells(ours, ref)
    assert ours.optimum == ref.optimum
    assert ours_session.last_record.result == ref_session.last_record.result
    assert ours_session.last_record.kind == "tune_matrix"
    assert [u.key for u in ours_session.last_unit_plan] == \
        [u.key for u in ref_session.last_unit_plan]
    assert store_values_bytes(MeasurementStore(ours_path)) == \
        store_values_bytes(RefStore(ref_path))
    # both journals hold the same units under the same namespace
    assert ours_session.unit_journal().entries() == ref_session.unit_journal().entries()
    # the facade, its artifact and its record (with the cost model's optimum)
    out = str(tmp_path / "out")
    again = repro_torch.tune_matrix(port_spec(), out_dir=out)
    assert_same_cells(again, ref)
    loaded = repro_torch.MatrixResults.load(f"{out}/harris_v5e.npz")
    assert_same_cells(loaded, ref)
    rec = repro_torch.RunRecord.load(f"{out}/harris_v5e.json")
    ref_out = str(tmp_path / "ref_out")
    repro.tune_matrix(ref_spec(), out_dir=ref_out)
    ref_rec = repro.RunRecord.load(f"{ref_out}/harris_v5e.json")
    assert rec.result == ref_rec.result
    assert rec.result["true_optimum"] == ref_rec.result["true_optimum"]
    assert {(w["algo"], w["sample_size"]) for w in rec.extra["cell_wall_s"]} == \
        {("rs", 25), ("rf", 25), ("ga", 25)}


def _ticks():
    """A clock that advances one second per reading: every timed repeat
    reads 1.0 in both packages, so both matrices see the same values."""
    count = itertools.count()
    return lambda: float(next(count))


def test_cuda_backend_matrix_on_the_cpu_equals_the_pallas_matrix(tmp_path):
    small = {"x": 64, "y": 128, "repeats": 1, "warmup": 1}
    design = dict(sample_sizes=(5,), n_experiments=(2,), final_repeats=2)
    common = dict(kernel="harris", algorithms=("rs", "ga"), seed=3)
    ref_clock.set_timer(_ticks())
    port_clock.set_timer(_ticks())
    try:
        ref_session = RefSession(RefSpec(backend="pallas", backend_kwargs=small,
                                         design=RefDesign(**design), **common))
        ref = ref_session.run_matrix()
        session = TuningSession(TuningSpec(
            backend="cuda", backend_kwargs={**small, "device": "cpu"},
            design=ExperimentDesign(**design), store="json",
            store_path=str(tmp_path / "cuda.json"), **common))
        ours = session.run_matrix()
    finally:
        ref_clock.set_timer(None)
        port_clock.set_timer(None)
    assert_same_cells(ours, ref)
    assert all((c.n_samples_used == 5).all() for c in ours.cells.values())
    prov = session.last_record.extra["backend_provenance"]
    assert prov["backend"] == "cuda" and prov["device"] == "cpu" and prov["launches"] == 0
    walls = session.last_record.extra["cell_wall_s"]
    assert all(w["compile_s"] > 0 and w["measure_s"] > 0 for w in walls)


# ------------------------------------------------------ each experiment's winner


WINNER_KW = dict(algorithms=("rs", "rf", "ga", "bo_gp", "bo_tpe"),
                 design_kw=dict(sample_sizes=(12, 25), n_experiments=(3, 2), final_repeats=2))


def winners_spec(ref: bool = False):
    kw = {**SPEC_KW, "algorithms": WINNER_KW["algorithms"]}
    design = (RefDesign if ref else ExperimentDesign)(**WINNER_KW["design_kw"])
    return (RefSpec if ref else TuningSpec)(**kw, design=design)


@pytest.fixture(scope="module")
def winners_matrix():
    session = TuningSession(winners_spec())
    return session, session.run_matrix()


def reference_winners(algo: str, s: int, n_exp: int) -> np.ndarray:
    """Each experiment's winner of one cell, recomputed through the
    reference's own paths with the matrix's experiment seeds: its dataset
    chunks (``rs``), its batched forest (``rf``), its searchers on a fresh
    measurement of the experiment's seed (the rest)."""
    from repro.core import ExperimentUnit as RefUnit
    from repro.core import stable_seed as ref_stable_seed
    from repro.core.searchers import make_searcher as ref_make_searcher

    spec = winners_spec(ref=True)
    session = RefSession(spec)
    if algo == "rf":
        results = session._rf_unit_batched(RefUnit(algo, s, 0, n_exp, n_exp))
    elif algo == "rs":
        results = [session._rs_from_dataset(e, s) for e in range(n_exp)]
    else:
        results = []
        for e in range(n_exp):
            seed = ref_stable_seed(spec.seed, algo, s, e)
            searcher = ref_make_searcher(algo, session.space, seed=seed)
            results.append(searcher.run(session._make_measurement(seed), s,
                                        dispatch=spec.dispatch))
    return np.stack([session.space.encode(r.best_config) for r in results])


@pytest.mark.parametrize("algo", WINNER_KW["algorithms"])
def test_matrix_winners_equal_the_references_searchers(winners_matrix, algo):
    """``best_indices`` (the port's own) of a cost-model matrix holds, per
    experiment, the winner the reference's searchers find at the same
    experiment seeds; finals stay the reference's."""
    session, results = winners_matrix
    ref = RefSession(winners_spec(ref=True)).run_matrix()
    for s, e in session.spec.design.rows():
        cell = results.cells[(algo, s)]
        assert cell.best_indices.dtype == np.int64 and cell.best_indices.shape == (e, 6)
        np.testing.assert_array_equal(cell.best_indices, reference_winners(algo, s, e))
        np.testing.assert_array_equal(cell.final_values, ref.cells[(algo, s)].final_values)


@pytest.mark.parametrize("algo", ["ga", "bo_gp", "bo_tpe"])
def test_searcher_winners_equal_a_single_run(winners_matrix, algo):
    """A searcher experiment's winner is what one ``TuningSession.run`` of
    the same searcher finds at the experiment's seed and budget."""
    session, results = winners_matrix
    for s, n_exp in session.spec.design.rows():
        for e in range(n_exp):
            seed = repro_torch.core.stable_seed(session.spec.seed, algo, s, e)
            single = TuningSession(TuningSpec(
                **{**SPEC_KW, "dataset_size": None, "algorithms": None, "seed": seed},
                searcher=algo, budget=s)).run()
            np.testing.assert_array_equal(results.cells[(algo, s)].best_indices[e],
                                          session.space.encode(single.best_config))


def test_rs_winners_are_the_dataset_chunks_least(winners_matrix):
    session, results = winners_matrix
    dataset = session._get_dataset()
    for s, n_exp in session.spec.design.rows():
        for e in range(n_exp):
            idx, vals = dataset.chunk(e, s)
            np.testing.assert_array_equal(results.cells[("rs", s)].best_indices[e],
                                          idx[int(np.argmin(vals))])


def test_matrix_results_save_and_load_keep_winners(winners_matrix, tmp_path):
    """``save`` writes each cell's winners as ``best_{i}``; ``load`` reads
    them back, and reads a file without them (the reference's, or one
    written before them) as ``None``."""
    _, results = winners_matrix
    path = str(tmp_path / "m.npz")
    results.save(path)
    back = repro_torch.MatrixResults.load(path)
    assert_same_cells(back, results)
    for key, cell in results.cells.items():
        np.testing.assert_array_equal(back.cells[key].best_indices, cell.best_indices)
    ref_path = str(tmp_path / "ref.npz")
    RefMatrixResults.load(path).save(ref_path)          # the reference's writer
    old = repro_torch.MatrixResults.load(ref_path)
    assert_same_cells(old, results)
    assert all(c.best_indices is None for c in old.cells.values())
    old.save(str(tmp_path / "again.npz"))
    assert "best_0" not in np.load(str(tmp_path / "again.npz")).files
