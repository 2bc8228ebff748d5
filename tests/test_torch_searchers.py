"""The port's searchers, surrogates and space helpers against the reference's.

* each of ``rf``, ``bo_gp``, ``bo_tpe``, ``sa``, ``pso`` and ``grid`` gives the
  reference's exact history, winner and sample count through both packages'
  ``callable`` backend, in both dispatch modes;
* ``bo_gp`` and ``bo_tpe`` through ``repro_torch.tune`` on the cuda backend
  (plain versions on the CPU) propose and penalise the same configs as
  ``repro.tune`` on the pallas backend;
* the surrogates alone: the batched forest predicts exactly what the
  reference's does, the per-node forest agrees with the batched one, the GP's
  posterior and expected improvement match the reference's;
* the new space helpers and ``TuningResult.trajectory`` on seeded inputs;
* the reference's behavioural checks, on the port: budgets, constraints, and
  the ``rf`` winner taken from its predictions;
* the constraint's batch screen (``SearchSpace.valid_mask``): ``rf``, ``rs``,
  ``ga``, ``pso`` and ``grid`` propose the same configs with it and with
  the row-by-row loop, rejection sampling leaves the same random stream,
  and constraints without a batch form (or spaces with a categorical
  parameter) go through the loop.
"""

import itertools

import numpy as np
import pytest

import repro
import repro.core.clock as ref_clock
import repro_torch
import repro_torch.core.clock as port_clock
from repro.core import EXTRA_ALGORITHMS as REF_EXTRA
from repro.core import PAPER_ALGORITHMS as REF_PAPER
from repro.core import TuningSession as RefSession
from repro.core import TuningSpec as RefSpec
from repro.core.searchers import TuningResult as RefResult
from repro.core.space import Param as RefParam
from repro.core.space import SearchSpace as RefSpace
from repro.core.space import paper_space as ref_paper_space
from repro.core.surrogates import GaussianProcess as RefGP
from repro.core.surrogates import RandomForestRegressor as RefForest
from repro.core.surrogates.forest_batched import BatchedForest as RefBatchedForest
from repro.core.surrogates.gp import expected_improvement as ref_ei
from repro_torch.core import (
    EXTRA_ALGORITHMS,
    PAPER_ALGORITHMS,
    SEARCHERS,
    CallableMeasurement,
    TuningSession,
    TuningSpec,
    make_searcher,
)
from repro_torch.core.searchers import TuningResult
from repro_torch.core.space import Param, SearchSpace, paper_space
from repro_torch.core.surrogates import GaussianProcess, RandomForestRegressor
from repro_torch.core.surrogates.forest_batched import BatchedForest
from repro_torch.core.surrogates.gp import expected_improvement

NEW = ("rf", "bo_gp", "bo_tpe", "sa", "pso", "grid")
ALL = PAPER_ALGORITHMS + EXTRA_ALGORITHMS
SMALL = {"x": 64, "y": 128, "repeats": 1, "warmup": 1}


def _objective(cfg):
    """A deterministic stand-in for a kernel's runtime, with ties."""
    target = dict(t_x=5, t_y=3, t_z=9, w_x=2, w_y=6, w_z=4)
    return 1.0 + sum((cfg[k] - v) ** 2 for k, v in target.items()) / 64.0


def test_registry_is_the_references():
    assert PAPER_ALGORITHMS == REF_PAPER and EXTRA_ALGORITHMS == REF_EXTRA
    assert repro_torch.PAPER_ALGORITHMS == REF_PAPER
    assert repro_torch.EXTRA_ALGORITHMS == REF_EXTRA
    assert sorted(SEARCHERS) == sorted(ALL)


# ------------------------------------------------------------- (a) histories


@pytest.mark.parametrize("budget", [25, 60])
@pytest.mark.parametrize("seed", [0, 11])
@pytest.mark.parametrize("dispatch", ["batch", "one"])
@pytest.mark.parametrize("algo", NEW)
def test_history_is_the_reference_history(algo, dispatch, seed, budget):
    common = dict(kernel="objective", searcher=algo, backend="callable",
                  backend_kwargs={"fn": _objective}, budget=budget, seed=seed,
                  dispatch=dispatch, final_repeats=1)
    r_ref = repro.tune(RefSpec(space=ref_paper_space(), **common))
    r_ours = repro_torch.tune(TuningSpec(space=paper_space(), **common))
    assert r_ours.history_configs == r_ref.history_configs
    assert r_ours.history_values == r_ref.history_values
    assert r_ours.best_config == r_ref.best_config
    assert r_ours.best_value == r_ref.best_value
    assert r_ours.final_value == r_ref.final_value
    assert r_ours.n_samples == r_ref.n_samples == budget


# ------------------------------------------- (b) penalties on kernel backends


def _narrow(P, S):
    """A space at 64x128 where about a third of the configs fit the image,
    so searches see penalties and finite values mixed."""
    return S([P.int_range("t_x", 1, 4), P.int_range("t_y", 1, 2),
              P.int_range("t_z", 1, 4), P.int_range("w_x", 1, 8),
              P.int_range("w_y", 1, 8), P.int_range("w_z", 1, 8)])


def _ticks():
    """A clock that advances one second per reading: every timed repeat
    reads 1.0 in both packages, so their searches see the same values."""
    count = itertools.count()
    return lambda: float(next(count))


@pytest.mark.parametrize("space", ["backend", "narrow"])
@pytest.mark.parametrize("algo,kwargs", [("bo_gp", {}), ("bo_tpe", {"n_startup": 4})])
def test_smbo_proposes_and_penalises_like_the_reference(algo, kwargs, space):
    common = dict(kernel="add", searcher=algo, searcher_kwargs=kwargs, budget=12,
                  seed=0, final_repeats=1)
    narrow = space == "narrow"
    ref_clock.set_timer(_ticks())
    port_clock.set_timer(_ticks())
    try:
        r_ref = RefSession(RefSpec(
            backend="pallas", backend_kwargs=SMALL,
            space=_narrow(RefParam, RefSpace) if narrow else None, **common)).run()
        r_ours = TuningSession(TuningSpec(
            backend="cuda", backend_kwargs={**SMALL, "device": "cpu"},
            space=_narrow(Param, SearchSpace) if narrow else None, **common)).run()
    finally:
        ref_clock.set_timer(None)
        port_clock.set_timer(None)
    assert r_ours.history_configs == r_ref.history_configs
    bad_ref = np.isinf(r_ref.history_values)
    bad_ours = np.isinf(r_ours.history_values)
    assert bad_ours.tolist() == bad_ref.tolist()
    assert bad_ours.any()
    assert r_ours.history_values == r_ref.history_values
    assert r_ours.best_config == r_ref.best_config
    if narrow:
        assert not bad_ours.all()
        if algo == "bo_gp":
            # a penalty before the first finite value: when that value came,
            # the stored penalty was re-clipped and the GP refit
            assert bad_ours[0] and not bad_ours[1:].all()


# ---------------------------------------------------------- (c) surrogates


def _toy(X):
    return (X[:, 0] - 8.0) ** 2 + 3.0 * X[:, 3] + 0.5 * X[:, 1]


#: forests, training rows, pools as (rows, one per forest), trees, max_depth,
#: targets.  The descent's blocks hold max(1, 2**16 // P) trees: one at
#: P = 65,536, several with a partial last block at P = 2,048 and 16,384,
#: whole forests at P = 1 and 7 (where numpy's mean over T is pairwise);
#: 33 forests cross the 32 a chunk the descent once took; 390 rows are the
#: paper's S = 400; equal targets grow single-leaf trees; max_depth cuts.
_FOREST_CASES = {
    "1": (1, 80, ((500, False), (64, True)), 30, 32, "toy"),
    "3": (3, 80, ((500, False), (64, True)), 30, 32, "toy"),
    "rf-100": (1, 90, ((16384, False),), 100, 32, "toy"),
    "p65536": (1, 15, ((65536, False),), 10, 32, "toy"),
    "g33-p1": (33, 15, ((1, False), (1, True)), 30, 32, "toy"),
    "g33-p7": (33, 15, ((7, False), (7, True)), 30, 32, "toy"),
    "g33-p2048": (33, 15, ((2048, False),), 30, 32, "toy"),
    "g3-p16384-per-forest": (3, 15, ((16384, True),), 30, 32, "toy"),
    "matrix-s25": (4, 15, ((2048, False),), 100, 32, "toy"),
    "matrix-s50": (2, 40, ((2048, False), (2048, True)), 100, 32, "toy"),
    "n2": (3, 2, ((1, False), (7, True), (2048, False)), 30, 32, "toy"),
    "n390": (1, 390, ((2048, False), (7, False)), 100, 32, "toy"),
    "single-leaf": (3, 15, ((7, False), (2048, True)), 30, 32, "equal"),
    "max-depth": (3, 90, ((7, True), (2048, False)), 30, 3, "toy"),
}


def _forest_data(rng, space, n_forests, n_train, targets):
    X = np.stack([space.sample_indices(rng, n_train) for _ in range(n_forests)])
    if targets == "equal":
        return X, np.full((n_forests, n_train), 1.5)
    return X, np.stack([_toy(x) + rng.normal(0, 0.05, len(x)) for x in X])


@pytest.mark.parametrize("case", list(_FOREST_CASES))
def test_batched_forest_predicts_what_the_reference_predicts(case):
    n_forests, n_train, pools, trees, max_depth, targets = _FOREST_CASES[case]
    space = paper_space(constrained=False)
    rng = np.random.default_rng(1)
    X, y = _forest_data(rng, space, n_forests, n_train, targets)
    kw = dict(n_estimators=trees, max_depth=max_depth, seed=4)
    ours = BatchedForest(space.cardinalities, **kw).fit(X, y)
    ref = RefBatchedForest(space.cardinalities, **kw).fit(X, y)
    for rows, per_forest in pools:
        if per_forest:
            pool = np.stack([space.sample_indices(rng, rows) for _ in range(n_forests)])
        else:
            pool = space.sample_indices(rng, rows)
        assert np.array_equal(ours.predict(pool), ref.predict(pool)), (rows, per_forest)


@pytest.mark.parametrize("targets,max_depth", [("toy", 32), ("equal", 32), ("toy", 3)],
                         ids=["grown", "single-leaf", "max-depth"])
def test_batched_forest_lays_siblings_side_by_side_and_records_depth(targets, max_depth):
    """``fit`` puts a split's right child at ``left + 1`` (the descent's step
    relies on it) and records each tree's depth, its longest root-to-leaf
    path; a refit after a prediction predicts the new fit."""
    space = paper_space(constrained=False)
    rng = np.random.default_rng(2)
    X, y = _forest_data(rng, space, 3, 90, targets)
    forest = BatchedForest(space.cardinalities, n_estimators=30, max_depth=max_depth, seed=4)
    with pytest.raises(RuntimeError, match="call fit first"):
        forest.predict(X[0])
    forest.fit(X, y)
    inner = forest.left >= 0
    assert np.array_equal(forest.right[inner], forest.left[inner] + 1)
    longest = []
    for root in forest.root:
        stack, deepest = [(root, 0)], 0
        while stack:
            node, level = stack.pop()
            if forest.left[node] < 0:
                deepest = max(deepest, level)
            else:
                stack += [(forest.left[node], level + 1), (forest.right[node], level + 1)]
        longest.append(deepest)
    assert forest.depth.tolist() == longest
    if targets == "equal":
        assert max(longest) == 0
    elif max_depth == 3:
        assert max(longest) == 3
    else:
        assert max(longest) > 3
    pool = space.sample_indices(rng, 300)
    forest.predict(pool)
    X2, y2 = _forest_data(rng, space, 3, 40, "toy")
    ref = RefBatchedForest(space.cardinalities, n_estimators=30, max_depth=max_depth, seed=4)
    assert np.array_equal(forest.fit(X2, y2).predict(pool), ref.fit(X2, y2).predict(pool))


def test_forest_against_batched_forest():
    space = paper_space(constrained=False)
    rng = np.random.default_rng(1)
    X = space.sample_indices(rng, 250)
    y = _toy(X) + rng.normal(0, 0.05, len(X))
    pool = space.sample_indices(rng, 400)
    ref = RandomForestRegressor(n_estimators=40, seed=0).fit(X.astype(float), y)
    bat = BatchedForest(space.cardinalities, n_estimators=40, seed=0).fit(X[None], y[None])
    pr, pb = ref.predict(pool.astype(float)), bat.predict(pool)[0]
    corr = np.corrcoef(pr, pb)[0, 1]
    assert corr > 0.97, corr
    # and the per-node forest is the reference's, prediction for prediction
    theirs = RefForest(n_estimators=40, seed=0).fit(X.astype(float), y)
    assert np.array_equal(pr, theirs.predict(pool.astype(float)))


def _close(a, b, rtol=1e-12):
    return np.all(np.abs(a - b) <= rtol * np.maximum(np.abs(b), 1e-300))


def test_gp_posterior_is_the_references():
    rng = np.random.default_rng(4)
    X = rng.uniform(0, 1, size=(40, 6))
    y = np.sin(4 * X[:, 0]) + (X[:, 1:] ** 2).sum(1)
    Xs = rng.uniform(0, 1, size=(200, 6))
    ours, ref = GaussianProcess().fit(X[:20], y[:20]), RefGP().fit(X[:20], y[:20])
    assert (ours.lengthscale, ours.noise) == (ref.lengthscale, ref.noise)
    for step in range(21):
        mu, sd = ours.predict(Xs)
        mu_r, sd_r = ref.predict(Xs)
        assert _close(mu, mu_r) and _close(sd, sd_r), step
        best = float(np.min(y[: 20 + step]))
        assert np.array_equal(expected_improvement(mu, sd, best),
                              ref_ei(mu_r, sd_r, best))
        if step < 20:    # incremental rank-1 appends, one refit at n = 40
            ours.add(X[20 + step], y[20 + step])
            ref.add(X[20 + step], y[20 + step])


def test_expected_improvement_is_the_references():
    rng = np.random.default_rng(6)
    mu = rng.normal(size=1000)
    sigma = np.abs(rng.normal(size=1000))
    sigma[::7] = 0.0
    for best, xi in ((0.0, 0.0), (-1.5, 0.01), (2.0, 0.1)):
        assert np.array_equal(expected_improvement(mu, sigma, best, xi),
                              ref_ei(mu, sigma, best, xi))


# ------------------------------------------------- (d) space and trajectory


def test_space_helpers_are_the_references():
    ours, ref = paper_space(), ref_paper_space()
    rng_o, rng_r = np.random.default_rng(9), np.random.default_rng(9)
    idx = ours.sample_indices(rng_o, 300)
    assert np.array_equal(idx, ref.sample_indices(rng_r, 300))
    assert np.array_equal(ours.to_unit(idx), ref.to_unit(idx))
    u = np.random.default_rng(2).uniform(-0.2, 1.2, size=(300, 6))
    u[:3] = np.array([0.0, 1.0, np.nextafter(1.0, 0.0)])[:, None]
    assert np.array_equal(ours.from_unit(u), ref.from_unit(u))
    assert np.array_equal(ours.from_unit(ours.to_unit(idx)), idx)
    assert np.array_equal(ours.flat_keys(idx), ref.flat_keys(idx))
    assert len(set(ours.flat_keys(idx).tolist())) == len({tuple(r) for r in idx})
    for row in idx[:20]:
        assert np.array_equal(ours.mutate_batch(rng_o, row, 0.3, 17),
                              ref.mutate_batch(rng_r, row, 0.3, 17))
        assert np.array_equal(ours.neighbor(rng_o, row), ref.neighbor(rng_r, row))
    sp = SearchSpace([Param.int_range("a", 1, 4), Param.int_range("b", 1, 2),
                      Param.pow2("q", 0, 2)])
    rsp = RefSpace([RefParam.int_range("a", 1, 4), RefParam.int_range("b", 1, 2),
                    RefParam.pow2("q", 0, 2)])
    assert sp.params[-1].values == rsp.params[-1].values == (1, 2, 4)
    rows = [r.tolist() for r in sp.iter_indices()]
    assert rows == [r.tolist() for r in rsp.iter_indices()]
    assert len(rows) == sp.cardinality == 24
    assert sp.flat_keys(np.array(rows)).tolist() == list(range(24))


@pytest.mark.parametrize("budget", [None, 30, 45])
def test_trajectory_is_the_references(budget):
    rng = np.random.default_rng(5)
    values = rng.uniform(1, 2, size=30).tolist()
    values[4] = float("inf")
    ours = TuningResult("x", {}, min(values), history_values=values)
    ref = RefResult("x", {}, min(values), history_values=values)
    curve = ours.trajectory(budget)
    assert np.array_equal(curve, ref.trajectory(budget))
    assert len(curve) == (budget or 30)
    assert (np.diff(curve) <= 0).all()


def test_trajectory_refuses_what_the_reference_refuses():
    ours = TuningResult("x", {}, 1.0, history_values=[3.0, 1.0, 2.0])
    with pytest.raises(ValueError, match="budget"):
        ours.trajectory(2)
    with pytest.raises(ValueError, match="budget"):
        ours.trajectory(0)
    with pytest.raises(ValueError, match="empty"):
        TuningResult("x", {}, 1.0).trajectory()


# --------------------------------------------------- (e) behavioural checks


@pytest.mark.parametrize("algo", ALL)
@pytest.mark.parametrize("budget", [5, 25, 40])
def test_budget_never_exceeded(algo, budget):
    space = paper_space()
    m = CallableMeasurement(_objective)
    r = make_searcher(algo, space, seed=0).run(m, budget)
    assert r.n_samples <= budget and m.n_samples <= budget
    # every searcher fills its budget on this space; pso's last round of 16
    # is cut to what is left
    assert r.n_samples == budget
    assert np.isfinite(r.best_value)
    assert set(r.best_config) == set(space.names)


@pytest.mark.parametrize("algo", ("rs", "rf", "ga", "sa", "pso", "grid"))
def test_constrained_searchers_respect_constraint(algo):
    seen = []

    def f(cfg):
        seen.append(cfg)
        return _objective(cfg)

    make_searcher(algo, paper_space(), seed=1).run(CallableMeasurement(f), 40)
    assert len(seen) == 40
    for cfg in seen:
        assert cfg["w_x"] * cfg["w_y"] * cfg["w_z"] <= 256


@pytest.mark.parametrize("algo", ("bo_gp", "bo_tpe"))
def test_smbo_ignores_constraints(algo):
    """Paper section V.C: SMBO methods search the raw space."""
    s = make_searcher(algo, paper_space(), seed=0)
    assert s.space.constraint is None


@pytest.mark.parametrize("dispatch", ["batch", "one"])
def test_rf_result_comes_from_predictions(dispatch):
    """Paper: RF stores the best of the 10 *predictions*, not the best
    training sample; the tune call's final re-measurement keeps it."""
    calls = []

    def f(cfg):
        calls.append(cfg)
        return _objective(cfg)

    session = TuningSession(TuningSpec(
        kernel="objective", searcher="rf", backend="callable",
        backend_kwargs={"fn": f}, space=paper_space(), budget=50, seed=5,
        dispatch=dispatch, final_repeats=3))
    r = session.run()
    tail = r.history_values[-10:]
    assert min(tail) == r.best_value
    assert r.best_config in r.history_configs[-10:]
    assert r.best_config == r.history_configs[-10 + int(np.argmin(tail))]
    assert r.final_value == _objective(r.best_config)
    assert calls[-3:] == [r.best_config] * 3
    assert session.last_record.result["best_config"] == r.best_config


# ------------------------------------------ (f) the constraint's batch screen


@pytest.mark.parametrize("algo,budget,kwargs", [
    ("rf", 20, {"pool_size": 256}), ("rs", 20, {}), ("ga", 24, {}),
    ("pso", 24, {}), ("grid", 20, {})])
def test_batch_screen_proposes_what_the_loop_proposes(monkeypatch, algo, budget, kwargs):
    """On the cuda space at 64x128 (~0.6 % of the configs fit, so rejection
    sampling screens many rows), each constrained searcher proposes the same
    configs with the constraint's batch form and without it (the loop)."""
    from repro_torch.cuda_bench import default_space

    space = default_space("harris", x=64, y=128)

    def history() -> list:
        m = CallableMeasurement(_objective)
        return make_searcher(algo, space, seed=4, **kwargs).run(m, budget).history_configs

    batched = history()
    rows, n_batched = space.screened()
    assert rows == n_batched > 0
    monkeypatch.delattr(space.constraint, "batch")
    assert history() == batched
    assert space.screened()[1] == n_batched and space.screened()[0] > rows


def test_batch_screen_keeps_the_random_stream():
    """``sample_indices`` draws and keeps the same rows both ways, and
    leaves the generator in the same state."""
    from repro_torch.cuda_bench import default_space

    space = default_space("add", x=64, y=256)
    loop = SearchSpace(space.params, constraint=lambda cfg: space.constraint(cfg))
    rng_b, rng_l = np.random.default_rng(21), np.random.default_rng(21)
    for n in (1, 37, 400):
        assert np.array_equal(space.sample_indices(rng_b, n),
                              loop.sample_indices(rng_l, n))
        assert rng_b.bit_generator.state == rng_l.bit_generator.state
    assert space.screened()[0] == space.screened()[1] == loop.screened()[0] > 0
    assert loop.screened()[1] == 0


def _loop_verdicts(space, idx) -> list:
    return [bool(space.constraint(space.decode(r))) for r in idx]


def test_constraints_without_a_batch_form_screen_row_by_row(monkeypatch):
    """A registered lambda, a ``vmem:`` cost-model constraint and a space
    with a categorical parameter go through the loop (nothing counted as
    batched), with the predicate's verdicts."""
    import pickle

    from repro_torch.core import api
    from repro_torch.core.space import _paper_wg256
    from repro_torch.costmodel import CHIPS, WORKLOADS, executable_space

    params = paper_space().params
    monkeypatch.setattr(api, "CONSTRAINTS", dict(api.CONSTRAINTS))
    lam = api.register_constraint("test_batchless_tz", lambda c: c["t_z"] <= c["w_x"] + 3)
    cat = SearchSpace([*params, Param.choice("layout", ("rows", "cols"))],
                      constraint=_paper_wg256)
    spaces = [SearchSpace(params, constraint=lam),
              executable_space(WORKLOADS["harris"], CHIPS["v5e"]), cat]
    idx = paper_space(False).sample_indices(np.random.default_rng(3), 3000)
    for space in spaces:
        rows = idx if space is not cat else np.concatenate(
            [idx, np.random.default_rng(4).integers(0, 2, (len(idx), 1))], axis=1)
        mask = space.valid_mask(rows)
        assert mask.tolist() == _loop_verdicts(space, rows)
        assert 0 < mask.sum() < len(rows)
        assert space.screened() == (len(rows), 0)
    # the paper's space screens in one pass, and survives a pickle round trip
    paper = pickle.loads(pickle.dumps(paper_space()))
    assert paper.valid_mask(idx).tolist() == _loop_verdicts(paper, idx)
    assert paper.screened() == (len(idx), len(idx))


@pytest.mark.parametrize("kernel", ("add", "harris", "mandelbrot"))
def test_search_cost_times_the_steps_rf_takes(kernel):
    """The host-time split of ``rf`` (``cuda_bench.search_cost``) times the
    searcher's own steps: the configs its steps rank first are the last
    samples of the searcher's own run, and each part is timed."""
    from repro_torch.cuda_bench.search_cost import rf_parts

    parts = rf_parts(kernel, 8192, 8192, pool_size=1024)
    for key in ("train_draw_s", "fit_s", "pool_draw_s", "predict_s", "rank_s"):
        assert parts[key] > 0.0
    assert parts["parts_s"] == pytest.approx(
        sum(parts[k] for k in ("train_draw_s", "fit_s", "pool_draw_s",
                               "predict_s", "rank_s")))
    assert parts["screen_accepts"] == 1.0   # cuda_fit accepts all at 8192²
