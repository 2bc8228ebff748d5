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
  the ``rf`` winner taken from its predictions.
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


@pytest.mark.parametrize("n_forests", [1, 3])
def test_batched_forest_predicts_what_the_reference_predicts(n_forests):
    space = paper_space(constrained=False)
    rng = np.random.default_rng(1)
    X = np.stack([space.sample_indices(rng, 80) for _ in range(n_forests)])
    y = np.stack([_toy(x) + rng.normal(0, 0.05, len(x)) for x in X])
    pool = space.sample_indices(rng, 500)
    ours = BatchedForest(space.cardinalities, n_estimators=30, seed=4).fit(X, y)
    ref = RefBatchedForest(space.cardinalities, n_estimators=30, seed=4).fit(X, y)
    assert np.array_equal(ours.predict(pool), ref.predict(pool))
    per_pool = np.stack([space.sample_indices(rng, 64) for _ in range(n_forests)])
    assert np.array_equal(ours.predict(per_pool), ref.predict(per_pool))


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
