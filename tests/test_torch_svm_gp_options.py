"""The sklearn options of the port's SVM and Gaussian-process wrappers held
against the JAX package's wrappers, which hand them to sklearn, on the CPU.

Tolerances:
- SVC class_weight without shrinking follows libsvm's iterates (each class's
  rows bounded by C x its weight): the same iteration counts and support
  vectors, dual coefficients and intercepts within SVM_ATOL. With shrinking
  the shrunk gradient is rebuilt in another order: labels equal, dual
  coefficients within SVM_SHRINK_ATOL.
- break_ties: labels equal everywhere, the rows where libsvm's one-vs-one
  vote ties included.
- GPR restarts (L-BFGS-B from θ = 0 and from θ₀ drawn by the RandomState):
  the same run kept, θ within GPR_THETA_ATOL, the log-marginal likelihood
  within GPR_LML_RTOL; a callable optimizer likewise.
- GPC one_vs_one: OneVsOneClassifier's decision values within GPC_DEC_ATOL,
  labels equal, the lml within GP_EXACT; warm_start: probabilities within
  GPC_DEC_ATOL.
- results/kernel_baselines_options.json re-derived from
  studies/kernel_baselines_options_ref.py to REDERIVE_RTOL, and the port's
  CPU fits held to it (kernel_baselines.compare_options).
"""
import json
import os
import sys

import numpy as np
import pytest

pytest.importorskip("sklearn")
pytest.importorskip("threadpoolctl")

import torch  # noqa: E402
from threadpoolctl import threadpool_limits  # noqa: E402

from tensornetworksfork_tpu.models import baselines as jbl  # noqa: E402
from tensornetworksfork_tpu_torch.experiments import kernel_baselines as kb  # noqa: E402
from tensornetworksfork_tpu_torch.models import baselines as tbl  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SVM_ATOL = 1e-12
SVM_SHRINK_ATOL = 1e-9
GPR_THETA_ATOL = 1e-6
GPR_LML_RTOL = 1e-8
GP_EXACT = 1e-12
GPC_DEC_ATOL = 1e-9
REDERIVE_RTOL = 1e-9


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Every fit here is small: torch and BLAS on one thread each, so the
    file does not oversubscribe the cores that other test processes use."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with threadpool_limits(1):
            yield
    finally:
        torch.set_num_threads(n)


def _svc(d, params):
    j = jbl.SVMClfWrapper(dict(params))
    j.fit(d["X_train"], d["y_train"])
    p = tbl.SVMClfWrapper(dict(params), device="cpu").fit(d["X_train"], d["y_train"])
    return j, p


@pytest.mark.parametrize("shrinking", [False, True])
@pytest.mark.parametrize("class_weight", ["balanced", {0: 2.5, 2: 0.4}])
@pytest.mark.parametrize("name", ["iris", "wine"])
def test_class_weight_follows_libsvm(name, class_weight, shrinking):
    d, _ = kb.table(name)
    j, p = _svc(d, {"class_weight": class_weight, "shrinking": shrinking})
    sk = j.svm_object
    np.testing.assert_array_equal(p.class_weight_, sk.class_weight_)
    np.testing.assert_array_equal(p.n_support_, sk.n_support_)
    atol = SVM_SHRINK_ATOL if shrinking else SVM_ATOL
    np.testing.assert_allclose(p.dual_coef_, sk.dual_coef_, rtol=0, atol=atol)
    np.testing.assert_allclose(p.intercept_, sk.intercept_, rtol=0, atol=atol)
    if not shrinking:
        assert p.n_iter_ == sk.n_iter_.tolist()
    for split in ("val", "test"):
        np.testing.assert_array_equal(p.predict(d[f"X_{split}"]), j.predict(d[f"X_{split}"]))


@pytest.mark.parametrize("name,spread", [("iris", 2.0), ("wine", 1.0)])
def test_break_ties_follows_sklearn(name, spread):
    """Points drawn around the data until libsvm's vote ties 1-1-1 on some:
    break_ties predicts sklearn's class on every point, and on the ties it
    is not always the vote's first class."""
    d, _ = kb.table(name)
    j, p = _svc(d, {"break_ties": True})
    rng = np.random.default_rng(0)
    X = rng.normal(0, spread, (20000, d["X_train"].shape[1]))
    ovo = j.svm_object._decision_function(X)
    votes = np.zeros((len(X), 3), int)
    for k, (a, b) in enumerate([(0, 1), (0, 2), (1, 2)]):
        votes[np.arange(len(X)), np.where(ovo[:, k] > 0, a, b)] += 1
    tie = (votes == 1).all(1)
    assert tie.sum() >= 10
    got = p.predict(X)
    np.testing.assert_array_equal(got, j.predict(X))
    assert (got[tie] != 0).any()
    for split in ("val", "test"):
        np.testing.assert_array_equal(p.predict(d[f"X_{split}"]), j.predict(d[f"X_{split}"]))


def _gpr_table():
    """111 points of a noisy sine of 3 features on which L-BFGS-B from θ = 0
    stops at the length scale's lower bound, and a restart finds a better
    optimum inside the bounds."""
    rng = np.random.default_rng(13)
    n, d = int(rng.integers(40, 120)), int(rng.integers(1, 4))
    X = rng.uniform(-1, 1, (n, d)) * rng.choice([0.1, 1, 10, 100])
    y = (np.sin(X.sum(1) * rng.choice([0.05, 0.5, 3, 20])) * rng.choice([0.1, 1, 30])
         + rng.choice([0.0, 0.01, 0.3]) * rng.normal(size=n))
    return X, y


def _sklearn_optima(monkeypatch):
    """Record each optimiser run's (theta, -lml) of sklearn's regressor."""
    from sklearn.gaussian_process import GaussianProcessRegressor
    runs = []
    orig = GaussianProcessRegressor._constrained_optimization

    def recorded(self, obj_func, initial_theta, bounds):
        out = orig(self, obj_func, initial_theta, bounds)
        runs.append(out)
        return out
    monkeypatch.setattr(GaussianProcessRegressor, "_constrained_optimization", recorded)
    return runs


@pytest.mark.parametrize("random_state", [0, None])
def test_gpr_restarts_keep_sklearn_optimum(monkeypatch, random_state):
    X, y = _gpr_table()
    params = {"alpha": 1e-2, "n_restarts_optimizer": 3, "random_state": random_state}
    runs = _sklearn_optima(monkeypatch)
    # None draws from numpy's global RandomState: seeded here as
    # random_state=0 seeds its own, so both cases draw the same θ₀
    np.random.seed(0)
    j = jbl.GaussianProcessWrapper(dict(params)).fit(X, y)
    np.random.seed(0)
    p = tbl.GaussianProcessWrapper(dict(params), device="cpu").fit(X, y)
    sk = j.model
    values = [v for _, v in runs]
    kept = int(np.argmin(values))
    # the choice shows: the run kept is a restart, at another optimum than θ = 0's
    assert kept != 0 and np.abs(runs[kept][0] - runs[0][0]).max() > 0.1
    assert p.fit_.chosen == kept and len(p.fit_.optima) == len(runs) == 4
    for (t, v), (ts, vs) in zip(p.fit_.optima, runs):
        np.testing.assert_allclose(t, ts, rtol=0, atol=GPR_THETA_ATOL)
        np.testing.assert_allclose(v, vs, rtol=GPR_LML_RTOL)
    np.testing.assert_allclose(p.theta_, sk.kernel_.theta, rtol=0, atol=GPR_THETA_ATOL)
    np.testing.assert_allclose(p.log_marginal_likelihood_value_,
                               sk.log_marginal_likelihood_value_, rtol=GPR_LML_RTOL)
    np.testing.assert_allclose(p.predict(X), j.predict(X), rtol=0,
                               atol=1e-6 * np.abs(j.predict(X)).max())


def _nelder_mead(obj_func, initial_theta, bounds):
    """A callable optimizer on -lml alone (eval_gradient=False)."""
    import scipy.optimize
    res = scipy.optimize.minimize(lambda t: obj_func(t, eval_gradient=False),
                                  initial_theta, method="Nelder-Mead", bounds=bounds,
                                  options={"xatol": 1e-10, "fatol": 1e-12, "maxiter": 400})
    return res.x, res.fun


def test_gpr_callable_optimizer():
    d, _ = kb.table("diabetes")
    params = {"optimizer": _nelder_mead, "n_restarts_optimizer": 1, "random_state": 1}
    j = jbl.GaussianProcessWrapper(dict(params)).fit(d["X_train"], d["y_train"])
    p = tbl.GaussianProcessWrapper(dict(params), device="cpu").fit(d["X_train"], d["y_train"])
    sk = j.model
    assert len(p.fit_.optima) == 2
    np.testing.assert_allclose(p.theta_, sk.kernel_.theta, rtol=0, atol=GPR_THETA_ATOL)
    np.testing.assert_allclose(p.log_marginal_likelihood_value_,
                               sk.log_marginal_likelihood_value_, rtol=GPR_LML_RTOL)
    want = j.predict(d["X_test"])
    np.testing.assert_allclose(p.predict(d["X_test"]), want, rtol=0,
                               atol=1e-6 * np.abs(want).max())


def _gpc(name, params):
    d, task = kb.table(name)
    j = jbl.GaussianProcessWrapper(dict(params), task=task).fit(d["X_train"], d["y_train"])
    p = tbl.GaussianProcessWrapper(dict(params), task=task, device="cpu").fit(
        d["X_train"], d["y_train"])
    np.testing.assert_allclose(p.log_marginal_likelihood_value_,
                               j.model.log_marginal_likelihood_value_, rtol=GP_EXACT)
    return d, j, p


@pytest.mark.parametrize("name", ["iris", "wine"])
def test_gpc_one_vs_one(name):
    d, j, p = _gpc(name, {"multi_class": "one_vs_one"})
    for split in ("val", "test"):
        X = d[f"X_{split}"]
        np.testing.assert_allclose(p.decision_function(X),
                                   j.model.base_estimator_.decision_function(X),
                                   rtol=0, atol=GPC_DEC_ATOL)
        np.testing.assert_array_equal(p.predict(X), j.predict(X))
    with pytest.raises(ValueError, match="one_vs_one"):
        p.predict_proba(d["X_test"])
    with pytest.raises(ValueError, match="one_vs_one"):
        j.model.predict_proba(d["X_test"])


def test_gpc_one_vs_one_two_classes_is_binary():
    d, j, p = _gpc("breast_cancer", {"multi_class": "one_vs_one"})
    X = d["X_test"]
    np.testing.assert_array_equal(p.predict(X), j.predict(X))
    np.testing.assert_allclose(p.predict_proba(X), j.model.predict_proba(X), rtol=0,
                               atol=GPC_DEC_ATOL)


@pytest.mark.parametrize("name", ["iris", "wine", "breast_cancer"])
def test_gpc_warm_start(name):
    d, j, p = _gpc(name, {"warm_start": True})
    for split in ("val", "test"):
        X = d[f"X_{split}"]
        np.testing.assert_allclose(p.predict_proba(X), j.model.predict_proba(X),
                                   rtol=0, atol=GPC_DEC_ATOL)
        np.testing.assert_array_equal(p.predict(X), j.predict(X))
    # the second mode search starts at the first's f, so it stops sooner
    assert max(p.fit_.n_iter) < min(p.first_fit_.n_iter)


def _committed():
    with open(os.path.join(ROOT, kb.OPTIONS_REFERENCE)) as f:
        return json.load(f)


def test_options_reference_file_is_current():
    sys.path.insert(0, os.path.join(ROOT, "studies"))
    try:
        import kernel_baselines_options_ref
    finally:
        sys.path.pop(0)
    fresh = kernel_baselines_options_ref.reference()
    want = _committed()
    assert fresh["rows"] == want["rows"]
    assert json.loads(json.dumps(fresh["params"])) == want["params"]
    assert set(fresh["options"]) == set(want["options"]) == set(kb.OPTIONS)
    for option, (_, _, tables) in kb.OPTIONS.items():
        assert set(fresh["options"][option]) == set(want["options"][option]) == set(tables)
        for name, metrics in fresh["options"][option].items():
            assert metrics.keys() == want["options"][option][name].keys()
            for k, v in metrics.items():
                assert v == pytest.approx(want["options"][option][name][k],
                                          rel=REDERIVE_RTOL), (option, name, k)


def test_port_matches_options_reference():
    """The port's CPU fits of every option on the tables that are small on
    the CPU (digits runs on the card in chip_smoke.py)."""
    got = {o: {t: kb.option_scores(o, t, "cpu") for t in tables if t != "digits"}
           for o, (_, _, tables) in kb.OPTIONS.items()}
    assert kb.compare_options(got, _committed()) == []
