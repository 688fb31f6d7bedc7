"""The port's SVM and Gaussian-process baselines held against the JAX
package's wrappers, which are sklearn (libsvm's SVC / SVR, sklearn's
GaussianProcessRegressor / GaussianProcessClassifier), on the CPU.

Tolerances:
- SVC / SVR with shrinking=False follow libsvm's iterates: the same
  iteration counts and support vectors, dual coefficients and intercepts
  within SVM_ATOL, decision values within SVM_ATOL x max|dec|.
- With shrinking (sklearn's default) the port also permutes its variables
  as libsvm's shrinking does, but rebuilds the shrunk gradient summed in
  another order: decision values within the solver's tol, labels equal
  except on rows whose sklearn |decision| is under it.
- GPR (default kernel C * RBF, L-BFGS-B): θ within GPR_THETA_ATOL, the
  log-marginal likelihood within GPR_LML_RTOL, predictions within
  GPR_PRED_RTOL x max|pred| (the optimiser stops where its gradient
  tolerance lets it; the gradients differ by rounding); with optimizer=None
  all to float64 rounding (GP_EXACT).
- SVC probability=True: the default fit's model (libsvm trains it apart
  from Platt scaling's folds), labels equal to the JAX wrapper's.
- GPC (fixed kernel, Laplace): labels equal, probabilities within
  GPC_PROBA_ATOL (predict_proba's erf mixture cancels terms of ~3,500),
  log-marginal likelihood within GP_EXACT relative.
- The converters: sklearn's fitted state predicts through the port as
  sklearn predicts, to float64 rounding (CONVERT_ATOL).
"""
import sys
import warnings

import numpy as np
import pytest

pytest.importorskip("sklearn")
import torch  # noqa: E402

from tensornetworksfork_tpu.models import baselines as jbl  # noqa: E402
from tensornetworksfork_tpu_torch.data.synthetic import make_regression  # noqa: E402
from tensornetworksfork_tpu_torch.data.tabular import (  # noqa: E402
    load_sklearn_dataset, split_train_val_test)
from tensornetworksfork_tpu_torch.models import baselines as tbl  # noqa: E402
from tensornetworksfork_tpu_torch.models import _libsvm  # noqa: E402
from tensornetworksfork_tpu_torch.utils.convert import (  # noqa: E402
    gp_from_sklearn, svm_from_sklearn)

SVM_ATOL = 1e-12
SVM_TOL = 1e-3                  # sklearn's default tol
GPR_THETA_ATOL = 1e-5
GPR_LML_RTOL = 1e-6
GPR_PRED_RTOL = 1e-5
GP_EXACT = 1e-12
GPC_PROBA_ATOL = 1e-10
CONVERT_ATOL = 1e-11


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Every fit here is small: torch and BLAS on one thread each, so the
    file does not oversubscribe the cores that other test processes use."""
    from threadpoolctl import threadpool_limits  # a dependency of sklearn
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with threadpool_limits(1):
            yield
    finally:
        torch.set_num_threads(n)


def _table(name, rows=None):
    d = load_sklearn_dataset(name, seed=42)
    task = d.pop("task")
    if task == "classification":
        for k in ("y_train", "y_val", "y_test"):
            d[k] = d[k].reshape(-1).astype(np.int64)
    if rows:
        d["X_train"], d["y_train"] = d["X_train"][:rows], d["y_train"][:rows]
    return d, task


def _synthetic(S=1000, seed=42):
    X, y = make_regression(S=S, d=6, degree=3, seed=seed)
    return split_train_val_test(X, y, seed=seed)


def _fit_svc(d, params):
    j = jbl.SVMClfWrapper(dict(params))
    j.fit(d["X_train"], d["y_train"])
    p = tbl.SVMClfWrapper(dict(params), device="cpu").fit(d["X_train"], d["y_train"])
    return j, p


SVC_CASES = [("iris", None, {}), ("wine", None, {}), ("breast_cancer", None, {}),
             ("digits", 300, {}),
             # C = 100 runs past libsvm's shrinking counter (395 iterations)
             ("breast_cancer", None, {"C": 100.0}),
             ("wine", None, {"kernel": "linear", "C": 1000.0})]


@pytest.mark.parametrize("name,rows,params", SVC_CASES)
def test_svc_follows_libsvm_without_shrinking(name, rows, params):
    d, _ = _table(name, rows)
    params = dict(params, shrinking=False, decision_function_shape="ovo")
    j, p = _fit_svc(d, params)
    sk = j.svm_object
    assert p.n_iter_ == sk.n_iter_.tolist()
    np.testing.assert_array_equal(p.n_support_, sk.n_support_)
    np.testing.assert_allclose(p.dual_coef_, sk.dual_coef_, rtol=0, atol=SVM_ATOL)
    np.testing.assert_allclose(p.intercept_, sk.intercept_, rtol=0, atol=SVM_ATOL)
    for split in ("val", "test"):
        X = d[f"X_{split}"]
        want = sk.decision_function(np.asarray(X, np.float64))
        got = p.decision_function(X)
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=SVM_ATOL * max(1.0, np.abs(want).max()))
        np.testing.assert_array_equal(p.predict(X), j.predict(X))


@pytest.mark.parametrize("name,rows,params", SVC_CASES)
def test_svc_with_shrinking(name, rows, params):
    d, _ = _table(name, rows)
    j, p = _fit_svc(d, params)
    sk = j.svm_object
    for split in ("val", "test"):
        X = d[f"X_{split}"]
        want = sk.decision_function(np.asarray(X, np.float64))
        got = p.decision_function(X)
        # sklearn's default "ovr" shape: votes plus confidences in (-1/3, 1/3)
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=SVM_TOL)
        ovo = sk._decision_function(np.asarray(X, np.float64))
        sure = np.abs(ovo).reshape(len(X), -1).min(1) >= SVM_TOL
        np.testing.assert_array_equal(p.predict(X)[sure], j.predict(X)[sure])


def test_vote_ties_go_to_the_first_class():
    """libsvm's vote over iris's three pairs: where each class wins one pair
    the first class is predicted. Points drawn around the data until 1-1-1
    ties appear; the port predicts sklearn's class on every point."""
    d, _ = _table("iris")
    j, p = _fit_svc(d, {"decision_function_shape": "ovo"})
    rng = np.random.default_rng(0)
    X = rng.normal(0, 2.0, (20000, 4))
    dec = j.svm_object.decision_function(X)
    votes = np.zeros((len(X), 3), int)
    for k, (a, b) in enumerate([(0, 1), (0, 2), (1, 2)]):
        votes[np.arange(len(X)), np.where(dec[:, k] > 0, a, b)] += 1
    tie = (votes == 1).all(1)
    assert tie.sum() >= 10
    np.testing.assert_array_equal(p.predict(X), j.predict(X))
    assert (p.predict(X[tie]) == 0).all()


SVR_CASES = [("diabetes", {}), ("synthetic", {}), ("synthetic", {"C": 10.0, "epsilon": 0.05})]


@pytest.mark.parametrize("name,params", SVR_CASES)
@pytest.mark.parametrize("shrinking", [False, True])
def test_svr_follows_libsvm(name, params, shrinking):
    d = _table(name)[0] if name == "diabetes" else _synthetic()
    params = dict(params, shrinking=shrinking)
    j = jbl.SVMRegWrapper(dict(params))
    j.fit(d["X_train"], d["y_train"])
    p = tbl.SVMRegWrapper(dict(params), device="cpu").fit(d["X_train"], d["y_train"])
    sk = j.svm_object
    X = d["X_test"]
    want = j.predict(X)
    if not shrinking:
        assert p.n_iter_ == [sk.n_iter_]
        np.testing.assert_allclose(p.model_.dual_coef.numpy(), sk.dual_coef_,
                                   rtol=0, atol=SVM_ATOL)
        np.testing.assert_allclose(p.predict(X), want, rtol=0,
                                   atol=SVM_ATOL * np.abs(want).max())
    else:
        np.testing.assert_allclose(p.predict(X), want, rtol=0, atol=SVM_TOL)


def _libsvm_swaps(order, active_size, gone):
    """do_shrinking's loop over places (svm.cpp), on a list of variables."""
    order = list(order)
    i = 0
    while i < active_size:
        if order[i] in gone:
            active_size -= 1
            while active_size > i:
                if order[active_size] not in gone:
                    order[i], order[active_size] = order[active_size], order[i]
                    break
                active_size -= 1
        i += 1
    return order, active_size


@pytest.mark.parametrize("seed", range(4))
def test_shrinking_permutes_as_libsvm(seed):
    """_shrink's places against libsvm's swap loop: variables at the lower
    bound with G > Gmax2 (y = +1) are shrunk, the others kept."""
    rng = np.random.default_rng(seed)
    L = 16
    order = rng.permutation(L)                  # the variable at each place
    active_size = int(rng.integers(8, L + 1))
    active = set(order[:active_size].tolist())
    gone = {v for v in active if rng.random() < 0.5}
    st = _libsvm._State.__new__(_libsvm._State)
    st.pos = torch.as_tensor(np.argsort(order))[None]
    st.active = torch.tensor([[v in active for v in range(L)]])
    st.alpha = torch.zeros(1, L, dtype=torch.float64)
    st.G = torch.tensor([[1.0 if v in gone else -1.0 for v in range(L)]],
                        dtype=torch.float64)
    pr = _libsvm.Problems(K32=None, QD=None, idx=None,
                          y=torch.ones(1, L, dtype=torch.float64), p=None,
                          C=torch.ones(1, L, dtype=torch.float64),
                          valid=torch.ones(1, L, dtype=torch.bool))
    g = torch.zeros(1, dtype=torch.float64)
    _libsvm._shrink(pr, st, torch.tensor([True]), g, g)
    want, size = _libsvm_swaps(order.tolist(), active_size, gone)
    assert st.pos[0].tolist() == np.argsort(want).tolist()
    assert st.active[0].tolist() == [v in want[:size] for v in range(L)]


def test_gpr_against_sklearn():
    cases = [("diabetes", {}), ("diabetes", {"normalize_y": True}),
             ("diabetes", {"optimizer": None}), ("noisy", {"alpha": 1e-2}),
             ("noisy", {"alpha": 1e-2, "normalize_y": True}),
             ("noisy", {"optimizer": None, "normalize_y": True})]
    noisy = _synthetic(S=400, seed=3)
    rng = np.random.default_rng(3)
    noisy["y_train"] = noisy["y_train"] + 0.1 * rng.normal(size=noisy["y_train"].shape)
    for name, params in cases:
        d = _table("diabetes")[0] if name == "diabetes" else noisy
        j = jbl.GaussianProcessWrapper(dict(params)).fit(d["X_train"], d["y_train"])
        p = tbl.GaussianProcessWrapper(dict(params), device="cpu").fit(
            d["X_train"], d["y_train"])
        exact = params.get("optimizer", "") is None
        sk = j.model
        np.testing.assert_allclose(p.theta_, sk.kernel_.theta, rtol=0,
                                   atol=GP_EXACT if exact else GPR_THETA_ATOL)
        np.testing.assert_allclose(p.log_marginal_likelihood_value_,
                                   sk.log_marginal_likelihood_value_,
                                   rtol=GP_EXACT if exact else GPR_LML_RTOL)
        want = j.predict(d["X_test"])
        got = p.predict(d["X_test"])
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=(GP_EXACT if exact else GPR_PRED_RTOL)
                                   * np.abs(want).max())


@pytest.mark.parametrize("name", ["breast_cancer", "iris", "wine"])
def test_gpc_against_sklearn(name):
    d, task = _table(name)
    j = jbl.GaussianProcessWrapper(task=task).fit(d["X_train"], d["y_train"])
    p = tbl.GaussianProcessWrapper(task=task, device="cpu").fit(d["X_train"], d["y_train"])
    np.testing.assert_allclose(p.log_marginal_likelihood_value_,
                               j.model.log_marginal_likelihood_value_, rtol=GP_EXACT)
    for split in ("val", "test"):
        X = d[f"X_{split}"]
        np.testing.assert_array_equal(p.predict(X), j.predict(X))
        np.testing.assert_allclose(p.predict_proba(X), j.model.predict_proba(X),
                                   rtol=0, atol=GPC_PROBA_ATOL)


def test_converters_predict_as_sklearn():
    from sklearn.gaussian_process import (GaussianProcessClassifier,
                                          GaussianProcessRegressor)
    from sklearn.svm import SVC, SVR
    for name in ("iris", "breast_cancer"):
        d, _ = _table(name)
        X, Xt = d["X_train"].astype(np.float64), d["X_test"].astype(np.float64)
        for sk in (SVC(C=3.0).fit(X, d["y_train"]),
                   SVC(kernel="poly", degree=2, decision_function_shape="ovo").fit(X, d["y_train"])):
            w = svm_from_sklearn(sk, device="cpu")
            np.testing.assert_array_equal(w.predict(Xt), sk.predict(Xt))
            np.testing.assert_allclose(w.decision_function(Xt), sk.decision_function(Xt),
                                       rtol=0, atol=CONVERT_ATOL)
        g = GaussianProcessClassifier().fit(X, d["y_train"])
        w = gp_from_sklearn(g, device="cpu")
        np.testing.assert_array_equal(w.predict(Xt), g.predict(Xt))
        np.testing.assert_allclose(w.predict_proba(Xt), g.predict_proba(Xt), rtol=0,
                                   atol=CONVERT_ATOL)
    d, _ = _table("diabetes")
    X, Xt, y = d["X_train"].astype(np.float64), d["X_test"].astype(np.float64), d["y_train"]
    sk = SVR(C=2.0, epsilon=0.2).fit(X, y.ravel())
    np.testing.assert_allclose(svm_from_sklearn(sk, device="cpu").predict(Xt), sk.predict(Xt),
                               rtol=0, atol=CONVERT_ATOL)
    for gp in (GaussianProcessRegressor().fit(X, y.ravel()),
               GaussianProcessRegressor(normalize_y=True).fit(X, y)):
        np.testing.assert_allclose(gp_from_sklearn(gp, device="cpu").predict(Xt),
                                   gp.predict(Xt), rtol=0, atol=CONVERT_ATOL)


def _three_classes():
    rng = np.random.default_rng(0)
    X = rng.normal(size=(30, 2))
    return X, np.arange(30) % 3


def _fit_three(wrapper):
    X, y = _three_classes()
    return wrapper.fit(X, y), X


@pytest.mark.parametrize("make", [
    lambda: tbl.SVMClfWrapper({"nu": 0.5}, device="cpu"),
    # not one of libsvm's kernels (sklearn refuses it too)
    lambda: tbl.SVMClfWrapper({"kernel": "cosine"}, device="cpu"),
    # sklearn's compute_class_weight: a key that is no class, a class missing
    lambda: _fit_three(tbl.SVMClfWrapper({"class_weight": {0: 2.0, 7: 1.0}}, device="cpu")),
    # SVC.predict refuses break_ties under "ovo"
    lambda: (lambda m, X: m.predict(X))(*_fit_three(tbl.SVMClfWrapper(
        {"break_ties": True, "decision_function_shape": "ovo"}, device="cpu"))),
    lambda: tbl.SVMRegWrapper({"decision_function_shape": "ovo"}, device="cpu"),
    lambda: tbl.GaussianProcessWrapper({"kernel": object()}, device="cpu"),
    # GaussianProcessClassifier refuses predict_proba under one_vs_one
    lambda: (lambda m, X: m.predict_proba(X))(*_fit_three(tbl.GaussianProcessWrapper(
        {"multi_class": "one_vs_one"}, task="classification", device="cpu"))),
    lambda: tbl.GaussianProcessWrapper({"optimizer": "adam"}, device="cpu"),
    lambda: tbl.GaussianProcessWrapper({"optimizer": "fmin_cobyla", "n_restarts_optimizer": 2},
                                       device="cpu"),
    lambda: tbl.GaussianProcessWrapper({"length_scale": 2.0}, device="cpu"),
])
def test_unported_keys_raise(make):
    with pytest.raises(ValueError):
        make()


@pytest.mark.parametrize("name", ["iris", "wine"])
def test_svc_probability_true_fits_the_default_model(name):
    """probability=True (Platt scaling, which the wrappers never read)
    leaves libsvm's model as it is: the port's labels equal the JAX
    wrapper's under probability=True, and its decision values, SMO
    iterations and support vectors equal its own default fit's."""
    d, _ = _table(name)
    j = jbl.SVMClfWrapper({"probability": True, "random_state": 0})
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")         # sklearn deprecates probability
        j.fit(d["X_train"], d["y_train"])
    p = tbl.SVMClfWrapper({"probability": True, "random_state": 0}, device="cpu").fit(
        d["X_train"], d["y_train"])
    q = tbl.SVMClfWrapper(device="cpu").fit(d["X_train"], d["y_train"])
    assert p.n_iter_ == q.n_iter_ == j.svm_object.n_iter_.tolist()
    np.testing.assert_array_equal(p.n_support_, j.svm_object.n_support_)
    for split in ("val", "test"):
        X = d[f"X_{split}"]
        np.testing.assert_array_equal(p.predict(X), j.predict(X))
        np.testing.assert_array_equal(p.decision_function(X), q.decision_function(X))


@pytest.mark.parametrize("task", ["regression", "classification"])
def test_kernel_none_is_the_default(task):
    """gp_params={"kernel": None} is sklearn's default: C(1) * RBF(1), free
    for regression and fixed for classification; the fit equals the one
    without the key, and the JAX wrapper's."""
    d, _ = _table("iris" if task == "classification" else "diabetes")
    fits = [tbl.GaussianProcessWrapper(params, task=task, device="cpu").fit(
        d["X_train"], d["y_train"]) for params in ({"kernel": None}, {})]
    j = jbl.GaussianProcessWrapper({"kernel": None}, task=task).fit(d["X_train"], d["y_train"])
    assert fits[0].kernel_ == fits[1].kernel_
    assert fits[0].log_marginal_likelihood_value_ == fits[1].log_marginal_likelihood_value_
    X = d["X_test"]
    np.testing.assert_array_equal(fits[0].predict(X), fits[1].predict(X))
    if task == "classification":
        assert fits[0].theta_.size == 0
        assert ([repr(k) for k in fits[0].kernels_]
                == [repr(e.kernel_) for e in j.model.base_estimator_.estimators_])
        np.testing.assert_array_equal(fits[0].predict(X), j.predict(X))
    else:
        np.testing.assert_allclose(fits[0].theta_, j.model.kernel_.theta, rtol=0,
                                   atol=GPR_THETA_ATOL)
        np.testing.assert_allclose(fits[0].predict(X), j.predict(X), rtol=0,
                                   atol=GPR_PRED_RTOL * np.abs(j.predict(X)).max())


def test_wrappers_need_no_sklearn(monkeypatch):
    """Fit and predict each wrapper with every sklearn module unimportable."""
    for mod in [m for m in sys.modules if m == "sklearn" or m.startswith("sklearn.")]:
        monkeypatch.setitem(sys.modules, mod, None)
    monkeypatch.setitem(sys.modules, "sklearn", None)
    with pytest.raises(ImportError):
        import sklearn  # noqa: F401
    rng = np.random.default_rng(0)
    X = rng.normal(size=(40, 3))
    labels = (X[:, 0] > 0).astype(int) + (X[:, 1] > 0)
    target = X @ np.array([1.0, -2.0, 0.5])
    assert tbl.SVMClfWrapper(device="cpu").fit(X, labels).predict(X).shape == (40,)
    assert tbl.SVMRegWrapper(device="cpu").fit(X, target).predict(X).shape == (40,)
    gpr = tbl.GaussianProcessWrapper({"alpha": 1e-2}, device="cpu").fit(X, target)
    assert gpr.predict(X).shape == (40,)
    gpc = tbl.GaussianProcessWrapper(task="classification", device="cpu").fit(X, labels)
    assert gpc.predict(X).shape == (40,)
    from tensornetworksfork_tpu_torch.models._gp_kernels import (RBF, ConstantKernel,
                                                                 Matern, WhiteKernel)
    kernel = ConstantKernel(1.0) * Matern(length_scale=1.0, nu=2.5) + WhiteKernel(0.1)
    gpr = tbl.GaussianProcessWrapper({"kernel": kernel}, device="cpu").fit(X, target)
    assert gpr.predict(X).shape == (40,) and gpr.kernel_.n_dims == 3
    gpc = tbl.GaussianProcessWrapper({"kernel": ConstantKernel() * RBF()},
                                     task="classification", device="cpu").fit(X, labels)
    assert gpc.predict(X).shape == (40,) and len(gpc.kernels_) == 3
    svc = tbl.SVMClfWrapper({"probability": True}, device="cpu").fit(X, labels)
    assert svc.predict(X).shape == (40,)


@pytest.mark.parametrize("dataset", ["iris", "diabetes"])
def test_tabular_cli_svm_matches_jax(dataset):
    from tensornetworksfork_tpu.experiments import train_tabular as jt
    from tensornetworksfork_tpu.utils.config import RunConfig as JaxConfig
    from tensornetworksfork_tpu_torch.experiments import train_tabular as tt
    from tensornetworksfork_tpu_torch.utils.config import RunConfig
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = jt.run(JaxConfig(dataset=dataset, model_type="svm", verbose=0))
    got = tt.run(RunConfig(dataset=dataset, model_type="svm", device="cpu", verbose=0))
    keys = [k for k in want if k.startswith(("val_", "test_"))]
    assert keys
    for k in keys:
        assert got[k] == pytest.approx(want[k], rel=1e-12, abs=1e-12), k


def test_tabular_cli_skips_svm_above_10k_classification_rows(monkeypatch):
    """Both CLIs return the skip dict before building a model."""
    from tensornetworksfork_tpu.experiments import train_tabular as jt
    from tensornetworksfork_tpu.utils.config import RunConfig as JaxConfig
    from tensornetworksfork_tpu_torch.experiments import train_tabular as tt
    from tensornetworksfork_tpu_torch.utils.config import RunConfig

    def data(n):
        rng = np.random.default_rng(1)
        return {"task": "classification",
                "X_train": rng.normal(size=(n, 2)).astype(np.float32),
                "y_train": rng.integers(0, 2, (n, 1)).astype(np.float32),
                "X_val": rng.normal(size=(5, 2)).astype(np.float32),
                "y_val": np.array([[0], [1], [0], [1], [0]], np.float32),
                "X_test": rng.normal(size=(5, 2)).astype(np.float32),
                "y_test": np.array([[1], [0], [1], [0], [1]], np.float32)}

    def no_build(*a, **k):
        raise AssertionError("built a model")
    monkeypatch.setattr(tt, "build_model", no_build)
    skip = {"skipped": True, "model_type": "svm"}
    assert tt.run(RunConfig(model_type="svm", device="cpu"), data=data(10_001)) == skip
    assert jt.run(JaxConfig(model_type="svm"), data=data(10_001)) == skip
    with pytest.raises(AssertionError, match="built a model"):
        tt.run(RunConfig(model_type="svm", device="cpu"), data=data(10_000))
