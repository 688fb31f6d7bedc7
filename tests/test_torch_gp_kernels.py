"""The port's Gaussian-process kernel objects (models/_gp_kernels.py) and the
fits over them, held against sklearn on the CPU: the kernels against
sklearn.gaussian_process.kernels, the fits against the JAX package's
GaussianProcessWrapper, which hands the kernel to sklearn.

Tolerances:
- Each kernel, sum, product and power: K, K(X, Y), ∂K/∂θ and diag within
  KERNEL_RTOL of their max; theta, bounds, n_dims, the hyperparameters and
  clone_with_theta equal.
- GPR (L-BFGS-B from the kernel's θ): θ within GPR_THETA_ATOL, the
  log-marginal likelihood within GPR_LML_RTOL, predictions within
  GPR_PRED_RTOL x max|pred| (tests/test_torch_svm_gp.py's bounds: the
  optimiser stops where its gradient tolerance lets it, and the gradients
  differ by rounding).
- GPC with free hyperparameters (L-BFGS-B on the Laplace log-marginal
  likelihood, each binary problem on its own θ): each problem's θ within
  GPR_THETA_ATOL, the lml within GPR_LML_RTOL, probabilities (one-vs-one:
  decision values) within GPC_PROBA_ATOL, labels equal. The probabilities
  follow θ, which L-BFGS-B leaves ~1e-8 from sklearn's: on breast_cancer
  under the Matern 1.5 kernel θ lies 8.7e-9 from sklearn's and the test
  split's probabilities 1.06e-7 (`studies/port_repairs_study.py cells`).
- The converter: a fitted sklearn GP predicts through the port as it does,
  to CONVERT_ATOL.
- What the port refuses, it refuses as sklearn does (REFUSALS): a
  CompoundKernel as input, an object without the kernel API, a kernel that
  needs vectors on strings, chi2 on negative input, an unknown metric.
- results/gp_kernels.json re-derived from studies/gp_kernels_ref.py to
  REDERIVE_RTOL, and the port's CPU fits held to it.

Two cells of the table are not in KERNEL_OPTIONS (see its note there):
the per-feature RBF on diabetes, whose optimum lies along a flat
direction, and DotProduct(1) ** 2 + WhiteKernel(1) on diabetes's float32
split, where sklearn forms X Xᵀ in float32. The per-feature RBF is fitted
here on a table where every feature sets the fit, and the dot-product
kernel on diabetes's float64 copy, where sklearn computes in float64.
"""
import json
import os
import sys
import warnings

import numpy as np
import pytest

pytest.importorskip("sklearn")
pytest.importorskip("threadpoolctl")

import sklearn.gaussian_process.kernels as skk  # noqa: E402
import torch  # noqa: E402
from threadpoolctl import threadpool_limits  # noqa: E402

from tensornetworksfork_tpu.models import baselines as jbl  # noqa: E402
from tensornetworksfork_tpu_torch.experiments import kernel_baselines as kb  # noqa: E402
from tensornetworksfork_tpu_torch.models import _gp_kernels as tk  # noqa: E402
from tensornetworksfork_tpu_torch.models import baselines as tbl  # noqa: E402
from tensornetworksfork_tpu_torch.utils.convert import (  # noqa: E402
    gp_from_sklearn, gp_kernel_from_sklearn)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNEL_RTOL = 1e-12
GPR_THETA_ATOL = 1e-5
GPR_LML_RTOL = 1e-6
GPR_PRED_RTOL = 1e-5
GPC_PROBA_ATOL = 1e-6
CONVERT_ATOL = 1e-11
REDERIVE_RTOL = 1e-9

SK = {name: getattr(skk, cls.__name__) for name, cls in tk.NAMESPACE.items()}


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


def _both(expression):
    return (kb.kernel_from_expression(expression, SK),
            kb.kernel_from_expression(expression))


def _close(got, want, rtol=KERNEL_RTOL):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * max(np.abs(want).max(initial=0.0), 1e-300))


KERNELS = [
    "ConstantKernel(2.0)", "WhiteKernel(0.3)", "RBF(1.5)", "RBF([0.5, 1.0, 2.0, 3.0])",
    "Matern(0.7, nu=0.5)", "Matern([0.5, 1.0, 2.0, 3.0], nu=0.5)",
    "Matern(0.7, nu=1.5)", "Matern([0.5, 1.0, 2.0, 3.0], nu=1.5)",
    "Matern(0.7, nu=2.5)", "Matern([0.5, 1.0, 2.0, 3.0], nu=2.5)",
    "Matern(0.7, nu=inf)", "Matern([0.5, 1.0, 2.0, 3.0], nu=inf)",
    "RationalQuadratic(length_scale=0.8, alpha=2.0)",
    "ExpSineSquared(length_scale=1.2, periodicity=3.0)", "DotProduct(sigma_0=0.5)",
    # sums, products and powers, a number as a ConstantKernel
    "C(1.0) * Matern(length_scale=1.0, nu=2.5) + WhiteKernel(1.0)",
    "DotProduct(sigma_0=1.0) ** 2 + WhiteKernel(1.0)", "2.0 * RBF(1.0) + 0.5",
    "(RBF(0.9) + DotProduct(0.3)) ** 3 * C(0.7)",
    "C(1.0) * RationalQuadratic(length_scale=1.0, alpha=1.0)",
    "ExpSineSquared(1.0, 2.0) * RBF([1.0, 2.0, 0.5, 1.5]) + WhiteKernel(0.1)",
    # "fixed" hyperparameters: no θ, no gradient column
    "C(1.0, 'fixed') * RBF(1.0, 'fixed')", "RBF(1.0, length_scale_bounds='fixed') * C(3.0)",
    "RationalQuadratic(0.8, 2.0, alpha_bounds='fixed')",
    "ExpSineSquared(1.2, 3.0, periodicity_bounds='fixed') + DotProduct(1.0, 'fixed')",
    "Matern([1.0, 2.0, 3.0, 4.0], length_scale_bounds=(1e-2, 1e2), nu=1.5) "
    "+ WhiteKernel(0.5, noise_level_bounds='fixed')",
]


@pytest.mark.parametrize("expression", KERNELS)
def test_kernel_matches_sklearn(expression):
    rng = np.random.default_rng(len(expression))
    X, Y = rng.normal(size=(23, 4)), rng.normal(size=(9, 4))
    sk, port = _both(expression)
    assert np.array_equal(port.theta, sk.theta) and np.array_equal(port.bounds, sk.bounds)
    assert port.n_dims == sk.n_dims
    assert port.hyperparameters == sk.hyperparameters
    assert repr(port) == repr(sk)
    K, G = sk(X, eval_gradient=True)
    Kt, Gt = port(torch.from_numpy(X), eval_gradient=True)
    assert Kt.dtype == Gt.dtype == torch.float64
    _close(Kt, K)
    _close(Gt, G)
    _close(port(X, Y), sk(X, Y))
    _close(port.diag(X), sk.diag(X))
    theta = sk.theta + rng.uniform(-0.5, 0.5, sk.n_dims)
    sk2, port2 = sk.clone_with_theta(theta), port.clone_with_theta(theta)
    assert np.array_equal(port.theta, sk.theta)            # the clone is a copy
    np.testing.assert_array_equal(port2.theta, sk2.theta)
    K2, G2 = sk2(X, eval_gradient=True)
    K2t, G2t = port2(X, eval_gradient=True)
    _close(K2t, K2)
    _close(G2t, G2)
    assert gp_kernel_from_sklearn(sk) == port
    assert gp_kernel_from_sklearn(sk2) == port2


def test_kernel_parameters_and_errors_follow_sklearn():
    sk, port = _both("C(2.0) * RBF([1.0, 2.0]) + WhiteKernel(0.1)")
    assert set(port.get_params()) == set(sk.get_params())
    port.set_params(k1__k2__length_scale=[3.0, 4.0])
    sk.set_params(k1__k2__length_scale=[3.0, 4.0])
    np.testing.assert_array_equal(port.theta, sk.theta)
    X = np.zeros((3, 2))
    for k in (sk, port):
        with pytest.raises(ValueError, match="Gradient can only be evaluated"):
            k(X, X, eval_gradient=True)
        with pytest.raises(ValueError, match="theta has not the correct number"):
            k.theta = np.zeros(2)
    with pytest.raises(ValueError, match="Anisotropic kernel"):
        port(np.zeros((3, 5)))
    with pytest.raises(AttributeError, match="only supports isotropic"):
        tk.RationalQuadratic(length_scale=[1.0, 2.0])(X)


def _jax_gp(params, task, X, y):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return jbl.GaussianProcessWrapper(dict(params), task=task).fit(X, y)


def _ard_table():
    """120 points of a function of three features, each of which sets the
    fit: the per-feature length scales have one well-defined optimum."""
    rng = np.random.default_rng(5)
    X = rng.uniform(-1, 1, (120, 3))
    y = np.sin(3 * X[:, 0]) + 0.5 * X[:, 1] ** 2 + 0.2 * X[:, 2] + 0.05 * rng.normal(size=120)
    return {"X_train": X, "y_train": y, "X_test": rng.uniform(-1, 1, (40, 3))}


def _diabetes64():
    d = dict(kb.table("diabetes")[0])
    return {k: np.asarray(v, np.float64) for k, v in d.items()}


GPR_CASES = {
    **{o: (v[0], lambda: kb.table("diabetes")[0])
       for o, v in kb.KERNEL_OPTIONS.items() if v[2] == ("diabetes",)},
    "rbf per feature + white": ("C(1.0) * RBF([1.0, 1.0, 1.0]) + WhiteKernel(0.1)", _ard_table),
    "dot product ** 2 + white, float64": ("DotProduct(sigma_0=1.0) ** 2 + WhiteKernel(1.0)",
                                          _diabetes64),
}


@pytest.mark.parametrize("case", sorted(GPR_CASES))
def test_gpr_kernel_fit_matches_jax(case):
    expression, data = GPR_CASES[case]
    d = data()
    sk_kernel, port_kernel = _both(expression)
    j = _jax_gp({"kernel": sk_kernel}, "regression", d["X_train"], d["y_train"])
    p = tbl.GaussianProcessWrapper({"kernel": port_kernel}, device="cpu").fit(
        d["X_train"], d["y_train"])
    assert port_kernel.theta.tolist() == sk_kernel.theta.tolist()    # fitted on a clone
    sk = j.model
    assert p.fit_.n_eval > 1
    np.testing.assert_allclose(p.theta_, sk.kernel_.theta, rtol=0, atol=GPR_THETA_ATOL)
    np.testing.assert_allclose(p.kernel_.theta, sk.kernel_.theta, rtol=0, atol=GPR_THETA_ATOL)
    np.testing.assert_allclose(p.log_marginal_likelihood_value_,
                               sk.log_marginal_likelihood_value_, rtol=GPR_LML_RTOL)
    want = j.predict(d["X_test"])
    got = p.predict(d["X_test"])
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=GPR_PRED_RTOL * np.abs(want).max())


def _estimators(model):
    base = model.base_estimator_
    return getattr(base, "estimators_", [base])


def _gpc_check(j, p, d):
    ests = _estimators(j.model)
    assert len(p.kernels_) == len(ests)
    for kt, e in zip(p.kernels_, ests):
        assert kt.n_dims > 0
        np.testing.assert_allclose(kt.theta, e.kernel_.theta, rtol=0, atol=GPR_THETA_ATOL)
    np.testing.assert_allclose(p.log_marginal_likelihood_value_,
                               j.model.log_marginal_likelihood_value_, rtol=GPR_LML_RTOL)
    for split in ("val", "test"):
        X = d[f"X_{split}"]
        np.testing.assert_array_equal(p.predict(X), j.predict(X))
        if p._one_vs_one:
            np.testing.assert_allclose(p.decision_function(X),
                                       j.model.base_estimator_.decision_function(X),
                                       rtol=0, atol=GPC_PROBA_ATOL)
        else:
            np.testing.assert_allclose(p.predict_proba(X), j.model.predict_proba(X),
                                       rtol=0, atol=GPC_PROBA_ATOL)


GPC_CASES = {
    "iris rbf": ("iris", "C(1.0) * RBF(1.0)", {}),
    "iris rbf one_vs_one": ("iris", "C(1.0) * RBF(1.0)", {"multi_class": "one_vs_one"}),
    "breast_cancer matern 1.5": ("breast_cancer", "C(1.0) * Matern(length_scale=1.0, nu=1.5)",
                                 {}),
    "iris rbf warm_start": ("iris", "C(1.0) * RBF(1.0)", {"warm_start": True}),
    "breast_cancer rbf restarts": ("breast_cancer", "C(1.0) * RBF(1.0)",
                                   {"n_restarts_optimizer": 2, "random_state": 0}),
}


@pytest.mark.parametrize("case", sorted(GPC_CASES))
def test_gpc_free_kernel_fit_matches_jax(case):
    """Each binary problem fits its own θ: one-vs-rest, one-vs-one, two
    classes, warm_start (every mode search from the last one's f) and
    restarts (θ₀ = exp of a draw within the log bounds, as sklearn's
    classifier draws it)."""
    name, expression, params = GPC_CASES[case]
    d, task = kb.table(name)
    sk_kernel, port_kernel = _both(expression)
    j = _jax_gp(dict(params, kernel=sk_kernel), task, d["X_train"], d["y_train"])
    p = tbl.GaussianProcessWrapper(dict(params, kernel=port_kernel), task=task,
                                   device="cpu").fit(d["X_train"], d["y_train"])
    _gpc_check(j, p, d)
    if params.get("n_restarts_optimizer"):
        assert all(len(o) == 3 for o in p.fit_.optima)


def test_gp_from_sklearn_round_trip():
    """Fitted sklearn GPs (a Matern + white regressor, a one-vs-rest and a
    one-vs-one classifier with each binary problem's fitted kernel) carry
    across and predict as they do."""
    from sklearn.gaussian_process import (GaussianProcessClassifier,
                                          GaussianProcessRegressor)
    d = _diabetes64()
    g = GaussianProcessRegressor(
        kernel=kb.kernel_from_expression(GPR_CASES["matern 2.5 + white"][0], SK)).fit(
        d["X_train"], d["y_train"])
    w = gp_from_sklearn(g, device="cpu")
    assert w.kernel_ == gp_kernel_from_sklearn(g.kernel_)
    want = g.predict(d["X_test"])
    np.testing.assert_allclose(w.predict(d["X_test"]), want, rtol=0,
                               atol=CONVERT_ATOL * np.abs(want).max())
    d, _ = kb.table("iris")
    X, Xt = d["X_train"].astype(np.float64), d["X_test"].astype(np.float64)
    for multi in ("one_vs_rest", "one_vs_one"):
        g = GaussianProcessClassifier(skk.ConstantKernel() * skk.RBF(), multi_class=multi)
        g.fit(X, d["y_train"])
        w = gp_from_sklearn(g, device="cpu")
        for kt, e in zip(w.kernels_, _estimators(g)):
            np.testing.assert_array_equal(kt.theta, e.kernel_.theta)
        np.testing.assert_array_equal(w.predict(Xt), g.predict(Xt))
        if multi == "one_vs_rest":
            np.testing.assert_allclose(w.predict_proba(Xt), g.predict_proba(Xt), rtol=0,
                                       atol=CONVERT_ATOL)
        else:
            np.testing.assert_allclose(w.decision_function(Xt),
                                       g.base_estimator_.decision_function(Xt), rtol=0,
                                       atol=CONVERT_ATOL)


# what the port still refuses, each as sklearn refuses it: a CompoundKernel
# as input, an object without the kernel API, a kernel that needs vectors on
# strings, chi2 on negative input, a metric that is no kernel function
REFUSALS = ("kernel cannot be a CompoundKernel|is not a GP kernel|requires vector input"
            "|contains negative values|'metric' parameter of pairwise_kernels")


class _CallOnly:
    """Half of a kernel: __call__ and diag, no θ."""

    def __call__(self, X, Y=None, eval_gradient=False):
        return np.zeros((len(X), len(X)))

    def diag(self, X):
        return np.zeros(len(X))


_THREE = (np.array([[0.0, 1.0], [1.0, 0.0], [2.0, 2.0]]), np.array([0.0, 1.0, 2.0]))


@pytest.mark.parametrize("make", [
    lambda: tbl.GaussianProcessWrapper(
        {"kernel": skk.CompoundKernel([skk.RBF(), skk.RBF()])}, device="cpu").fit(*_THREE),
    lambda: tbl.GaussianProcessWrapper(
        {"kernel": skk.CompoundKernel([skk.RBF(), skk.RBF()])}, task="classification",
        device="cpu").fit(*_THREE),
    lambda: gp_kernel_from_sklearn(object()),
    lambda: tbl.GaussianProcessWrapper({"kernel": _CallOnly()}, device="cpu"),
    # sklearn fits a WhiteKernel on strings, not an RBF
    lambda: tbl.GaussianProcessWrapper({"kernel": skk.RBF()}, device="cpu").fit(
        np.array(["ab", "cd", "ef"]), np.array([0.0, 1.0, 2.0])),
    lambda: tk.PairwiseKernel(metric="chi2")(-_THREE[0]),
    lambda: gp_kernel_from_sklearn(skk.PairwiseKernel(metric="hamming"))(_THREE[0]),
])
def test_unported_kernels_raise(make):
    with pytest.raises(ValueError, match=REFUSALS):
        make()


def _committed():
    with open(os.path.join(ROOT, kb.KERNELS_REFERENCE)) as f:
        return json.load(f)


def test_gp_kernels_reference_is_current():
    sys.path.insert(0, os.path.join(ROOT, "studies"))
    try:
        import gp_kernels_ref
    finally:
        sys.path.pop(0)
    fresh = gp_kernels_ref.reference()
    want = _committed()
    assert fresh["rows"] == want["rows"]
    assert json.loads(json.dumps(fresh["params"])) == want["params"]
    assert fresh["kernels_as_written"] == want["kernels_as_written"]
    assert set(fresh["kernels"]) == set(want["kernels"]) == set(kb.KERNEL_OPTIONS)
    for option, tables in fresh["kernels"].items():
        assert set(tables) == set(want["kernels"][option]) == set(kb.KERNEL_OPTIONS[option][2])
        for name, record in tables.items():
            ref = want["kernels"][option][name]
            assert record.keys() == ref.keys()
            for k, v in record.items():
                assert v == pytest.approx(ref[k], rel=REDERIVE_RTOL, abs=REDERIVE_RTOL), \
                    (option, name, k)


def test_port_matches_gp_kernels_reference():
    """The port's CPU fits of every KERNEL_OPTIONS cell: the metrics at the
    GP's bounds (kernel_baselines.compare_kernels), θ and the lml at the
    fits' bounds."""
    got = kb.run_gp_kernels("cpu")
    want = _committed()
    assert kb.compare_kernels(got, want) == []
    for option, tables in got.items():
        for name, record in tables.items():
            ref = want["kernels"][option][name]
            np.testing.assert_allclose(record["theta"], ref["theta"], rtol=0,
                                       atol=GPR_THETA_ATOL)
            np.testing.assert_allclose(record["lml"], ref["lml"], rtol=GPR_LML_RTOL)
