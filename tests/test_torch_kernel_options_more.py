"""The last kernel options of the port's SVM and GP wrappers held against
sklearn on the CPU: the Bessel function kv (models/_special.py), the
pairwise kernel functions (models/_pairwise.py), Matern at any ν,
PairwiseKernel and CompoundKernel (models/_gp_kernels.py), SVC / SVR with a
precomputed or a callable kernel, and kernels the user wrote (HostKernel),
on vectors and on strings. Fits are held to the JAX package's wrappers,
which hand everything to sklearn.

Tolerances (written before the port's first fit of these cells):
- kv against scipy.special.kv: KV_RTOL relative at every x where scipy's is
  not 0, and 0 where scipy's is (below its underflow limit);
- each pairwise function, and the K, K(X, Y) and diag of PairwiseKernel and
  of Matern at a general ν: KERNEL_RTOL of their max;
- a finite-difference gradient (ε = 1e-10 over K's rounding): FD_GRAD_RTOL
  of its max; a fit through one: θ within FD_THETA_ATOL, the lml within
  FD_LML_RTOL, GPR predictions within FD_PRED_RTOL x max|pred|, GPC
  probabilities within FD_PROBA_ATOL, labels equal;
- a user's kernel on the host (the same numpy K on both sides): θ within
  THETA_ATOL, the lml within LML_RTOL, predictions within PRED_RTOL x
  max|pred|, probabilities within PROBA_ATOL;
- SVC / SVR under a precomputed or a callable kernel with shrinking=False:
  libsvm's iterates (SMO iterations, support_, n_support_ equal, dual
  coefficients and intercepts within SVM_ATOL, decision values within
  SVM_ATOL x max|dec|); with shrinking, decision values within sklearn's
  tol and support_ equal;
- CompoundKernel: θ and bounds equal, K and its gradient within
  KERNEL_RTOL; a fitted multi-class kernel_ with free hyperparameters
  within THETA_ATOL of sklearn's θ.
"""
import json
import os
import sys
import warnings

import numpy as np
import pytest

pytest.importorskip("sklearn")
pytest.importorskip("threadpoolctl")

import scipy.special  # noqa: E402
import sklearn.gaussian_process.kernels as skk  # noqa: E402
import sklearn.metrics.pairwise as skp  # noqa: E402
import torch  # noqa: E402
from threadpoolctl import threadpool_limits  # noqa: E402

from tensornetworksfork_tpu.models import baselines as jbl  # noqa: E402
from tensornetworksfork_tpu_torch.experiments import kernel_baselines as kb  # noqa: E402
from tensornetworksfork_tpu_torch.models import _gp_kernels as tk  # noqa: E402
from tensornetworksfork_tpu_torch.models import _pairwise as tp  # noqa: E402
from tensornetworksfork_tpu_torch.models import baselines as tbl  # noqa: E402
from tensornetworksfork_tpu_torch.models._special import kv  # noqa: E402
from tensornetworksfork_tpu_torch.utils.convert import (  # noqa: E402
    gp_kernel_from_sklearn, svm_from_sklearn)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "studies"))
import gp_kernels_more_ref  # noqa: E402

sys.path.pop(0)

KV_RTOL = 1e-13
KERNEL_RTOL = 1e-13
FD_GRAD_RTOL = 1e-4
FD_THETA_ATOL = kb.FD_THETA_ATOL            # 1e-3
FD_LML_RTOL = kb.FD_LML_RTOL                # 1e-6
FD_PRED_RTOL = 1e-3
FD_PROBA_ATOL = 1e-4
THETA_ATOL = 1e-5
LML_RTOL = 1e-6
PRED_RTOL = 1e-5
PROBA_ATOL = 1e-6
SVM_ATOL = 1e-12
SVM_TOL = 1e-3
REDERIVE_RTOL = 1e-9

SK = gp_kernels_more_ref.sklearn_namespace()


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


def _close(got, want, rtol=KERNEL_RTOL):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * max(np.abs(want).max(initial=0.0), 1e-300))


def _both(expression):
    return (kb.kernel_from_expression(expression, SK),
            kb.kernel_from_expression(expression))


@pytest.mark.parametrize("nu", kb.KV_NUS)
def test_kv_matches_scipy(nu):
    x = kb.kv_grid()
    want = scipy.special.kv(nu, x)
    got = kv(nu, torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got == 0, want == 0)
    assert (want == 0).any() and (want != 0).sum() >= 60
    nz = want != 0
    np.testing.assert_allclose(got[nz], want[nz], rtol=KV_RTOL, atol=0)
    edge = kv(nu, torch.tensor([0.0, -1.0, float("nan")])).numpy()
    np.testing.assert_array_equal(edge, scipy.special.kv(nu, [0.0, -1.0, np.nan]))


def _rows(seed):
    rng = np.random.default_rng(seed)
    X, Y = rng.uniform(0, 2, (23, 4)), rng.uniform(0, 2, (9, 4))
    X[5] = X[2]                     # a repeated row: a zero distance off the diagonal
    X[7, 1] = 0.0
    return X, Y


@pytest.mark.parametrize("metric", sorted(tp.PAIRWISE_KERNEL_FUNCTIONS))
def test_pairwise_function_matches_sklearn(metric):
    X, Y = _rows(len(metric))
    kw = {k: v for k, v in dict(gamma=0.6, degree=2, coef0=0.4).items()
          if k in tp.KERNEL_PARAMS[metric]}
    for Yv in (None, Y):
        want = skp.pairwise_kernels(X, Yv, metric=metric, **kw)
        got = tp.pairwise_kernels(torch.from_numpy(X),
                                  None if Yv is None else torch.from_numpy(Yv),
                                  metric=metric, **kw)
        _close(got, want)
    if "chi2" in metric:
        for args in ((-X, None), (X, -Y)):
            with pytest.raises(ValueError, match="contains negative values"):
                skp.pairwise_kernels(*args, metric=metric)
            with pytest.raises(ValueError, match="contains negative values"):
                tp.pairwise_kernels(*(None if a is None else torch.from_numpy(a)
                                      for a in args), metric=metric)


def _sum_of_squares(x, y, gamma, shift=0.0):
    """A user's metric for PairwiseKernel (numpy rows)."""
    return float(np.exp(-np.squeeze(gamma) * np.sum((x - y) ** 2)) + shift)


KERNELS = [f"PairwiseKernel(gamma=0.7, metric='{m}')"
           for m in sorted(tp.PAIRWISE_KERNEL_FUNCTIONS)] + [
    "PairwiseKernel(gamma=0.3, metric='poly', pairwise_kernels_kwargs={'degree': 2, 'coef0': 0.5})",
    "C(2.0) * PairwiseKernel(metric='laplacian') + WhiteKernel(0.1)",
    "PairwiseKernel(gamma=0.5, gamma_bounds='fixed', metric='rbf')",
    "PairwiseKernel(gamma=0.4, metric=metric)",
    "PairwiseKernel(gamma=0.4, metric=metric, pairwise_kernels_kwargs={'shift': 0.25})",
    "Matern(0.7, nu=0.3)", "Matern(0.9, nu=0.75)", "Matern(1.1, nu=1.0)",
    "Matern([0.5, 1.0, 2.0, 3.0], nu=1.25)", "Matern(1.3, nu=3.7)", "Matern(1.6, nu=8.5)",
    "Matern(1.0, length_scale_bounds='fixed', nu=0.75)",
    "C(1.0) * Matern(length_scale=1.0, nu=0.75) + WhiteKernel(1.0)",
]


@pytest.mark.parametrize("expression", KERNELS)
def test_kernel_matches_sklearn(expression):
    """K, K(X, Y), diag, θ, bounds, the hyperparameters, repr,
    is_stationary, clones, and the finite-difference gradient."""
    X, Y = _rows(len(expression))
    ns = dict(SK, metric=_sum_of_squares)
    sk = kb.kernel_from_expression(expression, ns)
    port = kb.kernel_from_expression(expression, dict(tk.NAMESPACE, metric=_sum_of_squares))
    assert np.array_equal(port.theta, sk.theta) and np.array_equal(port.bounds, sk.bounds)
    assert port.hyperparameters == sk.hyperparameters
    assert repr(port) == repr(sk)
    assert port.is_stationary() == sk.is_stationary()
    assert port.requires_vector_input == sk.requires_vector_input
    K, G = sk(X, eval_gradient=True)
    Kt, Gt = port(torch.from_numpy(X), eval_gradient=True)
    _close(Kt, K)
    _close(Gt, G, FD_GRAD_RTOL)
    _close(port(X, Y), sk(X, Y))
    _close(port.diag(X), sk.diag(X))
    theta = sk.theta + 0.3
    sk2, port2 = sk.clone_with_theta(theta), port.clone_with_theta(theta)
    np.testing.assert_array_equal(port2.theta, sk2.theta)
    _close(port2(X), sk2(X))
    assert gp_kernel_from_sklearn(sk) == port


def test_compound_kernel_matches_sklearn():
    X, Y = _rows(3)
    expr = "CompoundKernel([C(2.0) * RBF(1.5), C(0.5) * Matern(0.7, nu=1.0), C(1.0) * RBF(0.4)])"
    sk, port = _both(expr)
    assert port.n_dims == sk.n_dims == 6
    np.testing.assert_array_equal(port.theta, sk.theta)
    np.testing.assert_array_equal(port.bounds, sk.bounds)
    assert port.hyperparameters == sk.hyperparameters == []
    assert set(port.get_params()) == set(sk.get_params()) == {"kernels"}
    assert port.is_stationary() == sk.is_stationary()
    assert port.requires_vector_input == sk.requires_vector_input
    K, G = sk(X, eval_gradient=True)
    Kt, Gt = port(torch.from_numpy(X), eval_gradient=True)
    assert Kt.shape == (23, 23, 3) and Gt.shape == (23, 23, 2, 3)
    _close(Kt, K)
    _close(Gt, G, FD_GRAD_RTOL)
    _close(port(X, Y), sk(X, Y))
    _close(port.diag(X), sk.diag(X))
    assert gp_kernel_from_sklearn(sk) == port
    assert port != tk.CompoundKernel(port.kernels[:2])
    assert not tk.CompoundKernel([tk.DotProduct()]).is_stationary()
    # θ set back in turn, each kernel its n_dims (sklearn's setter reads a
    # k1 the class lacks)
    theta = sk.theta + 1.0
    port.theta = theta
    for i, k in enumerate(sk.kernels):
        k.theta = theta[2 * i:2 * i + 2]
    np.testing.assert_array_equal(port.theta, sk.theta)


@pytest.mark.parametrize("kernel", ["default", "free"])
def test_multiclass_kernel_is_a_compound_kernel(kernel):
    """Above two classes, one-vs-rest, kernel_ is a CompoundKernel of the
    binary problems' kernels, as sklearn's: θ, bounds and K(X) equal (the
    default fixed kernel) or within the fits' bounds (C * RBF free)."""
    d, task = kb.table("iris")
    params = {} if kernel == "default" else {"kernel": SK["C"](1.0) * SK["RBF"](1.0)}
    j = jbl.GaussianProcessWrapper(dict(params), task=task).fit(d["X_train"], d["y_train"])
    params = {} if kernel == "default" else {"kernel": gp_kernel_from_sklearn(params["kernel"])}
    p = tbl.GaussianProcessWrapper(dict(params), task=task, device="cpu").fit(
        d["X_train"], d["y_train"])
    sk, port = j.model.kernel_, p.kernel_
    assert type(sk).__name__ == type(port).__name__ == "CompoundKernel"
    assert isinstance(port, tk.CompoundKernel) and len(port.kernels) == 3
    assert port.bounds.shape == sk.bounds.shape
    np.testing.assert_array_equal(port.bounds, sk.bounds)
    X = np.asarray(d["X_test"], np.float64)
    if kernel == "default":
        np.testing.assert_array_equal(port.theta, sk.theta)
        _close(port(X), sk(X))
    else:
        np.testing.assert_allclose(port.theta, sk.theta, rtol=0, atol=THETA_ATOL)
        np.testing.assert_allclose(port.theta, p.theta_, rtol=0, atol=0)
        _close(port(X), sk(X), THETA_ATOL)


@pytest.mark.parametrize("task", ["classification", "regression"])
def test_compound_kernel_as_input_raises(task):
    d, _ = kb.table("iris")
    kernel = skk.CompoundKernel([skk.RBF(), skk.RBF()])
    if task == "classification":
        with pytest.raises(ValueError, match="kernel cannot be a CompoundKernel"):
            jbl.GaussianProcessWrapper({"kernel": kernel}, task=task).fit(
                d["X_train"], d["y_train"])
    w = tbl.GaussianProcessWrapper({"kernel": kernel}, task=task, device="cpu")
    with pytest.raises(ValueError, match="kernel cannot be a CompoundKernel"):
        w.fit(d["X_train"], d["y_train"])


GP_CELLS = {(o, t): v for o, v in kb.MORE_KERNEL_OPTIONS.items() if v[0] == "gp"
            for t in v[3]}


def _fd(option):
    return "Matern" in kb.MORE_KERNEL_OPTIONS[option][1] or \
        "Pairwise" in kb.MORE_KERNEL_OPTIONS[option][1]


@pytest.mark.parametrize("option,name", sorted(GP_CELLS), ids=lambda v: str(v))
def test_more_gp_fit_matches_jax(option, name):
    """Each GP cell of MORE_KERNEL_OPTIONS through both wrappers."""
    data, task = kb.more_table(option, name)
    params = kb.MORE_KERNEL_OPTIONS[option][2]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        j = jbl.GaussianProcessWrapper(dict(params, kernel=kb.more_kernel(option, SK)),
                                       task=task).fit(data["X_train"], data["y_train"])
    p = kb.more_model(option, task, "cpu").fit(data["X_train"], data["y_train"])
    fd = _fd(option)
    np.testing.assert_allclose(p.theta_, gp_kernels_more_ref.fitted_theta(j.model), rtol=0,
                               atol=FD_THETA_ATOL if fd else THETA_ATOL)
    np.testing.assert_allclose(p.log_marginal_likelihood_value_,
                               j.model.log_marginal_likelihood_value_,
                               rtol=FD_LML_RTOL if fd else LML_RTOL)
    for split in ("val", "test"):
        X = data[f"X_{split}"]
        if task == "regression":
            want = j.predict(X)
            np.testing.assert_allclose(p.predict(X), want, rtol=0, atol=(
                FD_PRED_RTOL if fd else PRED_RTOL) * np.abs(want).max())
        else:
            np.testing.assert_array_equal(p.predict(X), j.predict(X))
            np.testing.assert_allclose(p.predict_proba(X), j.model.predict_proba(X), rtol=0,
                                       atol=FD_PROBA_ATOL if fd else PROBA_ATOL)


def test_string_kernel_runs_on_host_rows():
    """A user's string kernel: the rows stay strings (HostRows), the kernel
    is a HostKernel whose K and gradient land on the wrapper's device, and a
    WhiteKernel beside it counts the rows; a kernel that requires vectors
    refuses strings as sklearn's does."""
    data, _ = kb.more_table("string kernel", "sequences")
    w = kb.more_model("string kernel", "regression", "cpu").fit(data["X_train"], data["y_train"])
    X = w._x(data["X_test"])
    assert isinstance(X, tk.HostRows) and X.data.dtype.kind == "U"
    assert isinstance(w.kernel_.k1, tk.HostKernel) and isinstance(w.kernel_.k2, tk.WhiteKernel)
    K, G = w.kernel_(X, eval_gradient=True)
    assert K.dtype == G.dtype == torch.float64 and G.shape == (20, 20, 2)
    np.testing.assert_array_equal(K[:, :].diagonal().numpy(), w.kernel_.diag(X).numpy())
    Xl = list(data["X_test"])
    np.testing.assert_array_equal(w.predict(Xl), w.predict(data["X_test"]))
    with pytest.raises(ValueError, match="requires vector input"):
        tbl.GaussianProcessWrapper({"kernel": skk.RBF()}, device="cpu").fit(
            data["X_train"], data["y_train"])
    with pytest.raises(ValueError):
        jbl.GaussianProcessWrapper({"kernel": skk.RBF()}).fit(data["X_train"], data["y_train"])


SVM_CELLS = [("svc precomputed", "iris", None), ("svc precomputed", "digits", 300),
             ("svc callable linear", "iris", None), ("svc callable linear", "digits", 300),
             ("svr precomputed", "synthetic", 300)]


def _svm_data(option, name, rows):
    data, task = kb.more_table(option, name)
    if rows:
        data = dict(data)
        if kb.MORE_KERNEL_OPTIONS[option][1] == "precomputed":
            for s in ("train", "val", "test"):
                data[f"X_{s}"] = data[f"X_{s}"][:, :rows]
            data["X_train"] = data["X_train"][:rows]
        else:
            data["X_train"] = data["X_train"][:rows]
        data["y_train"] = data["y_train"][:rows]
    return data, task


@pytest.mark.parametrize("shrinking", [False, True])
@pytest.mark.parametrize("option,name,rows", SVM_CELLS)
def test_svm_precomputed_and_callable_follow_libsvm(option, name, rows, shrinking):
    data, task = _svm_data(option, name, rows)
    params = dict(kernel=kb.more_kernel(option), shrinking=shrinking)
    if task == "classification":
        params["decision_function_shape"] = "ovo"
        j, p = jbl.SVMClfWrapper(dict(params)), tbl.SVMClfWrapper(dict(params), device="cpu")
    else:
        j, p = jbl.SVMRegWrapper(dict(params)), tbl.SVMRegWrapper(dict(params), device="cpu")
    j.fit(data["X_train"], data["y_train"])
    p.fit(data["X_train"], data["y_train"])
    sk = j.svm_object
    np.testing.assert_array_equal(p.support_, sk.support_)
    if task == "classification":
        np.testing.assert_array_equal(p.n_support_, sk.n_support_)
    for split in ("val", "test"):
        X = data[f"X_{split}"]
        want = sk.decision_function(X) if task == "classification" else j.predict(X)
        got = p.decision_function(X) if task == "classification" else p.predict(X)
        if shrinking:
            np.testing.assert_allclose(got, want, rtol=0, atol=SVM_TOL)
        else:
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=SVM_ATOL * max(1.0, np.abs(want).max()))
        if task == "classification":
            np.testing.assert_array_equal(p.predict(X), j.predict(X))
    if not shrinking:
        assert p.n_iter_ == np.atleast_1d(sk.n_iter_).tolist()
        np.testing.assert_allclose(p.dual_coef_, sk.dual_coef_, rtol=0, atol=SVM_ATOL)
        np.testing.assert_allclose(p.intercept_, sk.intercept_, rtol=0, atol=SVM_ATOL)
        w = svm_from_sklearn(sk, device="cpu")
        X = data["X_test"]
        got = w.decision_function(X) if task == "classification" else w.predict(X)
        want = sk.decision_function(X) if task == "classification" else sk.predict(X)
        np.testing.assert_allclose(got, want, rtol=0, atol=SVM_ATOL * np.abs(want).max())


def test_precomputed_shapes_are_checked_as_sklearn_checks_them():
    data, _ = kb.more_table("svc precomputed", "iris")
    G = data["X_train"]
    for w in (jbl.SVMClfWrapper({"kernel": "precomputed"}).svm_object,
              tbl.SVMClfWrapper({"kernel": "precomputed"}, device="cpu")):
        with pytest.raises(ValueError, match="Precomputed matrix must be a square matrix"):
            w.fit(G[:, :50], data["y_train"])
        w.fit(G, data["y_train"])
        with pytest.raises(ValueError, match="has 50 features, but SVC is expecting 90 features"):
            w.predict(data["X_test"][:, :50])


def _tree_has_host_kernel(k) -> bool:
    if isinstance(k, tk.HostKernel):
        return True
    parts = [getattr(k, a) for a in ("k1", "k2", "kernel") if hasattr(k, a)]
    parts += list(getattr(k, "kernels", []))
    return any(_tree_has_host_kernel(p) for p in parts)


def _builtins():
    return {"ConstantKernel": skk.ConstantKernel(2.0), "WhiteKernel": skk.WhiteKernel(0.3),
            "RBF": skk.RBF([1.0, 2.0]), "Matern": skk.Matern(nu=0.8),
            "RationalQuadratic": skk.RationalQuadratic(),
            "ExpSineSquared": skk.ExpSineSquared(), "DotProduct": skk.DotProduct(),
            "PairwiseKernel": skk.PairwiseKernel(metric="chi2"),
            "Sum": skk.RBF() + skk.WhiteKernel(), "Product": skk.ConstantKernel() * skk.RBF(),
            "Exponentiation": skk.DotProduct() ** 2,
            "CompoundKernel": skk.CompoundKernel([skk.RBF(), skk.Matern()])}


def test_builtin_kernels_never_take_the_host_path():
    """Every sklearn kernel class, and compositions of them, convert to the
    port's native classes; only a kernel the user wrote (or a subclass of a
    built-in class) becomes a HostKernel, and an object without the kernel
    API raises."""
    import inspect
    classes = {n for n, c in inspect.getmembers(skk, inspect.isclass)
               if issubclass(c, skk.Kernel) and not inspect.isabstract(c)
               and c.__module__ == skk.__name__ and n != "KernelOperator"}
    built = _builtins()
    assert classes == set(built) == set(tk.CLASSES)
    rng = np.random.default_rng(0)
    leaves = [k for n, k in built.items() if n != "CompoundKernel"]
    kernels = list(built.values())
    for _ in range(40):
        a, b = (leaves[i] for i in rng.integers(0, len(leaves), 2))
        op = rng.integers(0, 3)
        kernels.append(a + b if op == 0 else a * b if op == 1 else (a + b) ** 2 * a)
    for k in kernels:
        port = gp_kernel_from_sklearn(k)
        assert type(port).__name__ == type(k).__name__
        assert not _tree_has_host_kernel(port), k
        np.testing.assert_array_equal(port.theta, k.theta)

    class MyRBF(skk.RBF):
        pass
    user = kb.SequenceKernel()
    for k in (MyRBF(), user, SK["SequenceKernel"](), skk.RBF() + SK["SequenceKernel"]()):
        assert _tree_has_host_kernel(gp_kernel_from_sklearn(k))
    with pytest.raises(ValueError, match="is not a GP kernel"):
        gp_kernel_from_sklearn(object())


def _committed():
    with open(os.path.join(ROOT, kb.MORE_REFERENCE)) as f:
        return json.load(f)


def test_more_reference_is_current():
    fresh = gp_kernels_more_ref.reference()
    want = _committed()
    assert fresh["rows"] == want["rows"]
    assert json.loads(json.dumps(fresh["as_written"])) == want["as_written"]
    assert set(fresh["options"]) == set(want["options"]) == set(kb.MORE_KERNEL_OPTIONS)
    for option, tables in fresh["options"].items():
        assert set(tables) == set(want["options"][option])
        for name, record in tables.items():
            ref = want["options"][option][name]
            assert record.keys() == ref.keys()
            for k, v in record.items():
                if k in ("support", "n_iter"):
                    assert v == ref[k], (option, name, k)
                else:
                    np.testing.assert_allclose(v, ref[k], rtol=REDERIVE_RTOL,
                                               atol=REDERIVE_RTOL, err_msg=f"{option} {name} {k}")
            if "theta" in record:        # a cell stays only where BLAS's threads move θ less
                assert record["theta_moved_on_8_threads"] <= (
                    FD_THETA_ATOL if _fd(option) else THETA_ATOL)
    np.testing.assert_array_equal(fresh["kv"]["x"], want["kv"]["x"])
    for nu, values in want["kv"]["values"].items():
        np.testing.assert_array_equal(fresh["kv"]["values"][nu], values)


def test_port_matches_more_reference():
    """The port's CPU fits of every MORE_KERNEL_OPTIONS cell against the
    reference (kernel_baselines.compare_more), and kv at its grid."""
    want = _committed()
    assert kb.compare_more(kb.run_more("cpu"), want) == []
    x = torch.tensor(want["kv"]["x"], dtype=torch.float64)
    for nu, values in want["kv"]["values"].items():
        values = np.asarray(values)
        got = kv(float(nu), x).numpy()
        np.testing.assert_array_equal(got == 0, values == 0)
        np.testing.assert_allclose(got[values != 0], values[values != 0], rtol=KV_RTOL, atol=0)
