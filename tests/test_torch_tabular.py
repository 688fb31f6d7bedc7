"""The tabular TT-regression path of the port held against the JAX package:
the sweep on a tensor train with squared loss (diagonal Hessians), the
own-out kernel route, `TensorTrainRegressor`, the synthetic data and the
`train_tabular` CLI.

Params are made by the JAX package and copied across (`utils/convert.py`),
data come from a numpy seed. With TNF_PACKED_SYRK_MIN_D=1 the middle core
takes the tiled kernel route (retile_rows + weighted_gram_tiled, or the int8
band Gram) and the last core the flat weighted Gram; the port runs the
kernels' plain versions on the CPU, the JAX package its Pallas kernels in
interpret mode. TNF_FULLBATCH_MAX_BYTES=0 keeps the chunks apart so the
carry spans them.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from tensornetworksfork_tpu.core.engine import Network as JNetwork  # noqa: E402
from tensornetworksfork_tpu.core.sweep import SweepConfig as JConfig  # noqa: E402
from tensornetworksfork_tpu.core.sweep import Sweeper as JSweeper  # noqa: E402
from tensornetworksfork_tpu.models.layers import TensorTrainLayer as JLayer  # noqa: E402
from tensornetworksfork_tpu.ops import bregman as jb  # noqa: E402
from tensornetworksfork_tpu_torch.core.sweep import SweepConfig, Sweeper  # noqa: E402
from tensornetworksfork_tpu_torch.models.layers import TensorTrainLayer as TLayer  # noqa: E402
from tensornetworksfork_tpu_torch.ops import bregman as tb  # noqa: E402
from tensornetworksfork_tpu_torch.ops.cuda import gram as tg  # noqa: E402
from tensornetworksfork_tpu_torch.utils.convert import (  # noqa: E402
    params_from_numpy, params_to_numpy)

N, R, F, S, B = 3, 4, 9, 128, 64
CFG = dict(num_swipes=1, batch_size=B, method="ridge_cholesky", eps=5.0,
           eps_decay=0.25)


def table(seed=0, S=S, F=F, C=1):
    """Features in [-1, 1] with a bias column; a regression target, or
    one-hot labels of C+1 classes when C > 1."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(-1, 1, (S, F)).astype(np.float32)
    X[:, -1] = 1.0
    if C == 1:
        return X, rng.standard_normal((S, 1)).astype(np.float32)
    return X, np.eye(C + 1, dtype=np.float32)[rng.integers(0, C + 1, S)]


def count_calls(monkeypatch, names):
    calls = {}

    def wrap(name):
        fn = getattr(tg, name)

        def wrapper(*a, **k):
            calls[name] = calls.get(name, 0) + 1
            return fn(*a, **k)
        monkeypatch.setattr(tg, name, wrapper)

    for name in names:
        wrap(name)
    return calls


def swipe_both(X, Y, C=1, seed=0):
    """One swipe of the same TT through both packages; returns the
    predictions after it and both ok flags."""
    jl = JLayer(N, R, F, output_shape=(C,), seed=seed)
    tl = TLayer(N, R, F, output_shape=(C,), seed=seed, use_kernels=True,
                device="cpu")
    jloss, tloss = ((jb.SquareBregFunction(), tb.SquareBregFunction()) if C == 1
                    else (jb.XEBregman(1.0), tb.XEBregman(1.0)))
    p0 = {k: np.asarray(v) for k, v in jl.params.items()}
    pj, okj = JSweeper(JNetwork(jl.topology, use_pallas=True), jloss,
                       JConfig(**CFG)).run([jl.params], jnp.asarray(X),
                                           jnp.asarray(Y))
    pt, okt = Sweeper(tl.network, tloss, SweepConfig(**CFG)).run(
        [params_from_numpy(p0, device="cpu")], torch.tensor(X), torch.tensor(Y))
    pred_j = np.asarray(jl.network.forward(
        {k: np.asarray(v) for k, v in pj[0].items()}, jnp.asarray(X)))
    pred_t = tl.network.forward(pt[0], torch.tensor(X)).numpy()
    return pred_j, pred_t, okj, okt, (pj[0], params_to_numpy(pt[0]))


# Tolerances on the predictions after the swipe, relative to max|pred|:
# - f32: the same f32 arithmetic summed in another order (measured ~1e-6);
#   the params are held to rtol 1e-4, atol 1e-5 as well;
# - bf16 and int8: a J entry whose f32 sum lands next to a bf16 rounding
#   boundary rounds one ulp apart (and in int8 may flip a code), carried
#   through five chained solves; measured ~1e-4, held to 1e-2.
@pytest.mark.parametrize("tier,rtol", [("f32", 1e-4), ("bf16", 1e-2),
                                       ("int8", 1e-2)])
def test_tt_regression_swipe_matches_jax(tier, rtol, monkeypatch):
    monkeypatch.setenv("TNF_GRAM_DTYPE", tier)
    monkeypatch.setenv("TNF_PACKED_SYRK_MIN_D", "1")
    monkeypatch.setenv("TNF_FULLBATCH_MAX_BYTES", "0")
    calls = count_calls(monkeypatch, ("retile_rows", "weighted_gram_tiled",
                                      "weighted_gram", "quantize_tiled",
                                      "gram_pair_band_q", "own_out_gram"))
    X, Y = table(0)
    pred_j, pred_t, okj, okt, (pj, pt) = swipe_both(X, Y)
    assert okj and okt
    np.testing.assert_allclose(pred_t, pred_j, rtol=0,
                               atol=rtol * np.abs(pred_j).max())
    if tier == "f32":
        for k in pj:
            np.testing.assert_allclose(pt[k], np.asarray(pj[k]), rtol=1e-4,
                                       atol=1e-5)
    # A2 (2 updates x 2 chunks) took the tiled route, A3 the flat weighted
    # Gram (1 update, the second pass starts past it, x 2 chunks); A1 the
    # structured own-out dot (no opt-in)
    assert calls["retile_rows"] == 4
    assert calls["weighted_gram"] == 2
    if tier == "int8":
        assert calls["quantize_tiled"] == 8 and calls["gram_pair_band_q"] == 4
        assert "weighted_gram_tiled" not in calls
    else:
        assert calls["weighted_gram_tiled"] == 4
        assert "quantize_tiled" not in calls
    assert "own_out_gram" not in calls


@pytest.mark.parametrize("C,tier,rtol", [(1, "f32", 1e-4), (3, "f32", 1e-4),
                                         (1, "bf16", 1e-2)])
def test_ownout_kernel_route_matches_jax(C, tier, rtol, monkeypatch):
    """TNF_OWNOUT_KERNEL=1 sends the first core through K8 + K11 in both
    packages. C=1 is the regression TT (diagonal Hessian embedded); C=3 an
    XE classifier, where the sweep offers the deferred own-out form and the
    opt-in must still return the full A (no deferred plan)."""
    monkeypatch.setenv("TNF_GRAM_DTYPE", tier)
    monkeypatch.setenv("TNF_OWNOUT_KERNEL", "1")
    monkeypatch.setenv("TNF_OWNOUT_KERNEL_MIN_DJ", "1")
    monkeypatch.setenv("TNF_FULLBATCH_MAX_BYTES", "0")
    calls = count_calls(monkeypatch, ("own_out_gram", "retile_rows"))
    X, Y = table(1, C=C)
    pred_j, pred_t, okj, okt, _ = swipe_both(X, Y, C=C)
    assert okj and okt
    np.testing.assert_allclose(pred_t, pred_j, rtol=0,
                               atol=rtol * np.abs(pred_j).max())
    # A1 is updated twice, over two chunks each
    assert calls["own_out_gram"] == 4 and calls["retile_rows"] >= 4


def test_ownout_kernel_returns_full_gram(monkeypatch):
    """With the opt-in, gram_and_rhs answers a deferred-own-out request with
    the full node-shaped A and leaves the plan unset, and that A equals the
    deferred form expanded."""
    monkeypatch.setenv("TNF_OWNOUT_KERNEL_MIN_DJ", "1")
    X, Y = table(2, C=3)
    tl = TLayer(N, R, F, output_shape=(3,), seed=0, use_kernels=True,
                device="cpu")
    net = tl.network
    Xt = torch.tensor(X)
    inputs = net.bind_inputs(Xt)
    right = net.env_chain(tl.params, inputs, "right", skip_last=True)
    J = net.jacobian(0, tl.params, inputs, None, right[1])
    pred = net.predict_from_jacobian(0, J, tl.params["A1"])
    _, g, H = tb.XEBregman(1.0)(pred, torch.tensor(Y))
    cell = {"plan": None}
    A_def, _ = net.gram_and_rhs(0, J, g, H, defer_ownout=cell)
    A_full = net.expand_ownout(A_def, cell["plan"])
    monkeypatch.setenv("TNF_OWNOUT_KERNEL", "1")
    cell2 = {"plan": None}
    A_k, _ = net.gram_and_rhs(0, J, g, H, defer_ownout=cell2)
    assert cell2["plan"] is None
    assert A_k.shape == A_full.shape
    np.testing.assert_allclose(A_k.numpy(), A_full.numpy(), rtol=0,
                               atol=1e-5 * float(A_full.abs().max()))


def build_estimators(model_type, **kw):
    """The JAX and the port's TensorTrainRegressor with the same settings,
    their models pre-built and sharing the JAX init params."""
    from tensornetworksfork_tpu.models.estimators import (
        TensorTrainRegressor as JEst)
    from tensornetworksfork_tpu_torch.models.estimators import (
        TensorTrainRegressor as TEst)
    args = dict(N=N, r=R, batch_size=B, num_swipes=1, model_type=model_type,
                eps_start=1.0, eps_decay=0.5, seed=3, **kw)
    je, te = JEst(**args), TEst(**args, device="cpu")
    for e in (je, te):
        e.input_dim = F  # F - 1 features and the bias column
        e._initialize_model()
    if model_type == "tt":
        te._model.params = params_from_numpy(je._model.params, device="cpu")
    else:
        te._model.set_params_list([params_from_numpy(p, device="cpu")
                                   for p in je._model.params_list])
    return je, te


@pytest.mark.parametrize("model_type", ["tt", "tt_type1"])
@pytest.mark.parametrize("early_stopping", [0, 2])
def test_estimator_matches_jax(model_type, early_stopping, monkeypatch):
    """fit / predict / score on the CPU (both packages' default routes
    there), with and without early stopping (val history and best-state
    restore included). rtol 1e-4 of max|pred|: f32 sums in another order."""
    monkeypatch.setenv("TNF_FIT_PRECOMPILE", "0")
    monkeypatch.setenv("TNF_GRAM_DTYPE", "f32")
    X, Y = table(4, S=192, F=F)
    Xtr, Ytr, Xva, Yva = X[:128, :-1], Y[:128], X[128:, :-1], Y[128:]
    je, te = build_estimators(model_type, early_stopping=early_stopping)
    je.fit(Xtr, Ytr, X_val=Xva, y_val=Yva)
    te.fit(Xtr, Ytr, X_val=Xva, y_val=Yva)
    assert te.fit_ok_
    pj, pt = np.asarray(je.predict(Xva)), te.predict(Xva)
    assert isinstance(pt, np.ndarray) and pt.shape == pj.shape == (64, 1)
    np.testing.assert_allclose(pt, pj, rtol=0, atol=1e-4 * np.abs(pj).max())
    assert abs(te.score(Xva, Yva) - je.score(Xva, Yva)) < 1e-4
    if early_stopping:
        hj = je._early_stopper.val_history
        ht = te._early_stopper.val_history
        assert list(ht) == list(hj)
        np.testing.assert_allclose(list(ht.values()), list(hj.values()),
                                   rtol=1e-4)


@pytest.mark.parametrize("seed,S,d", [(0, 256, 4), (7, 100, 128)])
def test_make_regression_bit_equal(seed, S, d):
    from tensornetworksfork_tpu.data.synthetic import make_regression as jmr
    from tensornetworksfork_tpu_torch.data.synthetic import make_regression
    Xj, yj = jmr(S=S, d=d, degree=3, seed=seed)
    Xt, yt = make_regression(S=S, d=d, degree=3, seed=seed)
    np.testing.assert_array_equal(Xt, Xj)
    np.testing.assert_array_equal(yt, yj)


def test_train_tabular_synthetic_matches_jax(tmp_path, monkeypatch):
    """The CLI on --dataset synthetic (the port through main(), which also
    appends the results row) against the JAX package's run(): the same
    data and init reach the same val/test rmse to rtol 1e-4 (f32 order;
    measured ~5e-6). The CLI builds its model inside fit, so the port's
    model build is wrapped to take the JAX package's init params."""
    import csv
    from tensornetworksfork_tpu.experiments import train_tabular as jtt
    from tensornetworksfork_tpu.models.estimators import (
        TensorTrainRegressor as JEst)
    from tensornetworksfork_tpu.utils.config import RunConfig as JRunConfig
    from tensornetworksfork_tpu_torch.experiments import train_tabular as ttt
    from tensornetworksfork_tpu_torch.models.estimators import (
        TensorTrainRegressor as TEst)

    build = TEst._initialize_model

    def build_with_jax_init(self):
        build(self)
        je = JEst(N=self.N, r=self.r, seed=self.seed, model_type=self.model_type)
        je.input_dim = self.input_dim
        je._initialize_model()
        self._model.params = params_from_numpy(je._model.params, device="cpu")

    monkeypatch.setattr(TEst, "_initialize_model", build_with_jax_init)
    monkeypatch.setenv("TNF_FIT_PRECOMPILE", "0")
    monkeypatch.setenv("TNF_GRAM_DTYPE", "f32")
    res_j = jtt.run(JRunConfig(dataset="synthetic", num_swipes=1, verbose=0))
    out = tmp_path / "results.csv"
    ttt.main(["--dataset", "synthetic", "--num_swipes", "1", "--verbose", "0",
              "--results_file", str(out), "--device", "cpu"])
    with open(out, newline="") as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == 1 and rows[0]["singular"] == "False"
    for key in ("val_rmse", "test_rmse", "val_r2", "test_r2"):
        assert abs(float(rows[0][key]) - res_j[key]) <= 1e-4 * abs(res_j[key]), key
    assert res_j["val_r2"] > 0.5  # the fit learned the target


def test_prepared_npz_round_trip(tmp_path):
    """prepare_dataset writes {name}_tensor.npz; load_tabular_data reads it
    back by name or path; the splits are 60/20/20 and X is standardized on
    the train split."""
    from tensornetworksfork_tpu_torch.data.tabular import (
        load_tabular_data, prepare_dataset)
    rng = np.random.default_rng(5)
    X = rng.normal(3.0, 2.0, (50, 4))
    y = rng.normal(size=50)
    splits = prepare_dataset(X, y, "toy", out_dir=str(tmp_path))
    by_name = load_tabular_data("toy", str(tmp_path))
    by_path = load_tabular_data(str(tmp_path / "toy_tensor.npz"))
    for k, v in splits.items():
        np.testing.assert_array_equal(by_name[k], v)
        np.testing.assert_array_equal(by_path[k], v)
    assert [len(splits[f"X_{s}"]) for s in ("train", "val", "test")] == [30, 10, 10]
    np.testing.assert_allclose(splits["X_train"].mean(0), 0, atol=1e-5)
    assert splits["y_train"].shape == (30, 1)


@pytest.mark.parametrize("model_type", ["cpd", "cpd_type1", "tnml", "tt_batch",
                                        "mlp", "xgboost", "svm", "polynomial"])
def test_unported_families_raise(model_type):
    """The family not ported (xgboost) raises naming the library the card's
    machine lacks; cpd, cpd_type1, tnml, polynomial, tt_batch, mlp and svm
    (SVMClfWrapper for classification, SVMRegWrapper for regression), which
    raised until they were ported, now build their estimator on the device
    asked for."""
    from tensornetworksfork_tpu_torch.experiments.train_tabular import build_model
    from tensornetworksfork_tpu_torch.models.baselines import (MLPWrapper,
                                                               PolynomialRegressionWrapper,
                                                               SVMClfWrapper, SVMRegWrapper)
    from tensornetworksfork_tpu_torch.models.estimators import TensorTrainRegressor
    from tensornetworksfork_tpu_torch.models.module import TensorTrainBatchRegressor
    from tensornetworksfork_tpu_torch.models.tnml import TNMLRegressor
    from tensornetworksfork_tpu_torch.utils.config import RunConfig
    built = {"cpd": TensorTrainRegressor, "cpd_type1": TensorTrainRegressor,
             "tnml": TNMLRegressor, "polynomial": PolynomialRegressionWrapper,
             "tt_batch": TensorTrainBatchRegressor, "mlp": MLPWrapper}
    if model_type in built:
        m = build_model(RunConfig(model_type=model_type, device="cpu"), 4)
        assert type(m) is built[model_type] and m.device.type == "cpu"
        if model_type.startswith("cpd"):
            assert m.model_type == model_type
        return
    if model_type == "svm":
        for task, cls in (("classification", SVMClfWrapper), ("regression", SVMRegWrapper)):
            m = build_model(RunConfig(model_type="svm", task=task, device="cpu"), 4)
            assert type(m) is cls and m.device.type == "cpu"
        return
    with pytest.raises(NotImplementedError, match="xgboost"):
        build_model(RunConfig(model_type=model_type), 4)


def test_run_config_fields_reach_the_cli():
    """Every RunConfig field is a CLI flag, so each one must be read by the
    CLI (no flag is accepted and then ignored); --timeout reaches the
    estimator, and results default to build/, outside the JAX package's
    results/ directory."""
    import inspect
    import re
    from tensornetworksfork_tpu_torch.experiments import train_tabular
    from tensornetworksfork_tpu_torch.utils.config import RunConfig
    read = set(re.findall(r"cfg\.(\w+)", inspect.getsource(train_tabular)))
    assert set(RunConfig.field_names()) <= read
    cfg = RunConfig.from_args(["--timeout", "60", "--device", "cpu"])
    assert train_tabular.build_model(cfg, 4).timeout == 60
    assert RunConfig().results_file.startswith("build/")


@pytest.mark.parametrize("kw", [dict(cum_sum=True), dict(linear_dim=2),
                                dict(solve_dtype="float64")])
def test_unported_estimator_options_raise(kw):
    """Options that raised until they were ported now reach the model:
    cum_sum builds a CumSumLayer and linear_dim a TensorTrainLinearLayer
    (tests/test_torch_zoo.py fits both against the JAX package), and
    solve_dtype="float64" reaches the estimator (tests/test_torch_solve.py
    fits with it)."""
    from tensornetworksfork_tpu_torch.models import layers
    from tensornetworksfork_tpu_torch.models.estimators import TensorTrainRegressor
    est = TensorTrainRegressor(**kw, device="cpu")
    if "solve_dtype" in kw:
        assert est.solve_dtype == "float64"
        return
    est.input_dim = 4
    est._initialize_model()
    want = layers.CumSumLayer if "cum_sum" in kw else layers.TensorTrainLinearLayer
    assert type(est._model) is want


def test_fast_tiers_refused(monkeypatch):
    """"fast" and "fastest" (bf16 or int8 Gram operands and the bf16 aux
    tier) fit, and the ambient env comes back after the fit; the bf16x3 aux
    tier, TNF_AUX_PRECISION=high (refused until the port ran it), fits as
    well, and an unknown aux precision is refused."""
    import os
    from tensornetworksfork_tpu_torch.models.estimators import TensorTrainRegressor
    X, Y = table(6, S=32, F=4)
    before = os.environ.get("TNF_AUX_PRECISION")
    for tier in ("fast", "fastest"):
        est = TensorTrainRegressor(N=2, r=2, num_swipes=2, eps_start=5.0,
                                   eps_decay=0.25, precision=tier,
                                   device="cpu").fit(X, Y)
        assert est.fit_ok_
        assert np.isfinite(est.predict(X)).all()
        assert os.environ.get("TNF_AUX_PRECISION") == before
    monkeypatch.setenv("TNF_AUX_PRECISION", "high")
    est = TensorTrainRegressor(N=2, r=2, num_swipes=2, eps_start=5.0, eps_decay=0.25,
                               device="cpu").fit(X, Y)
    assert est.fit_ok_ and np.isfinite(est.predict(X)).all()
    monkeypatch.setenv("TNF_AUX_PRECISION", "bf16x3")
    with pytest.raises(ValueError, match="precision must be one of"):
        TensorTrainRegressor(N=2, r=2, device="cpu").fit(X, Y)


def _no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("entry", ["estimator", "tt_layer", "conv_tt_layer",
                                   "network", "cli", "params_from_numpy"])
def test_entry_points_need_the_card_unless_asked(entry, tmp_path, monkeypatch):
    """Without a device argument every entry point asks for the card; where
    none is visible it raises RuntimeError telling the caller to pass the
    CPU explicitly, instead of running there silently."""
    from tensornetworksfork_tpu_torch.core.engine import Network
    from tensornetworksfork_tpu_torch.experiments import train_tabular as ttt
    from tensornetworksfork_tpu_torch.models.estimators import TensorTrainRegressor
    from tensornetworksfork_tpu_torch.models.layers import TensorConvolutionTrainLayer
    _no_card(monkeypatch)
    out = tmp_path / "results.csv"
    build = {
        "estimator": lambda: TensorTrainRegressor(N=2, r=2),
        "tt_layer": lambda: TLayer(N, R, F),
        "conv_tt_layer": lambda: TensorConvolutionTrainLayer(2, 2, 3, 4),
        "network": lambda: Network(TLayer(N, R, F, device="cpu").topology),
        "cli": lambda: ttt.main(["--dataset", "synthetic", "--num_swipes", "1",
                                 "--verbose", "0", "--results_file", str(out)]),
        "params_from_numpy": lambda: params_from_numpy({"A1": np.zeros((2, 3))}),
    }[entry]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build()
    assert not out.exists()


def test_entry_points_run_on_the_cpu_when_asked(tmp_path, monkeypatch):
    """device="cpu" and --device cpu run the estimator and the CLI on the
    CPU with no card visible."""
    from tensornetworksfork_tpu_torch.experiments import train_tabular as ttt
    from tensornetworksfork_tpu_torch.models.estimators import TensorTrainRegressor
    _no_card(monkeypatch)
    monkeypatch.setenv("TNF_GRAM_DTYPE", "f32")
    X, Y = table(7, S=64, F=4)
    est = TensorTrainRegressor(N=2, r=2, num_swipes=1, device="cpu")
    est.fit(X[:, :-1], Y)
    assert est.fit_ok_ and est.device.type == "cpu"
    assert est._model.params["A1"].device.type == "cpu"
    out = tmp_path / "results.csv"
    ttt.main(["--dataset", "synthetic", "--num_swipes", "1", "--verbose", "0",
              "--results_file", str(out), "--device", "cpu"])
    assert out.exists()


def test_continued_fit_matches_jax(monkeypatch):
    """A fit of 2 swipes, then a continued fit of 1 more, in both packages
    from the JAX init: `fit` restarts eps at eps_start in both (the
    reference's estimators.py keeps eps_start as self.eps and hands it to
    every sweep), so the continued fit's first, large-eps swipe raises the
    val RMSE in both. Predictions agree after each fit to 1e-4 of max|pred|
    (f32 sums in another order; measured ~3e-7)."""
    from tensornetworksfork_tpu.models.estimators import (
        TensorTrainRegressor as JEst)
    from tensornetworksfork_tpu_torch.data.synthetic import make_regression
    from tensornetworksfork_tpu_torch.models.estimators import (
        TensorTrainRegressor as TEst)
    monkeypatch.setenv("TNF_FIT_PRECOMPILE", "0")
    monkeypatch.setenv("TNF_GRAM_DTYPE", "f32")
    X, y = make_regression(S=1024, d=6, degree=3, seed=0)
    Xtr, ytr, Xva, yva = X[:819], y[:819], X[819:], y[819:]
    args = dict(N=3, r=4, batch_size=512, num_swipes=2, eps_start=5.0,
                eps_decay=0.25, seed=0)
    je, te = JEst(**args), TEst(**args, device="cpu")
    for e in (je, te):
        e.input_dim = X.shape[1] + 1
        e._initialize_model()
    te._model.params = params_from_numpy(je._model.params, device="cpu")
    rmse = []
    for swipes in (2, 1):
        je.num_swipes = te.num_swipes = swipes
        je.fit(Xtr, ytr, X_val=Xva, y_val=yva)
        te.fit(Xtr, ytr, X_val=Xva, y_val=yva)
        pj, pt = np.asarray(je.predict(Xva)), te.predict(Xva)
        np.testing.assert_allclose(pt, pj, rtol=0, atol=1e-4 * np.abs(pj).max())
        rmse.append([float(np.sqrt(np.mean((p - yva) ** 2))) for p in (pj, pt)])
    for i in range(2):
        assert rmse[1][i] > 2 * rmse[0][i], rmse
