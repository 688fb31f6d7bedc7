"""The older estimator variants (models/module.py), TTNaturalGradient,
SymmetricCPD and calibrate_logit_scale of the port held against the JAX
package.

The regressors start from the JAX package's initial params (carried across
with `params_from_numpy` into a model built before the fit; the perturb
init draws the same numpy numbers in both packages); minibatches come from
np.random.RandomState(seed) in both. Predictions agree within 1e-4 x
max|pred| (the convention of tests/test_torch_zoo.py), TTNaturalGradient's
12 step losses within 1e-4 relative, SymmetricCPD's predictions after 60
Gauss-Newton iterations within 1e-4 x max|pred|. Sizes are JAX
tests/test_aux.py:126's.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from tensornetworksfork_tpu.models import module as jm  # noqa: E402
from tensornetworksfork_tpu_torch.models import module as tm  # noqa: E402
from tensornetworksfork_tpu_torch.utils.convert import params_from_numpy  # noqa: E402

PRED_REL = 1e-4


def _np(params):
    return {k: np.asarray(v) for k, v in params.items()}


def _data(seed=4, S=256):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((S, 3)).astype(np.float32)
    y = (X[:, 0] + X[:, 1] * X[:, 2]).astype(np.float32)
    return X, y


def _pred_close(got, want, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=0, atol=PRED_REL * np.abs(want).max(),
                               err_msg=what)


def _pair(name, X, **kw):
    """The JAX and the port estimator `name`, the port's model carrying the
    JAX model's initial params."""
    j = getattr(jm, name)(**kw)
    t = getattr(tm, name)(**kw, device="cpu")
    j.input_dim = t.input_dim = X.shape[1] + 1
    j._initialize_model()
    t._initialize_model()
    t._model.params = params_from_numpy(_np(j._model.params), device="cpu")
    return j, t


def test_mirrored_cycle_matches_jax():
    seq = [(0, 0), (0, 1), (0, 2)]
    for one in (True, False):
        a, b = jm.mirrored_cycle(seq, one), tm.mirrored_cycle(seq, one)
        assert [next(a) for _ in range(5 if one else 11)] == \
            [next(b) for _ in range(5 if one else 11)]
    assert list(tm.mirrored_cycle([])) == []


def test_geomspace_regressor_matches_jax():
    """TensorTrainRegressor (module.py): eps on a geomspace, a trajectory
    entry per node update; the trajectory and predictions agree."""
    X, y = _data()
    kw = dict(N=2, r=4, num_swipes=2, eps_start=1e-2, eps_end=1e-4, perturb=False,
              constrict_bond=False, seed=0, batch_size=64)
    j, t = _pair("TensorTrainRegressor", X, **kw)
    assert t.epss == j.epss
    j.fit(X, y)
    t.fit(X, y)
    assert len(t.trajectory) == len(j.trajectory) > 0
    np.testing.assert_allclose([e["val_rmse"] for e in t.trajectory],
                               [e["val_rmse"] for e in j.trajectory], rtol=1e-3)
    _pred_close(t.predict(X), j.predict(X))
    assert abs(t.score(X, y) - j.score(X, y)) <= 1e-4


@pytest.mark.parametrize("swipe_method", ["batch_unique", "batch_same", "batch_block"])
def test_batch_regressor_matches_jax(swipe_method):
    """TensorTrainBatchRegressor in each swipe method: 2 swipes over
    64-row minibatches of the 230 training rows."""
    X, y = _data()
    kw = dict(N=2, r=4, num_swipes=2, batch_size=64, swipe_method=swipe_method,
              perturb=False, constrict_bond=False, eps_start=1e-3, eps_end=1e-3,
              seed=0)
    j, t = _pair("TensorTrainBatchRegressor", X, **kw)
    j.fit(X, y)
    t.fit(X, y)
    assert [e["epoch"] for e in t.trajectory] == [e["epoch"] for e in j.trajectory] == [1, 2]
    _pred_close(t.predict(X), j.predict(X), swipe_method)


def test_early_stopping_regressor_matches_jax():
    """TensorTrainRegressorEarlyStopping: one pass with per-node eps from
    the perturb init (the same numpy draws in both packages), stopping on
    the node count: the same best degree and predictions."""
    rng = np.random.default_rng(7)
    X = rng.standard_normal((256, 3)).astype(np.float32)
    y = (X[:, 0] + 0.5 * X[:, 1] * X[:, 2] + 0.3 * rng.standard_normal(256)).astype(np.float32)
    kw = dict(N=6, r=4, eps_start=1e-1, eps_end=1e-3, early_stopping=2, seed=3,
              batch_size=128)
    j = jm.TensorTrainRegressorEarlyStopping(**kw).fit(X[:192], y[:192], X[192:], y[192:])
    t = tm.TensorTrainRegressorEarlyStopping(**kw, device="cpu").fit(
        X[:192], y[:192], X[192:], y[192:])
    assert t._best_degree == j._best_degree
    assert t._singular == j._singular
    _pred_close(t.predict(X), j.predict(X))


def test_stream_native_waits_for_item_18():
    """stream="native" raised until item 18 ported the native prefetcher;
    now it fits through it (tests/test_torch_native.py holds it to the JAX
    package's native fit) and a stream it does not know raises."""
    X, y = _data()
    est = tm.TensorTrainBatchRegressor(N=2, r=4, num_swipes=1, batch_size=64,
                                       stream="native", seed=0, device="cpu")
    est.fit(X, y)
    assert [e["epoch"] for e in est.trajectory] == [1]
    assert np.isfinite(est.predict(X)).all()
    with pytest.raises(ValueError, match="stream"):
        tm.TensorTrainBatchRegressor(stream="numpy", device="cpu")


def test_tt_natural_gradient_matches_jax():
    """TTNaturalGradient, 12 train steps over 256-row batches (4 cycles of
    its 3 blocks: the eps decay and lmb anneal run) from eps 0.1, on a
    target with noise (so the loss stays off zero): every step's loss
    within 1e-4 relative. A block has up to 96 values: over batches of 64
    rows each system is underdetermined, and f32 rounding, amplified step
    after step, reaches 1.8e-3 by step 12 in either package."""
    from tensornetworksfork_tpu.models.tt_nn import TTNaturalGradient as JN
    from tensornetworksfork_tpu.ops.bregman import SquareBregFunction as JS
    from tensornetworksfork_tpu_torch.models.tt_nn import TTNaturalGradient as TN
    from tensornetworksfork_tpu_torch.ops.bregman import SquareBregFunction as TS
    B = 256
    rng = np.random.default_rng(0)
    X = rng.standard_normal((4 * B, 5)).astype(np.float32)
    y = (np.tanh(X[:, :1] * X[:, 1:2])
         + 0.3 * rng.standard_normal((4 * B, 1))).astype(np.float32)
    jn = JN(5, (1,), N=3, r=4, eps=0.1)
    tn = TN(5, (1,), N=3, r=4, eps=0.1, device="cpu")
    tn.params = params_from_numpy(_np(jn.params), device="cpu")
    pj, pt = jn.params, tn.params
    for s in range(12):
        b = slice((s % 4) * B, (s % 4 + 1) * B)
        pj, lj = jn.train_step(pj, jnp.asarray(X[b]), jnp.asarray(y[b]), JS())
        pt, lt = tn.train_step(pt, torch.tensor(X[b]), torch.tensor(y[b]), TS())
        assert abs(float(lt) - float(lj)) <= 1e-4 * abs(float(lj)), s
    assert tn.eps == pytest.approx(jn.eps) and tn.lmb == pytest.approx(jn.lmb)


def test_symmetric_cpd_matches_jax():
    """SymmetricCPD (rank 3, order 3, the same numpy init): predictions
    after 60 Gauss-Newton iterations within 1e-4 x max|pred|."""
    from tensornetworksfork_tpu.models.symmetric_cpd import SymmetricCPD as JC
    from tensornetworksfork_tpu_torch.models.symmetric_cpd import SymmetricCPD as TC
    rng = np.random.default_rng(0)
    X = rng.standard_normal((256, 5)).astype(np.float32)
    W = rng.standard_normal((2, 5))
    y = ((X @ W[0]) ** 3 / 10 + (X @ W[1]) ** 3 / 10).astype(np.float32)
    j = JC(5, 3, 3, seed=1).fit(X, y, iters=60)
    t = TC(5, 3, 3, seed=1, device="cpu").fit(X, y, iters=60)
    _pred_close(t.predict(X), j.predict(X))


def test_calibrate_logit_scale_matches_jax():
    from tensornetworksfork_tpu.models import layers as jl
    from tensornetworksfork_tpu.models.estimators import calibrate_logit_scale as jcal
    from tensornetworksfork_tpu_torch.models import layers as tl
    from tensornetworksfork_tpu_torch.models.estimators import calibrate_logit_scale as tcal
    jlay = jl.TensorConvolutionTrainLayer(2, 3, 5, 6, output_shape=(3,),
                                          convolution_bond=2, seed=0)
    tlay = tl.TensorConvolutionTrainLayer(2, 3, 5, 6, output_shape=(3,),
                                          convolution_bond=2, seed=0, device="cpu")
    tlay.params = params_from_numpy(_np(jlay.params), device="cpu")
    x = np.random.default_rng(1).standard_normal((100, 5, 6)).astype(np.float32)
    want = jcal(jlay, jnp.asarray(x))
    assert tcal(tlay, torch.tensor(x)) == pytest.approx(want, rel=1e-5)
    assert tcal(tlay, {"X1": torch.tensor(x), "X2": torch.tensor(x)}) == \
        pytest.approx(want, rel=1e-5)


def test_train_tabular_tt_batch_and_mlp(tmp_path):
    """train_tabular's tt_batch family runs on the CPU and scores in two
    swipe methods; its mlp family builds an MLPWrapper with one logit per
    class (the JAX package's CLI passes the networks' C-1)."""
    from tensornetworksfork_tpu_torch.experiments.train_tabular import build_model, run
    from tensornetworksfork_tpu_torch.models.baselines import MLPWrapper
    from tensornetworksfork_tpu_torch.utils.config import RunConfig
    for method in ("batch_unique", "batch_block"):
        res = run(RunConfig(dataset="synthetic", model_type="tt_batch", num_swipes=1,
                            swipe_method=method, verbose=0, device="cpu",
                            results_file=str(tmp_path / "r.csv")))
        assert not res["singular"] and np.isfinite(res["test_rmse"]), method
    mlp = build_model(RunConfig(model_type="mlp", task="classification", output_dim=2,
                                device="cpu"), 4)
    assert isinstance(mlp, MLPWrapper) and mlp.output_dim == 3
