"""The neural baselines and the Lasso of the port held against the JAX
package (flax + optax) and sklearn.

- Forwards of MLP, PINet, ResMLP and SimpleCNN from the flax init carried
  across with `utils.convert.mlp_params_from_flax` (the CNN's NHWC flatten
  rows permuted to NCHW): within rtol 1e-5.
- Three AdamW steps of MLPWrapper / CNNWrapper (one epoch of three
  batches) from the same init and the same numpy batch order: every weight
  within 1e-5 x max|w| (max over all the model's weights) of optax.adamw's.
- PolynomialRegressionWrapper(regularization="l1") against sklearn's Lasso
  on PolynomialFeatures of iris and diabetes: predictions within 1e-5 x
  max|pred|; the coordinate descent is sklearn's, so its iterates are too.
"""
import warnings

import numpy as np
import pytest

jax = pytest.importorskip("jax")
flax = pytest.importorskip("flax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from tensornetworksfork_tpu.models import baselines as jbl  # noqa: E402
from tensornetworksfork_tpu_torch.models import baselines as tbl  # noqa: E402
from tensornetworksfork_tpu_torch.utils.convert import mlp_params_from_flax  # noqa: E402

FWD_RTOL = 1e-5
STEP_REL = 1e-5
LASSO_REL = 1e-5


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _nets():
    return {
        "mlp": (lambda: jbl.MLP(2, (8, 8)), lambda: tbl.MLP(5, 2, (8, 8))),
        "mlp_tanh": (lambda: jbl.MLP(1, (6,), "tanh"), lambda: tbl.MLP(5, 1, (6,), "tanh")),
        "pinet": (lambda: jbl.PINet(1, (5, 5)), lambda: tbl.PINet(5, 1, (5, 5))),
        "resmlp": (lambda: jbl.ResMLP(1, (5, 5)), lambda: tbl.ResMLP(5, 1, (5, 5))),
        "cnn": (lambda: jbl.SimpleCNN(3, (4, 6)), lambda: tbl.SimpleCNN(3, (4, 6), (8, 8, 1))),
    }


def _inputs(name, S=48):
    rng = np.random.default_rng(0)
    if name == "cnn":
        return rng.standard_normal((S, 8, 8)).astype(np.float32)
    return rng.standard_normal((S, 5)).astype(np.float32)


@pytest.mark.parametrize("name", list(_nets()))
def test_forward_from_flax_weights_matches(name):
    make_j, make_t = _nets()[name]
    X = _inputs(name)
    jm, tm = make_j(), make_t()
    p = jm.init(jax.random.PRNGKey(3), jnp.asarray(X[:1]))
    state = mlp_params_from_flax(_np_tree(p))
    assert set(state) == set(tm.state_dict())
    tm.load_state_dict(state)
    want = np.asarray(jm.apply(p, jnp.asarray(X)))
    with torch.no_grad():
        got = tm(torch.tensor(X)).numpy()
    np.testing.assert_allclose(got, want, rtol=FWD_RTOL, atol=FWD_RTOL * np.abs(want).max())


def test_init_draws_flax_distributions():
    """The port's init: zero biases, kernels within two standard deviations
    of lecun-normal (sqrt(1/fan_in)/0.8796) and of about its spread."""
    m = tbl.MLP(400, 1, (300,), seed=0)
    w = m.dense[0].weight.detach()
    std = np.sqrt(1 / 400) / 0.87962566103423978
    assert float(w.abs().max()) <= 2 * std
    assert abs(float(w.std()) / np.sqrt(1 / 400) - 1) < 0.02
    assert not m.dense[0].bias.any()


WRAPPERS = {
    "mlp": dict(type="mlp", hidden_layers=(8, 8)),
    "pinet": dict(type="pinet", hidden_layers=(5, 5)),
    "resmlp": dict(type="resmlp", hidden_layers=(5, 5)),
}


@pytest.mark.parametrize("name", list(WRAPPERS) + ["cnn", "mlp_classification"])
def test_three_adamw_steps_match_optax(name):
    """One epoch of three 16-row batches (lr 1e-2, weight decay 1e-4 in
    both): every weight within 1e-5 x max|w| of the JAX wrapper's."""
    X = _inputs("cnn" if name == "cnn" else "mlp")
    rng = np.random.default_rng(1)
    common = dict(epochs=1, batch_size=16, lr=1e-2)
    if name == "cnn":
        y = rng.integers(0, 3, len(X))
        jw = jbl.CNNWrapper(3, dict(common, channels=(4, 6)))
        tw = tbl.CNNWrapper(3, dict(common, channels=(4, 6)), device="cpu")
    elif name == "mlp_classification":
        y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, len(X))]
        jw = jbl.MLPWrapper(5, 3, dict(common, **WRAPPERS["mlp"]), task="classification")
        tw = tbl.MLPWrapper(5, 3, dict(common, **WRAPPERS["mlp"]), task="classification",
                            device="cpu")
    else:
        y = rng.standard_normal(len(X)).astype(np.float32)
        jw = jbl.MLPWrapper(5, 1, dict(common, **WRAPPERS[name]))
        tw = tbl.MLPWrapper(5, 1, dict(common, **WRAPPERS[name]), device="cpu")
    # the JAX wrapper initialises inside fit, from PRNGKey(seed); the port's
    # model is built inside fit too, and starts from those weights here
    state = mlp_params_from_flax(
        _np_tree(jw.model.init(jax.random.PRNGKey(0), jnp.asarray(X[:1]))))
    build = tw._build

    def build_from_flax(X):
        model = build(X)
        model.load_state_dict(state)
        return model
    tw._build = build_from_flax
    jw.fit(X, y)
    tw.fit(X, y)
    want = mlp_params_from_flax(_np_tree(jw._params))
    got = tw.model.state_dict()
    scale = max(float(v.abs().max()) for v in want.values())
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0,
                                   atol=STEP_REL * scale, err_msg=k)
    assert tw.predict(X).shape == jw.predict(X).shape
    assert np.isfinite(tw.final_loss_)


@pytest.mark.parametrize("dataset,degree,alpha", [("iris", 2, 0.01), ("iris", 3, 0.1),
                                                  ("diabetes", 2, 0.1),
                                                  ("diabetes", 2, 1e-3)])
def test_lasso_matches_sklearn(dataset, degree, alpha):
    """Lasso's fit on PolynomialFeatures(degree) of a sklearn dataset: the
    port's written-out coordinate descent against sklearn.linear_model.Lasso
    (float64, intercept fit, max_iter 1000, tol 1e-4; diabetes at 1e-3 and
    iris at degree 3 run all 1000 iterations without meeting tol)."""
    pytest.importorskip("sklearn")
    from sklearn.datasets import load_diabetes, load_iris
    from sklearn.exceptions import ConvergenceWarning
    from sklearn.linear_model import Lasso
    from sklearn.preprocessing import PolynomialFeatures
    X, y = (load_iris if dataset == "iris" else load_diabetes)(return_X_y=True)
    y = y.astype(np.float64)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", ConvergenceWarning)
        want = Lasso(alpha=alpha).fit(PolynomialFeatures(degree).fit_transform(X), y)
    Xp = PolynomialFeatures(degree).fit_transform(X)
    port = tbl.PolynomialRegressionWrapper(degree, "l1", alpha, device="cpu").fit(X, y)
    pred = port.predict(X)
    assert pred.shape == want.predict(Xp).shape and pred.dtype == np.float64
    np.testing.assert_allclose(pred, want.predict(Xp), rtol=0,
                               atol=LASSO_REL * np.abs(want.predict(Xp)).max())
    np.testing.assert_allclose(port._coef[:, 0].numpy(), want.coef_, rtol=0,
                               atol=LASSO_REL * np.abs(want.coef_).max())
