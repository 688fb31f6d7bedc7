"""The model zoo of the port held against the JAX package and against dense
oracles.

- The whole-zoo Gram oracle (counterpart of tests/test_gram_all_layers.py):
  for every layer family and every train node, the port's (A, b) from
  `jacobian` + `gram_and_rhs` equals the dense Gauss-Newton system built
  from `torch.func.jacrev` of the flattened forward (rtol/atol 5e-3 of
  max|A|, the JAX test's bound: the oracle's f32 Jacobian differs from the
  engine's contraction order) and the JAX engine's (A, b) on the same
  params and inputs (1e-4 of max|A|: the same f32 sums in another order).
  The port's networks use the kernel routes (`use_kernels=True`), whose
  plain versions run on the CPU.
- More than 52 axes: a 30-carriage tensor train (forward and one swipe) and
  a 30-feature TNML swipe on breast_cancer, against the JAX package.
- Complex tensor trains: a complex64 swipe against the JAX package, and a
  complex128 swipe against a numpy complex128 oracle of the same swipe.
- Fits: one swipe of each new estimator family (cpd, cpd_type1, cum_sum,
  linear_dim and its fractional form, TNML in both bases) from the JAX
  package's initial params: predictions within 1e-4 x max|pred|.

Data come from numpy seeds; JAX params cross with `params_from_numpy`.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from tensornetworksfork_tpu.core.sweep import SweepConfig as JConfig  # noqa: E402
from tensornetworksfork_tpu.core.sweep import Sweeper as JSweeper  # noqa: E402
from tensornetworksfork_tpu.models import layers as jl  # noqa: E402
from tensornetworksfork_tpu.ops import bregman as jb  # noqa: E402
from tensornetworksfork_tpu_torch.core.sweep import SweepConfig, Sweeper  # noqa: E402
from tensornetworksfork_tpu_torch.models import layers as tl  # noqa: E402
from tensornetworksfork_tpu_torch.ops import bregman as tb  # noqa: E402
from tensornetworksfork_tpu_torch.utils.convert import (  # noqa: E402
    params_from_numpy, params_to_numpy)


def _x(seed, *shape, S=6):
    return np.random.default_rng(seed).standard_normal((S,) + shape).astype(np.float32)


def _np(params):
    return {k: np.asarray(v) for k, v in params.items()}


# name -> (builder, args, kwargs, inputs): tests/test_gram_all_layers.py's
# cases, and the ring operator, CPDTrain and conv-operator layers
CASES = {
    "tt": ("TensorTrainLayer", (3, 3, 3), dict(output_shape=(2,), seed=0),
           lambda: _x(0, 3)),
    "tt_linear": ("TensorTrainLinearLayer", (2, 3, 4, 2),
                  dict(output_shape=(1,), seed=1), lambda: _x(1, 4)),
    "cumsum": ("CumSumLayer", (3, 3, 3), dict(output_shape=(1,), seed=2),
               lambda: _x(2, 3)),
    "conv": ("TensorConvolutionTrainLayer", (2, 3, 4, 5),
             dict(output_shape=(2,), convolution_bond=2, seed=3),
             lambda: _x(3, 4, 5)),
    "grid": ("TensorConvolutionGridTrainLayer", (2, 2, 3, 2, 2, 4, 5),
             dict(output_shape=(2,), convolution_bond=2, seed=4),
             lambda: _x(4, 4, 5)),
    "cpd": ("CPDLayer", (3, 4, 3), dict(output_shape=(2,), seed=5),
            lambda: _x(5, 3)),
    "operator": ("OperatorTTLayer", (jl.cum_sum_operator(1, 4, 3), 3, 3, 2),
                 dict(output_shape=(1,), left=jl.cum_sum_operator(0, 2, 3),
                      right=jl.cum_sum_operator(1, 2, 3), seed=6),
                 lambda: _x(6, 3)),
    "split": ("TensorTrainSplitInputLayer", (2, 3),
              dict(input_shape=(2, 3), output_shape=(1,), axle_bond=2, seed=7),
              lambda: [_x(7, 2, 3)] * 2),
    "operator_ring": ("OperatorTTLayer", (jl.cum_sum_operator(1, 4, 3), 3, 2, 3),
                      dict(output_shape=(1,), ring=True, seed=8),
                      lambda: _x(8, 3)),
    "cpd_train": ("CPDTrainLayer", (3, 3, 3), dict(output_shape=(2,), seed=9),
                  lambda: _x(9, 3)),
    "conv_operator": ("TensorConvOperatorLayer",
                      (np.random.default_rng(10).standard_normal((5, 3)), 3, 3, 2,
                       4, 5), dict(output_shape=(2,), convolution_bond=2, seed=10),
                      lambda: _x(10, 4, 5)),
}


def _case(name):
    cls, args, kw, make_x = CASES[name]
    jlayer = getattr(jl, cls)(*args, **kw)
    tlayer = getattr(tl, cls)(*args, **kw, device="cpu", use_kernels=True)
    x = make_x()
    jx = [jnp.asarray(a) for a in x] if isinstance(x, list) else jnp.asarray(x)
    tx = [torch.tensor(a) for a in x] if isinstance(x, list) else torch.tensor(x)
    params = params_from_numpy(_np(jlayer.params), device="cpu")
    return jlayer, tlayer, jx, tx, params


def _systems(net, params, x, loss_fn, y=None, ni=None):
    """(node index, name, pred, A, b) of every train node (or of `ni`)."""
    t = net.topology
    inputs = net.bind_inputs(x)
    envs_l = net.env_chain(params, inputs, "left")
    envs_r = net.env_chain(params, inputs, "right")
    ncols = len(t.columns)
    out = []
    for n in ([ni] if ni is not None else t.train_nodes):
        name = t.nodes[n].name
        ci = t.col_of[n]
        L = envs_l[ci - 1] if ci > 0 else None
        R = envs_r[ci + 1] if ci < ncols - 1 else None
        J = net.jacobian(n, params, inputs, L, R)
        pred = net.predict_from_jacobian(n, J, params[name])
        target = pred * 0 if y is None else y
        _, g, H = loss_fn(pred, target)
        A, b = net.gram_and_rhs(n, J, g, H)
        out.append((n, name, pred, A, b))
    return out


def _close(got, want, tol, what):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale, err_msg=what)


@pytest.mark.parametrize("name", sorted(CASES))
def test_gram_matches_autograd_and_jax(name):
    jlayer, tlayer, jx, tx, params = _case(name)
    net, jnet = tlayer.network, jlayer.network
    full = net.forward(params, net.bind_inputs(tx))
    jsys = {n: (A, b) for n, _, _, A, b in
            _systems(jnet, jlayer.params, jx, jb.SquareBregFunction())}
    for ni, node, pred, A, b in _systems(net, params, tx, tb.SquareBregFunction()):
        _close(pred.numpy(), full.numpy(), 2e-3, f"{name}:{node} pred != forward")

        def fwd_flat(core_flat):
            p = dict(params, **{node: core_flat.reshape(params[node].shape)})
            return net.forward(p, net.bind_inputs(tx)).reshape(-1)

        Ja = torch.func.jacrev(fwd_flat)(params[node].reshape(-1)).numpy()
        D = params[node].numel()
        A2, b2 = A.reshape(D, D).numpy(), b.reshape(D).numpy()
        _close(b2, Ja.T @ (2 * pred.numpy().reshape(-1)), 5e-3, f"{name}:{node} b")
        _close(A2, 2 * Ja.T @ Ja, 5e-3, f"{name}:{node} A")
        jA, jb_ = jsys[ni]
        _close(A2, np.asarray(jA).reshape(D, D), 1e-4, f"{name}:{node} A vs JAX")
        _close(b2, np.asarray(jb_).reshape(D), 1e-4, f"{name}:{node} b vs JAX")


def test_gram_matches_autograd_xe_full_hessian():
    """The full-Hessian (XE) path on the conv layer's second train node,
    against autograd and the JAX engine."""
    jlayer, tlayer, jx, tx, params = _case("conv")
    net = tlayer.network
    ni = net.topology.train_nodes[1]
    y = np.eye(3, dtype=np.float32)[np.random.default_rng(8).integers(0, 3, 6)]
    ((_, node, pred, A, b),) = _systems(net, params, tx, tb.XEBregman(1.0),
                                        torch.tensor(y), ni)
    ((_, _, _, jA, jb_),) = _systems(jlayer.network, jlayer.params, jx,
                                     jb.XEBregman(1.0), jnp.asarray(y), ni)
    _, g, H = tb.XEBregman(1.0)(pred, torch.tensor(y))

    def fwd_flat(core_flat):
        p = dict(params, **{node: core_flat.reshape(params[node].shape)})
        return net.forward(p, net.bind_inputs(tx)).reshape(-1)

    S, C = pred.shape
    Jsc = torch.func.jacrev(fwd_flat)(params[node].reshape(-1)).numpy().reshape(S, C, -1)
    D = params[node].numel()
    b_ref = np.einsum("sci,sc->i", Jsc, g.numpy())
    A_ref = np.einsum("sci,sdj,scd->ij", Jsc, Jsc, H.numpy())
    _close(b.reshape(D).numpy(), b_ref, 5e-3, "b")
    _close(A.reshape(D, D).numpy(), A_ref, 5e-3, "A")
    _close(A.reshape(D, D).numpy(), np.asarray(jA).reshape(D, D), 1e-4, "A vs JAX")
    _close(b.reshape(D).numpy(), np.asarray(jb_).reshape(D), 1e-4, "b vs JAX")


# ---------------------------------------------------------------- > 52 axes
def test_thirty_carriage_train_forward_and_swipe_match_jax():
    """A 30-carriage TT with bond 3 over 2 features carries 61 axes in its
    forward (s, the output axis, 29 bonds, 30 feature axes), past the 52
    ASCII letters of torch.einsum. Forward within rtol 1e-5, one swipe's
    predictions within 1e-4 x max|pred|."""
    N, r, f, S = 30, 3, 2, 64
    jlayer = jl.TensorTrainLayer(N, r, f, output_shape=(1,), seed=0)
    tlayer = tl.TensorTrainLayer(N, r, f, output_shape=(1,), seed=0, device="cpu")
    t = tlayer.topology
    assert len(set(a for ax in t.node_axes for a in ax)) > 52
    rng = np.random.default_rng(1)
    X = [rng.uniform(0.5, 1.5, (S, f)).astype(np.float32) for _ in range(N)]
    y = rng.standard_normal((S, 1)).astype(np.float32)
    params = params_from_numpy(_np(jlayer.params), device="cpu")
    want = np.asarray(jlayer([jnp.asarray(a) for a in X]))
    got = tlayer([torch.tensor(a) for a in X], params=params).numpy()
    _close(got, want, 1e-5, "forward")
    cfg = dict(num_swipes=1, batch_size=32, method="ridge_cholesky", eps=1.0,
               eps_decay=0.5)
    pj, okj = JSweeper(jlayer.network, jb.SquareBregFunction(), JConfig(**cfg)).run(
        [jlayer.params], [jnp.asarray(a) for a in X], jnp.asarray(y))
    pt, okt = Sweeper(tlayer.network, tb.SquareBregFunction(), SweepConfig(**cfg)).run(
        [params], [torch.tensor(a) for a in X], torch.tensor(y))
    assert okj and okt
    pred_j = np.asarray(jlayer([jnp.asarray(a) for a in X], params=pj[0]))
    pred_t = tlayer([torch.tensor(a) for a in X], params=pt[0]).numpy()
    np.testing.assert_allclose(pred_t, pred_j, rtol=0,
                               atol=1e-4 * np.abs(pred_j).max())


# ------------------------------------------------------------------ complex
def _complex_data(seed, S, f, dtype):
    rng = np.random.default_rng(seed)
    X = (rng.standard_normal((S, f)) + 1j * rng.standard_normal((S, f))).astype(dtype)
    M = rng.standard_normal((f, f)) + 1j * rng.standard_normal((f, f))
    y = np.einsum("si,ij,sj->s", X, M, X).reshape(-1, 1).astype(dtype)
    return X, y


def test_complex64_swipe_matches_jax():
    """complex64 TT, SquareComplexBregFunction, two swipes: params within
    rtol 1e-4 of the JAX package's (conjugated Gram and rhs on both
    sides)."""
    jlayer = jl.ComplexTensorTrainLayer(3, 3, 3, output_shape=(1,), seed=0)
    tlayer = tl.ComplexTensorTrainLayer(3, 3, 3, output_shape=(1,), seed=0,
                                        device="cpu")
    X, y = _complex_data(4, 64, 3, np.complex64)
    cfg = dict(num_swipes=2, batch_size=32, method="ridge_exact", eps=1e-3)
    pj, okj = JSweeper(jlayer.network, jb.SquareComplexBregFunction(),
                       JConfig(**cfg)).run([jlayer.params], jnp.asarray(X),
                                           jnp.asarray(y))
    p0 = params_from_numpy(_np(jlayer.params), device="cpu", dtype=torch.complex64)
    pt, okt = Sweeper(tlayer.network, tb.SquareComplexBregFunction(),
                      SweepConfig(**cfg)).run([p0], torch.tensor(X), torch.tensor(y))
    assert okj and okt
    for k, v in pj[0].items():
        assert pt[0][k].dtype == torch.complex64
        _close(pt[0][k].numpy(), np.asarray(v), 1e-4, k)


def _oracle_swipes(topology, params, X, y, num_swipes, eps):
    """numpy complex128 oracle of the sweep with SquareComplexBregFunction,
    method ridge_exact, one chunk: each update forms J column by column
    (the forward is linear in the node), A = JᴴJ and b = Jᴴ(pred - y),
    rescales both by mean|diag A|, adds the ridge and takes the step;
    passes alternate direction and skip the column the previous pass ended
    on (the junction rule)."""
    t = topology
    letters = "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ"
    lab = {a: letters[i] for i, a in enumerate(sorted(t.axis_size))}
    terms = ",".join("".join(lab[a] for a in ax) for ax in t.node_axes)
    expr = terms + "->" + lab[t.sample_axis] + "".join(lab[a] for a in t.output_axes)

    def forward(p):
        ops = [X if s.kind == "input" else p[s.name] for s in t.nodes]
        return np.einsum(expr, *ops, optimize=True)

    p = {k: v.copy() for k, v in params.items()}
    order = [t.nodes[n].name for n in t.train_nodes]
    last = None
    for _ in range(num_swipes):
        for seq in (order, order[::-1]):
            for name in seq:
                if name == last:
                    continue
                core = p[name]
                J = np.empty((y.size, core.size), np.complex128)
                for k in range(core.size):
                    e = np.zeros(core.size, np.complex128)
                    e[k] = 1
                    J[:, k] = forward(dict(p, **{name: e.reshape(core.shape)})).reshape(-1)
                g = (J @ core.reshape(-1) - y.reshape(-1))
                A, b = J.conj().T @ J, J.conj().T @ g
                scale = np.abs(np.diag(A)).mean()
                A = A / scale + 2 * eps * np.eye(core.size)
                b = b / scale + 2 * eps * core.reshape(-1)
                p[name] = core + np.linalg.solve(A, -b).reshape(core.shape)
                last = name
    return p


EPS128 = 1e-4


def test_complex128_swipe_matches_numpy_oracle():
    """complex128 in the port (natively, on the CPU here as on the card)
    against the numpy complex128 oracle: params within rtol 1e-9 after two
    swipes; the fit is a good one (relative residual below 1e-2 at this
    ridge)."""
    layer = tl.ComplexTensorTrainLayer(2, 3, 3, output_shape=(1,), seed=0,
                                       dtype=torch.complex128, device="cpu")
    X, y = _complex_data(5, 64, 3, np.complex128)
    p0 = params_to_numpy(layer.params)
    cfg = SweepConfig(num_swipes=2, batch_size=-1, method="ridge_exact", eps=EPS128)
    pt, ok = Sweeper(layer.network, tb.SquareComplexBregFunction(), cfg).run(
        [layer.params], torch.tensor(X), torch.tensor(y))
    assert ok
    want = _oracle_swipes(layer.topology, p0, X, y, 2, EPS128)
    for k, v in want.items():
        assert pt[0][k].dtype == torch.complex128
        np.testing.assert_allclose(pt[0][k].numpy(), v, rtol=1e-9,
                                   atol=1e-9 * np.abs(v).max(), err_msg=k)
    pred = layer(torch.tensor(X), params=pt[0]).numpy()
    assert np.linalg.norm(pred - y) / np.linalg.norm(y) < 1e-2


# --------------------------------------------------------------------- fits
def _splits(name, seed=0):
    from tensornetworksfork_tpu_torch.data.tabular import load_sklearn_dataset
    d = load_sklearn_dataset(name, seed=seed)
    return d, d.pop("task")


def _estimators(cls_j, cls_t, input_dim, **kw):
    """The JAX and port estimators of the same config with the port's model
    holding the JAX package's initial params."""
    j, t = cls_j(**kw), cls_t(**kw, device="cpu")
    for e in (j, t):
        e.input_dim = input_dim
        e._initialize_model()

    def layers(e):
        return e._model.layers if hasattr(e._model, "layers") else [e._model]
    for a, b in zip(layers(j), layers(t)):
        b.params = params_from_numpy(_np(a.params), device="cpu")
    return j, t


FITS = {
    "cpd": ("diabetes", dict(model_type="cpd")),
    "cpd_xe": ("iris", dict(model_type="cpd")),
    "cpd_type1": ("diabetes", dict(model_type="cpd_type1")),
    "cum_sum": ("diabetes", dict(cum_sum=True)),
    "cum_sum_xe": ("wine", dict(cum_sum=True)),
    "linear_dim": ("diabetes", dict(linear_dim=4)),
    "linear_dim_fraction": ("wine", dict(linear_dim=0.5)),
    "linear_dim_type1": ("diabetes", dict(model_type="tt_type1", linear_dim=4)),
}


@pytest.mark.parametrize("case", sorted(FITS))
def test_estimator_family_swipe_matches_jax(case, monkeypatch):
    monkeypatch.setenv("TNF_FIT_PRECOMPILE", "0")
    from tensornetworksfork_tpu.models.estimators import TensorTrainRegressor as JT
    from tensornetworksfork_tpu_torch.models.estimators import TensorTrainRegressor as TT
    ds, kw = FITS[case]
    d, task = _splits(ds)
    y_tr, y_val = d["y_train"], d["y_val"]
    out = 1
    if task == "classification":
        n = int(y_tr.max()) + 1
        y_tr, y_val = (np.eye(n, dtype=np.float32)[a.reshape(-1).astype(int)]
                       for a in (y_tr, y_val))
        out = n - 1
    j, t = _estimators(JT, TT, d["X_train"].shape[1] + 1, N=3, r=4,
                       output_dim=out, num_swipes=1, eps_start=0.5,
                       eps_decay=0.5, batch_size=64, task=task, seed=3, **kw)
    if "linear_dim" in kw:
        assert t.linear_dim == j.linear_dim
    j.fit(d["X_train"], y_tr, X_val=d["X_val"], y_val=y_val)
    t.fit(d["X_train"], y_tr, X_val=d["X_val"], y_val=y_val)
    assert t.fit_ok_
    pj, pt = np.asarray(j.predict(d["X_test"])), t.predict(d["X_test"])
    np.testing.assert_allclose(pt, pj, rtol=0, atol=1e-4 * np.abs(pj).max())


@pytest.mark.parametrize("basis,ds", [("sin-cos", "breast_cancer"),
                                      ("polynomial", "diabetes")])
def test_tnml_swipe_matches_jax(basis, ds, monkeypatch):
    """TNMLRegressor (minmax inputs, initial left gauge, orthonormalize=True
    sweeps) from the JAX package's initial params. breast_cancer has 30
    features: 30 carriages, past the old 52-axis ceiling."""
    from tensornetworksfork_tpu.models.tnml import TNMLRegressor as JN
    from tensornetworksfork_tpu_torch.models.tnml import TNMLRegressor as TN
    d, task = _splits(ds)
    y_tr, y_val = d["y_train"], d["y_val"]
    kw = dict(r=4, num_swipes=1, eps_start=0.5, eps_decay=0.5, batch_size=128,
              task=task, basis=basis, degree=2, input_scale="minmax", seed=1)
    j, t = JN(**kw), TN(**kw, device="cpu")
    if task == "classification":  # two classes: one logit
        j.output_dim = t.output_dim = 1
    F = d["X_train"].shape[1]
    from tensornetworksfork_tpu.models.layers import TensorTrainLayer as JL
    from tensornetworksfork_tpu_torch.models.layers import TensorTrainLayer as TL
    j._model = JL(F, 4, j.input_dim, output_shape=j.output_dim, seed=1)
    t._model = TL(F, 4, t.input_dim, output_shape=t.output_dim, seed=1,
                  device="cpu")
    t._model.params = params_from_numpy(_np(j._model.params), device="cpu")
    j.fit(d["X_train"], y_tr, X_val=d["X_val"], y_val=y_val)
    t.fit(d["X_train"], y_tr, X_val=d["X_val"], y_val=y_val)
    assert t.fit_ok_
    pj, pt = np.asarray(j.predict(d["X_test"])), t.predict(d["X_test"])
    np.testing.assert_allclose(pt, pj, rtol=0, atol=1e-4 * np.abs(pj).max())
