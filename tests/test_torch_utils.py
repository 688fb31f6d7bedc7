"""The port's utilities and data helpers of ROADMAP item 18 held against the
JAX package: checkpoints (npz, crossing between the packages both ways),
`RunConfig.from_env`, the synthetic generators and tabular helpers
(bit-equal: they are numpy code), the quantile transform (against sklearn,
1e-6), `reproduce_result digits_flat` (one seed at 2 swipes from the JAX
package's initial params: the same test accuracy within one of the 360 test
rows), the FLOP accounting (equal contraction by contraction where the two
plans agree; where numpy's planner leaves a three-operand contraction that
sums no axis as one step, the port counts torch.einsum's left-to-right
product, and that count is checked against opt_einsum's cost of that path),
`block_on` and `xla_trace`.
"""
import glob
import json
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from tensornetworksfork_tpu.data import synthetic as jsyn  # noqa: E402
from tensornetworksfork_tpu.data import tabular as jtab  # noqa: E402
from tensornetworksfork_tpu.utils import checkpoint as jck  # noqa: E402
from tensornetworksfork_tpu.utils.config import RunConfig as JRunConfig  # noqa: E402
from tensornetworksfork_tpu_torch.data import synthetic as tsyn  # noqa: E402
from tensornetworksfork_tpu_torch.data import tabular as ttab  # noqa: E402
from tensornetworksfork_tpu_torch.utils import checkpoint as tck  # noqa: E402
from tensornetworksfork_tpu_torch.utils.config import RunConfig  # noqa: E402


# ------------------------------------------------------------- checkpoints
def _states(layout):
    rng = np.random.default_rng(0)
    one = {"A1": rng.standard_normal((2, 3)).astype(np.float32),
           "A2": rng.standard_normal((3, 4, 3)).astype(np.float32),
           "C1": np.arange(4.0, dtype=np.float32)}
    if layout == "dict":
        return one
    return [one, {"B": rng.standard_normal(5).astype(np.float32)}, {}]


def _as_np(states):
    if isinstance(states, list):
        return [_as_np(s) for s in states]
    return {k: np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v)
            for k, v in states.items()}


@pytest.mark.parametrize("layout", ["dict", "list"])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_checkpoint_crosses_packages(tmp_path, layout, writer):
    """A checkpoint written by either package reads back in the other (and
    in itself) to the same arrays, in both layouts; the port's reader
    gives tensors on the device asked for."""
    states = _states(layout)
    p = str(tmp_path / "ckpt.npz")
    if writer == "port":
        tck.save_node_states(p, [{k: torch.from_numpy(v) for k, v in s.items()}
                                 for s in states] if layout == "list"
                             else {k: torch.from_numpy(v) for k, v in states.items()})
    else:
        jck.save_node_states(p, [{k: jnp.asarray(v) for k, v in s.items()} for s in states]
                             if layout == "list" else {k: jnp.asarray(v)
                                                       for k, v in states.items()})
    for back in (tck.load_node_states(p, device="cpu"), jck.load_node_states(p)):
        assert type(back) is type(states)
        if layout == "list":
            assert len(back) == len(states)
            for got, want in zip(_as_np(back), states):
                assert got.keys() == want.keys()
                for k in want:
                    np.testing.assert_array_equal(got[k], want[k])
        else:
            got = _as_np(back)
            assert got.keys() == states.keys()
            for k in states:
                np.testing.assert_array_equal(got[k], states[k])
    loaded = tck.load_node_states(p, device="cpu")
    first = loaded[0] if layout == "list" else loaded
    assert all(isinstance(v, torch.Tensor) and v.device.type == "cpu"
               for v in first.values())


def test_checkpoint_path_gains_npz_and_restores_a_model(tmp_path):
    """A path without .npz gains it (as the JAX package's npz protocol);
    a type-I sum's node states restore into a freshly built model and give
    the same forward bit for bit; loading on the card without one raises."""
    from tensornetworksfork_tpu_torch.models.layers import SumLayer, TensorConvolutionTrainLayer
    kw = dict(output_shape=3, convolution_bond=2, device="cpu")
    model = SumLayer([TensorConvolutionTrainLayer(n, 3, 5, 4, seed=n, **kw) for n in (1, 2)])
    p = str(tmp_path / "model")
    tck.save_node_states(p, model.node_states())
    assert os.path.exists(p + ".npz") and not os.path.exists(p)
    fresh = SumLayer([TensorConvolutionTrainLayer(n, 3, 5, 4, seed=10 + n, **kw) for n in (1, 2)])
    fresh.load_node_states(tck.load_node_states(p, device="cpu"))
    x = torch.randn(7, 5, 4)
    assert torch.equal(fresh(x), model(x))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tck.load_node_states(p)


# ----------------------------------------------------------------- config
@pytest.mark.parametrize("env", [
    {"N": "7", "EPS": "0.5", "CONSTRICT_BOND": "true"},
    {"R": "12", "EPS_DECAY": "0.5", "PERTURB": "1", "MODEL_TYPE": "cpd"},
    {"TIMEOUT": "2.5", "LINEAR_DIM": "4", "STREAM": "native", "SOLVE_DTYPE": "float64"},
    {"PRECISION": "fastest", "CUM_SUM": "no", "SEED": "3", "BATCH_SIZE": "64",
     "RESULTS_FILE": "x.csv", "SWIPE_METHOD": "batch_block", "REFINE": "YES"},
])
@pytest.mark.parametrize("prefix", ["", "TNF_"])
def test_run_config_from_env_matches_jax(monkeypatch, env, prefix):
    """The same variables (with and without a prefix) give the same values
    and types in both packages, field by shared field; absent ones keep
    each package's defaults (results go under build/ in the port)."""
    for k in list(os.environ):
        for f in RunConfig.field_names() + JRunConfig.field_names():
            if k.upper() in (f.upper(), ("TNF_" + f).upper()):
                monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(prefix + k, v)
    t, j = RunConfig.from_env(prefix), JRunConfig.from_env(prefix)
    shared = set(RunConfig.field_names()) & set(JRunConfig.field_names())
    assert set(env) <= {f.upper() for f in shared}
    for f in shared:
        if f.upper() in env:
            assert getattr(t, f) == getattr(j, f), f
            assert type(getattr(t, f)) is type(getattr(j, f)), f
        else:
            assert getattr(t, f) == getattr(RunConfig(), f), f
    assert t.device == "cuda"
    monkeypatch.setenv(prefix + "DEVICE", "cpu")
    assert RunConfig.from_env(prefix).device == "cpu"


# ----------------------------------------------------- synthetic, tabular
@pytest.mark.parametrize("cls,kw", [
    ("RandomPolynomial", dict(d=4, degree=3, random_state=0)),
    ("RandomPolynomial", dict(d=6, degree=2, sigma0=0.5, r=2.0, mask=0.3,
                              include_bias=False, random_state=5)),
    ("RandomPolynomial", dict(d=5, degree=3, interaction_only=True, random_state=1)),
    ("RandomIndependentPolynomial", dict(d=3, degree=4, random_state=2)),
    ("RandomIndependentPolynomial", dict(d=7, degree=2, coeff_sigma=1.5,
                                         include_bias=False, random_state=9)),
    ("RandomPolynomialRange", dict(d=5, degree=3, random_state=4)),
])
def test_synthetic_generators_bit_equal(cls, kw):
    """The same coefficients, design matrix (sklearn's PolynomialFeatures
    against the port's written-out one) and targets, bit for bit."""
    a, b = getattr(tsyn, cls)(**kw), getattr(jsyn, cls)(**kw)
    x = np.random.default_rng(3).uniform(-1, 1, (40, kw["d"]))
    for xx in (x, x.astype(np.float32)):
        if hasattr(b, "design_matrix"):
            np.testing.assert_array_equal(a.poly.powers_, b.poly.powers_)
            da, db = a.design_matrix(xx), b.design_matrix(xx)
            assert da.dtype == db.dtype
            np.testing.assert_array_equal(da, db)
            np.testing.assert_array_equal(a.coeffs_, b.coeffs_)
        np.testing.assert_array_equal(a.evaluate(xx), b.evaluate(xx))


@pytest.mark.parametrize("kw", [dict(), dict(S=300, d=6, n_classes=5, seed=7)])
def test_make_classification_bit_equal(kw):
    for got, want in zip(tsyn.make_classification(**kw), jsyn.make_classification(**kw)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("cap", [128, 6, 3])
def test_one_hot_with_cap_bit_equal(cap):
    rng = np.random.default_rng(0)
    cols = [("num", rng.standard_normal(50), False),
            ("cat", rng.choice(["a", "b", "c", "d", "e"], 50, p=[.4, .3, .15, .1, .05]), True),
            ("num2", rng.integers(0, 9, 50), False),
            ("code", rng.integers(0, 4, 50), True)]
    (X, names), (Xj, namesj) = ttab.one_hot_with_cap(cols, cap), jtab.one_hot_with_cap(cols, cap)
    assert names == namesj and X.dtype == Xj.dtype
    np.testing.assert_array_equal(X, Xj)


def test_combine_datasets_and_padw_bit_equal():
    """Three prepared split dicts of widths 3, 5, 2: the JAX test's shapes
    and the same arrays; padw pads right with zero columns."""
    rng = np.random.default_rng(0)
    ds = [jtab.split_train_val_test(rng.standard_normal((n, w)).astype(np.float32),
                                    rng.standard_normal((n, 1)), seed=s)
          for n, w, s in ((50, 3, 1), (40, 5, 2), (20, 2, 3))]
    for seed in (42, 0):
        got, want = ttab.combine_datasets(ds, seed=seed), jtab.combine_datasets(ds, seed=seed)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    assert got["X_train"].shape == (30 + 24 + 12, 5)
    X = rng.standard_normal((4, 2))
    P = ttab.padw(X, 5)
    assert P.dtype == np.float32 and P.shape == (4, 5)
    np.testing.assert_array_equal(P[:, :2], X.astype(np.float32))
    assert not P[:, 2:].any()
    np.testing.assert_array_equal(ttab.padw(P, 3), P)


# --------------------------------------------------- quantile transform
@pytest.mark.parametrize("n_quantiles,subsample,random_state", [
    (1000, 10_000, None), (37, 10_000, None), (100, 250, 0), (5, 10_000, None)])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_quantile_transform_matches_sklearn(n_quantiles, subsample, random_state, dtype):
    """On heavily tied digits-like columns, a constant column, a NaN and
    values past both ends: the same quantiles and transform as sklearn's
    QuantileTransformer(output_distribution="uniform") within 1e-6."""
    import warnings
    from sklearn.preprocessing import QuantileTransformer as SK
    rng = np.random.default_rng(1)
    X = (rng.integers(0, 17, (400, 5)) / 16.0).astype(dtype)
    X[:, 3] = 0.25
    X[7, 1] = np.nan
    Xt = np.concatenate([X[:50], rng.normal(0.5, 1.0, (30, 5)).astype(dtype)])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        sk = SK(n_quantiles=n_quantiles, subsample=subsample,
                random_state=random_state).fit(X)
    qt = ttab.QuantileTransformer(n_quantiles=n_quantiles, subsample=subsample,
                                  random_state=random_state).fit(X)
    assert qt.n_quantiles_ == sk.n_quantiles_
    np.testing.assert_allclose(qt.quantiles_, sk.quantiles_, rtol=0, atol=1e-6)
    for data in (X, Xt):
        got, want = qt.transform(data), sk.transform(data)
        assert got.dtype == want.dtype
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        assert np.nanmin(got) >= 0 and np.nanmax(got) <= 1


def test_quantile_transform_refuses_normal():
    with pytest.raises(ValueError, match="uniform"):
        ttab.QuantileTransformer(output_distribution="normal")


def test_digits_flat_one_seed_matches_jax(tmp_path, monkeypatch):
    """reproduce_result digits_flat, seed 42 at 2 swipes (20 in the
    protocol), the port's model starting from the JAX package's initial
    params: the data (split and quantile features) are bit-equal, and the
    test accuracy is the same within one of the 360 test rows."""
    from tensornetworksfork_tpu.experiments import reproduce_result as jrr
    from tensornetworksfork_tpu.experiments import train_tabular as jtt
    from tensornetworksfork_tpu.models.estimators import TensorTrainRegressor as JEst
    from tensornetworksfork_tpu_torch.experiments import reproduce_result as trr
    from tensornetworksfork_tpu_torch.experiments import train_tabular as ttt
    from tensornetworksfork_tpu_torch.models.estimators import TensorTrainRegressor as TEst
    from tensornetworksfork_tpu_torch.utils.convert import params_from_numpy

    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("DEVICE", "cpu")
    monkeypatch.setenv("TNF_FIT_PRECOMPILE", "0")
    monkeypatch.setenv("TNF_GRAM_DTYPE", "f32")
    build = TEst._initialize_model

    def build_with_jax_init(self):
        build(self)
        je = JEst(N=self.N, r=self.r, seed=self.seed, model_type=self.model_type,
                  output_dim=self.output_dim)
        je.input_dim = self.input_dim
        je._initialize_model()
        self._model.params = params_from_numpy(
            {k: np.asarray(v) for k, v in je._model.params.items()}, device="cpu")

    monkeypatch.setattr(TEst, "_initialize_model", build_with_jax_init)
    for mod in (jtt, ttt):
        run = mod.run

        def short(cfg, overrides=None, data=None, _run=run):
            cfg.num_swipes = 2
            return _run(cfg, overrides, data=data)
        monkeypatch.setattr(mod, "run", short)
    data = trr.digits_flat_data()
    from sklearn.datasets import load_digits
    from sklearn.preprocessing import QuantileTransformer as SK
    X = np.asarray(load_digits().data, np.float32) / 16.0
    y = np.asarray(load_digits().target, np.float32)
    ref = jtab.split_train_val_test(X, y.reshape(-1, 1), seed=42)
    qt = SK(output_distribution="uniform", n_quantiles=min(1000, len(ref["X_train"])))
    np.testing.assert_array_equal(data["X_train"], qt.fit_transform(ref["X_train"]))
    np.testing.assert_array_equal(data["X_test"], qt.transform(ref["X_test"]))
    np.testing.assert_array_equal(data["y_test"], ref["y_test"])
    (acc_t,) = trr.main("digits_flat", seeds=(42,))
    (acc_j,) = jrr.main("digits_flat", seeds=(42,))
    assert len(data["y_test"]) == 360
    assert abs(acc_t - acc_j) <= 100.0 / 360 + 1e-9, (acc_t, acc_j)
    assert acc_t > 80.0
    assert os.path.exists(tmp_path / "build" / "reproduce_digits_flat.csv")


# ------------------------------------------------------------------ flops
def _flops_pair(kind):
    from tensornetworksfork_tpu.core.sweep import SweepConfig as JC, Sweeper as JS
    from tensornetworksfork_tpu.models import layers as jl
    from tensornetworksfork_tpu.ops import bregman as jb
    from tensornetworksfork_tpu_torch.core.sweep import SweepConfig as TC, Sweeper as TS
    from tensornetworksfork_tpu_torch.models import layers as tl
    from tensornetworksfork_tpu_torch.ops import bregman as tb
    if kind == "tt":
        jlay, tlay = jl.TensorTrainLayer(3, 4, 9, seed=0), tl.TensorTrainLayer(
            3, 4, 9, seed=0, device="cpu")
        x, y = np.zeros((300, 9), np.float32), np.zeros((300, 1), np.float32)
        cfg, jloss, tloss = dict(num_swipes=2, batch_size=128), jb.SquareBregFunction(), \
            tb.SquareBregFunction()
    else:
        kw = dict(output_shape=(4,), convolution_bond=3, seed=0)
        jlay = jl.TensorConvolutionTrainLayer(3, 4, 6, 5, **kw)
        tlay = tl.TensorConvolutionTrainLayer(3, 4, 6, 5, device="cpu", **kw)
        x, y = np.zeros((200, 6, 5), np.float32), np.zeros((200, 5), np.float32)
        cfg, jloss, tloss = dict(num_swipes=1, batch_size=64), jb.XEBregman(), tb.XEBregman()
    return (JS(jlay.network, jloss, JC(**cfg)), x, y), \
        (TS(tlay.network, tloss, TC(**cfg)), torch.from_numpy(x), torch.from_numpy(y))


def _record(mod, monkeypatch):
    calls, fn = [], mod.contraction_flops

    def rec(ops, keep, sizes):
        cost = fn(ops, keep, sizes)
        calls.append(([tuple(o) for o in ops], tuple(keep), dict(sizes), cost))
        return cost
    monkeypatch.setattr(mod, "contraction_flops", rec)
    return calls


@pytest.mark.parametrize("kind", ["tt", "conv_tt"])
def test_epoch_flops_matches_jax(kind, monkeypatch):
    """Contraction by contraction: the same operands and keeps in the same
    order; the same cost where the port's plan is pairwise; where it holds
    one step of three or more operands (a TT middle core's Jacobian: numpy
    leaves a contraction that sums no axis unplanned), the port's cost is
    opt_einsum's of the left-to-right path, which torch.einsum runs. With
    one contraction cost in both, every key of epoch_flops is equal."""
    import opt_einsum as oe
    from tensornetworksfork_tpu.core.contract import einsum_expr
    from tensornetworksfork_tpu.utils import flops as jf
    from tensornetworksfork_tpu_torch.core.contract import _plan, max_elems
    from tensornetworksfork_tpu_torch.utils import flops as tf
    (js, jx, jy), (ts, tx, ty) = _flops_pair(kind)
    jcalls, tcalls = _record(jf, monkeypatch), _record(tf, monkeypatch)
    a, b = jf.epoch_flops(js, jx, jy), tf.epoch_flops(ts, tx, ty)
    assert a.keys() == b.keys() == {"total", "per_pass", "env", "gram_and_jac", "solve"}
    assert len(jcalls) == len(tcalls) > 0
    parted = 0
    for (jops, jkeep, sizes, jc), (tops, tkeep, _, tc) in zip(jcalls, tcalls):
        assert (jops, jkeep) == (tops, tkeep)
        if len(jops) < 2:
            assert jc == tc == 0
            continue
        shapes = [tuple(sizes[x] for x in o) for o in jops]
        expr = einsum_expr(jops, jkeep)
        if all(len(step) <= 2 for step, _ in _plan(expr, tuple(shapes), max_elems())):
            assert tc == jc, expr
        else:
            parted += 1
            left = [(0, 1)] * (len(shapes) - 1)
            assert tc == oe.contract_path(expr, *shapes, shapes=True,
                                          optimize=left)[1].opt_cost, expr
    assert (parted > 0) == (kind == "tt")
    if kind == "conv_tt":
        assert a == b
    assert a["env"] == b["env"] and a["solve"] == b["solve"]
    monkeypatch.setattr(tf, "contraction_flops", jf.contraction_flops)
    assert tf.epoch_flops(ts, tx, ty) == a


def test_peak_table_and_mfu(monkeypatch):
    """The H100 SXM's dense bf16 and int8 peaks by device name; None on
    other cards and without one; mfu = flops / s / peak."""
    from tensornetworksfork_tpu_torch.utils import flops as tf
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "NVIDIA H100 80GB HBM3")
    assert tf.device_peak_flops("bf16") == 989e12 and tf.device_peak_flops() == 989e12
    assert tf.device_peak_flops("int8") == 1979e12
    assert tf.mfu(989e12, 2.0) == 0.5
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "NVIDIA A100-SXM4-80GB")
    assert tf.device_peak_flops() is None and tf.mfu(1e12, 1.0) is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tf.device_peak_flops("int8") is None
    assert tf.mfu(1e12, 0.0, peak=1e12) is None and tf.mfu(2e12, 1.0, peak=4e12) == 0.5


# ----------------------------------------------------------------- timing
def test_block_on_and_xla_trace(tmp_path):
    """block_on passes its argument through (tensors nested in dicts and
    lists); xla_trace yields its directory and leaves a Chrome trace of the
    block's operations in it."""
    from tensornetworksfork_tpu_torch.utils.timing import block_on, xla_trace
    a = torch.randn(64, 64)
    tree = {"x": [a, (a @ a,)], "n": 3}
    assert block_on(tree) is tree and block_on(a) is a
    d = str(tmp_path / "trace")
    with xla_trace(d) as log_dir:
        assert log_dir == d
        b = torch.einsum("ij,jk->ik", a, a)
    (path,) = glob.glob(os.path.join(d, "trace-*.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any("einsum" in e.get("name", "") or "mm" in e.get("name", "") for e in events)
    assert torch.equal(b, a @ a) or torch.allclose(b, a @ a)
