"""Serving exports of the port (`utils/serving.py` on `torch.export`) held
against the JAX package's.

The five cases of the JAX package's tests/test_serving.py run on the port.
Then the port's artifact, made from the JAX package's params, is held to
the JAX package's `load_forward(export_forward(...))` of the same model
within 1e-5 (of max|pred|, and absolutely where that is below 1) at
batches 1, 3 and 32, for a TT layer, a conv-TT layer, a type-I sum of
conv-TTs and a fitted classification estimator; and an artifact loads and
serves in a process where `tensornetworksfork_tpu_torch` cannot be
imported.
"""
import io
import os
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from tensornetworksfork_tpu.models import layers as jl  # noqa: E402
from tensornetworksfork_tpu.utils import serving as js  # noqa: E402
from tensornetworksfork_tpu_torch.models import layers as tl  # noqa: E402
from tensornetworksfork_tpu_torch.models.estimators import TensorTrainRegressor  # noqa: E402
from tensornetworksfork_tpu_torch.utils.convert import params_from_numpy  # noqa: E402
from tensornetworksfork_tpu_torch.utils.serving import (  # noqa: E402
    export_estimator, export_forward, load_forward, save_forward)

SERVE_REL = 1e-5
BATCHES = (1, 3, 32)


def _np(params):
    return {k: np.asarray(v) for k, v in params.items()}


def _close(got, want, rel=SERVE_REL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(1.0, float(np.abs(want).max())))


# -------------------------------------------------- JAX test_serving.py cases
def test_layer_export_roundtrip_batch_polymorphic(tmp_path):
    layer = tl.TensorTrainLayer(3, 4, 5, output_shape=2, seed=0, device="cpu")
    x = np.random.default_rng(0).normal(size=(8, 5)).astype(np.float32)
    ref = layer(torch.from_numpy(x)).numpy()
    blob = export_forward(layer, (5,), device="cpu")
    p = str(tmp_path / "tt.pt2")
    save_forward(p, blob)
    f = load_forward(p)
    assert f.device.type == "cpu"
    np.testing.assert_allclose(f(x).numpy(), ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(f(x[:3]).numpy(), ref[:3], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(f(np.tile(x, (4, 1))).numpy(), np.tile(ref, (4, 1)),
                               rtol=1e-5, atol=1e-5)


def test_conv_layer_export():
    layer = tl.TensorConvolutionTrainLayer(2, 3, 4, 6, output_shape=3,
                                           convolution_bond=2, seed=1, device="cpu")
    x = np.random.default_rng(1).normal(size=(5, 4, 6)).astype(np.float32)
    ref = layer(torch.from_numpy(x)).numpy()
    f = load_forward(export_forward(layer, (4, 6), device="cpu"))
    np.testing.assert_allclose(f(x).numpy(), ref, rtol=1e-5, atol=1e-5)


def test_estimator_export_matches_predict():
    rng = np.random.default_rng(2)
    X = rng.uniform(-1, 1, size=(96, 4)).astype(np.float32)
    y = (X[:, 0] + 0.5 * X[:, 1] > 0).astype(np.int64)
    reg = TensorTrainRegressor(N=2, r=4, task="classification", num_swipes=3,
                               eps_start=0.5, eps_decay=0.5, seed=0, device="cpu")
    reg.fit(X, y)
    f = load_forward(export_estimator(reg))
    logits = f(X).numpy()
    ref = reg.predict(X)
    assert logits.shape == ref.shape
    np.testing.assert_allclose(logits, ref, rtol=1e-5, atol=1e-5)
    assert (logits.argmax(-1) == ref.argmax(-1)).all()


def test_estimator_export_requires_fit():
    with pytest.raises(ValueError, match="fitted"):
        export_estimator(TensorTrainRegressor(N=2, r=4, device="cpu"))


def test_estimator_export_method_and_tnml(tmp_path):
    """est.export(path) writes a loadable artifact; the TNML artifact
    carries the minmax rescale and the basis embedding (raw rows in)."""
    from tensornetworksfork_tpu_torch.models.tnml import TNMLRegressor
    rng = np.random.default_rng(3)
    X = rng.uniform(0, 1, size=(64, 6)).astype(np.float32)
    y = (X[:, 0] + X[:, 3] > 1.0).astype(np.int64)
    reg = TensorTrainRegressor(N=2, r=4, task="classification", num_swipes=2,
                               eps_start=0.5, seed=0, device="cpu")
    reg.fit(X, y)
    p = str(tmp_path / "reg.pt2")
    reg.export(p)
    f = load_forward(p)
    np.testing.assert_allclose(f(X).numpy(), reg.predict(X), rtol=1e-5, atol=1e-5)
    tn = TNMLRegressor(r=3, num_swipes=1, task="classification", seed=0,
                       verbose=0, input_scale="minmax", device="cpu")
    tn.fit(X, y)
    g = load_forward(tn.export())
    np.testing.assert_allclose(g(X).numpy(), tn.predict(X), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(g(X[:5]).numpy(), tn.predict(X[:5]), rtol=1e-4, atol=1e-4)


# --------------------------------------------- against the JAX package's blob
def _tt():
    j = jl.TensorTrainLayer(3, 4, 6, output_shape=2, seed=0)
    t = tl.TensorTrainLayer(3, 4, 6, output_shape=2, seed=0, device="cpu")
    t.params = params_from_numpy(_np(j.params), device="cpu")
    return j, t, (6,)


def _conv():
    kw = dict(output_shape=3, convolution_bond=2, seed=1)
    j = jl.TensorConvolutionTrainLayer(3, 3, 5, 4, **kw)
    t = tl.TensorConvolutionTrainLayer(3, 3, 5, 4, **kw, device="cpu")
    t.params = params_from_numpy(_np(j.params), device="cpu")
    return j, t, (5, 4)


def _type1():
    """A type-I sum of conv-TTs of 1-3 carriages (train_image's model
    shape), each member reading the one global input."""
    kw = dict(output_shape=3, convolution_bond=2)
    js_ = [jl.TensorConvolutionTrainLayer(n, 3, 5, 4, seed=n, **kw) for n in (1, 2, 3)]
    ts = [tl.TensorConvolutionTrainLayer(n, 3, 5, 4, seed=n, device="cpu", **kw)
          for n in (1, 2, 3)]
    for a, b in zip(js_, ts):
        b.params = params_from_numpy(_np(a.params), device="cpu")
    return jl.SumLayer(js_), tl.SumLayer(ts), (5, 4)


@pytest.mark.parametrize("make", [_tt, _conv, _type1], ids=["tt", "conv_tt", "type1_sum"])
def test_layer_artifact_matches_jax(make):
    j, t, shape = make()
    f = load_forward(export_forward(t, shape, device="cpu"))
    g = js.load_forward(js.export_forward(j, shape, platforms=("cpu",)))
    x = np.random.default_rng(5).normal(size=(max(BATCHES),) + shape).astype(np.float32)
    for b in BATCHES:
        _close(f(x[:b]).numpy(), np.asarray(g(x[:b])))
        _close(f(x[:b]).numpy(), t(torch.from_numpy(x[:b])).numpy())


@pytest.mark.parametrize("model_type", ["tt", "tt_type1"])
def test_estimator_artifact_matches_jax(model_type):
    """A classification estimator fitted by the JAX package, its params
    copied into the port's: both artifacts give the same logits (zero
    logit appended) and the same argmax."""
    from tensornetworksfork_tpu.models.estimators import TensorTrainRegressor as JEst
    rng = np.random.default_rng(6)
    X = rng.uniform(-1, 1, size=(96, 4)).astype(np.float32)
    y = (X[:, 0] + 0.5 * X[:, 1] > 0).astype(np.int64) + (X[:, 2] > 0.5)
    kw = dict(N=3, r=4, task="classification", num_swipes=2, eps_start=0.5,
              seed=0, model_type=model_type)
    je = JEst(**kw).fit(X, y)
    te = TensorTrainRegressor(**kw, device="cpu")
    te.input_dim, te.output_dim = je.input_dim, je.output_dim
    te._initialize_model()
    if model_type == "tt":
        te._model.params = params_from_numpy(_np(je._model.params), device="cpu")
    else:
        te._model.set_params_list([params_from_numpy(_np(p), device="cpu")
                                   for p in je._model.params_list])
    f = load_forward(te.export())
    g = js.load_forward(je.export(platforms=("cpu",)))
    for b in BATCHES:
        got, want = f(X[:b]).numpy(), np.asarray(g(X[:b]))
        assert got.shape == (b, 3)
        _close(got, want)
        assert (got.argmax(-1) == want.argmax(-1)).all()
        _close(got, te.predict(X[:b]))


def test_artifact_loads_without_the_package(tmp_path):
    """The artifact is torch's alone: a fresh interpreter in which any
    import of tensornetworksfork_tpu_torch raises loads and serves it."""
    layer = tl.TensorConvolutionTrainLayer(2, 3, 5, 4, output_shape=3,
                                           convolution_bond=2, seed=2, device="cpu")
    p = str(tmp_path / "conv.pt2")
    save_forward(p, export_forward(layer, (5, 4), device="cpu", classification=True))
    x = np.random.default_rng(7).normal(size=(4, 5, 4)).astype(np.float32)
    np.save(tmp_path / "x.npy", x)
    script = (
        "import importlib.abc, sys\n"
        "class Block(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path, target=None):\n"
        "        if name.startswith('tensornetworksfork_tpu'):\n"
        "            raise ImportError('blocked ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import numpy as np, torch\n"
        "m = torch.export.load(sys.argv[1]).module()\n"
        "y = m(torch.from_numpy(np.load(sys.argv[2])))\n"
        "assert not [k for k in sys.modules if k.startswith('tensornetworksfork')]\n"
        "np.save(sys.argv[3], y.detach().numpy())\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    subprocess.run([sys.executable, "-c", script, p, str(tmp_path / "x.npy"),
                    str(tmp_path / "y.npy")], check=True, cwd=tmp_path, env=env,
                   timeout=300)
    want = layer(torch.from_numpy(x)).numpy()
    want = np.concatenate([want, np.zeros_like(want[:, :1])], axis=1)
    _close(np.load(tmp_path / "y.npy"), want)


def test_export_refuses_a_batch_of_one_example():
    """torch.export specialises a dimension whose example size is 1: the
    symbolic batch is traced at EXAMPLE_BATCH rows (never 1), the loaded
    program's batch dimension stays symbolic, and it serves batches of 1
    and 2 as the eager forward does (within 1e-5)."""
    from tensornetworksfork_tpu_torch.utils.serving import EXAMPLE_BATCH
    assert EXAMPLE_BATCH >= 2
    layer = tl.TensorTrainLayer(2, 3, 4, seed=0, device="cpu")
    blob = export_forward(layer, (4,), device="cpu")
    ep = torch.export.load(io.BytesIO(blob))
    (x_node,) = [n for n in ep.graph.nodes
                 if n.op == "placeholder" and n.name not in ep.graph_signature.inputs_to_buffers]
    assert isinstance(x_node.meta["val"].shape[0], torch.SymInt)
    f = load_forward(blob)
    for rows in (1, 2):
        x = torch.randn(rows, 4)
        _close(f(x).numpy(), layer(x).numpy())
