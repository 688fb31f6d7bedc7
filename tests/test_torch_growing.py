"""Growth (DMRG two-site blocks, conv-TT carriages) and the feature-map
script of the port held against the JAX package.

The DMRG layer draws its cores from numpy's default_rng(seed) in both
packages, so both start from the same numbers; conv-TT params (and the
conv block a grown carriage draws) are the JAX package's, carried across
with `params_from_numpy`. Forwards agree within rtol 1e-5; predictions
after a swipe within 1e-4 x max|pred| (the convention of
tests/test_torch_zoo.py). Sizes are those of JAX tests/test_zoo_extra.py
:22-75 and tests/test_aux.py:75-91 and :144, each script cut to one swipe.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from tensornetworksfork_tpu.core.sweep import SweepConfig as JConfig  # noqa: E402
from tensornetworksfork_tpu.core.sweep import accumulating_sweep as jsweep  # noqa: E402
from tensornetworksfork_tpu.experiments import default_train as jdt  # noqa: E402
from tensornetworksfork_tpu.experiments import growing as jxg  # noqa: E402
from tensornetworksfork_tpu.models import growing as jg  # noqa: E402
from tensornetworksfork_tpu.models import layers as jl  # noqa: E402
from tensornetworksfork_tpu.ops import bregman as jb  # noqa: E402
from tensornetworksfork_tpu_torch.core.sweep import SweepConfig, accumulating_sweep  # noqa: E402
from tensornetworksfork_tpu_torch.experiments import default_train as tdt  # noqa: E402
from tensornetworksfork_tpu_torch.experiments import growing as txg  # noqa: E402
from tensornetworksfork_tpu_torch.models import growing as tg  # noqa: E402
from tensornetworksfork_tpu_torch.models import layers as tl  # noqa: E402
from tensornetworksfork_tpu_torch.ops import bregman as tb  # noqa: E402
from tensornetworksfork_tpu_torch.utils.convert import params_from_numpy  # noqa: E402

FWD_RTOL = 1e-5
PRED_REL = 1e-4


def _np(params):
    return {k: np.asarray(v) for k, v in params.items()}


def _fwd_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=FWD_RTOL,
                               atol=FWD_RTOL * np.abs(want).max())


def _pred_close(got, want, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=0, atol=PRED_REL * np.abs(want).max(),
                               err_msg=what)


# ------------------------------------------------------------------- DMRG
def test_dmrg_grow_and_split_forward_match_jax():
    """TensorTrainDMRGInfiLayer (test_zoo_extra.py:22): the same numpy
    draws, so the forward matches before growth, after grow_middle (the
    grown block the only train node) and after split_node at full rank."""
    rng = np.random.default_rng(0)
    jlay = jg.TensorTrainDMRGInfiLayer(4, 3, output_shape=(1,), seed=0)
    tlay = tg.TensorTrainDMRGInfiLayer(4, 3, output_shape=(1,), seed=0, device="cpu")
    X = rng.standard_normal((8, 2, 3)).astype(np.float32)
    _fwd_close(tlay(tlay.bind_x(torch.tensor(X))).numpy(),
               jlay(jlay.bind_x(jnp.asarray(X))))
    jlay.grow_middle()
    tlay.grow_middle()
    assert tlay.num_carriages == jlay.num_carriages == 4
    assert [tlay.topology.nodes[i].name for i in tlay.topology.train_nodes] == \
        [jlay.topology.nodes[i].name for i in jlay.topology.train_nodes]
    X4 = rng.standard_normal((8, 4, 3)).astype(np.float32)
    _fwd_close(tlay(tlay.bind_x(torch.tensor(X4))).numpy(),
               jlay(jlay.bind_x(jnp.asarray(X4))))
    ej, et = jlay.split_node(rank=16), tlay.split_node(rank=16)
    assert abs(et - ej) <= 1e-6 * max(abs(ej), 1.0)
    assert len(tlay._cores) == len(jlay._cores) == 4
    _fwd_close(tlay(tlay.bind_x(torch.tensor(X4))).numpy(),
               jlay(jlay.bind_x(jnp.asarray(X4))))


def test_dmrg_training_loop_matches_jax():
    """The DMRG training loop (test_zoo_extra.py:47) cut to one swipe, then
    grow, one swipe of the grown block, split at full rank and one swipe
    of the chain: predictions within 1e-4 x max|pred| after each."""
    rng = np.random.default_rng(1)
    S, f = 256, 4
    X2 = rng.standard_normal((S, 2, f)).astype(np.float32)
    X2[..., -1] = 1.0
    y = (X2[:, 0, 0] * X2[:, 1, 1]).reshape(S, 1).astype(np.float32)
    jlay = jg.TensorTrainDMRGInfiLayer(4, f, output_shape=(1,), seed=1)
    tlay = tg.TensorTrainDMRGInfiLayer(4, f, output_shape=(1,), seed=1, device="cpu")
    cfg = dict(num_swipes=1, method="ridge_cholesky", eps=1e-4)
    x = X2
    for step in ("first", "grown", "split"):
        if step == "grown":
            jlay.grow_middle()
            tlay.grow_middle()
            x = np.concatenate([x[:, :1], x[:, 1:2], x[:, 1:2], x[:, 1:]], axis=1)
        elif step == "split":
            jlay.split_node(rank=16)
            tlay.split_node(rank=16)
        xj, xt = jlay.bind_x(jnp.asarray(x)), tlay.bind_x(torch.tensor(x))
        pj, okj = jsweep(jlay.network, jlay.params, xj, jnp.asarray(y),
                         jb.SquareBregFunction(), JConfig(**cfg))
        pt, okt = accumulating_sweep(tlay.network, tlay.params, xt, torch.tensor(y),
                                     tb.SquareBregFunction(), SweepConfig(**cfg))
        assert okj and okt
        jlay.params, tlay.params = pj, pt
        _pred_close(tlay(xt).numpy(), jlay(xj), step)


def test_run_dmrg_growth_matches_jax():
    """run_dmrg_growth, two growth steps of one swipe each, rank 4, on a
    noisy target with eps 0.1 (a near-exact fit leaves the grown block's
    small singular values to the ridge and to rounding, and the split
    error with them): each step's positions, and its RMSE and split error
    within 1e-4 relative."""
    rng = np.random.default_rng(2)
    S, f = 1024, 4
    X2 = rng.standard_normal((S, 2, f)).astype(np.float32)
    X2[..., -1] = 1.0
    y = (X2[:, 0, 0] * X2[:, 1, 1] + 0.3 * X2[:, 1, 2]
         + 0.3 * rng.standard_normal(S)).reshape(S, 1).astype(np.float32)
    kw = dict(bond_dim=4, grow_steps=2, rank=4, num_swipes=1, eps=0.1)
    _, hj = jxg.run_dmrg_growth(X2, y, **kw)
    _, ht = txg.run_dmrg_growth(X2, y, device="cpu", **kw)
    assert [h["positions"] for h in ht] == [h["positions"] for h in hj] == [2, 4, 6]
    for a, b in zip(ht, hj):
        assert a["ok"] and b["ok"]
        assert abs(a["rmse"] - b["rmse"]) <= PRED_REL * b["rmse"]
        if "split_err" in b:
            assert abs(a["split_err"] - b["split_err"]) <= PRED_REL * b["split_err"]


# -------------------------------------------------------------- grow_cart
def _conv_pair(N=2, seed=0):
    jlay = jl.TensorConvolutionTrainLayer(N, 3, 5, 6, output_shape=(2,),
                                          convolution_bond=2, seed=seed)
    tlay = tl.TensorConvolutionTrainLayer(N, 3, 5, 6, output_shape=(2,),
                                          convolution_bond=2, seed=seed, device="cpu")
    tlay.params = params_from_numpy(_np(jlay.params), device="cpu")
    return jlay, tlay


_GROW_CART = tg.grow_cart


def _grow_like_jax(tlayer):
    """grow_cart, with the new carriage's conv block drawn by the JAX
    package (its grown layer's own init) instead of a torch.Generator."""
    grown = _GROW_CART(tlayer)
    N = grown.num_carriages
    ref = jl.TensorConvolutionTrainLayer(
        N, tlayer.bond_dim, tlayer.num_patches, tlayer.patch_pixels,
        output_shape=tuple(grown.topology.axis_size[a] for a in grown.topology.output_axes),
        convolution_bond=tlayer.convolution_bond, seed=0)
    grown.params = dict(grown.params, **{f"C{N}": torch.tensor(np.asarray(ref.params[f"C{N}"]))})
    return grown


def test_grow_cart_forward_matches_jax():
    """grow_cart (test_zoo_extra.py:65): the grown layer's params (old cores
    copied, the boundary core and conv block broadcast, the new core on the
    bias patch at 1/new_bond) and its forward, within rtol 1e-5."""
    jlay, tlay = _conv_pair()
    gj = jg.grow_cart(jlay, new_bond=3, new_convolution_bond=2)
    gt = _grow_like_jax(tlay)
    assert gt.num_carriages == 3
    for k, v in gj.params.items():
        np.testing.assert_array_equal(gt.params[k].numpy(), np.asarray(v), err_msg=k)
    x = np.random.default_rng(0).standard_normal((4, 5, 6)).astype(np.float32)
    _fwd_close(gt(torch.tensor(x)).numpy(), gj(jnp.asarray(x)))


def test_run_grow_cart_matches_jax(monkeypatch):
    """run_grow_cart at test_aux.py:144's sizes (1 -> 2 carriages, bond 3,
    conv bond 2, one swipe a step): from the JAX package's initial params
    and grown conv block, each step's RMSE within 1e-4 relative and the
    final predictions within 1e-4 x max|pred|."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((256, 6, 5)).astype(np.float32)
    y = rng.standard_normal((256, 2)).astype(np.float32)
    kw = dict(start_carriages=1, grow_steps=1, bond_dim=3, convolution_bond=2,
              num_swipes=1, eps=1e-2)
    lj, hj = jxg.run_grow_cart(x, y, **kw)
    ref = jl.TensorConvolutionTrainLayer(1, 3, 6, 5, output_shape=(2,),
                                         convolution_bond=2)
    built = tl.TensorConvolutionTrainLayer

    def start(*a, **k):
        layer = built(*a, **k)
        layer.params = params_from_numpy(_np(ref.params), device="cpu")
        return layer
    monkeypatch.setattr(txg, "TensorConvolutionTrainLayer", start)
    monkeypatch.setattr(txg.growing, "grow_cart", _grow_like_jax)
    lt, ht = txg.run_grow_cart(x, y, device="cpu", **kw)
    assert [h["carriages"] for h in ht] == [h["carriages"] for h in hj] == [1, 2]
    assert [h["params"] for h in ht] == [h["params"] for h in hj]
    for a, b in zip(ht, hj):
        assert a["ok"] and b["ok"]
        assert abs(a["train_rmse"] - b["train_rmse"]) <= PRED_REL * b["train_rmse"]
    _pred_close(lt(torch.tensor(x)).numpy(), lj(jnp.asarray(x)))


# ---------------------------------------------------------- default_train
# test_aux.py:75-91's sizes for each variant, cut to one swipe, at eps 1e-2
# (uncertainty's there): at default_train's default 1e-4 the raw target is fit
# almost exactly by the second core, and the third core's system is then so
# ill-conditioned that f32 rounding alone parts the two packages'
# predictions by 1.41e-4 of their largest (at 1e-2, 7.7e-6;
# studies/conditioning_study.py)
VARIANTS = {
    "raw": dict(S=512, d=3, degree=2, N=3, r=6),
    "rbf": dict(S=512, d=3, degree=2, N=3, r=6),
    "legendre": dict(S=512, d=3, degree=2, N=3, r=6),
    "fourier": dict(S=256, d=2, degree=2, r=6),
    "fourier_sparse": dict(S=256, d=2, degree=2, r=6),
    "uncertainty": dict(S=512, d=3, degree=2, N=2, r=4),
    "data_comp": dict(S=256, d=3, degree=2, N=2, r=4),
}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_default_train_variant_matches_jax(variant, monkeypatch):
    """default_train.run, one swipe of each variant from the JAX package's
    initial params (read where the JAX module calls accumulating_sweep):
    the port's predictions (its result's `pred`) within 1e-4 x max|pred| of
    the JAX package's (read where the JAX module scores them), and so its
    train RMSE."""
    kw = dict(VARIANTS[variant], num_swipes=1, eps=1e-2)
    seen = {}

    def sweep(net, params, *a, **k):
        seen["init"] = _np(params)
        return jsweep(net, params, *a, **k)

    def score(y, pred):
        seen["pred"] = np.asarray(pred)
        return float(np.sqrt(np.mean((np.asarray(y) - np.asarray(pred)) ** 2)))
    monkeypatch.setattr(jdt, "accumulating_sweep", sweep)
    monkeypatch.setattr(jdt, "rmse", score)
    rj = jdt.run(variant, **kw)
    dtype = torch.complex64 if variant.startswith("fourier") else torch.float32
    init = params_from_numpy(seen["init"], device="cpu", dtype=dtype)

    def sweep_from_jax(net, params, *a, **k):
        return accumulating_sweep(net, init, *a, **k)
    monkeypatch.setattr(tdt, "accumulating_sweep", sweep_from_jax)
    rt = tdt.run(variant, device="cpu", **kw)
    assert rj["ok"] and rt["ok"]
    _pred_close(rt["pred"], seen["pred"], variant)
    assert abs(rt["train_rmse"] - rj["train_rmse"]) <= PRED_REL * np.abs(seen["pred"]).max()
