"""The port's topology, contraction, loss and engine held against the JAX package.

Params are made by the JAX package and copied across with
`utils.convert.params_from_numpy`; data comes from a numpy seed. The engine
tests use a tiny conv-TT (N=4, r=4, CB=2, 6 patches x 5 pixels, 3 logits) with
TNF_PACKED_SYRK_MIN_D=1, so the middle cores take the tiled kernel route
(through the kernels' plain versions on the CPU, as the JAX side runs its
Pallas kernels in interpret mode) and every other route of the conv-TT is
reached too.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from tensornetworksfork_tpu.core import contract as jcontract  # noqa: E402
from tensornetworksfork_tpu.core.engine import Network as JNetwork  # noqa: E402
from tensornetworksfork_tpu.models.layers import (  # noqa: E402
    TensorConvolutionTrainLayer as JLayer)
from tensornetworksfork_tpu.ops.bregman import XEBregman as JXE  # noqa: E402
from tensornetworksfork_tpu_torch.core import contract as tcontract  # noqa: E402
from tensornetworksfork_tpu_torch.models.layers import (  # noqa: E402
    TensorConvolutionTrainLayer as TLayer)
from tensornetworksfork_tpu_torch.ops.bregman import XEBregman as TXE  # noqa: E402
from tensornetworksfork_tpu_torch.utils.convert import (  # noqa: E402
    params_from_numpy, params_to_numpy)

N, R, CB, P, PP, C, S = 4, 4, 2, 6, 5, 3, 40


def tiny_layers():
    jl = JLayer(N, R, P, PP, output_shape=(C,), convolution_bond=CB, seed=0)
    tl = TLayer(N, R, P, PP, output_shape=(C,), convolution_bond=CB, seed=0,
                use_kernels=True, device="cpu")
    return jl, tl


def tiny_data(seed=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((S, P, PP)).astype(np.float32)
    Y = np.eye(C + 1, dtype=np.float32)[rng.integers(0, C + 1, S)]
    return X, Y


def test_topology_matches():
    """Same axis ids, sizes, columns, output axes and train order."""
    jl, tl = tiny_layers()
    jt, tt = jl.topology, tl.topology
    assert tt.node_axes == jt.node_axes
    assert tt.axis_size == jt.axis_size
    assert tt.columns == jt.columns
    assert tt.output_axes == jt.output_axes
    assert tt.train_nodes == jt.train_nodes
    assert [n.name for n in tt.nodes] == [n.name for n in jt.nodes]
    assert {k: tuple(v.shape) for k, v in tl.params.items()} == \
        {k: tuple(v.shape) for k, v in jl.params.items()}


def test_params_roundtrip_and_init():
    """params_from_numpy/params_to_numpy are exact; the port's own init is
    seeded (same seed, same draws) and unit-norm per node."""
    jl, tl = tiny_layers()
    p = {k: np.asarray(v) for k, v in jl.params.items()}
    back = params_to_numpy(params_from_numpy(p, device="cpu"))
    assert all(np.array_equal(back[k], p[k]) for k in p)
    again = TLayer(N, R, P, PP, output_shape=(C,), convolution_bond=CB, seed=0,
                   device="cpu")
    for k, v in tl.params.items():
        assert torch.equal(v, again.params[k])
        assert abs(float(torch.linalg.vector_norm(v)) - 1.0) < 1e-5


@pytest.mark.parametrize("case", [
    # (operand axes, keep): chain, hyperedge, reduction, 7 operands (greedy)
    ([(0, 1), (1, 2), (2, 3)], (0, 3)),
    ([(0, 5), (1, 5), (2, 5)], (0, 1, 2)),
    ([(0, 1, 2), (2, 3)], (3,)),
    ([(9, 0, 1), (1, 2), (2, 3), (3, 4), (4, 5), (5, 6), (6, 9)], (0, 9)),
])
def test_contract_matches(case):
    """Planned pairwise torch.einsum vs the JAX contract (opt_einsum path,
    HIGHEST). rtol 1e-5: f32 sums in another order."""
    axes, keep = case
    rng = np.random.default_rng(len(axes))
    sizes = {a: 2 + (a % 4) for ax in axes for a in ax}
    arrs = [rng.standard_normal([sizes[a] for a in ax]).astype(np.float32)
            for ax in axes]
    ref = np.asarray(jcontract.contract(
        [(ax, jnp.asarray(a)) for ax, a in zip(axes, arrs)], keep))
    out = tcontract.contract(
        [(ax, torch.tensor(a)) for ax, a in zip(axes, arrs)], keep).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("seed", range(12))
def test_greedy_path_matches_numpy(seed):
    """The port's greedy planner, which plans every contraction of more
    than 6 operands, gives numpy.einsum_path's greedy path, capped and not,
    on random expressions of 7-14 operands (hyperedges, size-1 axes, kept
    axes, disconnected parts) and on the 54-axis chain written in ASCII's
    52 letters: the ASCII plans are numpy's as they were."""
    rng = np.random.default_rng(seed)
    n_ops = int(rng.integers(7, 15))
    letters = "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ"
    n_ax = int(rng.integers(6, 30))
    dims = {ch: int(rng.integers(1, 7)) for ch in letters[:n_ax]}
    terms = ["".join(rng.choice(list(letters[:n_ax]), int(rng.integers(1, 5)),
                                replace=False)) for _ in range(n_ops)]
    used = sorted(set("".join(terms)))
    out = "".join(ch for ch in used if rng.uniform() < 0.15)
    expr = ",".join(terms) + "->" + out
    dummies = [np.broadcast_to(np.empty((), np.float32), [dims[ch] for ch in t])
               for t in terms]
    for cap in (float(rng.integers(4, 200)), tcontract._UNCAPPED):
        ref = np.einsum_path(expr, *dummies, optimize=("greedy", cap))[0][1:]
        got = tcontract._greedy_path(terms, out, dims, cap)
        assert [tuple(st) for st in got] == [tuple(st) for st in ref], (expr, cap)
    chain = [letters[i] + letters[i + 1] for i in range(51)]
    ref = np.einsum_path(",".join(chain) + "->az", *[np.ones((2, 2))] * 51,
                         optimize=("greedy", tcontract._UNCAPPED))[0][1:]
    assert tcontract._greedy_path(chain, "az", {ch: 2 for ch in letters},
                                  tcontract._UNCAPPED) == [tuple(st) for st in ref]


def test_contract_rejects_more_than_52_axes():
    """A contraction may carry any number of axes, as the JAX package's may:
    each pairwise step gets letters of its own, so a 54-axis chain of 53
    matrices matches the JAX package (rtol 1e-5: f32 sums in another
    order). One step over more than 52 distinct axes is still refused:
    torch.einsum takes only the 52 ASCII letters."""
    rng = np.random.default_rng(0)
    mats = [rng.uniform(0.5, 1.0, (2, 2)).astype(np.float32) for _ in range(53)]
    out = tcontract.contract(
        [((i, i + 1), torch.tensor(m)) for i, m in enumerate(mats)], (0, 53))
    ref = np.asarray(jcontract.contract(
        [((i, i + 1), jnp.asarray(m)) for i, m in enumerate(mats)], (0, 53)))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5)
    with pytest.raises(ValueError):
        tcontract.contract([(tuple(range(53)), torch.ones((1,) * 53))], ())


def test_xebregman_matches():
    """(loss, grad, hess) of the C-1-logit cross entropy; rtol 1e-6 (f32
    elementwise math, log_softmax evaluated by two libraries)."""
    rng = np.random.default_rng(3)
    pred = rng.standard_normal((16, 4)).astype(np.float32) * 2
    y = np.eye(5, dtype=np.float32)[rng.integers(0, 5, 16)]
    for w in (1.0, 0.5):
        ref = JXE(w)(jnp.asarray(pred), jnp.asarray(y))
        out = TXE(w)(torch.tensor(pred), torch.tensor(y))
        for r, o in zip(ref, out):
            np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-6,
                                       atol=1e-6)


def _node_system(net, params, x, ni, to_np, loss_fn, make_t):
    """A, b, prediction and route for node `ni` through `net` (either
    package), from the environment chains around it."""
    t = net.topology
    ci = t.col_of[ni]
    ncols = len(t.columns)
    inputs = net.bind_inputs(x)
    left = net.env_chain(params, inputs, "left")
    right = net.env_chain(params, inputs, "right")
    L = left[ci - 1] if ci > 0 else None
    R = right[ci + 1] if ci < ncols - 1 else None
    core = params[t.nodes[ni].name]
    pj = net.packed_jacobian(ni, params, inputs, L, R)
    if pj is not None:
        pred = net.packed_predict(pj, core)
    else:
        J = net.jacobian(ni, params, inputs, L, R)
        pred = net.predict_from_jacobian(ni, J, core)
    _, g, H = loss_fn(pred, make_t(tiny_data()[1]))
    if pj is not None:
        A, b = net.packed_gram_rhs(pj, g, H)[:2]
    else:
        A, b = net.gram_and_rhs(ni, J, g, H)
    D = int(np.prod(core.shape))
    return (to_np(A).reshape(D, D), to_np(b).reshape(D), to_np(pred),
            pj is not None)


@pytest.mark.parametrize("node", [f"A{i}" for i in range(1, N + 1)]
                         + [f"C{i}" for i in range(1, N + 1)])
def test_node_system_matches(node, monkeypatch):
    """For every node: the route taken (packed or not), the prediction
    J·core, and A = JᵀHJ, b = Jᵀg equal the JAX Network(use_pallas=True)
    in the f32 tier. rtol 1e-5 of the largest entry: f32 contractions
    summed in another order."""
    monkeypatch.setenv("TNF_GRAM_DTYPE", "f32")
    monkeypatch.setenv("TNF_PACKED_SYRK_MIN_D", "1")
    jl, tl = tiny_layers()
    X, _ = tiny_data()
    jnet = JNetwork(jl.topology, use_pallas=True)
    p_np = {k: np.asarray(v) for k, v in jl.params.items()}
    ni = jl.topology.by_name[node]
    Aj, bj, pj_pred, j_packed = _node_system(
        jnet, jl.params, jnp.asarray(X), ni, np.asarray, JXE(1.0), jnp.asarray)
    At, bt, pt_pred, t_packed = _node_system(
        tl.network, params_from_numpy(p_np, device="cpu"), torch.tensor(X), ni,
        lambda a: a.numpy(), TXE(1.0), torch.tensor)
    assert t_packed == j_packed
    for out, ref in ((pt_pred, pj_pred), (At, Aj), (bt, bj)):
        np.testing.assert_allclose(out, ref, rtol=0,
                                   atol=1e-5 * max(np.abs(ref).max(), 1e-30))
    np.testing.assert_allclose(At, At.T, rtol=0, atol=1e-6 * np.abs(At).max())


def test_forward_and_envs_match():
    """forward() and both environment chains equal the JAX package's
    (rtol 1e-5: f32 sums in another order; the staged conv-TT column advance
    runs on both sides)."""
    jl, tl = tiny_layers()
    X, _ = tiny_data()
    p = params_from_numpy({k: np.asarray(v) for k, v in jl.params.items()},
                          device="cpu")
    ref = np.asarray(jl.network.forward(jl.params, jnp.asarray(X)))
    out = tl.network.forward(p, torch.tensor(X)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5 * np.abs(ref).max())
    for d in ("left", "right"):
        je = jl.network.env_chain(jl.params, jl.network.bind_inputs(jnp.asarray(X)), d)
        te = tl.network.env_chain(p, tl.network.bind_inputs(torch.tensor(X)), d)
        for a, b in zip(je, te):
            assert a[0] == b[0]
            np.testing.assert_allclose(b[1].numpy(), np.asarray(a[1]), rtol=0,
                                       atol=1e-5 * np.abs(np.asarray(a[1])).max())


@pytest.mark.parametrize("node", ["A2", "A3"])
def test_packed_gram_rhs_full_hessian_bf16_matches_jax(node, monkeypatch):
    """The tiled full-Hessian route of a middle core in the bf16 tier, where
    K1 (retile_hmix) also sums b = Jtᵀg: A and b against the JAX engine's
    (Pallas retile_hmix and Gram in interpret mode, b by its dot over Jt).
    Each package forms J by f32 contractions in its own order and rounds it
    to bf16, so an entry of J (and of K) may differ by one bf16 ulp, 2^-8 of
    itself; the products are exact in f32 and the sums differ only in
    order. Both held to 2^-8 of their largest entry (tests/test_torch_gram.py
    holds b on one Jt to the order of its sums alone)."""
    monkeypatch.setenv("TNF_GRAM_DTYPE", "bf16")
    monkeypatch.setenv("TNF_PACKED_SYRK_MIN_D", "1")
    jl, tl = tiny_layers()
    X, _ = tiny_data()
    jnet = JNetwork(jl.topology, use_pallas=True)
    p_np = {k: np.asarray(v) for k, v in jl.params.items()}
    ni = jl.topology.by_name[node]
    Aj, bj, _, j_packed = _node_system(
        jnet, jl.params, jnp.asarray(X), ni, np.asarray, JXE(1.0), jnp.asarray)
    At, bt, _, t_packed = _node_system(
        tl.network, params_from_numpy(p_np, device="cpu"), torch.tensor(X), ni,
        lambda a: a.numpy(), TXE(1.0), torch.tensor)
    assert t_packed and j_packed
    np.testing.assert_allclose(bt, bj, rtol=0, atol=2.0 ** -8 * np.abs(bj).max())
    np.testing.assert_allclose(At, Aj, rtol=0, atol=2.0 ** -8 * np.abs(Aj).max())
