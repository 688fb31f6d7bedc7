"""The matrix-free tier of the port against the JAX package on the CPU: the
Krylov solvers (`core/krylov.py`), the engine's J v, Jᵀ u, H u and JᵀHJ v,
the iterative and gradient branches of `Sweeper.run`, and `train_image`
with METHOD=minres and PRESET=cifar_minres.

Inputs come from numpy seeds; params are made by the JAX package and copied
across (`utils/convert.py`).
"""
import math
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from tensornetworksfork_tpu.core import krylov as jk  # noqa: E402
from tensornetworksfork_tpu.core.sweep import SweepConfig as JConfig  # noqa: E402
from tensornetworksfork_tpu.core.sweep import Sweeper as JSweeper  # noqa: E402
from tensornetworksfork_tpu.models.layers import (  # noqa: E402
    TensorConvolutionTrainLayer as JConv, TensorTrainLayer as JTT)
from tensornetworksfork_tpu.ops import bregman as jb  # noqa: E402
from tensornetworksfork_tpu_torch.core import krylov as tk  # noqa: E402
from tensornetworksfork_tpu_torch.core.sweep import SweepConfig, Sweeper  # noqa: E402
from tensornetworksfork_tpu_torch.models.layers import (  # noqa: E402
    TensorConvolutionTrainLayer as TConv, TensorTrainLayer as TTT)
from tensornetworksfork_tpu_torch.ops import bregman as tb  # noqa: E402
from tensornetworksfork_tpu_torch.ops.cuda import gram as tg  # noqa: E402
from tensornetworksfork_tpu_torch.utils.convert import (  # noqa: E402
    params_from_numpy, params_to_numpy)


def spectral(n, hi, seed, indefinite=False):
    """Symmetric n x n with eigenvalues linspace(1, hi), every other one
    negated when indefinite."""
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    ev = np.linspace(1.0, hi, n)
    if indefinite:
        ev = ev * np.where(np.arange(n) % 2, -1.0, 1.0)
    A = (Q * ev) @ Q.T
    return ((A + A.T) / 2).astype(np.float32)


def both(A, b):
    """The dense operator and rhs for each package, and a counter of the
    port's matvecs."""
    Aj, At = jnp.asarray(A), torch.tensor(A)
    calls = []

    def mv(v):
        calls.append(1)
        return At @ v
    return (lambda v: Aj @ v), jnp.asarray(b), mv, torch.tensor(b), calls


# ---------------------------------------------------------------- solvers
# x within 1e-5 of max|x| (measured 1e-7..5e-7: the same recurrence, f32
# products summed in another order)
@pytest.mark.parametrize("name,indefinite,maxiter", [
    ("cg", False, 10), ("minres", True, 10), ("lanczos", False, 10)])
def test_solver_matches_jax_at_a_fixed_iteration_count(name, indefinite, maxiter):
    """tol = 0 runs every one of maxiter iterations in both packages."""
    A = spectral(32, 4.0, seed=1, indefinite=indefinite)
    b = np.random.default_rng(2).standard_normal(32).astype(np.float32)
    mvj, bj, mvt, bt, calls = both(A, b)
    if name == "lanczos":
        xj = jk.lanczos_galerkin(mvj, bj, jnp.zeros(32), maxiter=maxiter)
        xt = tk.lanczos_galerkin(mvt, bt, torch.zeros(32), maxiter=maxiter)
    else:
        xj, kj = getattr(jk, name)(mvj, bj, maxiter=maxiter, tol=0.0)
        xt, kt = getattr(tk, name)(mvt, bt, maxiter=maxiter, tol=0.0)
        assert int(kj) == int(kt) == maxiter
    assert len(calls) == maxiter + 1
    xj = np.asarray(xj)
    np.testing.assert_allclose(xt.numpy(), xj, rtol=0, atol=1e-5 * np.abs(xj).max())


class Lagging(tk._Flags):
    """A device `behind` iterations behind the host: iteration j's flag
    arrives once the host has reached iteration j + behind, or when the
    host waits for it. Records the iterations at which the host waited."""
    behind = 0
    waits: list = []

    def _send(self, it, active):
        self.host[it] = active
        return it

    def _arrived(self, it, j, ev):
        return it >= j + self.behind

    def _wait(self, ev):
        self.waits.append(ev)


# CG converges at k = 13 and MINRES at k = 30 here, neither a multiple of 8
@pytest.mark.parametrize("name,indefinite,tol", [("cg", False, 1e-6),
                                                 ("minres", True, 1e-4)])
@pytest.mark.parametrize("behind", [0, 3])
def test_masked_loop_stops_where_the_while_loop_does(name, indefinite, tol, behind,
                                                     monkeypatch):
    """The same k as the JAX package's while loop, x within 1e-5 of max|x|;
    the masked iterations past k leave x bit for bit as a loop of exactly k
    iterations does. With the flags at hand (the CPU) the host stops at k;
    with a device 3 iterations behind it launches LAG masked matvecs past
    k, waiting for the flag after the first iteration and then only for
    flags LAG old (a read every 8 would run 8·ceil(k/8) - k: 3 and 2)."""
    Lagging.behind, Lagging.waits = behind, []
    monkeypatch.setattr(tk, "_Flags", Lagging)
    A = spectral(48, 4.0, seed=0, indefinite=indefinite)
    b = np.random.default_rng(50).standard_normal(48).astype(np.float32)
    mvj, bj, mvt, bt, calls = both(A, b)
    xj, kj = getattr(jk, name)(mvj, bj, maxiter=100, tol=tol)
    xt, kt = getattr(tk, name)(mvt, bt, maxiter=100, tol=tol)
    k = int(kt)
    assert k == int(kj) and k % 8 != 0
    xj = np.asarray(xj)
    np.testing.assert_allclose(xt.numpy(), xj, rtol=0, atol=1e-5 * np.abs(xj).max())
    masked = tk.LAG if behind > tk.LAG else behind
    assert len(calls) == 1 + k + masked
    if behind:
        assert Lagging.waits == list(range(k + 1))
    x_k, k_k = getattr(tk, name)(mvt, bt, maxiter=k, tol=tol)
    assert int(k_k) == k and torch.equal(x_k, xt)


@pytest.mark.parametrize("name", ["cg", "minres"])
def test_a_system_one_iteration_solves_stops_after_one_matvec(name, monkeypatch):
    """A = 3 I (a node whose J is ~0 beside the ridge): the JAX package's
    loop ends at k = 1, and the host's wait for the flag after the first
    iteration stops the port's there too, after the residual and one matvec,
    on a device that lags too (a read every 8 would run 8)."""
    Lagging.behind = 3
    monkeypatch.setattr(tk, "_Flags", Lagging)
    A = 3.0 * np.eye(24, dtype=np.float32)
    b = np.random.default_rng(51).standard_normal(24).astype(np.float32)
    mvj, bj, mvt, bt, calls = both(A, b)
    _, kj = getattr(jk, name)(mvj, bj, maxiter=50, tol=1e-6)
    xt, kt = getattr(tk, name)(mvt, bt, maxiter=50, tol=1e-6)
    assert int(kj) == int(kt) == 1
    assert len(calls) == 2
    np.testing.assert_allclose(xt.numpy(), b / 3.0, rtol=1e-6, atol=1e-7)


def test_cg_matches_dense():
    """tests/test_matrixfree.py's CG case and bounds."""
    rng = np.random.default_rng(0)
    M = rng.standard_normal((12, 12)).astype(np.float32)
    A = M @ M.T + 12 * np.eye(12, dtype=np.float32)
    b = np.random.default_rng(1).standard_normal(12).astype(np.float32)
    x, k = tk.cg(lambda v: torch.tensor(A) @ v, torch.tensor(b), maxiter=100, tol=1e-6)
    np.testing.assert_allclose(x.numpy(), np.linalg.solve(A, b), rtol=1e-3, atol=1e-3)
    assert int(k) <= 100


def test_minres_matches_dense_indefinite():
    rng = np.random.default_rng(2)
    M = rng.standard_normal((10, 10)).astype(np.float32)
    A = (M + M.T) + 0.1 * np.eye(10, dtype=np.float32)
    b = rng.standard_normal(10).astype(np.float32)
    x, _ = tk.minres(lambda v: torch.tensor(A) @ v, torch.tensor(b), maxiter=200, tol=1e-7)
    np.testing.assert_allclose(x.numpy(), np.linalg.solve(A, b), rtol=2e-2, atol=2e-2)


def test_lanczos_galerkin_matches_dense():
    rng = np.random.default_rng(3)
    M = rng.standard_normal((8, 8)).astype(np.float32)
    A = M @ M.T + 8 * np.eye(8, dtype=np.float32)
    b = np.random.default_rng(4).standard_normal(8).astype(np.float32)
    x = tk.lanczos_galerkin(lambda v: torch.tensor(A) @ v, torch.tensor(b),
                            torch.zeros(8), maxiter=8, tol=1e-8)
    np.testing.assert_allclose(x.numpy(), np.linalg.solve(A, b), rtol=1e-2, atol=1e-2)


# ---------------------------------------------------------------- engine
def _layers(kind):
    """(JAX layer, port layer with its params, x, y, JAX loss, port loss,
    node names to test)."""
    rng = np.random.default_rng(5)
    if kind == "tt":
        jl = JTT(3, 3, 3, output_shape=(2,), seed=0)
        tl = TTT(3, 3, 3, output_shape=(2,), seed=0, device="cpu")
        x = rng.standard_normal((7, 3)).astype(np.float32)
        y = rng.standard_normal((7, 2)).astype(np.float32)
        losses = (jb.SquareBregFunction(), tb.SquareBregFunction())
        nodes = ("A1", "A2", "A3")
    else:
        jl = JConv(3, 3, 5, 4, output_shape=(3,), convolution_bond=2, seed=0)
        tl = TConv(3, 3, 5, 4, output_shape=(3,), convolution_bond=2, seed=0,
                   device="cpu")
        x = rng.standard_normal((9, 5, 4)).astype(np.float32)
        y = np.eye(4, dtype=np.float32)[rng.integers(0, 4, 9)]
        losses = (jb.XEBregman(1.0), tb.XEBregman(1.0))
        nodes = ("A1", "A2", "C2", "C3")
    tl.params = params_from_numpy({k: np.asarray(v) for k, v in jl.params.items()},
                                  device="cpu")
    return jl, tl, x, y, losses, nodes


# J v, Jᵀ u, H u (diagonal H on the TT, full H on the conv-TT) and JᵀHJ v
# within 1e-5 of their max (f32 contractions in another order); the fused
# matvec also within 1e-4 of max|A v| of the materialised A.
@pytest.mark.parametrize("kind", ["tt", "convtt"])
def test_matrix_free_ops_match_jax_and_the_materialised_A(kind):
    jl, tl, x, y, (jloss, tloss), nodes = _layers(kind)
    jn, tn = jl.network, tl.network
    jin, tin = jn.bind_inputs(jnp.asarray(x)), tn.bind_inputs(torch.tensor(x))
    jl_env = jn.env_chain(jl.params, jin, "left")
    jr_env = jn.env_chain(jl.params, jin, "right")
    tl_env = tn.env_chain(tl.params, tin, "left")
    tr_env = tn.env_chain(tl.params, tin, "right")
    t = tn.topology
    rng = np.random.default_rng(6)

    def close(a, b):
        b = np.asarray(b)
        np.testing.assert_allclose(np.asarray(a), b, rtol=0,
                                   atol=1e-5 * max(np.abs(b).max(), 1e-30))

    for name in nodes:
        ni = [n.name for n in t.nodes].index(name)
        ci = t.col_of[ni]
        ncols = len(t.columns)
        Lj = jl_env[ci - 1] if ci > 0 else None
        Rj = jr_env[ci + 1] if ci < ncols - 1 else None
        Lt = tl_env[ci - 1] if ci > 0 else None
        Rt = tr_env[ci + 1] if ci < ncols - 1 else None
        ops_j = jn.jacobian_operands(ni, jl.params, jin, Lj, Rj)
        ops_t = tn.jacobian_operands(ni, tl.params, tin, Lt, Rt)
        core = tl.params[name]
        v = rng.standard_normal(tuple(core.shape)).astype(np.float32)
        Jv_j = jn.jacobian_apply(ni, ops_j, jnp.asarray(v))
        Jv_t = tn.jacobian_apply(ni, ops_t, torch.tensor(v))
        close(Jv_t, Jv_j)
        _, g_t, H_t = tloss(Jv_t, torch.tensor(y))
        H_j = jnp.asarray(H_t.numpy())
        u = rng.standard_normal(tuple(Jv_t.shape)).astype(np.float32)
        close(tn.hessian_apply(H_t, torch.tensor(u)),
              jn.hessian_apply(H_j, jnp.asarray(u)))
        close(tn.jacobian_transpose_apply(ni, ops_t, torch.tensor(u)),
              jn.jacobian_transpose_apply(ni, ops_j, jnp.asarray(u)))
        J_t = tn.jacobian(ni, tl.params, tin, Lt, Rt)
        J_j = jn.jacobian(ni, jl.params, jin, Lj, Rj)
        gm_t = tn.gram_matvec(ni, J_t, H_t, g_t.ndim, torch.tensor(v))
        close(gm_t, jn.gram_matvec(ni, J_j, H_j, g_t.ndim, jnp.asarray(v)))
        fused = tn.jacobian_transpose_apply(
            ni, ops_t, tn.hessian_apply(H_t, Jv_t))
        close(fused, gm_t)
        A, b = tn.gram_and_rhs(ni, J_t, g_t, H_t)
        D = core.numel()
        Av = (A.reshape(D, D) @ torch.tensor(v).reshape(D)).numpy()
        np.testing.assert_allclose(fused.reshape(D).numpy(), Av, rtol=0,
                                   atol=1e-4 * np.abs(Av).max())
        np.testing.assert_allclose(tn.jacobian_transpose_apply(ni, ops_t, g_t).numpy(),
                                   b.numpy(), rtol=0, atol=1e-5 * np.abs(b.numpy()).max())


# ----------------------------------------------------------------- sweeps
def _sweep_problem(kind):
    rng = np.random.default_rng(7)
    if kind == "tt":
        S = 64
        X = rng.standard_normal((S, 4)).astype(np.float32)
        X[:, -1] = 1.0
        Y = (X[:, 0] * X[:, 1] + X[:, 2]).reshape(S, 1).astype(np.float32)
        make = (lambda: JTT(3, 3, 4, output_shape=(1,), seed=1),
                lambda: TTT(3, 3, 4, output_shape=(1,), seed=1, device="cpu",
                            use_kernels=True))
        return X, Y, make, (jb.SquareBregFunction(), tb.SquareBregFunction())
    S = 64
    X = rng.standard_normal((S, 5, 4)).astype(np.float32)
    Y = np.eye(4, dtype=np.float32)[rng.integers(0, 4, S)]
    make = (lambda: JConv(3, 3, 5, 4, output_shape=(3,), convolution_bond=2, seed=0),
            lambda: TConv(3, 3, 5, 4, output_shape=(3,), convolution_bond=2, seed=0,
                          device="cpu", use_kernels=True))
    return X, Y, make, (jb.XEBregman(1.0), tb.XEBregman(1.0))


def _max_rel(pj, pt):
    return max(float(np.abs(np.asarray(pj[k]) - pt[k]).max()
                     / np.abs(np.asarray(pj[k])).max()) for k in pt)


# One swipe from the JAX init, then a second, warm-started one, in both
# packages; eps 1.0, 32-sample chunks, max_iter 40, tol 1e-6 (the solves
# converge). Params within 5e-4 of their max after each swipe (measured
# 1.5e-6..1.1e-4: Krylov recurrences in f32 over contractions summed in
# another order). With the full-batch merge off (the chunked matvec) and
# on (one merged chunk). No Gram kernel is called: A is never formed.
@pytest.mark.parametrize("fullbatch", ["0", ""])
@pytest.mark.parametrize("method", ["cg", "minres", "lanczos"])
@pytest.mark.parametrize("kind", ["tt", "convtt"])
def test_iterative_swipes_match_jax(kind, method, fullbatch, monkeypatch):
    monkeypatch.setenv("TNF_FULLBATCH_MAX_BYTES", fullbatch)
    monkeypatch.setenv("TNF_GRAM_DTYPE", "f32")
    calls = {}
    for name in ("retile_hmix", "quantize_tiled", "gram_pair_band_q",
                 "gram_pair_tiled_q", "gram_pair", "retile_rows", "weighted_gram",
                 "weighted_gram_tiled", "own_out_gram"):
        fn = getattr(tg, name)

        def wrapper(*a, _fn=fn, _name=name, **k):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **k)
        monkeypatch.setattr(tg, name, wrapper)
    X, Y, (mj, mt), (jloss, tloss) = _sweep_problem(kind)
    jl, tl = mj(), mt()
    p0 = {k: np.asarray(v) for k, v in jl.params.items()}
    kw = dict(num_swipes=1, method=method, max_iter=40, tol=1e-6, batch_size=32,
              eps=1.0)
    js, ts = JSweeper(jl.network, jloss, JConfig(**kw)), Sweeper(tl.network, tloss, SweepConfig(**kw))
    pj, okj = js.run([jl.params], jnp.asarray(X), jnp.asarray(Y))
    pt, okt = ts.run([params_from_numpy(p0, device="cpu")], torch.tensor(X), torch.tensor(Y))
    assert okj and okt
    assert _max_rel(pj[0], params_to_numpy(pt[0])) < 5e-4
    assert set(ts._node_sols) == set(js._node_sols)
    # the kept solutions (the next visit's warm starts), to 5e-4 of their max
    for key, xj in js._node_sols.items():
        xj = np.asarray(xj)
        np.testing.assert_allclose(ts._node_sols[key].numpy(), xj, rtol=0,
                                   atol=5e-4 * np.abs(xj).max())
    first = len(ts.krylov_iters)
    pj, okj = js.run(pj, jnp.asarray(X), jnp.asarray(Y))
    pt, okt = ts.run(pt, torch.tensor(X), torch.tensor(Y))
    assert okj and okt
    assert _max_rel(pj[0], params_to_numpy(pt[0])) < 5e-4
    ks = [int(k) for _, _, k in ts.krylov_iters]
    assert len(ks) == 2 * first and all(0 < k <= 40 for k in ks)
    if method == "lanczos":
        assert set(ks) == {40}
    assert calls == {}


@pytest.mark.parametrize("method", ["cg", "minres", "lanczos"])
def test_warm_start_feeds_the_last_solution(method, monkeypatch):
    """Each node's first Krylov solve starts from zeros; every later one
    from the solution its previous visit kept, bit for bit, across passes
    and runs of the same Sweeper."""
    X, Y, (_, mt), (_, tloss) = _sweep_problem("tt")
    calls = []
    if method == "lanczos":
        real = tk.lanczos_galerkin

        def spy(matvec, b, x0, maxiter=50, tol=1e-6):
            calls.append([x0.clone()])
            x = real(matvec, b, x0, maxiter, tol)
            calls[-1].append(x.clone())
            return x
        monkeypatch.setattr(tk, "lanczos_galerkin", spy)
    else:
        real = tk.SOLVERS[method]

        def spy(matvec, b, x0=None, **kw):
            calls.append([x0.clone()])
            x, k = real(matvec, b, x0=x0, **kw)
            calls[-1].append(x.clone())
            return x, k
        monkeypatch.setitem(tk.SOLVERS, method, spy)
    tl = mt()
    ts = Sweeper(tl.network, tloss, SweepConfig(num_swipes=1, method=method,
                                                max_iter=20, batch_size=32, eps=1.0))
    params = [tl.params]
    for _ in range(2):
        params, ok = ts.run(params, torch.tensor(X), torch.tensor(Y))
        assert ok
    last = {}
    for (_, name, _), (x0, x) in zip(ts.krylov_iters, calls):
        if name in last:
            assert torch.equal(x0, last[name])
        else:
            assert not x0.any()
        last[name] = x
    assert len(calls) == len(ts.krylov_iters) > len(last)


# A non-finite input: lanczos and gradient steps turn non-finite, so both
# packages report False and keep every node at its old value, the
# matrix-free branch keeping zeros as warm starts; CG's and MINRES's stopping
# tests read False on a NaN residual, so their loops end at once at x0 = 0
# and the swipe reports True, again in both packages.
@pytest.mark.parametrize("method,ok", [("lanczos", False), ("gradient", False),
                                       ("cg", True), ("minres", True)])
def test_singular_iterative_swipe_matches_jax(method, ok):
    import warnings
    X, Y, (mj, mt), (jloss, tloss) = _sweep_problem("tt")
    X[0, 0] = np.nan
    jl, tl = mj(), mt()
    p0 = {k: np.asarray(v) for k, v in jl.params.items()}
    kw = dict(num_swipes=1, method=method, max_iter=10, batch_size=32, eps=1.0,
              lr=0.05 if method == "gradient" else 1.0)
    ts = Sweeper(tl.network, tloss, SweepConfig(**kw))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        pj, okj = JSweeper(jl.network, jloss, JConfig(**kw)).run(
            [jl.params], jnp.asarray(X), jnp.asarray(Y))
        pt, okt = ts.run([params_from_numpy(p0, device="cpu")], torch.tensor(X),
                         torch.tensor(Y))
    assert okj is ok and okt is ok
    for k in p0:
        np.testing.assert_array_equal(params_to_numpy(pt[0])[k], p0[k])
        np.testing.assert_array_equal(np.asarray(pj[0][k]), p0[k])
    assert all(not x.any() for x in ts._node_sols.values())


def test_gradient_method_matches_jax_and_descends():
    """tests/test_sweep_semantics.py's gradient problem: four swipes of
    per-chunk steps (lr 0.05, adaptive step) in both packages. The loss
    falls, the callbacks' losses agree within 1e-5 relative and the params
    within 1e-5 of their max (f32 in another order; measured ~1e-7)."""
    rng = np.random.default_rng(0)
    S, f = 128, 4
    X = np.concatenate([rng.standard_normal((S, f - 1)), np.ones((S, 1))],
                       axis=1).astype(np.float32)
    y = (X[:, 0] * X[:, 1] + X[:, 2]).reshape(S, 1).astype(np.float32)
    jl = JTT(2, 3, 4, output_shape=(1,), seed=3)
    tl = TTT(2, 3, 4, output_shape=(1,), seed=3, device="cpu")
    p0 = {k: np.asarray(v) for k, v in jl.params.items()}
    kw = dict(num_swipes=4, method="gradient", lr=0.05, batch_size=32,
              adaptive_step=True)
    lj, lt = [], []
    pj, okj = JSweeper(jl.network, jb.SquareBregFunction(), JConfig(**kw)).run(
        [jl.params], jnp.asarray(X), jnp.asarray(y),
        loss_callback=lambda ns, n, l: lj.append(l))
    pt, okt = Sweeper(tl.network, tb.SquareBregFunction(), SweepConfig(**kw)).run(
        [params_from_numpy(p0, device="cpu")], torch.tensor(X), torch.tensor(y),
        loss_callback=lambda ns, n, l: lt.append(l))
    assert okj and okt
    assert lt[-1] < lt[0], lt
    np.testing.assert_allclose(lt, lj, rtol=1e-5)
    assert _max_rel(pj[0], params_to_numpy(pt[0])) < 1e-5


def test_gradient_method_never_merges_and_forms_no_A(monkeypatch):
    """The gradient branch updates chunk by chunk even when the full batch
    would merge, and forms b alone: gram_and_rhs is never called."""
    from tensornetworksfork_tpu_torch.core.engine import Network
    monkeypatch.setenv("TNF_FULLBATCH_MAX_BYTES", "")
    called = []
    monkeypatch.setattr(Network, "gram_and_rhs",
                        lambda *a, **k: called.append(1))
    rng = np.random.default_rng(1)
    X = torch.tensor(rng.standard_normal((96, 4)).astype(np.float32))
    y = torch.tensor(rng.standard_normal((96, 1)).astype(np.float32))
    tl = TTT(2, 2, 4, output_shape=(1,), seed=0, device="cpu")
    steps = []
    real = Network.rhs
    monkeypatch.setattr(Network, "rhs",
                        lambda self, *a: steps.append(1) or real(self, *a))
    _, ok = Sweeper(tl.network, tb.SquareBregFunction(),
                    SweepConfig(num_swipes=1, method="gradient", lr=0.01,
                                batch_size=32, skip_second=True)).run(
        [tl.params], X, y)
    assert ok and not called
    assert len(steps) == 2 * 3  # two nodes, three 32-sample chunks each


# ------------------------------------------------------------ train_image
PRESET_KEYS = ("DATASET", "METHOD", "KERNEL_SIZE", "KERNEL_STRIDE", "BATCH_SIZE",
               "MAX_ITER", "TNF_GRAM_DTYPE", "TNF_AUX_PRECISION")


def _clear_preset(monkeypatch):
    # set, then delete: monkeypatch then restores each variable's absence,
    # which the preset's setdefault would otherwise leave set
    for k in PRESET_KEYS + ("PRESET", "RESULTS_FILE", "DEVICE"):
        monkeypatch.setenv(k, "")
        monkeypatch.delenv(k)


def test_cifar_minres_preset_resolves_as_in_jax(monkeypatch):
    """PRESET=cifar_minres gives the JAX package's train_image configuration key for key
    and the same TNF_* variables, and leaves variables the caller set."""
    from tensornetworksfork_tpu.experiments import train_image as jti
    from tensornetworksfork_tpu_torch.experiments import train_image as tti
    assert tti.PRESETS == jti.PRESETS
    _clear_preset(monkeypatch)
    monkeypatch.setenv("PRESET", "cifar_minres")
    t = tti.get_config_from_env()
    env_t = {k: os.environ.get(k) for k in PRESET_KEYS}
    _clear_preset(monkeypatch)
    monkeypatch.setenv("PRESET", "cifar_minres")
    j = jti.get_config_from_env()
    env_j = {k: os.environ.get(k) for k in PRESET_KEYS}
    assert env_t == env_j
    assert set(t) - set(j) == {"device"}
    for k in j:
        if k != "results_file":
            assert t[k] == j[k], k
    assert (t["dataset"], t["method"], t["kernel_size"], t["kernel_stride"],
            t["batch_size"], t["max_iter"]) == ("CIFAR10", "minres", 8, 8, 4096, 50)
    _clear_preset(monkeypatch)
    monkeypatch.setenv("PRESET", "cifar_minres")
    monkeypatch.setenv("METHOD", "cg")
    assert tti.get_config_from_env()["method"] == "cg"
    monkeypatch.setenv("PRESET", "nope")
    with pytest.raises(ValueError, match="cifar_minres"):
        tti.get_config_from_env()


def test_train_image_runs_minres(monkeypatch, tmp_path):
    """A tiny train_image run in METHOD=minres on the CPU (N=2, r=4, CB=2,
    384 synthetic MNIST-shaped samples, one swipe): every update a MINRES
    solve, finite results above chance, and the row written."""
    from tensornetworksfork_tpu_torch.experiments import train_image as tti
    _clear_preset(monkeypatch)
    for k, v in dict(N="2", R="4", CB="2", NUM_SWIPES="1", EARLY_STOPPING="100",
                     SYNTHETIC_SAMPLES="384", BATCH_SIZE="128", VERBOSE="0",
                     METHOD="minres", MAX_ITER="20", DEVICE="cpu",
                     DATA_PATH=str(tmp_path / "none"),
                     RESULTS_FILE=str(tmp_path / "rows.csv")).items():
        monkeypatch.setenv(k, v)
    seen = []
    real = tti.Sweeper

    def recording(*a, **k):
        seen.append(real(*a, **k))
        return seen[-1]
    monkeypatch.setattr(tti, "Sweeper", recording)
    config = tti.get_config_from_env()
    res = tti.train_model(config)
    assert res["method"] == "minres" and not res["singular"]
    assert res["test_accuracy"] > 100.0 / 10
    ks = [int(k) for _, _, k in seen[0].krylov_iters]
    # members of 1 and 2 carriages: 2 + 4 train nodes, each once a pass,
    # less the junction node skipped by the second pass of each member
    assert len(ks) >= 8 and all(0 < k <= 20 for k in ks)
