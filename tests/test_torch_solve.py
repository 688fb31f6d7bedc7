"""The port's block solves (`core/solve.py`) against the JAX package's: the
f32 tier, the float64 tier (on the operands' device in the port, on the
host through a callback in the JAX package), `ridge_trace` and `gradient`;
the eps ladder of tests/test_eps_ladder.py run on the port, and its
end-to-end estimator tests, the solve_dtype hint included.

Inputs come from numpy seeds; the estimators' weights are made by the JAX
package and copied across (`utils/convert.py`).
"""
import warnings

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from tensornetworksfork_tpu.core.solve import solve_block as jsolve  # noqa: E402
from tensornetworksfork_tpu_torch.core.solve import solve_block  # noqa: E402
from tensornetworksfork_tpu_torch.utils.convert import params_from_numpy  # noqa: E402

EPS_LADDER = [1e-3, 1e-6, 1e-9, 1e-12]


def _spd(D, cond_exp, seed):
    """SPD with eigenvalues logspace(0, -cond_exp) (tests/test_eps_ladder.py)."""
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((D, D)))
    ev = np.logspace(0.0, -cond_exp, D)
    A = (Q * ev) @ Q.T
    return (A + A.T) / 2.0


def _oracle(A32, b32, eps):
    """numpy-f64 oracle of solve_block's semantics (diagonal-mean rescale,
    then the 2 eps ridge) on the f32-cast system."""
    A = np.asarray(A32, np.float64)
    b = np.asarray(b32, np.float64)
    s = np.abs(np.diag(A)).mean()
    A, b = A / s, b / s
    A = A + 2.0 * eps * np.eye(A.shape[0])
    return np.linalg.solve(A, -b)


def _system(D, cond_exp, seed, bseed=None):
    A64 = _spd(D, cond_exp, seed)
    rng = np.random.default_rng(seed + 100 if bseed is None else bseed)
    b64 = -(A64 @ rng.standard_normal(D))
    return A64.astype(np.float32), b64.astype(np.float32)


def _ladder_errors(cond_exp=8.0, D=64, seed=0, **solve_kw):
    A, b = _system(D, cond_exp, seed)
    out = {}
    for eps in EPS_LADDER:
        xo = _oracle(A, b, eps)
        st, ok = solve_block(torch.tensor(A), torch.tensor(b), torch.zeros(D),
                             "ridge_cholesky", eps, **solve_kw)
        err = float(np.linalg.norm(st.double().numpy() - xo) / np.linalg.norm(xo))
        out[eps] = (err, bool(ok))
    return out


class TestLadderVsOracle:
    """tests/test_eps_ladder.py's ladder, its inputs and bounds, on the port."""

    def test_f32_tier_tracks_cond_and_saturates(self):
        errs = _ladder_errors()
        assert errs[1e-3][1] and errs[1e-3][0] < 1e-3
        assert errs[1e-9][0] > 1e-2
        assert errs[1e-12][0] > 1e-2
        assert errs[1e-12][0] == pytest.approx(errs[1e-9][0], rel=0.5)

    def test_refine_does_not_beat_the_floor(self):
        base = _ladder_errors()
        ref = _ladder_errors(refine=True)
        assert ref[1e-3][0] < 5 * base[1e-3][0]
        assert ref[1e-12][0] > 1e-2

    def test_f64_tier_tracks_oracle_at_every_eps(self):
        errs = _ladder_errors(solve_dtype="float64")
        for eps in EPS_LADDER:
            err, ok = errs[eps]
            assert ok, f"f64 tier not ok at eps={eps}"
            assert err < 1e-6, f"f64 tier err {err} at eps={eps}"

    def test_fixed_corner_f32_fails_f64_solves(self):
        """cond ~ 1e9, eps = 1e-12: the f32 Cholesky fails (ok False), the
        float64 tier factors the same system and meets the oracle."""
        D = 96
        A, b = _system(D, 9.0, seed=2, bseed=3)
        At, bt, nv = torch.tensor(A), torch.tensor(b), torch.zeros(D)
        _, ok32 = solve_block(At, bt, nv, "ridge_cholesky", 1e-12)
        assert not bool(ok32)
        st, ok64 = solve_block(At, bt, nv, "ridge_cholesky", 1e-12,
                               solve_dtype="float64")
        assert bool(ok64)
        xo = _oracle(A, b, 1e-12)
        assert np.linalg.norm(st.double().numpy() - xo) / np.linalg.norm(xo) < 1e-5

    def test_f64_ridge_semantics_match_f32_in_supported_regime(self):
        errs32 = _ladder_errors(cond_exp=3.0, seed=5)
        errs64 = _ladder_errors(cond_exp=3.0, seed=5, solve_dtype="float64")
        assert abs(errs32[1e-3][0] - errs64[1e-3][0]) < 1e-4

    def test_ridge_trace_and_exact_methods_f64(self):
        D = 32
        A, b = _system(D, 4.0, seed=7, bseed=8)
        nv = np.random.default_rng(8).standard_normal(D).astype(np.float32)
        At, bt, nt = torch.tensor(A), torch.tensor(b), torch.tensor(nv)
        for method in ("ridge_exact", "ridge_trace", "exact", "cholesky"):
            s32, ok32 = solve_block(At, bt, nt, method, 1e-4)
            s64, ok64 = solve_block(At, bt, nt, method, 1e-4, solve_dtype="float64")
            assert bool(ok32) and bool(ok64)
            # f32 against f64 arithmetic at cond ~1e4: ~cond * u_f32
            np.testing.assert_allclose(s32.numpy(), s64.numpy(), rtol=1e-2, atol=1e-4)

    @pytest.mark.parametrize("solve_dtype", ["bf16", "float16"])
    def test_bad_solve_dtype_rejected(self, solve_dtype):
        with pytest.raises(ValueError, match="solve_dtype"):
            solve_block(torch.eye(4), torch.ones(4), torch.ones(4),
                        "ridge_cholesky", 1e-3, solve_dtype=solve_dtype)

    def test_complex_system_rejected_in_f64(self):
        A = torch.eye(4, dtype=torch.complex64)
        with pytest.raises(ValueError, match="real systems"):
            solve_block(A, torch.ones(4, dtype=torch.complex64),
                        torch.ones(4, dtype=torch.complex64), "ridge_cholesky",
                        1e-3, solve_dtype="float64")


# Port against JAX, same f32 system. f32 tier: the same f32 arithmetic in
# another library (~cond * 2^-24 of the step; cond ~1e4 here), held to 1e-3
# of max|step|. f64 tier: float64 in both (another LAPACK), each step then
# rounded to f32, so within 2 f32 ulps of max|step|.
@pytest.mark.parametrize("solve_dtype,rtol", [(None, 1e-3), ("float64", 2.5e-7)])
@pytest.mark.parametrize("method", ["exact", "ridge_exact", "ridge_cholesky",
                                    "cholesky", "ridge_trace", "gradient"])
def test_solve_block_matches_jax(method, solve_dtype, rtol):
    D = 48
    A, b = _system(D, 4.0, seed=11, bseed=12)
    nv = np.random.default_rng(13).standard_normal(D).astype(np.float32)
    sj, okj = jsolve(jnp.asarray(A), jnp.asarray(b), jnp.asarray(nv), method,
                     1e-3, solve_dtype=solve_dtype)
    st, okt = solve_block(torch.tensor(A), torch.tensor(b), torch.tensor(nv),
                          method, 1e-3, solve_dtype=solve_dtype)
    assert bool(okj) and bool(okt)
    assert st.dtype == torch.float32
    sj = np.asarray(sj)
    np.testing.assert_allclose(st.numpy(), sj, rtol=0, atol=rtol * np.abs(sj).max())
    if method == "gradient":
        np.testing.assert_array_equal(st.numpy(), -b)


@pytest.mark.parametrize("solve_dtype", [None, "float64"])
def test_ridge_trace_scales_eps_by_the_rhs(solve_dtype):
    """ridge_trace is ridge_exact with eps scaled by |b|^2 of the rescaled
    rhs (JAX solve.py, the ridge_trace branch)."""
    D = 24
    A, b = _system(D, 3.0, seed=21, bseed=22)
    nv = np.random.default_rng(23).standard_normal(D).astype(np.float32)
    scale = np.abs(np.diag(A.astype(np.float64))).mean()
    eps_eff = 1e-2 * float(np.sum((b.astype(np.float64) / scale) ** 2))
    st, _ = solve_block(torch.tensor(A), torch.tensor(b), torch.tensor(nv),
                        "ridge_trace", 1e-2, solve_dtype=solve_dtype)
    se, _ = solve_block(torch.tensor(A), torch.tensor(b), torch.tensor(nv),
                        "ridge_exact", eps_eff, solve_dtype=solve_dtype)
    np.testing.assert_allclose(st.numpy(), se.numpy(), rtol=0,
                               atol=1e-5 * np.abs(se.numpy()).max())


def test_f64_cholesky_reads_one_triangle_and_mirrored_grams_agree():
    """The float64 tier reads the upper triangle, as scipy's cho_factor in
    the JAX package does; the f32 tier reads the lower one. For a mirrored
    A (every Gram the sweep hands to a solve is one) the two triangles give
    the same step bit for bit; the control, an A whose triangles differ,
    shows that only the upper one is read."""
    D = 40
    A, b = _system(D, 3.0, seed=31, bseed=32)
    A = np.triu(A) + np.triu(A, 1).T  # mirrored
    At, bt, nv = torch.tensor(A), torch.tensor(b), torch.zeros(D)
    up, ok = solve_block(At, bt, nv, "ridge_cholesky", 1e-4, solve_dtype="float64")
    assert bool(ok)
    # the lower triangle's step, with the tier's own rescale and ridge
    A64, b64 = At.double(), bt.double()
    s = A64.diagonal().abs().mean()
    M = A64 / s
    M.diagonal().add_(2.0 * float(np.float32(1e-4)))
    L, info = torch.linalg.cholesky_ex(M)
    low = torch.cholesky_solve(-(b64 / s)[:, None], L)[:, 0].float()
    assert int(info) == 0
    assert torch.equal(up, low)
    # control: garbage below the diagonal changes nothing
    bad = At.clone()
    bad[torch.tril_indices(D, D, -1).unbind()] = 7.0
    up_bad, _ = solve_block(bad, bt, nv, "ridge_cholesky", 1e-4, solve_dtype="float64")
    assert torch.equal(up_bad, up)


def test_f64_tier_reads_the_jax_triangle_on_sweep_grams(monkeypatch):
    """Not every Gram the sweep solves is exactly symmetric: the plain
    routes (the CPU's, and the JAX package's off a TPU) and the own-out
    route sum A[i, j] and A[j, i] in other orders. So each tier reads the
    triangle its JAX counterpart reads. On the Grams of a tiny conv-TT
    swipe the float64 tier meets the JAX package's host tier within 2 f32
    ulps of max|step|; the control, the same solve from the lower triangle,
    misses it on at least one of them."""
    from tensornetworksfork_tpu_torch.core import sweep as tsweep
    from tensornetworksfork_tpu_torch.core.sweep import SweepConfig, Sweeper
    from tensornetworksfork_tpu_torch.models.layers import TensorConvolutionTrainLayer
    from tensornetworksfork_tpu_torch.ops.bregman import XEBregman

    monkeypatch.setenv("TNF_GRAM_DTYPE", "f32")
    rng = np.random.default_rng(41)
    X = torch.tensor(rng.standard_normal((64, 5, 4)).astype(np.float32))
    Y = torch.tensor(np.eye(4, dtype=np.float32)[rng.integers(0, 4, 64)])
    seen = []
    real = tsweep.solve_block

    def recording(A, b, *args, **kw):
        seen.append((A.reshape(b.numel(), b.numel()).clone(), b.reshape(-1).clone()))
        return real(A, b, *args, **kw)

    monkeypatch.setattr(tsweep, "solve_block", recording)
    layer = TensorConvolutionTrainLayer(3, 3, 5, 4, output_shape=(3,),
                                        convolution_bond=2, seed=0, device="cpu")
    Sweeper(layer.network, XEBregman(1.0),
            SweepConfig(num_swipes=1, batch_size=32, eps=1.0)).run([layer.params], X, Y)
    assert len(seen) >= 10
    assert not all(torch.equal(A, A.T) for A, _ in seen)
    misses = []
    for A, b in seen:
        nv = torch.zeros_like(b)
        sj, _ = jsolve(jnp.asarray(A.numpy()), jnp.asarray(b.numpy()),
                       jnp.asarray(nv.numpy()), "ridge_cholesky", 1e-6,
                       solve_dtype="float64")
        sj = np.asarray(sj)
        tol = 2.5e-7 * np.abs(sj).max()
        st, _ = real(A, b, nv, "ridge_cholesky", 1e-6, solve_dtype="float64")
        np.testing.assert_allclose(st.numpy(), sj, rtol=0, atol=tol)
        lower = torch.tril(A) + torch.tril(A, -1).T
        sl, _ = real(lower, b, nv, "ridge_cholesky", 1e-6, solve_dtype="float64")
        misses.append(np.abs(sl.numpy() - sj).max() > tol)
    assert any(misses)


def test_failed_factorisation_gives_nan_and_not_ok():
    """An indefinite A fails the f64 Cholesky and a singular one the f64 LU:
    the step is NaN and ok False (the JAX package's LinAlgError path)."""
    A = torch.diag(torch.tensor([1.0, -1.0, 2.0, 3.0]))
    b, nv = torch.ones(4), torch.zeros(4)
    st, ok = solve_block(A, b, nv, "cholesky", 0.0, solve_dtype="float64")
    assert not bool(ok) and torch.isnan(st).all()
    S = torch.zeros(4, 4)
    S[0, 0] = 1.0
    st, ok = solve_block(S, b, nv, "exact", 0.0, solve_dtype="float64")
    assert not bool(ok) and torch.isnan(st).all()


class TestEndToEnd:
    """tests/test_eps_ladder.py's TestEndToEnd on the port's estimator."""

    @staticmethod
    def _collinear_problem():
        rng = np.random.default_rng(11)
        X = rng.standard_normal((128, 4))
        X[:, 3] = X[:, 2] + 1e-5 * rng.standard_normal(128)  # near-collinear
        y = X @ np.array([1.0, -2.0, 0.5, 0.5]) + 0.01 * rng.standard_normal(128)
        return X, y

    def test_estimator_f32_fails_at_deep_eps_with_hint(self):
        """eps = 1e-12 on a near-collinear problem: the f32 sweep reports a
        singular solve and warns with the solve_dtype hint."""
        from tensornetworksfork_tpu_torch.models.estimators import TensorTrainRegressor
        X, y = self._collinear_problem()
        m = TensorTrainRegressor(N=2, r=3, num_swipes=4, eps_start=1e-12,
                                 eps_decay=1.0, early_stopping=0, verbose=0,
                                 device="cpu")
        with pytest.warns(RuntimeWarning, match="solve_dtype"):
            m.fit(X, y, validation_split=0.2)
        assert m.fit_ok_ is False

    def test_estimator_solve_dtype_survives_deep_eps(self):
        """Same problem in solve_dtype='float64': no singular solve and no
        warning at eps = 1e-12; at eps = 1e-6 the fit converges."""
        from tensornetworksfork_tpu_torch.models.estimators import TensorTrainRegressor
        X, y = self._collinear_problem()
        m = TensorTrainRegressor(N=2, r=3, num_swipes=4, eps_start=1e-12,
                                 eps_decay=1.0, solve_dtype="float64",
                                 early_stopping=0, verbose=0, device="cpu")
        with warnings.catch_warnings():
            warnings.simplefilter("error", RuntimeWarning)
            m.fit(X, y, validation_split=0.2)
        assert np.isfinite(m.predict(X)).all()

        m2 = TensorTrainRegressor(N=2, r=3, num_swipes=10, eps_start=1e-6,
                                  eps_decay=1.0, solve_dtype="float64",
                                  early_stopping=0, verbose=0, device="cpu")
        m2.fit(X, y, validation_split=0.2)
        pred = m2.predict(X).ravel()
        ss = 1 - ((pred - y) ** 2).sum() / ((y - y.mean()) ** 2).sum()
        assert ss > 0.9

    def test_estimator_refine_plumbed(self):
        from tensornetworksfork_tpu_torch.models.estimators import TensorTrainRegressor
        rng = np.random.default_rng(12)
        X = rng.standard_normal((64, 3))
        y = X.sum(axis=1)
        m = TensorTrainRegressor(N=2, r=2, num_swipes=2, refine=True,
                                 early_stopping=0, verbose=0, device="cpu")
        m.fit(X, y, validation_split=0.2)
        assert np.isfinite(m.predict(X)).all()

    # The float64 fits from the JAX package's init in both packages, ten
    # swipes. Their Grams are summed in f32 in another order than XLA's,
    # and the float64 solve carries that rounding times the system's
    # condition: at eps = 1e-3 the predictions agree to 8.8e-7 of max|pred|
    # (held to 1e-5), at eps = 1e-6 on this near-collinear table to 3.4e-4
    # (held to 2e-3).
    @pytest.mark.parametrize("eps,rtol", [(1e-3, 1e-5), (1e-6, 2e-3)])
    def test_f64_fit_matches_jax(self, eps, rtol, monkeypatch):
        from tensornetworksfork_tpu.models.estimators import TensorTrainRegressor as JEst
        from tensornetworksfork_tpu_torch.models.estimators import TensorTrainRegressor
        monkeypatch.setenv("TNF_FIT_PRECOMPILE", "0")
        X, y = self._collinear_problem()
        args = dict(N=2, r=3, num_swipes=10, eps_start=eps, eps_decay=1.0,
                    solve_dtype="float64", early_stopping=0, verbose=0)
        je, te = JEst(**args), TensorTrainRegressor(**args, device="cpu")
        for e in (je, te):
            e.input_dim = X.shape[1] + 1
            e._initialize_model()
        te._model.params = params_from_numpy(je._model.params, device="cpu")
        je.fit(X, y, validation_split=0.2)
        te.fit(X, y, validation_split=0.2)
        pj, pt = np.asarray(je.predict(X)), te.predict(X)
        np.testing.assert_allclose(pt, pj, rtol=0, atol=rtol * np.abs(pj).max())

    def test_flush_warning_silent_in_f64_tier(self):
        """A singular solve in the float64 tier still reports False, with no
        f32 hint (the JAX package warns only when solve_dtype is None)."""
        from tensornetworksfork_tpu_torch.core.sweep import SweepConfig, Sweeper
        from tensornetworksfork_tpu_torch.models.layers import TensorTrainLayer
        from tensornetworksfork_tpu_torch.ops.bregman import SquareBregFunction
        rng = np.random.default_rng(5)
        X = torch.tensor(rng.standard_normal((32, 3)).astype(np.float32))
        X[0, 0] = float("nan")
        y = torch.tensor(rng.standard_normal((32, 1)).astype(np.float32))
        layer = TensorTrainLayer(2, 2, 3, output_shape=(1,), seed=0, device="cpu")
        for dtype, hint in (("float64", False), (None, True)):
            sw = Sweeper(layer.network, SquareBregFunction(),
                         SweepConfig(num_swipes=1, eps=1e-3, solve_dtype=dtype))
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                _, ok = sw.run([dict(layer.params)], X, y)
            assert ok is False
            assert any("solve_dtype" in str(w.message) for w in caught) is hint
