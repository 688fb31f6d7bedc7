"""Readings behind two repairs of the port's tests and the GP kernel cells
left out of `experiments/kernel_baselines.py` KERNEL_OPTIONS, on the CPU.

    python studies/port_repairs_study.py ridge [threads ...]
        The polynomial ridge (degree 3, alpha 0.5) on every zoo table and
        seed of tests/test_torch_zoo_eval.py: the port's and the JAX
        package's (sklearn's) predictions against a float64 solve, as a
        share of max|pred|, at each torch / BLAS thread count (default 1 8);
        then the pseudo-inverse and the Lasso (degree 2) likewise.
    python studies/port_repairs_study.py high [threads ...]
        Network(precision="high") swiped as tests/test_torch_aux.py swipes
        it: each of the port's bf16x3 products against the test fixture's
        bf16x3 of the same operands; the predictions of the port (its swipe
        at each torch thread count, default 1 8), of the JAX package under
        jit and op by op (jax.disable_jit()), and of a float64 swipe at
        HIGHEST, as shares of max|pred|. XLA's own threads are set by
        XLA_FLAGS before the run.
    python studies/port_repairs_study.py cells [--digits]
        The two diabetes kernels out of KERNEL_OPTIONS: sklearn's fitted θ
        and lml at one and eight BLAS threads, on the float32 split and on
        its float64 copy, beside the port's; the port's free-kernel
        classifier on breast_cancer against sklearn's; with --digits, the
        seconds of sklearn's one-thread fit of digits under a free C * RBF.

Needs the JAX package, sklearn and threadpoolctl. Run from the
repository's root.
"""
import functools
import os
import sys
import time
import warnings

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _zoo_data(name, seed):
    """tests/test_torch_zoo_eval.py's split of a zoo table."""
    from tensornetworksfork_tpu_torch.data import tabular as ttab
    if name == "synthetic":
        from tensornetworksfork_tpu_torch.data.synthetic import make_regression
        X, y = make_regression(S=4096, d=6, degree=3, seed=seed)
        return ttab.split_train_val_test(X, y, seed=seed), "regression"
    d = ttab.load_sklearn_dataset(name, seed=seed)
    return d, d.pop("task")


def _float64_ridge(X, Y, Xt, alpha, degree):
    import torch
    from tensornetworksfork_tpu_torch.models.baselines import polynomial_features
    Xp = polynomial_features(torch.tensor(X, dtype=torch.float64), degree)
    Tp = polynomial_features(torch.tensor(Xt, dtype=torch.float64), degree)
    Y = torch.tensor(Y, dtype=torch.float64)
    Xc, Yc = Xp - Xp.mean(0), Y - Y.mean(0)
    n, p = Xc.shape
    eye = torch.eye(min(n, p), dtype=Xc.dtype)
    coef = (Xc.T @ torch.linalg.solve(Xc @ Xc.T + alpha * eye, Yc) if p > n
            else torch.linalg.solve(Xc.T @ Xc + alpha * eye, Xc.T @ Yc))
    return (Tp @ coef + (Y.mean(0) - Xp.mean(0) @ coef)).numpy()


def ridge(threads):
    import torch
    from sklearn.linear_model import Lasso
    from sklearn.preprocessing import PolynomialFeatures
    from threadpoolctl import threadpool_limits
    from tensornetworksfork_tpu.models.baselines import PolynomialRegressionWrapper as JP
    from tensornetworksfork_tpu_torch.models.baselines import PolynomialRegressionWrapper as TP
    for t in threads:
        torch.set_num_threads(t)
        with threadpool_limits(t):
            for name in ("iris", "wine", "breast_cancer", "diabetes", "synthetic"):
                for seed in (42, 43, 44):
                    d, task = _zoo_data(name, seed)
                    y = d["y_train"]
                    if task == "classification":
                        y = np.eye(int(y.max()) + 1, dtype=np.float32)[
                            y.reshape(-1).astype(int)]
                    Xt = d["X_test"]
                    with warnings.catch_warnings():
                        warnings.simplefilter("ignore")
                        pj = np.asarray(JP(degree=3, regularization="l2", alpha=0.5)
                                        .fit(d["X_train"], y).predict(Xt))
                    pt = TP(degree=3, regularization="l2", alpha=0.5, device="cpu").fit(
                        d["X_train"], y).predict(Xt)
                    f64 = _float64_ridge(d["X_train"], y, Xt, 0.5, 3).reshape(pj.shape)
                    s = np.abs(pj).max()
                    print(f"threads {t} {name:13s} {seed}: sklearn-f64 "
                          f"{np.abs(pj - f64).max() / s:.3g}, port-f64 "
                          f"{np.abs(pt - f64).max() / s:.3g}, port-sklearn "
                          f"{np.abs(pt - pj).max() / s:.3g} (test bound "
                          f"{1e-4 + np.abs(pj - f64).max() / s:.3g})")
            # the pseudo-inverse and the Lasso (degree 2, alpha 0.01), each
            # against numpy's / sklearn's fit of the float64 features
            for name in ("iris", "diabetes", "synthetic"):
                d, task = _zoo_data(name, 42)
                y = d["y_train"]
                if task == "classification":
                    y = np.eye(int(y.max()) + 1, dtype=np.float32)[y.reshape(-1).astype(int)]
                P = PolynomialFeatures(2)
                Xp = P.fit_transform(d["X_train"].astype(np.float64))
                Tp = P.transform(d["X_test"].astype(np.float64))
                for reg in (None, "l1"):
                    with warnings.catch_warnings():
                        warnings.simplefilter("ignore")
                        pj = np.asarray(JP(degree=2, regularization=reg, alpha=0.01)
                                        .fit(d["X_train"], y).predict(d["X_test"]))
                        f64 = (Tp @ (np.linalg.pinv(Xp) @ y.astype(np.float64)) if reg is None
                               else Lasso(alpha=0.01).fit(Xp, y.astype(np.float64)).predict(Tp))
                    pt = TP(degree=2, regularization=reg, alpha=0.01, device="cpu").fit(
                        d["X_train"], y).predict(d["X_test"])
                    s = np.abs(pj).max()
                    f64 = f64.reshape(pj.shape)
                    print(f"threads {t} {name:13s} 42 {reg or 'pinv'}: sklearn-f64 "
                          f"{np.abs(pj - f64).max() / s:.3g}, port-f64 "
                          f"{np.abs(pt - f64).max() / s:.3g}")


def high(threads):
    import jax
    import jax.numpy as jnp
    import torch
    from tensornetworksfork_tpu.core.engine import Network as JNetwork
    from tensornetworksfork_tpu.core.sweep import SweepConfig as JConfig
    from tensornetworksfork_tpu.core.sweep import Sweeper as JSweeper
    from tensornetworksfork_tpu.models.layers import TensorConvolutionTrainLayer as JLayer
    from tensornetworksfork_tpu.ops.bregman import XEBregman as JXE
    from tensornetworksfork_tpu_torch.core import contract as tcon
    from tensornetworksfork_tpu_torch.core.engine import Network
    from tensornetworksfork_tpu_torch.core.sweep import SweepConfig, Sweeper
    from tensornetworksfork_tpu_torch.models.layers import TensorConvolutionTrainLayer as TLayer
    from tensornetworksfork_tpu_torch.ops.bregman import XEBregman as TXE
    from tensornetworksfork_tpu_torch.utils.convert import params_from_numpy
    jax.config.update("jax_platforms", "cpu")
    os.environ.pop("TNF_AUX_PRECISION", None)
    os.environ["TNF_GRAM_DTYPE"] = "f32"
    orig = jax.lax.dot_general

    def bf16(x):
        return x.astype(jnp.bfloat16).astype(jnp.float32) if x.dtype == jnp.float32 else x

    def is_(p, want):
        if isinstance(p, (tuple, list)):
            return len(p) > 0 and all(q == want for q in p)
        return p == want

    def dot(lhs, rhs, dimension_numbers, precision=None, preferred_element_type=None, **kw):
        """tests/test_torch_aux.py's tpu_default_dots."""
        def one(a, b):
            return orig(a, b, dimension_numbers, jax.lax.Precision.HIGHEST,
                        preferred_element_type=preferred_element_type, **kw)
        if is_(precision, jax.lax.Precision.DEFAULT):
            return one(bf16(lhs), bf16(rhs))
        if is_(precision, jax.lax.Precision.HIGH) and jnp.float32 in (lhs.dtype, rhs.dtype):
            lh, rh = bf16(lhs), bf16(rhs)
            ll, rl = bf16(lhs - lh), bf16(rhs - rh)
            return one(lh, rh) + (one(lh, rl) + one(ll, rh))
        return orig(lhs, rhs, dimension_numbers, precision,
                    preferred_element_type=preferred_element_type, **kw)

    jax.lax.dot_general = dot
    jnp.einsum = functools.partial(jnp.einsum, _dot_general=dot)
    products = []
    bf16_products = tcon._bf16_products

    def recorded(a, b, precision, fn):
        out = bf16_products(a, b, precision, fn)
        products.append((a.clone(), b.clone(), out.clone()))
        return out
    tcon._bf16_products = recorded

    c = dict(N=4, R=4, CB=2, P=6, PP=5, C=3, S=64, B=32)      # the test's SW
    jl = JLayer(c["N"], c["R"], c["P"], c["PP"], output_shape=(c["C"],),
                convolution_bond=c["CB"], seed=1)
    tl = TLayer(c["N"], c["R"], c["P"], c["PP"], output_shape=(c["C"],),
                convolution_bond=c["CB"], seed=1, device="cpu")
    rng = np.random.default_rng(1)
    X = rng.standard_normal((c["S"], c["P"], c["PP"])).astype(np.float32)
    Y = np.eye(c["C"] + 1, dtype=np.float32)[rng.integers(0, c["C"] + 1, c["S"])]
    cfg = dict(num_swipes=1, batch_size=c["B"], method="ridge_cholesky", eps=5.0)

    def jax_swipe(precision, dtype=jnp.float32):
        net = JNetwork(jl.topology, precision=precision, use_pallas=False)
        p0 = {k: jnp.asarray(np.asarray(v), dtype=dtype) for k, v in jl.params.items()}
        Xj = jnp.asarray(X, dtype=dtype)
        p, _ = JSweeper(net, JXE(1.0), JConfig(**cfg)).run([p0], Xj, jnp.asarray(Y, dtype))
        return np.asarray(net.forward(p[0], Xj))

    pred_j = jax_swipe(jax.lax.Precision.HIGH)
    with jax.disable_jit():
        pred_op = jax_swipe(jax.lax.Precision.HIGH)
    with jax.enable_x64(True):
        pred64 = jax_swipe(jax.lax.Precision.HIGHEST, jnp.float64)
    tnet = Network(tl.topology, device="cpu", precision="high", use_kernels=False)
    s = np.abs(pred_j).max()
    for t in threads:
        torch.set_num_threads(t)
        products.clear()
        p0 = params_from_numpy({k: np.asarray(v) for k, v in jl.params.items()},
                               device="cpu")
        pt, _ = Sweeper(tnet, TXE(1.0), SweepConfig(**cfg)).run([p0], torch.tensor(X),
                                                                torch.tensor(Y))
        pred_t = tnet.forward(pt[0], torch.tensor(X)).numpy()
        print(f"torch on {t} thread(s): predictions / max|pred|: port-JAX "
              f"{np.abs(pred_t - pred_j).max() / s:.3g}, port-float64 "
              f"{np.abs(pred_t - pred64).max() / s:.3g} (JAX-float64 "
              f"{np.abs(pred_j - pred64).max() / s:.3g})")
    worst_port = worst_fixture = 0.0
    for a, b, out in products:
        an, bn = jnp.asarray(a.numpy()), jnp.asarray(b.numpy())
        nb = a.ndim - 2
        dn = (((a.ndim - 1,), (nb,)), (tuple(range(nb)), tuple(range(nb))))
        fixture = np.asarray(dot(an, bn, dn, precision=jax.lax.Precision.HIGH))
        (ah, al), (bh, bl) = tcon.split_bf16(a), tcon.split_bf16(b)
        exact = (ah.double() @ bh.double() + ah.double() @ bl.double()
                 + al.double() @ bh.double()).numpy()
        scale = np.abs(exact).max()
        worst_port = max(worst_port, np.abs(out.numpy() - fixture).max() / scale)
        worst_fixture = max(worst_fixture, np.abs(fixture - exact).max() / scale)
    print(f"{len(products)} bf16x3 products of the port's swipe on {threads[-1]} thread(s): "
          f"port against the fixture on the same operands {worst_port:.3g} of the product's "
          f"max; the fixture against the exact sum of its three products {worst_fixture:.3g}")
    print(f"predictions / max|pred|: JAX jit-op by op {np.abs(pred_j - pred_op).max() / s:.3g}")


def cells(digits):
    import torch
    from sklearn.gaussian_process import GaussianProcessClassifier, GaussianProcessRegressor
    import sklearn.gaussian_process.kernels as skk
    from threadpoolctl import threadpool_limits
    from tensornetworksfork_tpu_torch.experiments import kernel_baselines as kb
    from tensornetworksfork_tpu_torch.models.baselines import GaussianProcessWrapper
    d = kb.table("diabetes")[0]
    kernels = {"C(1) * RBF([1.0] * 10)": lambda: skk.ConstantKernel(1.0) * skk.RBF([1.0] * 10),
               "DotProduct(1) ** 2 + WhiteKernel(1)":
               lambda: skk.DotProduct(sigma_0=1.0) ** 2 + skk.WhiteKernel(1.0)}
    for label, make in kernels.items():
        for dtype in (np.float32, np.float64):
            X = np.asarray(d["X_train"], dtype)
            for t in (1, 8):
                with threadpool_limits(t), warnings.catch_warnings():
                    warnings.simplefilter("ignore")
                    g = GaussianProcessRegressor(kernel=make()).fit(X, d["y_train"])
                print(f"{label}, {np.dtype(dtype).name} split, sklearn on {t} thread(s): "
                      f"theta {np.round(g.kernel_.theta, 6).tolist()}, lml "
                      f"{g.log_marginal_likelihood_value_!r}")
        torch.set_num_threads(1)
        p = GaussianProcessWrapper({"kernel": make()}, device="cpu").fit(
            d["X_train"], d["y_train"])
        print(f"{label}, the port (float64, one thread): theta "
              f"{np.round(p.theta_, 6).tolist()}, lml {p.log_marginal_likelihood_value_!r}")
    # a free-kernel classifier: the port's fit against sklearn's (the CPU
    # tests' GPC_PROBA_ATOL)
    b = kb.table("breast_cancer")[0]
    kernel = skk.ConstantKernel(1.0) * skk.Matern(length_scale=1.0, nu=1.5)
    with threadpool_limits(1):
        g = GaussianProcessClassifier(kernel).fit(b["X_train"], b["y_train"].ravel())
    p = GaussianProcessWrapper({"kernel": kernel}, task="classification", device="cpu").fit(
        b["X_train"], b["y_train"])
    print(f"breast_cancer under C * Matern(1.5), the port against sklearn: theta "
          f"{np.abs(p.theta_ - g.kernel_.theta).max():.3g} apart, probabilities "
          f"{np.abs(p.predict_proba(b['X_test']) - g.predict_proba(b['X_test'])).max():.3g}")
    if digits:
        dd = kb.table("digits")[0]
        with threadpool_limits(1), warnings.catch_warnings():
            warnings.simplefilter("ignore")
            t0 = time.perf_counter()
            GaussianProcessClassifier(skk.ConstantKernel(1.0) * skk.RBF(1.0)).fit(
                dd["X_train"], dd["y_train"])
        print(f"digits under a free C * RBF: sklearn's one-thread fit "
              f"{time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    what = sys.argv[1] if len(sys.argv) > 1 else ""
    if what == "ridge":
        ridge([int(a) for a in sys.argv[2:]] or [1, 8])
    elif what == "high":
        high([int(a) for a in sys.argv[2:]] or [1, 8])
    elif what == "cells":
        cells("--digits" in sys.argv[2:])
    else:
        sys.exit(__doc__)
