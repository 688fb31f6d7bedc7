"""sklearn's Gaussian-process regressor and classifier written out in
torch (the card's machine has no sklearn), over the kernels of
`_gp_kernels.py` (sklearn's kernel objects and their algebra).

- Regression (`GaussianProcessRegressor`, _gpr.py): the log-marginal
  likelihood of θ (the kernel's `theta`) and its gradient (`lml`) on the
  device in float64: L = chol(K + αI), a = L⁻ᵀL⁻¹y,
  -½ yᵀa - Σ log L_ii - n/2 log 2π, and ½ tr((aaᵀ - K⁻¹) ∂K/∂θ); scipy's
  L-BFGS-B (or a callable optimizer) maximises it on the host within
  `kernel.bounds`, from the kernel's θ and from each restart's θ₀, drawn
  uniform within the bounds from a numpy RandomState as sklearn draws it,
  keeping the optimum of least -lml (`fit_gpr`); a kernel without free
  hyperparameters runs no optimiser. Then the final Cholesky and a give
  the predictive mean k(X*, X) a.
- Classification (`_BinaryGaussianProcessClassifierLaplace`, _gpc.py): the
  Laplace approximation's Newton iteration for the posterior mode
  (`laplace_mode`, GPML Algorithm 3.1, from f = 0 or a warm start, stop
  when the approximate log marginal likelihood rises by less than 1e-10),
  the latent mean and variance at new points and predict_proba's five-erf
  approximation of the logistic-Gaussian integral. Where the kernel has
  free hyperparameters, the Laplace log marginal likelihood's gradient
  (GPML Algorithm 5.1, `laplace_lml`) drives L-BFGS-B (or the callable
  optimizer) with restarts, each binary problem on its own θ and path
  (`fit_gpc_binary`); under warm_start every mode search starts from the
  last one's f, as sklearn's `f_cached`. Without free hyperparameters every
  binary problem runs at one θ, and several iterate as one batch: over one
  K (one-vs-rest), or over row subsets of X (one-vs-one's class pairs)
  padded to one length with rows whose K entries are zero. A padded row
  decouples: its row and column of B = I + W^½ K W^½ are the identity's,
  so L is block-diagonal with an identity block there, its f stays 0, it
  adds exact zeros to every other row's products, and its term of the
  log-likelihood is masked out; each problem's iterates are therefore
  those of its rows alone. Each keeps the state of the pass it stopped
  at, so its result is the one it would reach alone.
"""
from __future__ import annotations

import math
import warnings
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import scipy.optimize
import torch

from ._gp_kernels import Kernel

# predict_proba's erf mixture (sklearn/gaussian_process/_gpc.py)
LAMBDAS = (0.41, 0.4, 0.37, 0.44, 0.39)
COEFS = (-1854.8214151, 3516.89893646, 221.29346712, 128.12323805, -2010.49422654)


def _optimize(obj, theta0, bounds, optimizer):
    """sklearn's _constrained_optimization: (θ, -lml) of L-BFGS-B
    (jac=True) or of `optimizer(obj, theta0, bounds=bounds)`."""
    if optimizer == "fmin_l_bfgs_b":
        res = scipy.optimize.minimize(obj, theta0, method="L-BFGS-B", jac=True,
                                      bounds=bounds)
        if res.status != 0:                     # sklearn's _check_optimize_result
            warnings.warn(f"lbfgs failed to converge (status={res.status}): "
                          f"{res.message}", RuntimeWarning)
        return res.x, res.fun
    return optimizer(obj, theta0, bounds=bounds)


def _restarts(optima, run, bounds, n_restarts, draw):
    """Append `n_restarts` runs from θ₀ = draw(lower, upper); (the index of
    the least -lml, the first on ties; that -lml)."""
    if n_restarts > 0:
        if not np.isfinite(bounds).all():
            raise ValueError("Multiple optimizer restarts (n_restarts_optimizer>0) "
                             "requires that all bounds are finite.")
        for _ in range(n_restarts):
            optima.append(run(draw(bounds[:, 0], bounds[:, 1])))
    values = [v for _, v in optima]
    return int(np.argmin(values)), float(np.min(values))


def lml(theta: np.ndarray, kernel: Kernel, X: torch.Tensor, Y: torch.Tensor, noise,
        eval_gradient: bool = True):
    """GaussianProcessRegressor.log_marginal_likelihood(θ) of `kernel` at θ
    over targets Y (n, t): (lml, its gradient in θ) as a float and a numpy
    array, (-inf, 0) where the Cholesky fails."""
    k = kernel.clone_with_theta(theta)
    K, G = k(X, eval_gradient=True) if eval_gradient else (k(X), None)
    K.diagonal().add_(noise)
    L, info = torch.linalg.cholesky_ex(K)
    if int(info) != 0:
        return -np.inf, np.zeros_like(theta)
    a = torch.cholesky_solve(Y, L)
    value = (-0.5 * (Y * a).sum(0) - torch.log(L.diagonal()).sum()
             - K.shape[0] / 2 * math.log(2 * math.pi)).sum()
    if not eval_gradient:
        return float(value), None
    inner = a @ a.T - Y.shape[1] * torch.cholesky_inverse(L)
    return float(value), (0.5 * torch.einsum("ij,ijk->k", inner, G)).cpu().numpy()


@dataclass
class GPRFit:
    kernel: Kernel              # the fitted kernel (sklearn's kernel_)
    lml: float
    X: torch.Tensor
    L: torch.Tensor
    alpha: torch.Tensor
    y_mean: np.ndarray
    y_std: np.ndarray
    n_eval: int = 0
    # each optimiser run's (theta, -lml), the kernel's θ's first, and the one kept
    optima: list = field(default_factory=list)
    chosen: int = 0

    @property
    def theta(self) -> np.ndarray:
        return self.kernel.theta

    def predict(self, Xs: torch.Tensor) -> torch.Tensor:
        """The predictive mean, normalisation undone: (m, t)."""
        mean = self.kernel(Xs, self.X) @ self.alpha
        return (torch.as_tensor(self.y_std, device=mean.device) * mean
                + torch.as_tensor(self.y_mean, device=mean.device))


def fit_gpr(X: torch.Tensor, y: np.ndarray, kernel: Kernel, noise: float = 1e-10,
            optimizer="fmin_l_bfgs_b", normalize_y: bool = False,
            n_restarts: int = 0, rng: np.random.RandomState = None) -> GPRFit:
    """GaussianProcessRegressor.fit with `kernel` (a clone is fitted):
    targets normalised on the host as sklearn does; where the kernel has
    free hyperparameters, θ by L-BFGS-B (jac=True) or by
    `optimizer(obj_func, initial_theta, bounds=...) -> (theta, -lml)`
    (sklearn's contract: obj_func(theta, eval_gradient=True) gives -lml and
    its gradient as numpy, or -lml alone), from the kernel's θ and then from
    `n_restarts` θ₀ drawn by `rng.uniform` within `kernel.bounds`; the run
    of least -lml is kept (the first on ties). optimizer=None keeps θ."""
    y = np.asarray(y, np.float64)
    Y2 = y[:, None] if y.ndim == 1 else y
    if normalize_y:
        y_mean = np.mean(Y2, axis=0)
        y_std = np.std(Y2, axis=0)
        y_std[y_std < 10 * np.finfo(y_std.dtype).eps] = 1.0
        Y2 = (Y2 - y_mean) / y_std
    else:
        y_mean, y_std = np.zeros(Y2.shape[1]), np.ones(Y2.shape[1])
    Y = torch.as_tensor(Y2, device=X.device)
    theta = kernel.theta
    n_eval, optima, chosen = 0, [], 0
    if optimizer is not None and kernel.n_dims > 0:
        def obj(t, eval_gradient=True):
            nonlocal n_eval
            n_eval += 1
            v, g = lml(t, kernel, X, Y, noise, eval_gradient)
            return (-v, -g) if eval_gradient else -v

        bounds = kernel.bounds

        def run(theta0):
            return _optimize(obj, theta0, bounds, optimizer)
        optima = [run(theta)]
        chosen, value = _restarts(optima, run, bounds, n_restarts, rng.uniform)
        theta, value = np.asarray(optima[chosen][0]), -value
    else:
        value = lml(theta, kernel, X, Y, noise, eval_gradient=False)[0]
    kernel = kernel.clone_with_theta(theta)
    K = kernel(X)
    K.diagonal().add_(noise)
    L = torch.linalg.cholesky(K)
    return GPRFit(kernel=kernel, lml=value, X=X, L=L, alpha=torch.cholesky_solve(Y, L),
                  y_mean=y_mean, y_std=y_std, n_eval=n_eval, optima=optima, chosen=chosen)


@dataclass
class LaplaceFit:
    """B binary Laplace fits under one kernel: targets (B, n) in {0, 1} over
    X's rows, or, with `rows`, over the rows rows[b] of X where `valid`
    (padding after); the state of the Newton pass each stopped at (its pi,
    W_sr, L and a), and its last f."""
    X: torch.Tensor
    y: torch.Tensor             # (B, n) float64
    pi: torch.Tensor            # (B, n)
    W_sr: torch.Tensor          # (B, n)
    L: torch.Tensor             # (B, n, n)
    kernel: Kernel
    lml: List[float] = field(default_factory=list)
    n_iter: List[int] = field(default_factory=list)
    f: Optional[torch.Tensor] = None        # (B, n): sklearn's f_cached
    a: Optional[torch.Tensor] = None        # (B, n)
    rows: Optional[torch.Tensor] = None     # (B, n) long
    valid: Optional[torch.Tensor] = None    # (B, n) bool

    def latent(self, Xs: torch.Tensor):
        """latent_mean_and_variance: (B, m) each."""
        Ks = self.kernel(self.X, Xs)                                  # (n, m)
        if self.rows is None:
            mean = (self.y - self.pi) @ Ks
        else:
            Ks = Ks[self.rows] * self.valid[:, :, None]                # (B, n, m)
            mean = ((self.y - self.pi)[:, None, :] @ Ks)[:, 0]
        v = torch.linalg.solve_triangular(self.L, self.W_sr[:, :, None] * Ks,
                                          upper=False)
        var = self.kernel.diag(Xs) - (v * v).sum(1)
        return mean, var

    def proba(self, Xs: torch.Tensor) -> torch.Tensor:
        """Each binary estimator's P(class 1): (B, m)."""
        return _proba(*self.latent(Xs))


def _proba(mean: torch.Tensor, var: torch.Tensor) -> torch.Tensor:
    """predict_proba's P(class 1) from the latent mean and variance."""
    lam = torch.tensor(LAMBDAS, dtype=mean.dtype, device=mean.device)[:, None, None]
    coef = torch.tensor(COEFS, dtype=mean.dtype, device=mean.device)[:, None, None]
    alpha = 1 / (2 * var)
    gamma = lam * mean
    integrals = (torch.sqrt(math.pi / alpha)
                 * torch.erf(gamma * torch.sqrt(alpha / (alpha + lam ** 2)))
                 / (2 * torch.sqrt(var * 2 * math.pi)))
    return (coef * integrals).sum(0) + 0.5 * sum(COEFS)


def laplace_mode(X: torch.Tensor, y: torch.Tensor, kernel: Kernel, max_iter: int = 100,
                 rows: Optional[torch.Tensor] = None, valid: Optional[torch.Tensor] = None,
                 f0: Optional[torch.Tensor] = None,
                 K: Optional[torch.Tensor] = None) -> LaplaceFit:
    """_posterior_mode for the binary targets y (B, n) in {0, 1}, from f0
    (sklearn's warm start from f_cached) or f = 0, all B at once: over the
    one K = kernel(X) (or the K given), or with `rows` over
    K[rows[b]][:, rows[b]], zero where not `valid` (padding, see the module
    note). A problem stops at the first pass whose approximate lml rises by
    less than 1e-10 and keeps that pass's pi, W_sr, L and a (and the lml
    before it) and its f, as sklearn's loop breaks."""
    if K is None:
        K = kernel(X)
    if rows is not None:
        K = K[rows[:, :, None], rows[:, None, :]] * (valid[:, :, None] & valid[:, None, :])
    Bn, n = y.shape
    dev = X.device
    f = (torch.zeros((Bn, n), dtype=torch.float64, device=dev) if f0 is None
         else f0.clone())
    eye = torch.eye(n, dtype=torch.float64, device=dev)
    prev = torch.full((Bn,), -math.inf, dtype=torch.float64, device=dev)
    live = torch.ones(Bn, dtype=torch.bool, device=dev)
    n_iter = torch.zeros(Bn, dtype=torch.long, device=dev)
    keep = {}
    for _ in range(max_iter):
        pi = torch.sigmoid(f)
        W = pi * (1 - pi)
        W_sr = torch.sqrt(W)
        W_sr_K = W_sr[:, :, None] * K
        Bm = eye + W_sr_K * W_sr[:, None, :]
        L = torch.linalg.cholesky(Bm)
        b = W * f + (y - pi)
        a = b - W_sr * torch.cholesky_solve((W_sr_K @ b[:, :, None]), L)[:, :, 0]
        f_new = a @ K if rows is None else (a[:, None, :] @ K)[:, 0]
        lik = torch.log1p(torch.exp(-(y * 2 - 1) * f_new))
        if valid is not None:
            lik = torch.where(valid, lik, 0.0)
        value = (-0.5 * (a * f_new).sum(1) - lik.sum(1)
                 - torch.log(L.diagonal(dim1=1, dim2=2)).sum(1))
        stop = live & (value - prev < 1e-10)
        n_iter += live
        for name, t in (("pi", pi), ("W_sr", W_sr), ("L", L), ("a", a)):
            keep[name] = t if name not in keep else torch.where(
                live.view(-1, *([1] * (t.dim() - 1))), t, keep[name])
        prev = torch.where(live & ~stop, value, prev)
        f = torch.where(live[:, None], f_new, f)
        live = live & ~stop
        if not bool(live.any()):
            break
    return LaplaceFit(X=X, y=y, pi=keep["pi"], W_sr=keep["W_sr"], L=keep["L"],
                      kernel=kernel, lml=prev.tolist(), n_iter=n_iter.tolist(), f=f,
                      a=keep["a"], rows=rows, valid=valid)


def laplace_lml(theta: np.ndarray, kernel: Kernel, X: torch.Tensor, y: torch.Tensor,
                max_iter: int = 100, f0: Optional[torch.Tensor] = None,
                eval_gradient: bool = True):
    """_BinaryGaussianProcessClassifierLaplace.log_marginal_likelihood(θ)
    for one binary problem, y (n,) in {0, 1}: (Z, dZ/dθ as numpy or None,
    the mode search's LaplaceFit), GPML Algorithm 5.1 as sklearn writes it
    (R, C, the third-derivative term s_2, then s_1 + s_2ᵀ s_3 for each θ_j,
    all j at once)."""
    k = kernel.clone_with_theta(theta)
    K, G = k(X, eval_gradient=True) if eval_gradient else (k(X), None)
    fit = laplace_mode(X, y[None], k, max_iter, f0=None if f0 is None else f0[None], K=K)
    if not eval_gradient:
        return fit.lml[0], None, fit
    pi, W_sr, L, a = fit.pi[0], fit.W_sr[0], fit.L[0], fit.a[0]
    R = W_sr[:, None] * torch.cholesky_solve(torch.diag(W_sr), L)
    Cm = torch.linalg.solve_triangular(L, W_sr[:, None] * K, upper=False)
    s_2 = -0.5 * (K.diagonal() - (Cm * Cm).sum(0)) * (pi * (1 - pi) * (1 - 2 * pi))
    s_1 = (0.5 * torch.einsum("i,ijk,j->k", a, G, a)
           - 0.5 * torch.einsum("ji,ijk->k", R, G))
    b = torch.einsum("ijk,j->ik", G, y - pi)
    s_3 = b - K @ (R @ b)
    return fit.lml[0], (s_1 + s_2 @ s_3).cpu().numpy(), fit


@dataclass
class BinaryFits:
    """Binary Laplace fits run one by one, each on its own kernel θ and
    optimiser path (and, under one-vs-one, its own rows of X), with the
    interface of one batched LaplaceFit over them."""
    fits: List[LaplaceFit]      # each B = 1, the final mode at the θ kept
    lml: List[float]            # each problem's log_marginal_likelihood_value_
    n_eval: List[int]
    optima: List[list]          # each problem's optimiser runs (theta, -lml)
    chosen: List[int]

    @property
    def n_iter(self) -> List[int]:
        return [f.n_iter[0] for f in self.fits]

    @property
    def kernels(self) -> List[Kernel]:
        return [f.kernel for f in self.fits]

    def latent(self, Xs: torch.Tensor):
        parts = [f.latent(Xs) for f in self.fits]
        return torch.cat([m for m, _ in parts]), torch.cat([v for _, v in parts])

    def proba(self, Xs: torch.Tensor) -> torch.Tensor:
        return _proba(*self.latent(Xs))


def fit_gpc_binary(X: torch.Tensor, y: torch.Tensor, kernel: Kernel,
                   optimizer="fmin_l_bfgs_b", n_restarts: int = 0,
                   rng: np.random.RandomState = None, max_iter: int = 100,
                   warm_start: bool = False):
    """_BinaryGaussianProcessClassifierLaplace.fit of one problem y (n,) in
    {0, 1} with a kernel of free hyperparameters: θ by L-BFGS-B (or the
    callable optimizer) on -laplace_lml within `kernel.bounds`, from the
    kernel's θ and then from `n_restarts` θ₀ = exp(rng.uniform(bounds)) (as
    _gpc.py draws them); the run of least -lml is kept, then the final
    mode search at that θ. Under warm_start each mode search starts from
    the previous one's f. Returns (the final LaplaceFit, the kept lml, the
    evaluations, the runs, the index kept)."""
    f_cached, n_eval = None, 0

    def obj(theta, eval_gradient=True):
        nonlocal f_cached, n_eval
        n_eval += 1
        Z, dZ, fit = laplace_lml(theta, kernel, X, y, max_iter,
                                 f0=f_cached if warm_start else None,
                                 eval_gradient=eval_gradient)
        f_cached = fit.f[0]
        return (-Z, -dZ) if eval_gradient else -Z

    bounds = kernel.bounds

    def run(theta0):
        return _optimize(obj, theta0, bounds, optimizer)
    optima = [run(kernel.theta)]
    chosen, value = _restarts(optima, run, bounds, n_restarts,
                              lambda lo, hi: np.exp(rng.uniform(lo, hi)))
    k = kernel.clone_with_theta(np.asarray(optima[chosen][0]))
    fit = laplace_mode(X, y[None], k, max_iter,
                       f0=f_cached[None] if warm_start and f_cached is not None else None)
    return fit, -value, n_eval, optima, chosen
