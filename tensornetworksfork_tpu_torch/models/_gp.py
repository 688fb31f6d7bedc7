"""sklearn's Gaussian-process regressor and classifier at their default
kernels, written out in torch (the card's machine has no sklearn).

The kernel is sklearn's `ConstantKernel(c) * RBF(ℓ)`:
k(a, b) = c exp(-||a/ℓ - b/ℓ||² / 2), its squared distances summed over the
differences as scipy's pdist / cdist sum them. θ = (log c, log ℓ).

- Regression (`GaussianProcessRegressor`, _gpr.py): the log-marginal
  likelihood of θ and its gradient in θ (`lml`) on the device in float64:
  L = chol(K + αI), a = L⁻ᵀL⁻¹y, -½ yᵀa - Σ log L_ii - n/2 log 2π, and
  ½ tr((aaᵀ - K⁻¹) ∂K/∂θ); scipy's L-BFGS-B (or a callable optimizer)
  maximises it on the host from θ = 0 and from each restart's θ₀, drawn
  uniform within the log bounds from a numpy RandomState as sklearn draws
  it, keeping the optimum of least -lml (`fit_gpr`); then the final
  Cholesky and a give the predictive mean K* a.
- Classification (`_BinaryGaussianProcessClassifierLaplace`, _gpc.py): the
  Laplace approximation's Newton iteration for the posterior mode
  (`laplace_mode`, GPML Algorithm 3.1, from f = 0 or a warm start, stop
  when the approximate log marginal likelihood rises by less than 1e-10),
  the latent mean and variance at new points and predict_proba's five-erf
  approximation of the logistic-Gaussian integral. Several binary problems
  iterate as one batch: over one K (one-vs-rest), or over row subsets of
  X (one-vs-one's class pairs) padded to one length with rows whose K
  entries are zero. A padded row decouples: its row and column of
  B = I + W^½ K W^½ are the identity's, so L is block-diagonal with an
  identity block there, its f stays 0, it adds exact zeros to every other
  row's products, and its term of the log-likelihood is masked out; each
  problem's iterates are therefore those of its rows alone. Each keeps the
  state of the pass it stopped at, so its result is the one it would
  reach alone.
"""
from __future__ import annotations

import math
import warnings
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import scipy.optimize
import torch

from ._libsvm import sq_dists

# predict_proba's erf mixture (sklearn/gaussian_process/_gpc.py)
LAMBDAS = (0.41, 0.4, 0.37, 0.44, 0.39)
COEFS = (-1854.8214151, 3516.89893646, 221.29346712, 128.12323805, -2010.49422654)
# sklearn's kernel_.bounds of C(1) * RBF(1): log of (1e-5, 1e5) for each
LOG_BOUNDS = np.log(np.array([[1e-5, 1e5], [1e-5, 1e5]]))


def rbf_parts(A: torch.Tensor, B: Optional[torch.Tensor], length_scale: float):
    """(E, D): exp(-D/2) and D = ||a/ℓ - b/ℓ||² (B None: A against itself)."""
    As = A / length_scale
    D = sq_dists(As, As if B is None else B / length_scale)
    return torch.exp(-0.5 * D), D


def kernel(A, B, constant: float, length_scale: float) -> torch.Tensor:
    return constant * rbf_parts(A, B, length_scale)[0]


def lml(theta: np.ndarray, X: torch.Tensor, Y: torch.Tensor, noise,
        eval_gradient: bool = True):
    """GaussianProcessRegressor.log_marginal_likelihood(θ) over targets Y
    (n, t): (lml, its gradient in θ) as floats on the host, (-inf, 0) where
    the Cholesky fails."""
    c, ls = (math.exp(v) for v in theta)
    E, D = rbf_parts(X, None, ls)
    K = c * E
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
    # ∂K/∂log c = c E, ∂K/∂log ℓ = c E D
    gc = 0.5 * (inner * (c * E)).sum()
    gl = 0.5 * (inner * ((c * E) * D)).sum()
    return float(value), torch.stack([gc, gl]).cpu().numpy()


@dataclass
class GPRFit:
    theta: np.ndarray
    lml: float
    X: torch.Tensor
    L: torch.Tensor
    alpha: torch.Tensor
    y_mean: np.ndarray
    y_std: np.ndarray
    n_eval: int = 0
    # each optimiser run's (theta, -lml), θ = 0's first, and the one kept
    optima: list = field(default_factory=list)
    chosen: int = 0

    @property
    def constant(self) -> float:
        return math.exp(self.theta[0])

    @property
    def length_scale(self) -> float:
        return math.exp(self.theta[1])

    def predict(self, Xs: torch.Tensor) -> torch.Tensor:
        """The predictive mean, normalisation undone: (m, t)."""
        Ks = kernel(Xs, self.X, self.constant, self.length_scale)
        mean = Ks @ self.alpha
        return (torch.as_tensor(self.y_std, device=mean.device) * mean
                + torch.as_tensor(self.y_mean, device=mean.device))


def fit_gpr(X: torch.Tensor, y: np.ndarray, noise: float = 1e-10,
            optimizer="fmin_l_bfgs_b", normalize_y: bool = False,
            n_restarts: int = 0, rng: np.random.RandomState = None) -> GPRFit:
    """GaussianProcessRegressor.fit at the default kernel C(1) * RBF(1):
    targets normalised on the host as sklearn does; θ by L-BFGS-B (jac=True)
    or by `optimizer(obj_func, initial_theta, bounds=...) -> (theta, -lml)`
    (sklearn's contract: obj_func(theta, eval_gradient=True) gives -lml and
    its gradient as numpy, or -lml alone), from θ = 0 and then from
    `n_restarts` θ₀ drawn by `rng.uniform` within the log bounds; the run of
    least -lml is kept (the first on ties). optimizer=None keeps θ = 0."""
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
    theta = np.zeros(2)
    n_eval, optima, chosen = 0, [], 0
    if optimizer is not None:
        def obj(t, eval_gradient=True):
            nonlocal n_eval
            n_eval += 1
            v, g = lml(t, X, Y, noise, eval_gradient)
            return (-v, -g) if eval_gradient else -v

        def run(theta0):
            if optimizer == "fmin_l_bfgs_b":
                res = scipy.optimize.minimize(obj, theta0, method="L-BFGS-B", jac=True,
                                              bounds=LOG_BOUNDS)
                if res.status != 0:             # sklearn's _check_optimize_result
                    warnings.warn(f"lbfgs failed to converge (status={res.status}): "
                                  f"{res.message}", RuntimeWarning)
                return res.x, res.fun
            return optimizer(obj, theta0, bounds=LOG_BOUNDS)
        optima = [run(theta)]
        for _ in range(n_restarts):
            optima.append(run(rng.uniform(LOG_BOUNDS[:, 0], LOG_BOUNDS[:, 1])))
        values = [v for _, v in optima]
        chosen = int(np.argmin(values))
        theta, value = np.asarray(optima[chosen][0]), -float(np.min(values))
    else:
        value = lml(theta, X, Y, noise, eval_gradient=False)[0]
    K = kernel(X, None, math.exp(theta[0]), math.exp(theta[1]))
    K.diagonal().add_(noise)
    L = torch.linalg.cholesky(K)
    return GPRFit(theta=np.asarray(theta), lml=value, X=X, L=L,
                  alpha=torch.cholesky_solve(Y, L), y_mean=y_mean, y_std=y_std,
                  n_eval=n_eval, optima=optima, chosen=chosen)


@dataclass
class LaplaceFit:
    """B binary Laplace fits: targets (B, n) in {0, 1} over X's rows, or,
    with `rows`, over the rows rows[b] of X where `valid` (padding after);
    the state of the Newton pass each stopped at, and its last f."""
    X: torch.Tensor
    y: torch.Tensor             # (B, n) float64
    pi: torch.Tensor            # (B, n)
    W_sr: torch.Tensor          # (B, n)
    L: torch.Tensor             # (B, n, n)
    lml: List[float] = field(default_factory=list)
    n_iter: List[int] = field(default_factory=list)
    constant: float = 1.0
    length_scale: float = 1.0
    f: Optional[torch.Tensor] = None        # (B, n): sklearn's f_cached
    rows: Optional[torch.Tensor] = None     # (B, n) long
    valid: Optional[torch.Tensor] = None    # (B, n) bool

    def latent(self, Xs: torch.Tensor):
        """latent_mean_and_variance: (B, m) each."""
        Ks = kernel(self.X, Xs, self.constant, self.length_scale)      # (n, m)
        if self.rows is None:
            mean = (self.y - self.pi) @ Ks
        else:
            Ks = Ks[self.rows] * self.valid[:, :, None]                # (B, n, m)
            mean = ((self.y - self.pi)[:, None, :] @ Ks)[:, 0]
        v = torch.linalg.solve_triangular(self.L, self.W_sr[:, :, None] * Ks,
                                          upper=False)
        var = self.constant - (v * v).sum(1)
        return mean, var

    def proba(self, Xs: torch.Tensor) -> torch.Tensor:
        """Each binary estimator's P(class 1): (B, m)."""
        mean, var = self.latent(Xs)
        lam = torch.tensor(LAMBDAS, dtype=mean.dtype, device=mean.device)[:, None, None]
        coef = torch.tensor(COEFS, dtype=mean.dtype, device=mean.device)[:, None, None]
        alpha = 1 / (2 * var)
        gamma = lam * mean
        integrals = (torch.sqrt(math.pi / alpha)
                     * torch.erf(gamma * torch.sqrt(alpha / (alpha + lam ** 2)))
                     / (2 * torch.sqrt(var * 2 * math.pi)))
        return (coef * integrals).sum(0) + 0.5 * sum(COEFS)


def laplace_mode(X: torch.Tensor, y: torch.Tensor, max_iter: int = 100,
                 constant: float = 1.0, length_scale: float = 1.0,
                 rows: Optional[torch.Tensor] = None, valid: Optional[torch.Tensor] = None,
                 f0: Optional[torch.Tensor] = None) -> LaplaceFit:
    """_posterior_mode for the binary targets y (B, n) in {0, 1}, from f0
    (sklearn's warm start from f_cached) or f = 0, all B at once: over the
    one K of X, or with `rows` over K[rows[b]][:, rows[b]], zero where not
    `valid` (padding, see the module note). A problem stops at the first
    pass whose approximate lml rises by less than 1e-10 and keeps that
    pass's pi, W_sr and L (and the lml before it) and its f, as sklearn's
    loop breaks."""
    K = kernel(X, None, constant, length_scale)
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
        for name, t in (("pi", pi), ("W_sr", W_sr), ("L", L)):
            keep[name] = t if name not in keep else torch.where(
                live.view(-1, *([1] * (t.dim() - 1))), t, keep[name])
        prev = torch.where(live & ~stop, value, prev)
        f = torch.where(live[:, None], f_new, f)
        live = live & ~stop
        if not bool(live.any()):
            break
    return LaplaceFit(X=X, y=y, pi=keep["pi"], W_sr=keep["W_sr"], L=keep["L"],
                      lml=prev.tolist(), n_iter=n_iter.tolist(), constant=constant,
                      length_scale=length_scale, f=f, rows=rows, valid=valid)
