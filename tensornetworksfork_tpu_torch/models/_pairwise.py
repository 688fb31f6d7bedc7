"""sklearn.metrics.pairwise's kernel functions written out in torch, for
sklearn's `PairwiseKernel` (models/_gp_kernels.py) on the card's machine,
which has no sklearn.

Each function takes X (n, d) and Y (m, d) or None (Y = X, and then the
functions that zero a distance's diagonal zero it) as tensors, computes in
their dtype on their device, and follows sklearn's own formula step by
step, so that its rounding follows sklearn's:

- `linear_kernel` X Yᵀ; `polynomial_kernel` ((X Yᵀ) γ + c₀)^degree;
  `sigmoid_kernel` tanh((X Yᵀ) γ + c₀); γ None is 1 / n_features;
- `rbf_kernel` exp(-γ D) with D = `euclidean_distances(squared=True)`:
  ‖x‖² - 2 x·y + ‖y‖² as (-2 X Yᵀ + ‖x‖²) + ‖y‖², clipped at 0;
- `laplacian_kernel` exp(-γ `manhattan_distances`), the distances summed
  over |x - y| as scipy's cdist "cityblock" sums them;
- `cosine_similarity`: the rows normalised (a norm under 10 eps taken as
  1) and then their dot products;
- `additive_chi2_kernel` -Σ (x - y)² / (x + y) over the features where
  x + y != 0, in feature order; `chi2_kernel` exp(γ of it); both raise on
  negative input, as sklearn does.

`pairwise_kernels(X, Y, metric, filter_params=..., **kwds)` dispatches as
sklearn's does: a metric name of PAIRWISE_KERNEL_FUNCTIONS (its keywords
filtered to KERNEL_PARAMS with filter_params), "precomputed" (X is the
kernel), or a callable, which is user code: it is called on the host on
each pair of rows as numpy arrays (sklearn's `_pairwise_callable`, the
upper triangle mirrored and the diagonal evaluated where Y is None), and
the result is moved to X's device.
"""
from __future__ import annotations

import itertools

import numpy as np
import torch

from ._libsvm import pair_sums

def _pair(X, Y):
    """(X, Y, Y is X) with Y = X where None."""
    return (X, X, True) if Y is None or Y is X else (X, Y, False)


def _gamma(gamma, X) -> float:
    """γ as a number: None is 1 / n_features; a one-element array (as
    PairwiseKernel's gradient passes exp(θ)) its element."""
    return 1.0 / X.shape[1] if gamma is None else float(np.squeeze(gamma))


def linear_kernel(X, Y=None):
    X, Y, _ = _pair(X, Y)
    return X @ Y.T


def polynomial_kernel(X, Y=None, degree=3, gamma=None, coef0=1):
    X, Y, _ = _pair(X, Y)
    return ((X @ Y.T) * _gamma(gamma, X) + coef0) ** degree


def sigmoid_kernel(X, Y=None, gamma=None, coef0=1):
    X, Y, _ = _pair(X, Y)
    return torch.tanh((X @ Y.T) * _gamma(gamma, X) + coef0)


def _row_norms(X):
    return torch.einsum("ij,ij->i", X, X)


def euclidean_distances(X, Y=None, squared=False):
    X, Y, same = _pair(X, Y)
    XX = _row_norms(X)[:, None]
    YY = XX.T if same else _row_norms(Y)[None, :]
    D = (-2 * (X @ Y.T) + XX) + YY
    D = D.clamp(min=0)
    if same:
        D.fill_diagonal_(0)
    return D if squared else torch.sqrt(D)


def rbf_kernel(X, Y=None, gamma=None):
    D = euclidean_distances(X, Y, squared=True)
    return torch.exp(D * -_gamma(gamma, X))


def manhattan_distances(X, Y=None):
    X, Y, _ = _pair(X, Y)
    return pair_sums(X, Y, torch.abs)


def laplacian_kernel(X, Y=None, gamma=None):
    return torch.exp(-_gamma(gamma, X) * manhattan_distances(X, Y))


def normalize(X):
    """sklearn's normalize (l2, by rows): a norm under 10 eps counts as 1."""
    norms = torch.sqrt(_row_norms(X))
    norms = torch.where(norms < 10 * torch.finfo(X.dtype).eps, 1.0, norms)
    return X / norms[:, None]


def cosine_similarity(X, Y=None):
    X, Y, same = _pair(X, Y)
    Xn = normalize(X)
    return Xn @ (Xn if same else normalize(Y)).T


def additive_chi2_kernel(X, Y=None):
    X, Y, same = _pair(X, Y)
    if bool((X < 0).any()):
        raise ValueError("X contains negative values.")
    if not same and bool((Y < 0).any()):
        raise ValueError("Y contains negative values.")
    res = torch.zeros((X.shape[0], Y.shape[0]), dtype=X.dtype, device=X.device)
    for k in range(X.shape[1]):
        d = X[:, k, None] - Y[None, :, k]
        s = X[:, k, None] + Y[None, :, k]
        res = res + torch.where(s != 0, d * d / torch.where(s != 0, s, 1.0), 0.0)
    return -res


def chi2_kernel(X, Y=None, gamma=1.0):
    return torch.exp(additive_chi2_kernel(X, Y) * _gamma(gamma, X))


PAIRWISE_KERNEL_FUNCTIONS = {
    "additive_chi2": additive_chi2_kernel,
    "chi2": chi2_kernel,
    "linear": linear_kernel,
    "polynomial": polynomial_kernel,
    "poly": polynomial_kernel,
    "rbf": rbf_kernel,
    "laplacian": laplacian_kernel,
    "sigmoid": sigmoid_kernel,
    "cosine": cosine_similarity,
}
# the keywords each function takes (pairwise_kernels' filter_params)
KERNEL_PARAMS = {
    "additive_chi2": (),
    "chi2": frozenset(["gamma"]),
    "cosine": (),
    "linear": (),
    "poly": frozenset(["gamma", "degree", "coef0"]),
    "polynomial": frozenset(["gamma", "degree", "coef0"]),
    "rbf": frozenset(["gamma"]),
    "laplacian": frozenset(["gamma"]),
    "sigmoid": frozenset(["gamma", "coef0"]),
}


def _host(X) -> np.ndarray:
    return X.detach().cpu().numpy() if torch.is_tensor(X) else np.asarray(X)


def _pairwise_callable(X, Y, metric, **kwds) -> torch.Tensor:
    """sklearn's _pairwise_callable: metric(x, y, **kwds) on each pair of
    rows (numpy, on the host); where Y is None the upper triangle, mirrored,
    then the diagonal. Returned as float64 on X's device."""
    dev = X.device if torch.is_tensor(X) else None
    same = Y is None or Y is X
    Xh = _host(X)
    Yh = Xh if same else _host(Y)
    if same:
        out = np.zeros((len(Xh), len(Xh)))
        for i, j in itertools.combinations(range(len(Xh)), 2):
            out[i, j] = metric(Xh[i], Yh[j], **kwds)
        out = out + out.T
        for i in range(len(Xh)):
            out[i, i] = metric(Xh[i], Xh[i], **kwds)
    else:
        out = np.empty((len(Xh), len(Yh)))
        for i, j in itertools.product(range(len(Xh)), range(len(Yh))):
            out[i, j] = metric(Xh[i], Yh[j], **kwds)
    return torch.as_tensor(out, dtype=torch.float64, device=dev)


def pairwise_kernels(X, Y=None, metric="linear", filter_params=False, **kwds):
    """sklearn's pairwise_kernels on tensors (n_jobs is not ported: one
    process computes every entry)."""
    if isinstance(metric, str) and metric == "precomputed":
        m = (X if Y is None else Y).shape[0]
        if X.shape[1] != m:
            raise ValueError(f"Precomputed metric requires shape (n_queries, n_indexed). "
                             f"Got ({X.shape[0]}, {X.shape[1]}) for {m} indexed.")
        return X
    if isinstance(metric, str):
        if metric not in PAIRWISE_KERNEL_FUNCTIONS:
            raise ValueError(f"The 'metric' parameter of pairwise_kernels must be a str "
                             f"among {sorted(set(PAIRWISE_KERNEL_FUNCTIONS) | {'precomputed'})} "
                             f"or a callable. Got {metric!r} instead.")
        if filter_params:
            kwds = {k: v for k, v in kwds.items() if k in KERNEL_PARAMS[metric]}
        return PAIRWISE_KERNEL_FUNCTIONS[metric](X, Y, **kwds)
    if callable(metric):
        return _pairwise_callable(X, Y, metric, **kwds)
    raise ValueError(f"metric {metric!r} is neither a name of PAIRWISE_KERNEL_FUNCTIONS, "
                     "'precomputed' nor a callable")
