"""sklearn's Gaussian-process kernels (sklearn/gaussian_process/kernels.py)
written out in torch, for the card's machine, which has no sklearn.

The same classes, parameters and algebra:

- `Hyperparameter` (bounds a pair, one pair per element, or "fixed"), and
  on each kernel `theta` (the log of its free hyperparameters, in the order
  of their names, as sklearn's `dir()` gives them), `bounds` (their log
  bounds), `n_dims`, `hyperparameters`, `get_params`, `set_params`,
  `clone_with_theta`, `is_stationary()` and `requires_vector_input`;
- `k(X, Y=None, eval_gradient=False)`: K (n, m) and, with Y None, ∂K/∂θ
  (n, n, n_dims), as float64 tensors on X's device; `k.diag(X)`;
- `ConstantKernel`, `WhiteKernel`, `RBF` (isotropic or one length scale a
  feature), `Matern` (at ν = 0.5, 1.5, 2.5 and ∞ sklearn's closed forms and
  analytic gradients; at any other ν > 0 its general form with the Bessel
  function `_special.kv` and its finite-difference gradient),
  `RationalQuadratic`, `ExpSineSquared`, `DotProduct` and `PairwiseKernel`
  (sklearn.metrics.pairwise's kernels, `_pairwise.py`, with the
  finite-difference gradient in log γ);
- `Sum`, `Product` and `Exponentiation`, built by `+`, `*` and `**`, a
  number becoming a `ConstantKernel`; `CompoundKernel`, one kernel a binary
  problem, K stacked on a last axis (sklearn's GaussianProcessClassifier
  returns one as its multi-class `kernel_`, and refuses one as input).

Squared distances are summed over the feature differences, as scipy's
pdist / cdist sum them (`_libsvm.sq_dists`), and a Euclidean distance is
their square root. A finite-difference gradient is sklearn's
`_approx_fprime` at ε = 1e-10 over `clone_with_theta`, so its f0 is taken
at exp(θ): it multiplies K's rounding by ~1e10.

`from_sklearn` turns an sklearn kernel object into the port's by its class
name and `get_params()`, without importing sklearn. Any other object with
sklearn's kernel API (a kernel the user wrote, or a subclass of one of
sklearn's) becomes a `HostKernel`, which calls the user's numpy code on the
host and moves K and ∂K/∂θ to the device: the one host path. A kernel whose
`requires_vector_input` is False may take rows of anything (strings, say),
held as `HostRows`; ConstantKernel and WhiteKernel count them.
"""
from __future__ import annotations

import copy
import math
from collections import namedtuple
from inspect import signature

import numpy as np
import torch

from ._libsvm import sq_dists
from ._pairwise import pairwise_kernels
from ._special import kv

# Matern's orders with a closed form and an analytic gradient
MATERN_NUS = (0.5, 1.5, 2.5, math.inf)
# the step of sklearn's finite-difference gradients (_approx_fprime)
FPRIME_EPS = 1e-10
# what a user's kernel object needs to be wrapped in a HostKernel
KERNEL_API = ("__call__", "diag", "theta", "bounds", "clone_with_theta",
              "hyperparameters", "requires_vector_input")


class Hyperparameter(namedtuple("Hyperparameter",
                                ("name", "value_type", "bounds", "n_elements", "fixed"))):
    """A hyperparameter's name, its bounds ((1, 2), or (n_elements, 2) for
    a vector-valued one, or "fixed") and whether it is fixed."""
    __slots__ = ()

    def __new__(cls, name, value_type, bounds, n_elements=1, fixed=None):
        if not isinstance(bounds, str) or bounds != "fixed":
            bounds = np.atleast_2d(bounds)
            if n_elements > 1:
                if bounds.shape[0] == 1:
                    bounds = np.repeat(bounds, n_elements, 0)
                elif bounds.shape[0] != n_elements:
                    raise ValueError(f"Bounds on {name} should have either 1 or "
                                     f"{n_elements} dimensions. Given are {bounds.shape[0]}")
        if fixed is None:
            fixed = isinstance(bounds, str) and bounds == "fixed"
        return super().__new__(cls, name, value_type, bounds, n_elements, fixed)

    def __eq__(self, other):
        return (self.name == other.name and self.value_type == other.value_type
                and np.all(self.bounds == other.bounds)
                and self.n_elements == other.n_elements and self.fixed == other.fixed)


class HostRows:
    """Rows of objects that are not vectors (strings, graphs), held on the
    host as sklearn's GPs keep them (a list or an array), with the device
    that a kernel's values over them go to."""

    def __init__(self, data, device):
        self.data = data
        self.device = torch.device(device)

    def __len__(self):
        return len(self.data)

    def __getitem__(self, idx):
        idx = np.asarray(idx.cpu() if torch.is_tensor(idx) else idx)
        if isinstance(self.data, np.ndarray):
            return HostRows(self.data[idx], self.device)
        return HostRows([self.data[i] for i in idx], self.device)


def _count(X):
    """(rows, device) of X: a tensor, an array or HostRows."""
    if isinstance(X, HostRows):
        return len(X), X.device
    X = _x(X)
    return X.shape[0], X.device


def _x(X, like=None) -> torch.Tensor:
    """X as a 2-D float64 tensor (on `like`'s device where given)."""
    dev = like.device if like is not None else (X.device if torch.is_tensor(X) else None)
    X = torch.as_tensor(X, dtype=torch.float64, device=dev)
    return X[None] if X.ndim == 1 else X


def _scalar(v: float, X: torch.Tensor) -> torch.Tensor:
    """A 0-d float64 tensor on X's device: a tensor divisor divides as IEEE
    division on the card too, where a Python scalar divisor is a product
    with its reciprocal."""
    return torch.tensor(v, dtype=torch.float64, device=X.device)


def _empty_gradient(X) -> torch.Tensor:
    n, dev = _count(X)
    return torch.empty((n, n, 0), dtype=torch.float64, device=dev)


def _approx_fprime(theta: np.ndarray, f, epsilon: float = FPRIME_EPS) -> torch.Tensor:
    """sklearn's _approx_fprime: (f(θ + ε e_k) - f(θ)) / ε for each k,
    stacked on a last axis; f0 is f(θ), not the K the caller holds."""
    f0 = f(theta)
    grad = f0.new_zeros(tuple(f0.shape) + (len(theta),))
    step = _scalar(epsilon, f0)
    for k in range(len(theta)):
        d = np.zeros(len(theta))
        d[k] = epsilon
        grad[:, :, k] = (f(theta + d) - f0) / step
    return grad


class Kernel:
    """The base of every kernel: parameters, hyperparameters, θ and the
    operators."""

    def get_params(self, deep=True) -> dict:
        """The __init__ parameters by name (sklearn's convention)."""
        return {name: getattr(self, name) for name, p in
                signature(type(self).__init__).parameters.items()
                if name != "self" and p.kind != p.VAR_KEYWORD}

    def set_params(self, **params):
        valid = self.get_params(deep=True)
        for key, value in params.items():
            name, _, sub = key.partition("__")
            if name not in valid:
                raise ValueError(f"Invalid parameter {name} for kernel {self!r}")
            if sub:
                valid[name].set_params(**{sub: value})
            else:
                setattr(self, key, value)
        return self

    def clone_with_theta(self, theta):
        cloned = copy.deepcopy(self)
        cloned.theta = theta
        return cloned

    @property
    def n_dims(self) -> int:
        return self.theta.shape[0]

    @property
    def hyperparameters(self) -> list:
        return [getattr(self, attr) for attr in dir(self)
                if attr.startswith("hyperparameter_")]

    @property
    def theta(self) -> np.ndarray:
        params = self.get_params()
        theta = [params[h.name] for h in self.hyperparameters if not h.fixed]
        return np.log(np.hstack(theta)) if theta else np.array([])

    @theta.setter
    def theta(self, theta):
        params = self.get_params()
        i = 0
        for h in self.hyperparameters:
            if h.fixed:
                continue
            if h.n_elements > 1:
                params[h.name] = np.exp(theta[i:i + h.n_elements])
                i += h.n_elements
            else:
                params[h.name] = np.exp(theta[i])
                i += 1
        if i != len(theta):
            raise ValueError(f"theta has not the correct number of entries. Should be "
                             f"{i}; given are {len(theta)}")
        self.set_params(**params)

    @property
    def bounds(self) -> np.ndarray:
        bounds = [h.bounds for h in self.hyperparameters if not h.fixed]
        return np.log(np.vstack(bounds)) if bounds else np.array([])

    def __add__(self, b):
        return Sum(self, _operand(b))

    def __radd__(self, b):
        return Sum(_operand(b), self)

    def __mul__(self, b):
        return Product(self, _operand(b))

    def __rmul__(self, b):
        return Product(_operand(b), self)

    def __pow__(self, b):
        return Exponentiation(self, b)

    def __eq__(self, b):
        if type(self) is not type(b):
            return False
        pa, pb = self.get_params(), b.get_params()
        return all(not np.any(pa.get(k) != pb.get(k)) for k in set(pa) | set(pb))

    def __repr__(self):
        return f"{type(self).__name__}({', '.join(f'{v:.3g}' for v in self.theta)})"

    def diag(self, X) -> torch.Tensor:
        """k(x, x) for each row x: ones (the normalised kernels)."""
        X = _x(X)
        return X.new_ones(X.shape[0])

    def is_stationary(self) -> bool:
        """Whether k(x, y) depends on x - y alone (sklearn's
        StationaryKernelMixin)."""
        return True

    @property
    def requires_vector_input(self) -> bool:
        """Whether the kernel takes rows of numbers only (sklearn's
        GenericKernelMixin kernels take any rows)."""
        return True


def _check_length_scale(X: torch.Tensor, length_scale) -> np.ndarray:
    length_scale = np.squeeze(length_scale).astype(float)
    if np.ndim(length_scale) > 1:
        raise ValueError("length_scale cannot be of dimension greater than 1")
    if np.ndim(length_scale) == 1 and X.shape[1] != length_scale.shape[0]:
        raise ValueError(f"Anisotropic kernel must have the same number of dimensions as "
                         f"data ({length_scale.shape[0]}!={X.shape[1]})")
    return length_scale


class ConstantKernel(Kernel):
    """k(x, y) = constant_value."""

    def __init__(self, constant_value=1.0, constant_value_bounds=(1e-5, 1e5)):
        self.constant_value = constant_value
        self.constant_value_bounds = constant_value_bounds

    @property
    def hyperparameter_constant_value(self):
        return Hyperparameter("constant_value", "numeric", self.constant_value_bounds)

    @property
    def requires_vector_input(self):
        return False

    def __call__(self, X, Y=None, eval_gradient=False):
        n, dev = _count(X)
        if Y is not None and eval_gradient:
            raise ValueError("Gradient can only be evaluated when Y is None.")
        m = n if Y is None else _count(Y)[0]
        value = float(self.constant_value)
        K = torch.full((n, m), value, dtype=torch.float64, device=dev)
        if not eval_gradient:
            return K
        if self.hyperparameter_constant_value.fixed:
            return K, _empty_gradient(X)
        return K, torch.full((n, n, 1), value, dtype=torch.float64, device=dev)

    def diag(self, X):
        n, dev = _count(X)
        return torch.full((n,), float(self.constant_value), dtype=torch.float64, device=dev)

    def __repr__(self):
        return f"{np.sqrt(self.constant_value):.3g}**2"


class WhiteKernel(Kernel):
    """k(x, y) = noise_level if x and y are the same row of one X, else 0."""

    def __init__(self, noise_level=1.0, noise_level_bounds=(1e-5, 1e5)):
        self.noise_level = noise_level
        self.noise_level_bounds = noise_level_bounds

    @property
    def hyperparameter_noise_level(self):
        return Hyperparameter("noise_level", "numeric", self.noise_level_bounds)

    @property
    def requires_vector_input(self):
        return False

    def __call__(self, X, Y=None, eval_gradient=False):
        n, dev = _count(X)
        if Y is not None:
            if eval_gradient:
                raise ValueError("Gradient can only be evaluated when Y is None.")
            return torch.zeros((n, _count(Y)[0]), dtype=torch.float64, device=dev)
        eye = torch.eye(n, dtype=torch.float64, device=dev)
        K = float(self.noise_level) * eye
        if not eval_gradient:
            return K
        if self.hyperparameter_noise_level.fixed:
            return K, _empty_gradient(X)
        return K, (float(self.noise_level) * eye)[:, :, None]

    def diag(self, X):
        n, dev = _count(X)
        return torch.full((n,), float(self.noise_level), dtype=torch.float64, device=dev)

    def __repr__(self):
        return f"{type(self).__name__}(noise_level={self.noise_level:.3g})"


class RBF(Kernel):
    """k(x, y) = exp(-||x/ℓ - y/ℓ||² / 2), ℓ a number or one a feature."""

    def __init__(self, length_scale=1.0, length_scale_bounds=(1e-5, 1e5)):
        self.length_scale = length_scale
        self.length_scale_bounds = length_scale_bounds

    @property
    def anisotropic(self) -> bool:
        return bool(np.iterable(self.length_scale) and len(self.length_scale) > 1)

    @property
    def hyperparameter_length_scale(self):
        if self.anisotropic:
            return Hyperparameter("length_scale", "numeric", self.length_scale_bounds,
                                  len(self.length_scale))
        return Hyperparameter("length_scale", "numeric", self.length_scale_bounds)

    def _scaled(self, X, Y):
        """(X/ℓ, Y/ℓ or None, ℓ as a tensor)."""
        ls = torch.as_tensor(_check_length_scale(X, self.length_scale), device=X.device)
        return X / ls, (None if Y is None else _x(Y, X) / ls), ls

    def _anisotropic_d(self, X, ls) -> torch.Tensor:
        """(x_i - x_j)² / ℓ² per feature: (n, n, d)."""
        return (X[:, None, :] - X[None, :, :]) ** 2 / ls ** 2

    def __call__(self, X, Y=None, eval_gradient=False):
        X = _x(X)
        if Y is not None and eval_gradient:
            raise ValueError("Gradient can only be evaluated when Y is None.")
        Xs, Ys, ls = self._scaled(X, Y)
        dists = sq_dists(Xs, Xs if Ys is None else Ys)
        K = torch.exp(-0.5 * dists)
        if Ys is None:
            K.fill_diagonal_(1)
        if not eval_gradient:
            return K
        if self.hyperparameter_length_scale.fixed:
            return K, _empty_gradient(X)
        if not self.anisotropic or ls.numel() == 1:
            return K, (K * dists)[:, :, None]
        return K, self._anisotropic_d(X, ls) * K[..., None]

    def __repr__(self):
        if self.anisotropic:
            return (f"{type(self).__name__}(length_scale=["
                    f"{', '.join(f'{v:.3g}' for v in self.length_scale)}])")
        return f"{type(self).__name__}(length_scale={np.ravel(self.length_scale)[0]:.3g})"


class Matern(RBF):
    """sklearn's Matern: at ν = 0.5, 1.5, 2.5 or ∞ its closed forms and
    analytic gradients; at any other ν > 0 its general case step by step
    (exact zero distances raised by float64's eps, then 2^(1-ν)/Γ(ν) tmp^ν
    K_ν(tmp) with tmp = √(2ν) d, in that order) and its finite-difference
    gradient."""

    def __init__(self, length_scale=1.0, length_scale_bounds=(1e-5, 1e5), nu=1.5):
        super().__init__(length_scale, length_scale_bounds)
        self.nu = nu

    def _general(self, dists: torch.Tensor) -> torch.Tensor:
        import scipy.special
        nu = float(self.nu)
        d = torch.where(dists == 0.0, np.finfo(float).eps, dists)
        tmp = math.sqrt(2 * nu) * d
        return ((2 ** (1.0 - nu)) / float(scipy.special.gamma(nu)) * tmp ** nu) * kv(nu, tmp)

    def __call__(self, X, Y=None, eval_gradient=False):
        X = _x(X)
        if Y is not None and eval_gradient:
            raise ValueError("Gradient can only be evaluated when Y is None.")
        Xs, Ys, ls = self._scaled(X, Y)
        dists = torch.sqrt(sq_dists(Xs, Xs if Ys is None else Ys))
        if self.nu == 0.5:
            K = torch.exp(-dists)
        elif self.nu == 1.5:
            K = dists * math.sqrt(3)
            K = (1.0 + K) * torch.exp(-K)
        elif self.nu == 2.5:
            K = dists * math.sqrt(5)
            K = (1.0 + K + K ** 2 / 3.0) * torch.exp(-K)
        elif self.nu == math.inf:
            K = torch.exp(-(dists ** 2) / 2.0)
        else:
            K = self._general(dists)
        if Ys is None:
            K.fill_diagonal_(1)
        if not eval_gradient:
            return K
        if self.hyperparameter_length_scale.fixed:
            return K, _empty_gradient(X)
        if self.nu not in MATERN_NUS:
            return K, _approx_fprime(self.theta, lambda t: self.clone_with_theta(t)(X, Y))
        D = self._anisotropic_d(X, ls) if self.anisotropic else (dists ** 2)[:, :, None]
        if self.nu == 0.5:
            den = torch.sqrt(D.sum(2))[:, :, None]
            G = K[..., None] * torch.where(den != 0, D / torch.where(den != 0, den, 1.0), 0.0)
        elif self.nu == 1.5:
            G = 3 * D * torch.exp(-torch.sqrt(3 * D.sum(-1)))[..., None]
        elif self.nu == 2.5:
            tmp = torch.sqrt(5 * D.sum(-1))[..., None]
            G = 5.0 / 3.0 * D * (tmp + 1) * torch.exp(-tmp)
        else:
            G = D * K[..., None]
        return K, (G if self.anisotropic else G.sum(-1)[:, :, None])

    def __repr__(self):
        return super().__repr__()[:-1] + f", nu={self.nu:.3g})"


class RationalQuadratic(Kernel):
    """k(x, y) = (1 + ||x - y||² / (2 α ℓ²))^-α; θ = (log α, log ℓ)."""

    def __init__(self, length_scale=1.0, alpha=1.0, length_scale_bounds=(1e-5, 1e5),
                 alpha_bounds=(1e-5, 1e5)):
        self.length_scale = length_scale
        self.alpha = alpha
        self.length_scale_bounds = length_scale_bounds
        self.alpha_bounds = alpha_bounds

    @property
    def hyperparameter_length_scale(self):
        return Hyperparameter("length_scale", "numeric", self.length_scale_bounds)

    @property
    def hyperparameter_alpha(self):
        return Hyperparameter("alpha", "numeric", self.alpha_bounds)

    def __call__(self, X, Y=None, eval_gradient=False):
        if len(np.atleast_1d(self.length_scale)) > 1:
            raise AttributeError("RationalQuadratic kernel only supports isotropic version, "
                                 "please use a single scalar for length_scale")
        X = _x(X)
        if Y is not None and eval_gradient:
            raise ValueError("Gradient can only be evaluated when Y is None.")
        alpha, ls = float(self.alpha), float(np.squeeze(self.length_scale))
        dists = sq_dists(X, X if Y is None else _x(Y, X))
        base = 1 + dists / _scalar(2 * alpha * ls ** 2, X)
        K = base ** -alpha
        if Y is None:
            K.fill_diagonal_(1)
        if not eval_gradient:
            return K
        parts = []
        if not self.hyperparameter_alpha.fixed:
            parts.append(K * (-alpha * torch.log(base)
                              + dists / (_scalar(2 * ls ** 2, X) * base)))
        if not self.hyperparameter_length_scale.fixed:
            parts.append(dists * K / (_scalar(ls ** 2, X) * base))
        return K, (torch.stack(parts, -1) if parts else _empty_gradient(X))

    def __repr__(self):
        return (f"{type(self).__name__}(alpha={self.alpha:.3g}, "
                f"length_scale={self.length_scale:.3g})")


class ExpSineSquared(Kernel):
    """k(x, y) = exp(-2 sin²(π ||x - y|| / p) / ℓ²); θ = (log ℓ, log p)."""

    def __init__(self, length_scale=1.0, periodicity=1.0, length_scale_bounds=(1e-5, 1e5),
                 periodicity_bounds=(1e-5, 1e5)):
        self.length_scale = length_scale
        self.periodicity = periodicity
        self.length_scale_bounds = length_scale_bounds
        self.periodicity_bounds = periodicity_bounds

    @property
    def hyperparameter_length_scale(self):
        return Hyperparameter("length_scale", "numeric", self.length_scale_bounds)

    @property
    def hyperparameter_periodicity(self):
        return Hyperparameter("periodicity", "numeric", self.periodicity_bounds)

    def __call__(self, X, Y=None, eval_gradient=False):
        X = _x(X)
        if Y is not None and eval_gradient:
            raise ValueError("Gradient can only be evaluated when Y is None.")
        ls, p = float(self.length_scale), float(self.periodicity)
        dists = torch.sqrt(sq_dists(X, X if Y is None else _x(Y, X)))
        if Y is not None:
            return torch.exp(-2 * (torch.sin(_scalar(math.pi / p, X) * dists)
                                   / _scalar(ls, X)) ** 2)
        arg = math.pi * dists / _scalar(p, X)
        sin_of_arg = torch.sin(arg)
        K = torch.exp(-2 * (sin_of_arg / _scalar(ls, X)) ** 2)
        if not eval_gradient:
            return K
        cos_of_arg = torch.cos(arg)
        parts = []
        if not self.hyperparameter_length_scale.fixed:
            parts.append(4 / ls ** 2 * sin_of_arg ** 2 * K)
        if not self.hyperparameter_periodicity.fixed:
            parts.append(4 * arg / _scalar(ls ** 2, X) * cos_of_arg * sin_of_arg * K)
        return K, (torch.stack(parts, -1) if parts else _empty_gradient(X))

    def __repr__(self):
        return (f"{type(self).__name__}(length_scale={self.length_scale:.3g}, "
                f"periodicity={self.periodicity:.3g})")


class DotProduct(Kernel):
    """k(x, y) = σ₀² + x·y."""

    def __init__(self, sigma_0=1.0, sigma_0_bounds=(1e-5, 1e5)):
        self.sigma_0 = sigma_0
        self.sigma_0_bounds = sigma_0_bounds

    @property
    def hyperparameter_sigma_0(self):
        return Hyperparameter("sigma_0", "numeric", self.sigma_0_bounds)

    def __call__(self, X, Y=None, eval_gradient=False):
        X = _x(X)
        if Y is not None and eval_gradient:
            raise ValueError("Gradient can only be evaluated when Y is None.")
        s2 = float(self.sigma_0) ** 2
        K = X @ (X if Y is None else _x(Y, X)).T + s2
        if not eval_gradient:
            return K
        if self.hyperparameter_sigma_0.fixed:
            return K, _empty_gradient(X)
        return K, X.new_full((X.shape[0], X.shape[0], 1), 2 * s2)

    def diag(self, X):
        X = _x(X)
        return torch.einsum("ij,ij->i", X, X) + float(self.sigma_0) ** 2

    def is_stationary(self):
        return False

    def __repr__(self):
        return f"{type(self).__name__}(sigma_0={self.sigma_0:.3g})"


class PairwiseKernel(Kernel):
    """sklearn's PairwiseKernel: `_pairwise.pairwise_kernels(X, Y, metric,
    gamma=γ, filter_params=True, **pairwise_kernels_kwargs)`, a metric name
    of sklearn.metrics.pairwise, "precomputed" or a callable (user code, run
    on the host on numpy rows); θ = log γ, its gradient the finite
    difference at exp(θ). diag is each row's kernel with itself as a 1 x 1
    kernel (sklearn's apply_along_axis)."""

    def __init__(self, gamma=1.0, gamma_bounds=(1e-5, 1e5), metric="linear",
                 pairwise_kernels_kwargs=None):
        self.gamma = gamma
        self.gamma_bounds = gamma_bounds
        self.metric = metric
        self.pairwise_kernels_kwargs = pairwise_kernels_kwargs

    @property
    def hyperparameter_gamma(self):
        return Hyperparameter("gamma", "numeric", self.gamma_bounds)

    def _kernel(self, X, Y, gamma):
        return pairwise_kernels(X, Y, metric=self.metric, gamma=gamma, filter_params=True,
                                **(self.pairwise_kernels_kwargs or {}))

    def __call__(self, X, Y=None, eval_gradient=False):
        X = _x(X)
        Y = None if Y is None else _x(Y, X)
        K = self._kernel(X, Y, self.gamma)
        if not eval_gradient:
            return K
        if self.hyperparameter_gamma.fixed:
            return K, _empty_gradient(X)
        return K, _approx_fprime(self.theta, lambda t: self._kernel(X, Y, np.exp(t)))

    def diag(self, X):
        X = _x(X)
        if callable(self.metric):
            kw = dict(self.pairwise_kernels_kwargs or {}, gamma=self.gamma)
            return torch.as_tensor([self.metric(x, x, **kw) for x in X.cpu().numpy()],
                                   dtype=torch.float64, device=X.device)
        # each row's kernel with itself, as a 1 x 1 kernel
        return torch.stack([self._kernel(x[None], None, self.gamma)[0, 0] for x in X])

    def is_stationary(self):
        return isinstance(self.metric, str) and self.metric == "rbf"

    def __repr__(self):
        return f"{type(self).__name__}(gamma={self.gamma}, metric={self.metric})"


class KernelOperator(Kernel):
    """A kernel of two kernels: θ is k1's then k2's."""

    def __init__(self, k1, k2):
        self.k1 = k1
        self.k2 = k2

    def get_params(self, deep=True):
        params = dict(k1=self.k1, k2=self.k2)
        if deep:
            for name in ("k1", "k2"):
                params.update((f"{name}__{k}", v)
                              for k, v in getattr(self, name).get_params().items())
        return params

    @property
    def hyperparameters(self):
        return [Hyperparameter(f"{name}__{h.name}", h.value_type, h.bounds, h.n_elements)
                for name in ("k1", "k2") for h in getattr(self, name).hyperparameters]

    @property
    def theta(self):
        return np.append(self.k1.theta, self.k2.theta)

    @theta.setter
    def theta(self, theta):
        k1_dims = self.k1.n_dims
        self.k1.theta = theta[:k1_dims]
        self.k2.theta = theta[k1_dims:]

    @property
    def bounds(self):
        if self.k1.bounds.size == 0:
            return self.k2.bounds
        if self.k2.bounds.size == 0:
            return self.k1.bounds
        return np.vstack((self.k1.bounds, self.k2.bounds))

    def __eq__(self, b):
        if type(self) is not type(b):
            return False
        return ((self.k1 == b.k1 and self.k2 == b.k2)
                or (self.k1 == b.k2 and self.k2 == b.k1))

    def is_stationary(self):
        return self.k1.is_stationary() and self.k2.is_stationary()

    @property
    def requires_vector_input(self):
        return bool(self.k1.requires_vector_input or self.k2.requires_vector_input)


class Sum(KernelOperator):
    """k1 + k2."""

    def __call__(self, X, Y=None, eval_gradient=False):
        if not eval_gradient:
            return self.k1(X, Y) + self.k2(X, Y)
        K1, G1 = self.k1(X, Y, eval_gradient=True)
        K2, G2 = self.k2(X, Y, eval_gradient=True)
        return K1 + K2, torch.cat((G1, G2), 2)

    def diag(self, X):
        return self.k1.diag(X) + self.k2.diag(X)

    def __repr__(self):
        return f"{self.k1} + {self.k2}"


class Product(KernelOperator):
    """k1 * k2."""

    def __call__(self, X, Y=None, eval_gradient=False):
        if not eval_gradient:
            return self.k1(X, Y) * self.k2(X, Y)
        K1, G1 = self.k1(X, Y, eval_gradient=True)
        K2, G2 = self.k2(X, Y, eval_gradient=True)
        return K1 * K2, torch.cat((G1 * K2[:, :, None], G2 * K1[:, :, None]), 2)

    def diag(self, X):
        return self.k1.diag(X) * self.k2.diag(X)

    def __repr__(self):
        return f"{self.k1} * {self.k2}"


class Exponentiation(Kernel):
    """kernel ** exponent."""

    def __init__(self, kernel, exponent):
        self.kernel = kernel
        self.exponent = exponent

    def get_params(self, deep=True):
        params = dict(kernel=self.kernel, exponent=self.exponent)
        if deep:
            params.update((f"kernel__{k}", v) for k, v in self.kernel.get_params().items())
        return params

    @property
    def hyperparameters(self):
        return [Hyperparameter(f"kernel__{h.name}", h.value_type, h.bounds, h.n_elements)
                for h in self.kernel.hyperparameters]

    @property
    def theta(self):
        return self.kernel.theta

    @theta.setter
    def theta(self, theta):
        self.kernel.theta = theta

    @property
    def bounds(self):
        return self.kernel.bounds

    def __eq__(self, b):
        if type(self) is not type(b):
            return False
        return self.kernel == b.kernel and self.exponent == b.exponent

    def is_stationary(self):
        return self.kernel.is_stationary()

    @property
    def requires_vector_input(self):
        return self.kernel.requires_vector_input

    def __call__(self, X, Y=None, eval_gradient=False):
        if not eval_gradient:
            return self.kernel(X, Y) ** self.exponent
        K, G = self.kernel(X, Y, eval_gradient=True)
        G = G * (self.exponent * K[:, :, None] ** (self.exponent - 1))
        return K ** self.exponent, G

    def diag(self, X):
        return self.kernel.diag(X) ** self.exponent

    def __repr__(self):
        return f"{self.kernel} ** {self.exponent}"


class CompoundKernel(Kernel):
    """sklearn's CompoundKernel: several kernels side by side, their K
    stacked on a last axis (n, m, n_kernels), ∂K/∂θ as (n, n, n_dims,
    n_kernels), diag (n, n_kernels); θ and bounds stacked. sklearn's
    GaussianProcessClassifier returns one as its kernel_ above two classes;
    its θ setter, which in sklearn reads a k1 the class lacks, here hands
    each kernel its n_dims in turn."""

    def __init__(self, kernels):
        self.kernels = kernels

    def get_params(self, deep=True):
        return dict(kernels=self.kernels)

    @property
    def theta(self):
        return np.hstack([k.theta for k in self.kernels])

    @theta.setter
    def theta(self, theta):
        i = 0
        for k in self.kernels:
            k.theta = theta[i:i + k.n_dims]
            i += k.n_dims

    @property
    def bounds(self):
        return np.vstack([k.bounds for k in self.kernels])

    def __call__(self, X, Y=None, eval_gradient=False):
        if not eval_gradient:
            return torch.stack([k(X, Y) for k in self.kernels], -1)
        parts = [k(X, Y, eval_gradient) for k in self.kernels]
        return (torch.stack([K for K, _ in parts], -1),
                torch.cat([G[..., None] for _, G in parts], 3))

    def __eq__(self, b):
        if type(self) is not type(b) or len(self.kernels) != len(b.kernels):
            return False
        return all(a == c for a, c in zip(self.kernels, b.kernels))

    def is_stationary(self):
        return all(k.is_stationary() for k in self.kernels)

    @property
    def requires_vector_input(self):
        return any(k.requires_vector_input for k in self.kernels)

    def diag(self, X):
        return torch.stack([k.diag(X) for k in self.kernels], 1)


def _host(X):
    """X as the user's kernel takes it (a numpy array or the rows of
    HostRows) and the device its values go to."""
    if isinstance(X, HostRows):
        return X.data, X.device
    if torch.is_tensor(X):
        return X.cpu().numpy(), X.device
    return X, torch.device("cpu")


class HostKernel(Kernel):
    """A kernel the user wrote with sklearn's kernel API (KERNEL_API), in
    numpy: called on the host, its K, ∂K/∂θ and diag moved to the device of
    X as float64. θ, bounds, hyperparameters and clones are the user
    object's. The only kernel that runs on the host."""

    def __init__(self, kernel):
        self.kernel = kernel

    def get_params(self, deep=True):
        return dict(kernel=self.kernel)

    @property
    def hyperparameters(self):
        return list(self.kernel.hyperparameters)

    @property
    def theta(self):
        return np.asarray(self.kernel.theta, dtype=np.float64)

    @theta.setter
    def theta(self, theta):
        self.kernel.theta = theta

    @property
    def bounds(self):
        return np.asarray(self.kernel.bounds, dtype=np.float64)

    def clone_with_theta(self, theta):
        return HostKernel(self.kernel.clone_with_theta(theta))

    def __call__(self, X, Y=None, eval_gradient=False):
        Xh, dev = _host(X)

        def t(a):
            return torch.as_tensor(np.asarray(a, dtype=np.float64), device=dev)
        if eval_gradient:
            if Y is not None:
                raise ValueError("Gradient can only be evaluated when Y is None.")
            K, G = self.kernel(Xh, eval_gradient=True)
            return t(K), t(G)
        return t(self.kernel(Xh) if Y is None else self.kernel(Xh, _host(Y)[0]))

    def diag(self, X):
        Xh, dev = _host(X)
        return torch.as_tensor(np.asarray(self.kernel.diag(Xh), dtype=np.float64), device=dev)

    def __eq__(self, b):
        return type(self) is type(b) and self.kernel == b.kernel

    def is_stationary(self):
        return bool(self.kernel.is_stationary())

    @property
    def requires_vector_input(self):
        return bool(self.kernel.requires_vector_input)

    def __repr__(self):
        return repr(self.kernel)


# sklearn's kernel classes, by the names sklearn.gaussian_process.kernels
# gives them
CLASSES = {k.__name__: k for k in (ConstantKernel, WhiteKernel, RBF, Matern,
                                   RationalQuadratic, ExpSineSquared, DotProduct,
                                   PairwiseKernel, Sum, Product, Exponentiation,
                                   CompoundKernel)}
# the names a kernel expression may use (experiments/kernel_baselines.py
# KERNEL_OPTIONS): the classes and sklearn's usual alias C
NAMESPACE = dict(CLASSES, C=ConstantKernel)
SKLEARN_MODULE = "sklearn.gaussian_process.kernels"


def _operand(b) -> Kernel:
    """The other side of +, * : a kernel object as from_sklearn takes it, a
    number as a ConstantKernel."""
    if isinstance(b, Kernel) or all(hasattr(b, a) for a in KERNEL_API):
        return from_sklearn(b)
    return ConstantKernel(b)


def from_sklearn(kernel) -> Kernel:
    """An sklearn kernel object -> the port's kernel with the same
    parameters. One of sklearn's own classes converts by its class name and
    `get_params(deep=False)` (sklearn is not imported), its parts in turn;
    a port kernel is returned as it is; any other object with sklearn's
    kernel API (KERNEL_API: a kernel the user wrote, or a subclass of one of
    sklearn's) becomes a HostKernel. Anything else raises ValueError."""
    if isinstance(kernel, Kernel):
        return kernel
    cls = type(kernel)
    if cls.__module__ == SKLEARN_MODULE and cls.__name__ in CLASSES:
        name, params = cls.__name__, kernel.get_params(deep=False)
        if name in ("Sum", "Product"):
            return CLASSES[name](from_sklearn(params["k1"]), from_sklearn(params["k2"]))
        if name == "Exponentiation":
            return Exponentiation(from_sklearn(params["kernel"]), params["exponent"])
        if name == "CompoundKernel":
            return CompoundKernel([from_sklearn(k) for k in params["kernels"]])
        return CLASSES[name](**{k: copy.deepcopy(v) for k, v in params.items()})
    missing = [a for a in KERNEL_API if not hasattr(kernel, a)]
    if missing:
        raise ValueError(f"{cls.__name__} ({kernel!r}) is not a GP kernel: it lacks "
                         f"{missing} of sklearn's kernel API")
    return HostKernel(kernel)
