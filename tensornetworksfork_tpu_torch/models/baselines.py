"""Comparison baselines (port of tensornetworksfork_tpu/models/baselines.py).

- `MLP`, `PINet` (multiplicative residual), `ResMLP` and `SimpleCNN` as
  `nn.Module`s, trained by `MLPWrapper` / `CNNWrapper` with
  `torch.optim.AdamW` (weight_decay 1e-4, optax.adamw's default, so both
  libraries apply the same update). Layers start as flax's do: kernels
  lecun-normal (truncated at two standard deviations, variance 1/fan_in),
  biases zero, drawn from a `torch.Generator(seed)` (flax's own init
  crosses with `utils.convert.mlp_params_from_flax`). `SimpleCNN` takes images
  (B, H, W) or (B, H, W, C), as flax's NHWC model does, and runs NCHW
  inside: its flatten order is (c, h, w), where flax's is (h, w, c).
- `PolynomialRegressionWrapper`: sklearn's PolynomialFeatures with Ridge
  (regularization="l2"), Lasso ("l1") or the pseudo-inverse (None), written
  in torch on `device` because the card's machine has no sklearn. The
  monomials of degree 0..degree come in sklearn's column order (each built
  as its first feature times the lower-degree column of the rest, as
  sklearn builds it, so the features are bit-equal). Ridge(alpha) has its
  centred, unpenalised intercept and is solved by a Cholesky solve of the
  primal system, or of the kernel system X Xᵀ where there are more
  features than rows, as sklearn's "cholesky" solver does, in float64 (as
  the pseudo-inverse is), its coefficients returned in the inputs' dtype.
  Lasso(alpha) is sklearn's cyclic coordinate descent (`lasso_cd`): the
  objective 1/(2n) ||y - Xw - b||² + alpha ||w||₁ on centred data, gap
  safe screening, and its stopping rule (a full pass whose largest
  coefficient change is below tol times the largest coefficient, then a
  duality gap below tol ||y||²), max_iter 1000, tol 1e-4.

- `SVMClfWrapper` / `SVMRegWrapper`: sklearn's SVC / SVR, which are
  libsvm, written out in torch (`models/_libsvm.py`): C-SVC one-vs-one over
  the k(k-1)/2 class pairs with libsvm's vote (class_weight and break_ties
  as sklearn's), and ε-SVR; float64 on `device`, the kernel entries rounded
  to float32 as libsvm's Qfloat. kernel="precomputed" takes the (n, n)
  Gram matrix at fit and the (m, n) test-train kernel at predict; a
  callable kernel is user code, called on the host on X as given
  (kernel(X, X_fit), as sklearn calls it) and then treated as precomputed
  on the device. probability=True fits the same model (libsvm trains it
  apart from Platt scaling's folds), and nothing here reads probabilities.
- `GaussianProcessWrapper`: sklearn's GaussianProcessRegressor and
  GaussianProcessClassifier over sklearn's kernel objects (the port's
  `models/_gp_kernels.py`, sklearn's own converted by class name, or a
  kernel the user wrote, run on the host; defaults C(1) * RBF(1), free for
  regression and fixed for classification): L-BFGS-B or a callable
  optimizer on the log-marginal likelihood with restarts, binary Laplace,
  one-vs-rest or one-vs-one above two classes, warm_start, written out in
  torch (`models/_gp.py`). A kernel that does not require vector input
  takes rows of anything (strings, say), as sklearn's do. A CompoundKernel
  as input raises ValueError, as sklearn's classifier refuses it.

Not ported: the XGBoost wrappers. xgboost is missing on the card's machine
and on the machine that runs the tests, so there is no reference to hold a
port to.
"""
from __future__ import annotations

import copy
import itertools
import math
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..utils.device import resolve_device
from . import _gp, _gp_kernels, _libsvm

# flax's lecun_normal: a normal truncated to [-2, 2] has this standard
# deviation; its samples are divided by it to keep the variance 1/fan_in
_TRUNC_STD = 0.87962566103423978


def _lecun_normal_(w: torch.Tensor, fan_in: int, gen: torch.Generator) -> None:
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    with torch.no_grad():
        nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=gen)


def _dense(fan_in: int, fan_out: int, gen: torch.Generator) -> nn.Linear:
    layer = nn.Linear(fan_in, fan_out)
    _lecun_normal_(layer.weight, fan_in, gen)
    nn.init.zeros_(layer.bias)
    return layer


def _activation(name: str):
    return torch.relu if name == "relu" else torch.tanh


class MLP(nn.Module):
    """Dense layers with an activation after each hidden one."""

    def __init__(self, input_dim: int, output_dim: int,
                 hidden_layers: Sequence[int] = (64, 64),
                 activation: str = "relu", seed: int = 0):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        dims = [input_dim, *hidden_layers, output_dim]
        self.dense = nn.ModuleList(_dense(a, b, gen) for a, b in zip(dims, dims[1:]))
        self.act = _activation(activation)

    def forward(self, x):
        for layer in self.dense[:-1]:
            x = self.act(layer(x))
        return self.dense[-1](x)


class PINet(nn.Module):
    """Multiplicative-residual net: a hidden layer of the same width as its
    input multiplies it in; no activation."""

    def __init__(self, input_dim: int, output_dim: int,
                 hidden_layers: Sequence[int] = (64, 64), seed: int = 0):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        dims = [input_dim, *hidden_layers, output_dim]
        self.dense = nn.ModuleList(_dense(a, b, gen) for a, b in zip(dims, dims[1:]))

    def forward(self, x):
        res = x
        for layer in self.dense[:-1]:
            h = layer(x)
            x = h * res if layer.in_features == layer.out_features else h
            res = x
        return self.dense[-1](x)


class ResMLP(nn.Module):
    """MLP with an additive skip over each hidden layer of the same width
    as its input."""

    def __init__(self, input_dim: int, output_dim: int,
                 hidden_layers: Sequence[int] = (64, 64),
                 activation: str = "relu", seed: int = 0):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        dims = [input_dim, *hidden_layers, output_dim]
        self.dense = nn.ModuleList(_dense(a, b, gen) for a, b in zip(dims, dims[1:]))
        self.act = _activation(activation)

    def forward(self, x):
        res = x
        for layer in self.dense[:-1]:
            h = self.act(layer(x))
            x = h + res if layer.in_features == layer.out_features else h
            res = x
        return self.dense[-1](x)


class SimpleCNN(nn.Module):
    """Two (3x3 same-padded conv, relu, 2x2 max pool) stages, a 64-wide
    dense layer and the class logits. `image_shape` is (H, W, C) of one
    input image."""

    def __init__(self, num_classes: int = 10, channels: Sequence[int] = (16, 32),
                 image_shape=(28, 28, 1), seed: int = 0):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        H, W, cin = image_shape
        convs = []
        for ch in channels:
            conv = nn.Conv2d(cin, ch, 3, padding=1)
            _lecun_normal_(conv.weight, 9 * cin, gen)
            nn.init.zeros_(conv.bias)
            convs.append(conv)
            cin, H, W = ch, H // 2, W // 2
        self.conv = nn.ModuleList(convs)
        self.dense = nn.ModuleList([_dense(cin * H * W, 64, gen),
                                    _dense(64, num_classes, gen)])

    def forward(self, x):
        x = x[..., None] if x.ndim == 3 else x
        x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW
        for conv in self.conv:
            x = nn.functional.max_pool2d(torch.relu(conv(x)), 2, 2)
        x = torch.relu(self.dense[0](x.reshape(x.shape[0], -1)))
        return self.dense[1](x)


class MLPWrapper:
    """AdamW minibatch trainer: `epochs` passes over a fresh permutation
    (numpy default_rng(seed)) in `batch_size` batches; mean squared error
    for regression, softmax cross-entropy on integer labels (one-hot
    targets are argmaxed) for classification. After fit, `final_loss_`
    holds that loss over the whole training set."""

    def __init__(self, input_dim, output_dim, mlp_params=None,
                 task="regression", device="cuda"):
        p = mlp_params or {}
        self.input_dim, self.output_dim = input_dim, output_dim
        self.hidden = tuple(p.get("hidden_layers", (64, 64)))
        self.activation = p.get("activation", "relu")
        self.lr = p.get("lr", 1e-1)
        self.epochs = p.get("epochs", 50)
        self.batch_size = p.get("batch_size", 128)
        self.kind = p.get("type", "mlp").lower()
        self.task = task
        self._seed = p.get("seed", 0)
        self.device = resolve_device(device)
        self.model = None
        self.final_loss_ = None

    def _build(self, X) -> nn.Module:
        if self.kind.startswith("pin"):
            return PINet(self.input_dim, self.output_dim, self.hidden, seed=self._seed)
        if self.kind.startswith("res"):
            return ResMLP(self.input_dim, self.output_dim, self.hidden,
                          self.activation, seed=self._seed)
        return MLP(self.input_dim, self.output_dim, self.hidden, self.activation,
                   seed=self._seed)

    def _as_x(self, X) -> torch.Tensor:
        return torch.as_tensor(np.asarray(X), dtype=torch.float32, device=self.device)

    def fit(self, X, y):
        X = self._as_x(X)
        y = np.asarray(y)
        if self.task == "classification":
            if y.ndim == 2:
                y = y.argmax(-1)
            y = torch.as_tensor(y, dtype=torch.long, device=self.device)

            def loss_fn(out, yb):
                return nn.functional.cross_entropy(out, yb)
        else:
            y = torch.as_tensor(y, dtype=torch.float32, device=self.device)
            if y.ndim == 1:
                y = y[:, None]

            def loss_fn(out, yb):
                return torch.mean((out - yb) ** 2)

        self.model = self._build(X).to(self.device)
        opt = torch.optim.AdamW(self.model.parameters(), lr=self.lr,
                                betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)
        n = X.shape[0]
        rng = np.random.default_rng(self._seed)
        for _ in range(self.epochs):
            idx = torch.as_tensor(rng.permutation(n), device=self.device)
            for b in range(0, n, self.batch_size):
                bi = idx[b:b + self.batch_size]
                opt.zero_grad(set_to_none=True)
                loss_fn(self.model(X[bi]), y[bi]).backward()
                opt.step()
        with torch.no_grad():
            self.final_loss_ = float(loss_fn(self.model(X), y))
        return self

    def predict(self, X):
        with torch.no_grad():
            out = self.model(self._as_x(X))
        if self.task == "classification":
            return out.argmax(dim=1).cpu().numpy()
        return out.cpu().numpy().squeeze(-1)


class CNNWrapper(MLPWrapper):
    """`SimpleCNN` classifier trained as MLPWrapper trains (lr 1e-3, 5
    epochs, batches of 128 by default)."""

    def __init__(self, num_classes=10, cnn_params=None, device="cuda"):
        p = cnn_params or {}
        super().__init__(None, num_classes, dict(lr=p.get("lr", 1e-3),
                                                 epochs=p.get("epochs", 5),
                                                 batch_size=p.get("batch_size", 128),
                                                 seed=p.get("seed", 0)),
                         task="classification", device=device)
        self.channels = tuple(p.get("channels", (16, 32)))

    def _build(self, X) -> nn.Module:
        shape = tuple(X.shape[1:]) + ((1,) if X.ndim == 3 else ())
        return SimpleCNN(self.output_dim, self.channels, shape, seed=self._seed)


def polynomial_features(X: torch.Tensor, degree: int) -> torch.Tensor:
    """sklearn's PolynomialFeatures(degree) (bias column included) of the
    rows of X: combinations with replacement of the features, by degree."""
    n, d = X.shape
    cols = {(): torch.ones((n,), dtype=X.dtype, device=X.device)}
    for deg in range(1, degree + 1):
        for c in itertools.combinations_with_replacement(range(d), deg):
            cols[c] = cols[c[1:]] * X[:, c[0]]
    return torch.stack(list(cols.values()), dim=1)


def _lasso_gap(X, y, R, w, alpha):
    """sklearn's duality gap of the Lasso (its formulation A, no l2 term):
    (gap, X'R, ||X'R||_inf)."""
    XtA = X.T @ R
    dual_norm = float(XtA.abs().max())
    R_norm2, Ry = float(R @ R), float(R @ y)
    scale = alpha / dual_norm if dual_norm > alpha else 1.0
    primal = 0.5 * R_norm2 + alpha * float(w.abs().sum())
    dual = -0.5 * scale ** 2 * R_norm2 + scale * Ry
    return primal - dual, XtA, dual_norm


def lasso_cd(X: torch.Tensor, y: torch.Tensor, alpha: float, max_iter: int = 1000,
             tol: float = 1e-4) -> torch.Tensor:
    """sklearn's `enet_coordinate_descent` with beta = 0 on centred X (n, p)
    and y (n,): minimises 1/2 ||y - Xw||² + alpha ||w||₁ (alpha already
    scaled by n) by cyclic coordinate descent with gap safe screening.
    Returns w (p,) in X's dtype and device."""
    p = X.shape[1]
    w = torch.zeros(p, dtype=X.dtype, device=X.device)
    norm2 = [float(v) for v in torch.einsum("ij,ij->j", X, X)]
    R = y.clone()
    d_w_tol, tol = tol, tol * float(y @ y)
    gap, XtA, dual_norm = _lasso_gap(X, y, R, w, alpha)
    if gap <= tol:
        return w

    def screen(candidates):
        """The coordinates the gap cannot rule out; the others go to 0."""
        active = []
        for j in candidates:
            if norm2[j] == 0:
                w[j] = 0
                continue
            d_j = (1 - abs(float(XtA[j]) / max(alpha, dual_norm))) / math.sqrt(norm2[j])
            if d_j <= math.sqrt(2 * gap) / alpha:
                active.append(j)
            elif float(w[j]) != 0:
                R.add_(X[:, j], alpha=float(w[j]))
                w[j] = 0
        return active

    active = screen(range(p))
    for n_iter in range(max_iter):
        w_max = d_w_max = 0.0
        for j in active:
            if norm2[j] == 0.0:
                continue
            w_j = float(w[j])
            tmp = float(X[:, j] @ R) + w_j * norm2[j]
            new = math.copysign(max(abs(tmp) - alpha, 0.0), tmp) / norm2[j] if tmp else 0.0
            w[j] = new
            # the stored (dtype-rounded) value, as sklearn's typed w holds it
            new = float(w[j])
            if new != w_j:
                R.add_(X[:, j], alpha=w_j - new)
            d_w_max = max(d_w_max, abs(new - w_j))
            w_max = max(w_max, abs(new))
        if w_max == 0.0 or d_w_max / w_max <= d_w_tol or n_iter == max_iter - 1:
            gap, XtA, dual_norm = _lasso_gap(X, y, R, w, alpha)
            if gap <= tol:
                break
            active = screen(active)
    return w


class PolynomialRegressionWrapper:
    """Polynomial features + Ridge (regularization="l2"), Lasso ("l1") or
    pinv (None)."""

    def __init__(self, degree=2, regularization: Optional[str] = None,
                 alpha=1.0, device="cuda"):
        if regularization not in (None, "l1", "l2"):
            raise ValueError(f"regularization must be None, 'l1' or 'l2', not "
                             f"{regularization!r}")
        self.degree = degree
        self.regularization = regularization
        self.alpha = alpha
        self.device = resolve_device(device)
        self._coef = None
        self._intercept = None

    def _features(self, X):
        X = torch.as_tensor(np.asarray(X), device=self.device)
        return polynomial_features(X, self.degree)

    def fit(self, X, y):
        X = np.asarray(X)
        dtype = torch.as_tensor(X[:0]).dtype   # the features' and the answer's
        y = torch.as_tensor(np.asarray(y), device=self.device)
        one_d = y.ndim == 1
        y2 = (y[:, None] if one_d else y).to(dtype)
        if self.regularization == "l1":
            Xp = self._features(X)
            x_off, y_off = Xp.mean(dim=0), y2.mean(dim=0)
            Xc, yc = Xp - x_off, y2 - y_off
            coef = torch.stack([lasso_cd(Xc, yc[:, k].contiguous(),
                                         self.alpha * Xc.shape[0])
                                for k in range(yc.shape[1])], dim=1)
            self._coef = coef
            self._intercept = y_off - x_off @ coef
            return self._finish(one_d, y2)
        # pinv and the ridge are solved in float64 (ridge systems of
        # condition up to ~3e7 here, where a float32 Cholesky's answer
        # moves with the thread count), the coefficients cast back to X's
        # dtype, which sklearn keeps
        Xd, yd = self._features(X.astype(np.float64)), y2.double()
        if self.regularization is None:
            self._coef = (torch.linalg.pinv(Xd) @ yd).to(dtype)
            self._intercept = torch.zeros(y2.shape[1], dtype=dtype, device=self.device)
        else:
            x_off, y_off = Xd.mean(dim=0), yd.mean(dim=0)
            Xc, yc = Xd - x_off, yd - y_off
            n, p = Xc.shape
            if p > n:  # the kernel form: dual = (X Xᵀ + alpha I)⁻¹ y
                K = Xc @ Xc.T
                K.diagonal().add_(self.alpha)
                coef = Xc.T @ torch.cholesky_solve(yc, torch.linalg.cholesky(K))
            else:
                A = Xc.T @ Xc
                A.diagonal().add_(self.alpha)
                coef = torch.cholesky_solve(Xc.T @ yc, torch.linalg.cholesky(A))
            self._coef = coef.to(dtype)
            self._intercept = (y_off - x_off @ coef).to(dtype)
        return self._finish(one_d, y2)

    def _finish(self, one_d, y2):
        # sklearn's Ridge and Lasso return a single target as a 1-D prediction
        self._ravel = one_d or (self.regularization is not None and y2.shape[1] == 1)
        return self

    def predict(self, X):
        pred = self._features(X) @ self._coef + self._intercept
        return (pred[:, 0] if self._ravel else pred).cpu().numpy()


# sklearn's SVC / SVR parameters and their defaults; the ones the port
# computes with, and those it accepts at their default only
_SVM_DEFAULTS = dict(C=1.0, kernel="rbf", degree=3, gamma="scale", coef0=0.0,
                     shrinking=True, tol=1e-3, max_iter=-1, cache_size=200)
_SVR_DEFAULTS = dict(_SVM_DEFAULTS, epsilon=0.1)
_SVC_DEFAULTS = dict(_SVM_DEFAULTS, decision_function_shape="ovr", random_state=None,
                     class_weight=None, break_ties=False)
# accepted at these values only: verbose libsvm output is not ported;
# probability=True trains the same model (libsvm fits it apart from Platt
# scaling's random folds) and only Platt's sigmoid, which nothing here
# reads, would need those folds
_SVC_FIXED = dict(probability=(False, True, "deprecated"), verbose=(False,))
_SVR_FIXED = dict(verbose=(False,))


def _svm_settings(params, defaults, fixed) -> dict:
    """sklearn's SVC / SVR keyword arguments, checked: a key the port does
    not implement (or a value it does not) raises ValueError naming it."""
    out = dict(defaults)
    for key, value in (params or {}).items():
        if key in fixed:
            if not any(value is v or value == v for v in fixed[key]):
                raise ValueError(f"svm_params[{key!r}] = {value!r} is not ported "
                                 f"(only {fixed[key]!r})")
        elif key not in defaults:
            raise ValueError(f"svm_params key {key!r} is not ported")
        else:
            out[key] = value
    if not (callable(out["kernel"]) or out["kernel"] in _libsvm.KERNELS):
        raise ValueError(f"svm_params['kernel'] = {out['kernel']!r} is not one of "
                         f"{_libsvm.KERNELS} or a callable")
    if out.get("decision_function_shape", "ovr") not in ("ovr", "ovo"):
        raise ValueError("svm_params['decision_function_shape'] must be 'ovr' or 'ovo'")
    cw = out.get("class_weight")
    if not (cw is None or cw == "balanced" or isinstance(cw, dict)):
        raise ValueError(f"svm_params['class_weight'] must be None, 'balanced' or a "
                         f"dict, not {cw!r}")
    return out


def class_weights(class_weight, codes: np.ndarray, k: int) -> np.ndarray:
    """sklearn's compute_class_weight over the codes 0..k-1 that the wrapper
    hands SVC: ones for None, n / (k bincount) for "balanced", else the
    dict's value of each code it holds (1 for the others); a dict with a key
    that is no class raises ValueError where it also misses a class."""
    if class_weight is None or len(class_weight) == 0:
        return np.ones(k)
    if isinstance(class_weight, str):
        return len(codes) / (k * np.bincount(codes, minlength=k))
    weight = np.ones(k)
    missing = []
    for c in range(k):
        if c in class_weight:
            weight[c] = class_weight[c]
        else:
            missing.append(c)
    if missing and k - len(missing) != len(class_weight):
        raise ValueError(f"The classes, {missing}, are not in class_weight")
    return weight


def _svm_gamma(gamma, X: np.ndarray) -> float:
    """sklearn's _gamma: "scale" = 1 / (n_features X.var()) (1 where the
    variance is 0), "auto" = 1 / n_features, or the number given."""
    if gamma == "scale":
        var = X.var()
        return 1.0 / (X.shape[1] * var) if var != 0 else 1.0
    if gamma == "auto":
        return 1.0 / X.shape[1]
    return float(gamma)


class _SVMBase:
    def __init__(self, svm_params, defaults, fixed, device):
        self.settings = _svm_settings(svm_params, defaults, fixed)
        self.device = resolve_device(device)
        self.model_ = None

    @property
    def _precomputed(self) -> bool:
        """Whether the model sees a kernel matrix: "precomputed" or a callable."""
        k = self.settings["kernel"]
        return callable(k) or k == "precomputed"

    def _x(self, X) -> torch.Tensor:
        """X as float64 rows on the device; under a callable kernel its
        matrix against the training rows (kernel(X, X_fit), on the host);
        under "precomputed" the (m, n_train) kernel, checked as sklearn's
        predict checks it."""
        k = self.settings["kernel"]
        if callable(k):
            X = k(X, self._X_fit)
        elif k == "precomputed":
            n, m = self.shape_fit_[0], np.shape(X)[1]
            if m != n:
                name = "SVC" if isinstance(self, SVMClfWrapper) else "SVR"
                raise ValueError(f"X has {m} features, but {name} is expecting {n} features "
                                 "as input.")
        return torch.as_tensor(np.asarray(X, np.float64), device=self.device)

    def _fit_x(self, X):
        """The training X on the device (a callable kernel's Gram kernel(X,
        X), computed on the host on X as given, as sklearn does; a
        precomputed Gram matrix checked square) and the array that sets
        gamma."""
        k = self.settings["kernel"]
        if callable(k):
            self._X_fit = X
            A = np.asarray(k(X, X), np.float64)
        else:
            A = np.asarray(X, np.float64)
        if self._precomputed and A.shape[0] != A.shape[1]:
            raise ValueError("Precomputed matrix must be a square matrix. Input is a "
                             f"{A.shape[0]}x{A.shape[1]} matrix.")
        self.shape_fit_ = np.shape(X) if callable(k) else A.shape
        return torch.as_tensor(A, device=self.device), A

    def _fit_args(self, X: np.ndarray) -> dict:
        s = self.settings
        return dict(C=float(s["C"]),
                    kernel="precomputed" if self._precomputed else s["kernel"],
                    gamma=0.0 if self._precomputed else _svm_gamma(s["gamma"], X),
                    coef0=float(s["coef0"]), degree=int(s["degree"]), tol=float(s["tol"]),
                    shrinking=bool(s["shrinking"]), max_iter=int(s["max_iter"]))

    @property
    def n_iter_(self):
        return self.model_.n_iter

    @property
    def support_(self) -> np.ndarray:
        """sklearn's support_: the training rows of the support vectors."""
        return self.model_.support.cpu().numpy().astype(np.int32)


class SVMRegWrapper(_SVMBase):
    """sklearn's SVR(**svm_params) (ε-SVR, libsvm's solver) in torch on
    `device`; predict = Σ coef K(x, sv) - rho."""

    def __init__(self, svm_params=None, device="cuda"):
        super().__init__(svm_params, _SVR_DEFAULTS, _SVR_FIXED, device)

    def fit(self, X, y):
        Xt, X = self._fit_x(X)
        y = np.asarray(y, np.float64)
        y = y.squeeze(-1) if y.ndim > 1 else y
        self.model_ = _libsvm.fit_svr(Xt, torch.as_tensor(y, device=self.device),
                                      epsilon=float(self.settings["epsilon"]),
                                      **self._fit_args(X))
        return self

    @property
    def dual_coef_(self) -> np.ndarray:
        return self.model_.dual_coef.cpu().numpy()

    @property
    def intercept_(self) -> np.ndarray:
        return self.model_.intercept.cpu().numpy()

    def predict(self, X):
        return self.model_.decision(self._x(X))[:, 0].cpu().numpy()


class SVMClfWrapper(_SVMBase):
    """sklearn's SVC(**svm_params) (C-SVC, libsvm's solver and one-vs-one
    vote) in torch on `device`. Labels are re-encoded to 0..k-1 through
    `translation_dict`, as the JAX package's wrapper does, so a class_weight
    dict is keyed by those codes, as sklearn sees them; one-hot targets are
    argmaxed."""

    def __init__(self, svm_params=None, device="cuda"):
        super().__init__(svm_params, _SVC_DEFAULTS, _SVC_FIXED, device)
        self.translation_dict = None
        self.retranslation_dict = None

    def fit(self, X, y):
        Xt, X = self._fit_x(X)
        y = np.asarray(y)
        if y.ndim == 2:
            y = y.argmax(-1)
        unique = np.unique(y)
        if unique.size < 2:
            raise ValueError(f"SVMClfWrapper needs two or more classes; got {unique.size}")
        self.translation_dict = {l: i for i, l in enumerate(unique)}
        self.retranslation_dict = {i: l for i, l in enumerate(unique)}
        self._labels = unique
        codes = np.searchsorted(unique, y)
        self.class_weight_ = class_weights(self.settings["class_weight"], codes, unique.size)
        self.model_ = _libsvm.fit_svc(Xt, torch.as_tensor(codes, device=self.device),
                                      unique.size, class_weight=self.class_weight_,
                                      **self._fit_args(X))
        return self

    @property
    def dual_coef_(self) -> np.ndarray:
        """sklearn's dual_coef_ (its sign flipped for two classes)."""
        d = self.model_.dual_coef.cpu().numpy()
        return -d if self.model_.n_class == 2 else d

    @property
    def intercept_(self) -> np.ndarray:
        b = self.model_.intercept.cpu().numpy()
        return -b if self.model_.n_class == 2 else b

    @property
    def n_support_(self) -> np.ndarray:
        return np.asarray(self.model_.n_support, np.int32)

    def decision_function(self, X) -> np.ndarray:
        """sklearn's decision_function: libsvm's pair values negated to one
        column for two classes, else (m, k(k-1)/2) for "ovo" or the votes
        plus squashed confidences (m, k) for "ovr"."""
        dec = self.model_.decision(self._x(X))
        k = self.model_.n_class
        if k == 2:
            return (-dec[:, 0]).cpu().numpy()
        if self.settings["decision_function_shape"] == "ovr":
            dec = _libsvm.ovr_decision(dec, k)
        return dec.cpu().numpy()

    def predict(self, X):
        """libsvm's one-vs-one vote; with break_ties (and "ovr", k > 2) the
        argmax of the "ovr" decision function, as sklearn's SVC.predict."""
        s = self.settings
        if s["break_ties"] and s["decision_function_shape"] == "ovo":
            raise ValueError("break_ties must be False when decision_function_shape "
                             "is 'ovo'")
        dec = self.model_.decision(self._x(X))
        k = self.model_.n_class
        if s["break_ties"] and k > 2:
            won = _libsvm.ovr_decision(dec, k).argmax(1)
        else:
            won = self.model_.vote(dec)
        return self._labels[won.cpu().numpy()]


# sklearn's GaussianProcessRegressor / GaussianProcessClassifier parameters
_GPR_DEFAULTS = dict(kernel=None, alpha=1e-10, optimizer="fmin_l_bfgs_b",
                     n_restarts_optimizer=0, normalize_y=False, copy_X_train=True,
                     n_targets=None, random_state=None)
_GPC_DEFAULTS = dict(kernel=None, optimizer="fmin_l_bfgs_b", n_restarts_optimizer=0,
                     max_iter_predict=100, warm_start=False, copy_X_train=True,
                     random_state=None, multi_class="one_vs_rest", n_jobs=None)


def check_random_state(seed):
    """sklearn's check_random_state: numpy's global RandomState for None, a
    new RandomState(seed) for an int, a RandomState as it is."""
    if seed is None or seed is np.random:
        return np.random.mtrand._rand
    if isinstance(seed, (int, np.integer)) and not isinstance(seed, bool):
        return np.random.RandomState(seed)
    if isinstance(seed, np.random.RandomState):
        return seed
    raise ValueError(f"{seed!r} cannot be used to seed a numpy.random.RandomState "
                     "instance")


def default_gp_kernel(task: str) -> _gp_kernels.Kernel:
    """sklearn's default kernels: C(1) * RBF(1), free for the regressor,
    fixed for the classifier."""
    C, RBF = _gp_kernels.ConstantKernel, _gp_kernels.RBF
    if task == "classification":
        return C(1.0, constant_value_bounds="fixed") * RBF(1.0, length_scale_bounds="fixed")
    return C(1.0) * RBF(1.0)


class GaussianProcessWrapper:
    """sklearn's Gaussian processes in torch on `device` (float64), over
    `gp_params["kernel"]`: None (sklearn's defaults, `default_gp_kernel`), a
    kernel of `models/_gp_kernels.py`, or an sklearn kernel object,
    converted by its class name without importing sklearn. Regression is
    GaussianProcessRegressor(**gp_params): a kernel with free
    hyperparameters fitted by L-BFGS-B (or a callable `optimizer`) on the
    log-marginal likelihood, from its θ and `n_restarts_optimizer` θ₀ drawn
    from `random_state`. Classification is
    GaussianProcessClassifier(**gp_params): the binary Laplace
    approximation and above two classes one-vs-rest (the class of largest
    P(class), the first on ties) or one-vs-one (sklearn's
    OneVsOneClassifier: the pairs' votes and P(class 1) through
    `_ovr_decision_function`, no predict_proba). Where the kernel has free
    hyperparameters each binary problem fits its own θ on the Laplace
    log-marginal likelihood (`_gp.fit_gpc_binary`); otherwise the problems
    run as one batch at the kernel's θ, and `warm_start` starts the fit's
    second mode search from the first's f. After `fit`: `kernel_` (the
    fitted kernel; above two classes a CompoundKernel, one kernel a binary
    problem), `kernels_` (a list of them), `theta_` and
    `log_marginal_likelihood_value_`. A kernel that does not require vector
    input takes rows of anything (a user's string kernel, say: see
    `_gp_kernels.HostKernel`). A key or value not ported, and a
    CompoundKernel as the kernel, raise ValueError."""

    def __init__(self, gp_params=None, task="regression", device="cuda"):
        self.task = task
        defaults = _GPC_DEFAULTS if task == "classification" else _GPR_DEFAULTS
        p = dict(defaults)
        for key, value in (gp_params or {}).items():
            if key not in defaults:
                raise ValueError(f"gp_params key {key!r} is not ported")
            p[key] = value
        if p["kernel"] is not None:
            p["kernel"] = _gp_kernels.from_sklearn(p["kernel"])
        opt = p["optimizer"]
        if not (opt is None or opt == "fmin_l_bfgs_b" or callable(opt)):
            raise ValueError(f"gp_params['optimizer'] = {opt!r} is not ported (only "
                             "'fmin_l_bfgs_b', a callable or None)")
        if task == "classification" and p["multi_class"] not in ("one_vs_rest",
                                                                  "one_vs_one"):
            raise ValueError(f"gp_params['multi_class'] = {p['multi_class']!r}: "
                             "'one_vs_rest' or 'one_vs_one'")
        self.params = p
        self.device = resolve_device(device)
        self.fit_ = None

    def _kernel(self) -> _gp_kernels.Kernel:
        """A clone of the kernel to fit (sklearn's kernel_ before fit)."""
        k = self.params["kernel"]
        return default_gp_kernel(self.task) if k is None else copy.deepcopy(k)

    def _x(self, X):
        """X as float64 rows on the device; where the kernel does not require
        vector input, other rows (strings, say) as sklearn's validate_data
        keeps them (`_gp_kernels.HostRows`); else ValueError."""
        A = np.asarray(X)
        if A.ndim == 2 and (np.issubdtype(A.dtype, np.number) or A.dtype == bool):
            return torch.as_tensor(A.astype(np.float64), device=self.device)
        k = self.params["kernel"]
        if k is None or k.requires_vector_input:
            raise ValueError("GaussianProcessWrapper takes rows of numbers (n, features) "
                             "for a kernel that requires vector input; got an array of "
                             f"shape {A.shape} and dtype {A.dtype}")
        return _gp_kernels.HostRows(A, self.device)

    @property
    def _one_vs_one(self) -> bool:
        return (self.task == "classification" and self.params["multi_class"] == "one_vs_one"
                and self.classes_.size > 2)

    def fit(self, X, y):
        if isinstance(self.params["kernel"], _gp_kernels.CompoundKernel):
            # sklearn's classifier raises so; its regressor fails on one too
            raise ValueError("kernel cannot be a CompoundKernel")
        y = np.asarray(y)
        X = self._x(X)
        p = self.params
        kernel = self._kernel()
        if self.task == "classification":
            if y.ndim == 2:
                y = y.argmax(-1)
            self.classes_ = np.unique(y)
            k = self.classes_.size
            if k < 2:
                raise ValueError("GaussianProcessWrapper needs two or more classes")
            codes = np.searchsorted(self.classes_, y)
            if k == 2:                  # one binary problem: class 1 against 0
                problems = [(None, codes == 1)]
            elif not self._one_vs_one:  # one problem per class against the rest
                problems = [(None, codes == c) for c in range(k)]
            else:                       # pair (i, j), i < j: its rows, j -> 1
                problems = []
                for i, j in itertools.combinations(range(k), 2):
                    r = np.flatnonzero((codes == i) | (codes == j))
                    problems.append((r, codes[r] == j))
            if p["optimizer"] is not None and kernel.n_dims > 0:
                self._fit_each(X, kernel, problems)
            else:
                self._fit_batch(X, kernel, problems)
        else:
            y = y.squeeze() if y.ndim > 1 else y
            self.fit_ = _gp.fit_gpr(X, y, kernel, noise=float(p["alpha"]),
                                    optimizer=p["optimizer"],
                                    normalize_y=bool(p["normalize_y"]),
                                    n_restarts=int(p["n_restarts_optimizer"]),
                                    rng=check_random_state(p["random_state"]))
            self.log_marginal_likelihood_value_ = self.fit_.lml
            self._ravel = y.ndim == 1
        return self

    def _fit_batch(self, X, kernel, problems):
        """Every binary problem at the kernel's θ, as one batch (rows of a
        one-vs-one pair padded to the longest pair, see `_gp`)."""
        p = self.params
        rows = valid = None
        if problems[0][0] is None:
            targets = np.stack([t for _, t in problems])
        else:
            n = max(r.size for r, _ in problems)
            rows = np.zeros((len(problems), n), np.int64)
            valid = np.zeros((len(problems), n), bool)
            targets = np.zeros((len(problems), n), bool)
            for b, (r, t) in enumerate(problems):
                rows[b, :r.size], valid[b, :r.size], targets[b, :r.size] = r, True, t
            rows = torch.as_tensor(rows, device=self.device)
            valid = torch.as_tensor(valid, device=self.device)
        targets = torch.as_tensor(targets.astype(np.float64), device=self.device)
        mode = dict(max_iter=int(p["max_iter_predict"]), rows=rows, valid=valid)
        self.fit_ = _gp.laplace_mode(X, targets, kernel, **mode)
        # sklearn's fit: the lml's mode search, then a second one for the
        # predictions, from the first's f under warm_start (else the same)
        self.first_fit_ = self.fit_
        if p["warm_start"]:
            self.fit_ = _gp.laplace_mode(X, targets, kernel, f0=self.first_fit_.f, **mode)
        self.log_marginal_likelihood_value_ = float(np.mean(self.first_fit_.lml))

    def _fit_each(self, X, kernel, problems):
        """Each binary problem on its own θ (`_gp.fit_gpc_binary`), in
        sklearn's order, each drawing its restarts from the random state as
        sklearn's clone of the binary estimator does: a new RandomState for
        an int, numpy's global one for None, the one given (a copy of it
        for each problem above two classes)."""
        p = self.params
        rs = p["random_state"]
        out = []
        for r, t in problems:
            rng = (copy.deepcopy(rs) if isinstance(rs, np.random.RandomState)
                   and len(problems) > 1 else check_random_state(rs))
            Xb = X if r is None else X[torch.as_tensor(r, device=self.device)]
            yb = torch.as_tensor(t.astype(np.float64), device=self.device)
            out.append(_gp.fit_gpc_binary(
                Xb, yb, kernel, optimizer=p["optimizer"],
                n_restarts=int(p["n_restarts_optimizer"]), rng=rng,
                max_iter=int(p["max_iter_predict"]), warm_start=bool(p["warm_start"])))
        self.fit_ = _gp.BinaryFits(*(list(v) for v in zip(*out)))
        self.first_fit_ = None
        self.log_marginal_likelihood_value_ = float(np.mean(self.fit_.lml))

    @property
    def kernels_(self) -> list:
        """The fitted kernel of each binary problem (one for regression)."""
        f = self.fit_
        if isinstance(f, _gp.BinaryFits):
            return f.kernels
        return [f.kernel] * (1 if self.task != "classification" else len(f.lml))

    @property
    def kernel_(self):
        """sklearn's kernel_: the fitted kernel, or above two classes a
        CompoundKernel of each binary problem's, in the problems' order."""
        ks = self.kernels_
        return ks[0] if len(ks) == 1 else _gp_kernels.CompoundKernel(ks)

    @property
    def theta_(self) -> np.ndarray:
        """The fitted θ (log hyperparameters); above two classes each binary
        problem's in turn, as sklearn's CompoundKernel gives them."""
        return np.hstack([k.theta for k in self.kernels_])

    def decision_function(self, X) -> np.ndarray:
        """One-vs-one above two classes only: sklearn's
        OneVsOneClassifier.decision_function, each pair's prediction (latent
        mean > 0) and P(class 1) through `_ovr_decision_function`: (m, k)."""
        if not self._one_vs_one:
            raise ValueError("decision_function needs multi_class='one_vs_one' and "
                             "more than two classes")
        Xs = self._x(X)
        won = (self.fit_.latent(Xs)[0] > 0).T
        dec = _libsvm.ovo_to_ovr(won, self.fit_.proba(Xs).T, self.classes_.size)
        return dec.cpu().numpy()

    def predict_proba(self, X) -> np.ndarray:
        if self._one_vs_one:
            raise ValueError("one_vs_one multi-class mode does not support predicting "
                             "probability estimates. Use one_vs_rest mode instead.")
        P = self.fit_.proba(self._x(X)).cpu().numpy()
        if self.classes_.size == 2:
            return np.stack([1 - P[0], P[0]], axis=1)
        P = P.T
        sums = P.sum(axis=1, keepdims=True)
        return np.divide(P, sums, out=P.copy(), where=sums != 0)

    def predict(self, X):
        Xs = self._x(X)
        if self.task != "classification":
            mean = self.fit_.predict(Xs).cpu().numpy()
            return mean[:, 0] if self._ravel or mean.shape[1] == 1 else mean
        if self.classes_.size == 2:
            latent = self.fit_.latent(Xs)[0][0].cpu().numpy()
            return np.where(latent > 0, self.classes_[1], self.classes_[0])
        if self._one_vs_one:
            return self.classes_[self.decision_function(X).argmax(1)]
        return self.classes_[self.fit_.proba(Xs).argmax(0).cpu().numpy()]
