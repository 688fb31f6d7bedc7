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
  centred, unpenalised intercept and is solved in the inputs' dtype by a
  Cholesky solve of the primal system, or of the kernel system X Xᵀ where
  there are more features than rows, as sklearn's "cholesky" solver does.
  Lasso(alpha) is sklearn's cyclic coordinate descent (`lasso_cd`): the
  objective 1/(2n) ||y - Xw - b||² + alpha ||w||₁ on centred data, gap
  safe screening, and its stopping rule (a full pass whose largest
  coefficient change is below tol times the largest coefficient, then a
  duality gap below tol ||y||²), max_iter 1000, tol 1e-4.

Not ported: the XGBoost, SVM and Gaussian-process wrappers (the card's
machine has neither xgboost nor sklearn).
"""
from __future__ import annotations

import itertools
import math
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..utils.device import resolve_device

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
        Xp = self._features(X)
        y = torch.as_tensor(np.asarray(y), device=self.device)
        one_d = y.ndim == 1
        y2 = (y[:, None] if one_d else y).to(Xp.dtype)
        if self.regularization is None:
            self._coef = torch.linalg.pinv(Xp) @ y2
            self._intercept = torch.zeros(y2.shape[1], dtype=Xp.dtype,
                                          device=self.device)
        else:
            x_off, y_off = Xp.mean(dim=0), y2.mean(dim=0)
            Xc, yc = Xp - x_off, y2 - y_off
            n, p = Xc.shape
            if self.regularization == "l1":
                coef = torch.stack([lasso_cd(Xc, yc[:, k].contiguous(),
                                             self.alpha * n)
                                    for k in range(yc.shape[1])], dim=1)
            elif p > n:  # the kernel form: dual = (X Xᵀ + alpha I)⁻¹ y
                K = Xc @ Xc.T
                K.diagonal().add_(self.alpha)
                coef = Xc.T @ torch.cholesky_solve(yc, torch.linalg.cholesky(K))
            else:
                A = Xc.T @ Xc
                A.diagonal().add_(self.alpha)
                coef = torch.cholesky_solve(Xc.T @ yc, torch.linalg.cholesky(A))
            self._coef = coef
            self._intercept = y_off - x_off @ coef
        # sklearn's Ridge and Lasso return a single target as a 1-D prediction
        self._ravel = one_d or (self.regularization is not None and y2.shape[1] == 1)
        return self

    def predict(self, X):
        pred = self._features(X) @ self._coef + self._intercept
        return (pred[:, 0] if self._ravel else pred).cpu().numpy()
