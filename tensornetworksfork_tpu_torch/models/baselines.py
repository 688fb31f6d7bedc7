"""Comparison baselines (port of tensornetworksfork_tpu/models/baselines.py):
`PolynomialRegressionWrapper` only, the zoo's `polynomial` family.

The JAX package builds it from sklearn's PolynomialFeatures and Ridge;
the card's machine has no sklearn, so both are written here in torch on
`device`: the monomials of degree 0..degree in sklearn's column order (each
built as its first feature times the lower-degree column of the rest, as
sklearn builds it, so the features are bit-equal),
and Ridge(alpha) with its centred, unpenalised intercept, solved in the
inputs' dtype (float32 inputs stay float32 in sklearn's Ridge) by a
Cholesky solve of the primal system, or of the kernel system X Xᵀ where
there are more features than rows, as sklearn's "cholesky" solver does.
regularization=None fits the pseudo-inverse without an intercept.
`"l1"` (Lasso) and the other baselines (mlp, xgboost, svm) are not
ported (ROADMAP item 15).
"""
from __future__ import annotations

import itertools
from typing import Optional

import numpy as np
import torch

from ..utils.device import resolve_device


def polynomial_features(X: torch.Tensor, degree: int) -> torch.Tensor:
    """sklearn's PolynomialFeatures(degree) (bias column included) of the
    rows of X: combinations with replacement of the features, by degree."""
    n, d = X.shape
    cols = {(): torch.ones((n,), dtype=X.dtype, device=X.device)}
    for deg in range(1, degree + 1):
        for c in itertools.combinations_with_replacement(range(d), deg):
            cols[c] = cols[c[1:]] * X[:, c[0]]
    return torch.stack(list(cols.values()), dim=1)


class PolynomialRegressionWrapper:
    """Polynomial features + Ridge (regularization="l2") or pinv (None)."""

    def __init__(self, degree=2, regularization: Optional[str] = None,
                 alpha=1.0, device="cuda"):
        if regularization not in (None, "l2"):
            raise NotImplementedError(
                f"regularization {regularization!r} is not ported: only 'l2' "
                "(Ridge) and None (pinv); Lasso is ROADMAP item 15")
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
            if p > n:  # the kernel form: dual = (X Xᵀ + alpha I)⁻¹ y
                K = Xc @ Xc.T
                K.diagonal().add_(self.alpha)
                coef = Xc.T @ torch.cholesky_solve(yc, torch.linalg.cholesky(K))
            else:
                A = Xc.T @ Xc
                A.diagonal().add_(self.alpha)
                coef = torch.cholesky_solve(Xc.T @ yc, torch.linalg.cholesky(A))
            self._coef = coef
            self._intercept = y_off - x_off @ coef
        # sklearn's Ridge returns a single target as a 1-D prediction
        self._ravel = one_d or (self.regularization == "l2" and y2.shape[1] == 1)
        return self

    def predict(self, X):
        pred = self._features(X) @ self._coef + self._intercept
        return (pred[:, 0] if self._ravel else pred).cpu().numpy()
