"""Synthetic polynomial targets (port of tensornetworksfork_tpu/data/synthetic.py,
the numpy-only generators).

- RandomPolynomialRange: y = prod_k (w_k . x - root_k), w_k softmax rows;
- make_regression: (X, y) from a RandomPolynomialRange target, y
  standardized.

Both are numpy only and draw exactly as the JAX package does, so a seed gives
the same data in both packages. The sklearn-backed generators
(RandomPolynomial, RandomIndependentPolynomial) are not ported yet.
"""
from __future__ import annotations

import numpy as np


class RandomPolynomialRange:
    """Root-product polynomial: y = prod_k (w_k . x - root_k)."""

    def __init__(self, d, degree, input_range=(-1, 1), mask=0.0,
                 random_state=None):
        self.d, self.degree = d, degree
        lo, hi = input_range
        self.rng = np.random.default_rng(random_state)
        C = self.rng.normal(size=(degree, d))
        C = np.exp(C - C.max(axis=1, keepdims=True))
        self.C = C / (C.sum(axis=1, keepdims=True) + 1e-12)
        self.roots = self.rng.uniform(lo, hi, size=(degree,))

    def evaluate(self, x, add_noise=0.0):
        x = np.asarray(x)
        t = x @ self.C.T
        y = np.prod(t - self.roots[None, :], axis=1)
        if add_noise:
            y = y + add_noise * self.rng.normal(size=y.shape)
        return y


def make_regression(S=1024, d=4, degree=3, noise=0.0, seed=0):
    """(X, y): X uniform in [-1, 1]^d (f32), y a RandomPolynomialRange
    target, standardized, shaped (S, 1)."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(-1, 1, size=(S, d)).astype(np.float32)
    f = RandomPolynomialRange(d, degree, random_state=seed)
    y = f.evaluate(X, add_noise=noise).astype(np.float32)
    y = (y - y.mean()) / (y.std() + 1e-8)
    return X, y.reshape(-1, 1)
