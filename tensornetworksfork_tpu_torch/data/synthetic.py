"""Synthetic polynomial targets (port of tensornetworksfork_tpu/data/synthetic.py).

- RandomPolynomial: a degree <= D multivariate polynomial with per-degree
  coefficient scaling sigma_k = sigma0 / ((k+1) sqrt(C(d+k-1, k))) r^-k,
  log-uniform magnitude jitter and Bernoulli masking;
- RandomPolynomialRange: y = prod_k (w_k . x - root_k), w_k softmax rows;
- RandomIndependentPolynomial: iid normal coefficients;
- make_regression: (X, y) from a RandomPolynomialRange target, y
  standardized; make_classification: a quadratic-logit labelling.

All are numpy only and draw exactly as the JAX package does, so a seed gives
the same data in both packages. The JAX package builds the monomials with
sklearn's PolynomialFeatures, which the card's machine lacks;
`PolynomialFeatures` below is its dense transform written out: the same
columns in the same order, each product taken in sklearn's order, so the
design matrices are bit-equal.
"""
from __future__ import annotations

import itertools
import math

import numpy as np


class PolynomialFeatures:
    """sklearn.preprocessing.PolynomialFeatures (dense input): every
    monomial of degree <= `degree` (or only products of distinct features
    with `interaction_only`), the constant first with `include_bias`,
    degree by degree in combinations-with-replacement order."""

    def __init__(self, degree=2, interaction_only=False, include_bias=True):
        self.degree = int(degree)
        self.interaction_only = interaction_only
        self.include_bias = include_bias

    def fit(self, X):
        n = np.asarray(X).shape[1]
        self.n_features_in_ = n
        comb = (itertools.combinations if self.interaction_only
                else itertools.combinations_with_replacement)
        start = 0 if self.include_bias else 1
        self._combos = [c for k in range(start, self.degree + 1)
                        for c in comb(range(n), k)]
        self.powers_ = np.vstack(
            [np.bincount(c, minlength=n) for c in self._combos]).astype(np.int64)
        return self

    def transform(self, X):
        X = np.asarray(X)
        if X.dtype not in (np.float32, np.float64):
            X = X.astype(np.float64)
        out = np.empty((X.shape[0], len(self._combos)), X.dtype)
        for j, c in enumerate(self._combos):
            if not c:
                out[:, j] = 1
                continue
            # sklearn multiplies a degree-k column by the lowest feature
            # into the degree-(k-1) column of the rest: x_last first
            v = X[:, c[-1]].copy()
            for f in reversed(c[:-1]):
                v = v * X[:, f]
            out[:, j] = v
        return out


class RandomPolynomial:
    def __init__(self, d, degree, sigma0=0.2, r=1.0, mask=0.1,
                 include_bias=True, interaction_only=False, random_state=None):
        self.d, self.degree = int(d), int(degree)
        self.sigma0, self.r, self.mask = float(sigma0), float(r), float(mask)
        self.rng = np.random.default_rng(random_state)
        self.poly = PolynomialFeatures(degree=self.degree,
                                       include_bias=include_bias,
                                       interaction_only=interaction_only)
        self.poly.fit(np.zeros((1, self.d)))
        self._degrees = self.poly.powers_.sum(axis=1)
        deg_std = {}
        for k in range(self.degree + 1):
            n_k = math.comb(self.d + k - 1, k)
            s = self.sigma0 / ((k + 1) * math.sqrt(max(n_k, 1)))
            if self.r != 0.0:
                s *= self.r ** (-k)
            deg_std[k] = s
        sigmas = np.array([deg_std[int(k)] for k in self._degrees])
        scale = self.rng.uniform(-10, 10, size=sigmas.shape)
        keep = 1 - self.rng.binomial(1, self.mask, size=sigmas.shape)
        self.coeffs_ = np.exp(scale) * self.rng.normal(0, sigmas) * keep

    def design_matrix(self, x):
        return self.poly.transform(np.asarray(x))

    def evaluate(self, x):
        return self.design_matrix(x) @ self.coeffs_


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


class RandomIndependentPolynomial:
    def __init__(self, d, degree, coeff_sigma=0.2, include_bias=True,
                 interaction_only=False, random_state=None):
        self.d, self.degree = int(d), int(degree)
        self.rng = np.random.default_rng(random_state)
        self.poly = PolynomialFeatures(degree=self.degree,
                                       include_bias=include_bias,
                                       interaction_only=interaction_only)
        self.poly.fit(np.zeros((1, self.d)))
        self.coeffs_ = self.rng.normal(0.0, coeff_sigma,
                                       size=(self.poly.powers_.shape[0], 1))

    def design_matrix(self, x):
        return self.poly.transform(np.asarray(x))

    def evaluate(self, x):
        return self.design_matrix(x) @ self.coeffs_


def make_regression(S=1024, d=4, degree=3, noise=0.0, seed=0):
    """(X, y): X uniform in [-1, 1]^d (f32), y a RandomPolynomialRange
    target, standardized, shaped (S, 1)."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(-1, 1, size=(S, d)).astype(np.float32)
    f = RandomPolynomialRange(d, degree, random_state=seed)
    y = f.evaluate(X, add_noise=noise).astype(np.float32)
    y = (y - y.mean()) / (y.std() + 1e-8)
    return X, y.reshape(-1, 1)


def make_classification(S=1024, d=4, n_classes=3, seed=0):
    """(X (S, d) f32 normal, one-hot (S, n_classes)): labels the argmax of
    a linear plus quadratic logit."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(S, d)).astype(np.float32)
    W = rng.normal(size=(d, n_classes))
    logits = X @ W + 0.5 * (X ** 2) @ rng.normal(size=(d, n_classes))
    labels = logits.argmax(axis=1)
    onehot = np.eye(n_classes, dtype=np.float32)[labels]
    return X, onehot
