"""Symmetric CPD with a dedicated Gauss-Newton fit (port of
tensornetworksfork_tpu/models/symmetric_cpd.py).

The model y(x) = Σ_r λ_r (w_rᵀ x)^m, a rank-R symmetric tensor of order m
applied to x, fit by Gauss-Newton on the factor matrix W and the weights λ
jointly: the parameters are one flat vector (W first, then λ, the order of
jax.flatten_util.ravel_pytree), J is `torch.func.jacfwd` of the forward over
it, and each step solves the diagonal-mean-scaled, ridge-damped normal
equations and clips the step to the parameter vector's norm. W and λ are
drawn from numpy's default_rng(seed), as in the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.device import resolve_device


class SymmetricCPD:
    def __init__(self, d: int, rank: int, order: int, seed: int = 0,
                 device="cuda"):
        self.d, self.rank, self.order = d, rank, order
        self.device = resolve_device(device)
        rng = np.random.default_rng(seed)
        self.W = torch.as_tensor(rng.standard_normal((rank, d)) / np.sqrt(d),
                                 dtype=torch.float32, device=self.device)
        self.lam = torch.as_tensor(rng.standard_normal(rank), dtype=torch.float32,
                                   device=self.device)

    def __call__(self, X) -> torch.Tensor:
        return ((X @ self.W.T) ** self.order) @ self.lam

    def _gn_step(self, X, y, eps: float):
        m, nW = self.order, self.W.numel()
        shape = self.W.shape

        def fwd_flat(v):
            return ((X @ v[:nW].reshape(shape).T) ** m) @ v[nW:]

        flat = torch.cat([self.W.reshape(-1), self.lam])
        resid = fwd_flat(flat) - y
        J = torch.func.jacfwd(fwd_flat)(flat)  # (B, P)
        A = J.T @ J
        scale = torch.abs(torch.diagonal(A)).mean()
        scale = torch.where(scale == 0, torch.ones_like(scale), scale)
        A = A / scale + eps * torch.eye(flat.numel(), dtype=flat.dtype,
                                        device=flat.device)
        b = (J.T @ resid) / scale
        step = torch.linalg.solve(A, -b)
        # trust-region style clip: no step longer than the parameter vector
        sn, pn = torch.linalg.vector_norm(step), torch.linalg.vector_norm(flat)
        step = step * torch.where(sn > pn, pn / torch.clamp(sn, min=1e-30),
                                  torch.ones_like(sn))
        new = flat + step
        self.W, self.lam = new[:nW].reshape(shape), new[nW:]
        return torch.mean(resid ** 2)

    def fit(self, X, y, iters: int = 50, eps: float = 1e-6,
            verbose: int = 0) -> "SymmetricCPD":
        X = torch.as_tensor(np.asarray(X), dtype=torch.float32, device=self.device)
        y = torch.as_tensor(np.asarray(y), dtype=torch.float32,
                            device=self.device).reshape(-1)
        for it in range(iters):
            loss = self._gn_step(X, y, eps)
            if verbose and it % 10 == 0:
                print(f"iter {it}: mse {float(loss):.6f}")
        return self

    def predict(self, X):
        X = torch.as_tensor(np.asarray(X), dtype=torch.float32, device=self.device)
        return self(X).cpu().numpy()
