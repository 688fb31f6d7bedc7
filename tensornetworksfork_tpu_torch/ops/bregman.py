"""Bregman losses returning (loss, gradient, Hessian) triples
(port of tensornetworksfork_tpu/ops/bregman.py).

Contract: a loss object's `__call__(y_pred, y_true)` returns

    loss : (B,)            per-sample loss
    grad : y_pred.shape    dL/dy_pred per sample
    hess : full  (B, *out, *out)  or  diagonal (B, *out)

The engine's Gram builder tells the two Hessian forms apart by ndim. A full
Hessian must be symmetric in its (out, out') block per sample: the Gram
kernels compute only the upper triangle of A = JᵀHJ and mirror it.

Classification convention: the model emits C-1 logits and a zero logit is
appended.

The autograd losses take (grad, Hessian) of a per-sample scalar loss from
`torch.func` (`grad`, `jacfwd` of it, under `vmap`), as the JAX package
takes them from `jax.grad` / `jax.jacfwd` under `jax.vmap`.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch
from torch.func import grad, jacfwd, vmap


def _flatten_tail(x):
    return x.reshape(x.shape[0], -1) if x.ndim > 1 else x.reshape(x.shape[0], 1)


class SquareBregFunction:
    """Squared error as a Bregman divergence with psi = sum x^2: grad=2(x-y),
    diagonal Hessian = 2."""

    def __call__(self, y_pred, y_true, only_loss=False):
        x = _flatten_tail(y_pred)
        y = _flatten_tail(y_true).to(x.dtype)
        diff = x - y
        loss = torch.sum(diff * diff, dim=-1)
        if only_loss:
            return loss
        grad = (2.0 * diff).reshape(y_pred.shape)
        hess = torch.full_like(y_pred, 2.0)
        return loss, grad, hess


class SquareComplexBregFunction:
    """Complex least squares: grad = x - y, unit diagonal Hessian."""

    def __call__(self, y_pred, y_true, only_loss=False):
        y = y_true.to(y_pred.dtype)
        diff = y_pred - y
        loss = torch.sum(torch.abs(_flatten_tail(diff)) ** 2, dim=-1)
        if only_loss:
            return loss
        return loss, diff, torch.full_like(y_pred, 1.0)


class SoftmaxSquaredLoss:
    """0.5 || softmax(w x) - y ||^2 with the Gauss-Newton JᵀJ Hessian."""

    def __init__(self, w: float = 1.0):
        self.w = w

    def __call__(self, y_pred, y_true, only_loss=False):
        s = torch.softmax(self.w * y_pred, dim=-1)
        diff = s - y_true.to(s.dtype)
        loss = 0.5 * torch.sum(diff * diff, dim=-1)
        if only_loss:
            return loss
        J = _softmax_jac(s)
        grad_ = self.w * torch.einsum("...ij,...j->...i", J, diff)
        hess = (self.w ** 2) * torch.einsum("...ik,...jk->...ij", J, J)
        return loss, grad_, hess


def _softmax_jac(s):
    """d softmax / d z = diag(s) - s sᵀ, per sample."""
    return torch.diag_embed(s) - s[..., :, None] * s[..., None, :]


class XEBregman:
    """Cross entropy on C-1 logits with an appended zero logit; analytic
    gradient w(s - y) and Hessian w²(diag(s) - s sᵀ), both restricted to the
    first C-1 channels."""

    def __init__(self, w: float = 1.0):
        self.w = w

    def __call__(self, y_pred, y_true, only_loss=False):
        z = self.w * y_pred
        z = torch.cat([z, torch.zeros_like(z[..., :1])], dim=-1)
        log_s = torch.log_softmax(z, dim=-1)
        y = y_true.to(log_s.dtype)
        loss = -torch.sum(y * log_s, dim=-1)
        if only_loss:
            return loss
        s = torch.exp(log_s)
        grad = self.w * (s - y)[..., :-1]
        outer = s[..., :, None] * s[..., None, :]
        diag = torch.diag_embed(s)
        hess = (self.w ** 2) * (diag - outer)[..., :-1, :-1]
        return loss, grad, hess


# The JAX package exposes these names for the same implementation.
KLDivBregman = XEBregman
XEAutogradBregman = XEBregman


class BinaryKLDivBregman:
    """Binary KL on sigmoid(w x); diagonal Hessian w² s(1-s)."""

    def __init__(self, w: float = 1.0):
        self.w = w

    def __call__(self, y_pred, y_true, only_loss=False, eps=1e-12):
        s = torch.clamp(torch.sigmoid(self.w * y_pred), eps, 1 - eps)
        y = torch.clamp(y_true.to(s.dtype), eps, 1 - eps)
        kl = y * torch.log(y / s) + (1 - y) * torch.log((1 - y) / (1 - s))
        loss = torch.sum(_flatten_tail(kl), dim=-1)
        if only_loss:
            return loss
        return loss, self.w * (s - y), (self.w ** 2) * s * (1 - s)


class AutogradLoss:
    """Any per-sample scalar loss f(y_pred_i, y_true_i); its gradient and
    full Hessian by `torch.func.grad` and `jacfwd` of it under `vmap`."""

    def __init__(self, loss_func: Optional[Callable] = None):
        if loss_func is None:
            loss_func = lambda x, y: torch.sum((x - y) ** 2)  # noqa: E731
        self._f = loss_func

    def __call__(self, y_pred, y_true, only_loss=False):
        f = self._f
        y_true = y_true.to(y_pred.dtype)
        loss = vmap(f)(y_pred, y_true)
        if only_loss:
            return loss
        g = vmap(grad(f))(y_pred, y_true)
        H = vmap(jacfwd(grad(f)))(y_pred, y_true)
        return loss, g, H


class AutogradBregman(AutogradLoss):
    """The Bregman divergence D_phi(y, x) of a callable phi."""

    def __init__(self, phi_func: Callable):
        def breg(x, y):
            d_phi_x = grad(phi_func)(x)
            return torch.sum(phi_func(y) - phi_func(x)
                             - torch.sum(d_phi_x * (y - x), dim=-1))

        super().__init__(breg)


class UncertaintyAutogradLoss(AutogradLoss):
    """Gaussian NLL over a (mean, softplus-std) 2-channel head."""

    def __init__(self):
        def nll(pred, y):
            mean = pred[..., 0]
            std = torch.nn.functional.softplus(pred[..., 1])
            var = std * std
            return torch.sum(0.5 * torch.log(2 * math.pi * var)
                             + 0.5 * (y - mean) ** 2 / var)

        super().__init__(nll)
