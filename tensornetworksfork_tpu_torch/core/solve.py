"""Local Gauss-Newton block solves (port of tensornetworksfork_tpu/core/solve.py).

Solves run in the params dtype (f32) with the diagonal-mean rescaling of the
JAX package. A failed factorisation cannot raise mid-sweep: `solve_block`
returns an `ok` flag that stays a device tensor (no host sync), and the
sweep keeps the old node where it is False.

The Cholesky factor of the f32 tier is always full f32
(`torch.linalg.cholesky_ex`). The JAX package's blocked Cholesky, which
drops the trailing GEMMs to DEFAULT precision on a TPU under the int8 tier,
is TPU precision control and is not ported.

solve_dtype="float64" is the tier for the reference's deep-eps corners
(eps <= 1e-9 at high condition numbers), where the f32 factor fails. The
JAX package runs it on the host through a callback; the card has float64,
so here it runs on the operands' device, with the host tier's semantics
step for step (`_solve_f64`).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

_CHOLESKY = ("ridge_cholesky", "cholesky")
_RIDGED = ("ridge_exact", "ridge_cholesky", "ridge_trace")
_METHODS = ("exact", "ridge_exact", "ridge_cholesky", "cholesky", "ridge_trace",
            "gradient")


def _flatten_system(A: torch.Tensor, b: torch.Tensor):
    D = b.numel()
    return A.reshape(D, D), b.reshape(D)


def _solve_f64(A_f: torch.Tensor, b_f: torch.Tensor, node_f: torch.Tensor,
               eps: float, method: str) -> torch.Tensor:
    """The float64 tier: the JAX package's host solve (`_host_solve_f64`)
    on the operands' device. The unrescaled system is promoted to float64,
    rescaled by its diagonal mean, ridged in float64 (so eps far below f32
    resolution still perturbs it), factored, solved, and the step returned
    in the input dtype; NaN where the factorisation fails. The Cholesky
    reads the upper triangle, as scipy's `cho_factor` there does."""
    out_dtype = A_f.dtype
    A = A_f.to(torch.float64)
    b = b_f.to(torch.float64)
    node = node_f.to(torch.float64)
    # the JAX package hands eps over as an f32 array
    e = float(np.float32(eps))
    scale = torch.abs(torch.diagonal(A)).mean()
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    A = A / scale
    b = b / scale
    two_e = torch.tensor(2.0 * e, dtype=torch.float64, device=A.device)
    if method == "ridge_trace":
        two_e = two_e * torch.sum(torch.abs(b) ** 2)
    if method in _RIDGED:
        A.diagonal().add_(two_e)
        b = b + two_e * node
    if method in _CHOLESKY:
        U, info = torch.linalg.cholesky_ex(A, upper=True)
        x = torch.cholesky_solve(-b[:, None], U, upper=True)[:, 0]
    else:
        LU, piv, info = torch.linalg.lu_factor_ex(A)
        x = torch.linalg.lu_solve(LU, piv, -b[:, None])[:, 0]
    x = torch.where(info == 0, x, torch.full_like(x, float("nan")))
    return x.to(out_dtype)


def solve_block(A: torch.Tensor, b: torch.Tensor, node_value: torch.Tensor,
                method: str = "exact", eps: float = 0.0, refine: bool = False,
                solve_dtype=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (step, ok). step solves (A [+2eps I]) x = -(b [+2eps node]).

    Methods: exact | ridge_exact | ridge_cholesky | cholesky | ridge_trace |
    gradient. ridge_trace scales eps by |b|^2 after the rescale and solves by
    LU; gradient returns -b (steepest descent on the local quadratic; A is
    not read). `ok` is a 0-dim bool tensor on A's device: the factorisation
    succeeded and the step is finite.

    solve_dtype "float64" runs the float64 tier (`_solve_f64`; real systems
    only, and `refine` is not applied there, as in the JAX package);
    anything but f32/f64 raises ValueError."""
    method = method.lower()
    if method not in _METHODS:
        raise ValueError(f"unknown solve method {method!r} "
                         f"(one of {', '.join(_METHODS)})")
    if method == "gradient":
        return -b, torch.ones((), dtype=torch.bool, device=b.device)

    if solve_dtype is not None and str(solve_dtype) not in ("float32", "f32"):
        if str(solve_dtype) not in ("float64", "f64"):
            raise ValueError(f"unsupported solve_dtype: {solve_dtype!r}")
        if A.is_complex():
            raise ValueError("solve_dtype='float64' supports real systems only")
        A_f, b_f = _flatten_system(A, b)
        node_f = node_value.reshape(-1).to(b_f.dtype)
        x = _solve_f64(A_f, b_f, node_f, eps, method)
        return x.reshape(b.shape), torch.isfinite(x).all()

    A_f, b_f = _flatten_system(A, b)
    dtype = A_f.dtype
    scale = torch.abs(torch.diagonal(A_f)).mean()
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    A_f = A_f / scale
    b_f = b_f / scale
    eps_t = torch.tensor(eps, dtype=dtype, device=A_f.device)
    if method == "ridge_trace":
        eps_t = eps_t * torch.sum(torch.abs(b_f) ** 2)
    two_eps = 2.0 * eps_t
    if method in _RIDGED:
        # A_f is a fresh tensor here, so the ridge goes onto its diagonal in
        # place instead of adding a materialised 2*eps*I
        A_f.diagonal().add_(two_eps)
        b_f = b_f + two_eps * node_value.reshape(-1).to(dtype)

    if method in _CHOLESKY:
        # cholesky_ex reads the lower triangle only (as the JAX package's
        # symmetrize_input=False) and reports failure in `info` instead of
        # raising
        L, info = torch.linalg.cholesky_ex(A_f)

        def _solve(rhs):
            return torch.cholesky_solve(rhs[:, None], L)[:, 0]
    else:
        LU, piv, info = torch.linalg.lu_factor_ex(A_f)

        def _solve(rhs):
            return torch.linalg.lu_solve(LU, piv, rhs[:, None])[:, 0]

    x = _solve(-b_f)
    if refine:
        r = -b_f - A_f @ x
        x = x + _solve(r)
    ok = (info == 0) & torch.isfinite(x).all()
    return x.reshape(b.shape), ok


def apply_update(core: torch.Tensor, step: torch.Tensor, lr: float = 1.0,
                 adaptive_step: bool = False, max_norm=None,
                 cpd_mask: torch.Tensor = None) -> torch.Tensor:
    """Node update with step-norm controls and the CPD diagonal mask."""
    if cpd_mask is not None:
        step = step * cpd_mask
    if adaptive_step:
        step_norm = torch.linalg.vector_norm(step)
        param_norm = torch.linalg.vector_norm(core)
        factor = torch.where(step_norm > param_norm,
                             param_norm / torch.clamp(step_norm, min=1e-30),
                             torch.ones_like(step_norm))
        step = step * factor
    new = core + lr * step
    if max_norm is not None:
        cur = torch.linalg.vector_norm(new)
        new = torch.where(cur > max_norm,
                          new * (max_norm / torch.clamp(cur, min=1e-30)), new)
    return new


def cpd_diag_mask(shape, labels, left, right, dtype=torch.float32,
                  device="cpu") -> torch.Tensor:
    """eye(left_bond) broadcast over non-bond axes — keeps CPD cores
    diagonal under updates."""
    lbl_to_ax = {l: i for i, l in enumerate(labels)}
    bond_axes = [lbl_to_ax[l] for l in (tuple(left) + tuple(right)) if l in lbl_to_ax]
    if len(bond_axes) < 2:
        return torch.ones(shape, dtype=dtype, device=device)
    a0, a1 = bond_axes[0], bond_axes[-1]
    eye = torch.eye(shape[a0], shape[a1], dtype=dtype, device=device)
    perm_eye = eye.reshape([shape[a0] if i == a0 else (shape[a1] if i == a1 else 1)
                            for i in range(len(shape))])
    return torch.broadcast_to(perm_eye, tuple(shape)).to(dtype)
