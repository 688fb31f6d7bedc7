"""Krylov solvers of the matrix-free sweep tier (port of
tensornetworksfork_tpu/core/krylov.py).

Solvers: `cg` (symmetric positive definite), `minres` (symmetric, possibly
indefinite; a Lanczos recurrence with Givens rotations) and
`lanczos_galerkin` (a fixed-size Lanczos basis and a tridiagonal Galerkin
solve). The recurrences, the 1e-30 clamps, the stopping tests (CG while
rs > (tol·‖b‖)², MINRES while |φ| > tol·β₀) and the returned iteration
count k are the JAX package's.

The loop. The JAX package runs a `lax.while_loop` on the device, which
decides every iteration there. An eager loop can only stop on a value it
reads on the host, and a read that waits for the device drains the launch
queue: the device idles until the host has launched the next iteration. So:

- every scalar of the recurrence stays a 0-dim tensor on the device;
- each iteration computes its `active` flag on the device (the while
  loop's condition on the current state) and commits its new state through
  `torch.where(active, new, old)`, so an inactive iteration is a no-op and
  k grows by `active`;
- on a CUDA device each iteration's flag is copied to pinned host memory
  behind an event (`_Flags`), and the host reads, without waiting, every
  flag that has arrived, and breaks at the first that is False. It waits
  for a flag only when it is LAG (1) iterations old, so that the device
  still has that iteration queued while the host waits, and for the flag
  after the first iteration, so that a system one iteration solves (A a
  multiple of I: a sweep's node whose J is ~0 beside the ridge) stops
  after one matvec. Elsewhere each flag is read as it is made. Each read
  is the span `tnf.krylov.check` (`utils/timing.py` `span`); the loop's
  bound is maxiter.

Once the condition is false the state no longer changes, so it stays false,
and the active iterations run the while loop's body on the same values in
the same order: x and k are the while loop's, whenever the host reads. What
it costs is at most LAG masked iterations past convergence, and one wait
for the device a solve, after its first iteration.
Lanczos runs its fixed maxiter with no read at all.
"""
from __future__ import annotations

from collections import deque
from typing import Callable, Tuple

import torch

from ..utils.timing import span

# iterations the host launches past the newest `active` flag it has read
# before it waits for the next one
LAG = 1


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Re <a, b> as a 0-dim tensor (jnp.vdot(a, b).real)."""
    a, b = a.reshape(-1), b.reshape(-1)
    if a.is_complex():
        return torch.vdot(a, b).real
    return torch.dot(a, b)


def _norm(a: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(a.reshape(-1))


def _floor(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, min=1e-30)


class _Flags:
    """The loop's `active` flags on their way to the host (module
    docstring): `ended(it, active)` sends iteration it's flag and reads
    those that have arrived."""

    def __init__(self, b: torch.Tensor, maxiter: int):
        self.cuda = b.is_cuda
        self.host = torch.empty((max(maxiter, 1),), dtype=torch.bool, pin_memory=self.cuda)
        self.sent = deque()

    def _send(self, it: int, active: torch.Tensor):
        if not self.cuda:
            self.host[it] = active
            return None
        self.host[it].copy_(active, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        return ev

    def _arrived(self, it: int, j: int, ev) -> bool:
        """Whether iteration j's flag is on the host when the host is at
        iteration it (tests stand a lagging device in here)."""
        return ev is None or ev.query()

    def _wait(self, ev) -> None:
        ev.synchronize()

    def ended(self, it: int, active: torch.Tensor) -> bool:
        """True when a flag read so far, this iteration's or an earlier
        one's, is False."""
        self.sent.append((it, self._send(it, active)))
        with span("tnf.krylov.check"):
            while self.sent:
                j, ev = self.sent[0]
                if not self._arrived(it, j, ev):
                    if j != 1 and j > it - LAG:
                        return False
                    self._wait(ev)
                self.sent.popleft()
                if not self.host[j]:
                    return True
        return False


def cg(matvec: Callable, b: torch.Tensor, x0=None, maxiter: int = 50,
       tol: float = 1e-6) -> Tuple[torch.Tensor, torch.Tensor]:
    """Conjugate gradients; returns (x, k), k a 0-dim device tensor."""
    x = torch.zeros_like(b) if x0 is None else x0
    r = b - matvec(x)
    atol2 = (tol * _norm(b)) ** 2
    p = r
    rs = _dot(r, r)
    k = torch.zeros((), dtype=torch.int64, device=b.device)
    flags = _Flags(b, maxiter)
    for it in range(maxiter):
        # k < maxiter holds inside the loop (k <= it)
        active = rs > atol2
        if flags.ended(it, active):
            break
        Ap = matvec(p)
        alpha = rs / _floor(_dot(p, Ap))
        x = torch.where(active, x + alpha * p, x)
        r_new = r - alpha * Ap
        rs_new = _dot(r_new, r_new)
        beta = rs_new / _floor(rs)
        p = torch.where(active, r_new + beta * p, p)
        r = torch.where(active, r_new, r)
        rs = torch.where(active, rs_new, rs)
        k = k + active
    return x, k


def minres(matvec: Callable, b: torch.Tensor, x0=None, maxiter: int = 50,
           tol: float = 1e-6) -> Tuple[torch.Tensor, torch.Tensor]:
    """MINRES for symmetric (possibly indefinite) systems: the Lanczos
    recurrence with Givens rotations. Returns (x, k)."""
    x = torch.zeros_like(b) if x0 is None else x0
    r0 = b - matvec(x)
    beta0 = _norm(r0)
    v = r0 / _floor(beta0)
    thresh = tol * _floor(beta0)

    def scalar(value):
        return torch.tensor(value, dtype=b.dtype, device=b.device)

    v_prev = torch.zeros_like(b)
    d_pprev, d_prev = torch.zeros_like(b), torch.zeros_like(b)
    beta, c_prev, s_prev, c, s = (scalar(0.0), scalar(1.0), scalar(0.0),
                                  scalar(1.0), scalar(0.0))
    phi = beta0
    k = torch.zeros((), dtype=torch.int64, device=b.device)
    flags = _Flags(b, maxiter)
    for it in range(maxiter):
        active = torch.abs(phi) > thresh
        if flags.ended(it, active):
            break
        Av = matvec(v)
        alpha = _dot(v, Av)
        w = Av - alpha * v - beta * v_prev
        beta_new = _norm(w)
        v_new = w / _floor(beta_new)
        # the previous rotations applied to the new tridiagonal column
        delta = c * alpha - c_prev * s * beta
        gamma_bar = s * alpha + c_prev * c * beta
        eps_next = s_prev * beta
        # the new rotation, which annihilates beta_new
        gamma = _floor(torch.sqrt(delta ** 2 + beta_new ** 2))
        c_new = delta / gamma
        s_new = beta_new / gamma
        d = (v - gamma_bar * d_prev - eps_next * d_pprev) / gamma
        new = (x + c_new * phi * d, v, v_new, beta_new, c, s, c_new, s_new,
               d_prev, d, -s_new * phi)
        old = (x, v_prev, v, beta, c_prev, s_prev, c, s, d_pprev, d_prev, phi)
        (x, v_prev, v, beta, c_prev, s_prev, c, s, d_pprev, d_prev, phi) = (
            torch.where(active, n, o) for n, o in zip(new, old))
        k = k + active
    return x, k


def lanczos_galerkin(matvec: Callable, b: torch.Tensor, x0: torch.Tensor,
                     maxiter: int = 50, tol: float = 1e-6) -> torch.Tensor:
    """A fixed-size Lanczos basis of maxiter vectors and the tridiagonal
    Galerkin solve, regularised by 1e-12·I (`tol` is not read, as in the
    JAX package)."""
    D = b.numel()
    r0 = b - matvec(x0)
    beta1 = _norm(r0)
    v1 = r0 / _floor(beta1)

    V = torch.zeros((maxiter, D), dtype=b.dtype, device=b.device)
    V[0] = v1.reshape(-1)
    alphas = torch.zeros((maxiter,), dtype=b.dtype, device=b.device)
    betas = torch.zeros((maxiter + 1,), dtype=b.dtype, device=b.device)
    betas[0] = beta1
    v_prev, v = torch.zeros_like(v1), v1
    for j in range(maxiter):
        w = matvec(v) - betas[j] * v_prev
        a_j = _dot(w, v)
        w = w - a_j * v
        b_j1 = _norm(w)
        v_new = w / _floor(b_j1)
        if j + 1 < maxiter:
            V[j + 1] = v_new.reshape(-1)
        alphas[j] = a_j
        betas[j + 1] = b_j1
        v_prev, v = v, v_new

    T = (torch.diag(alphas) + torch.diag(betas[1:maxiter], 1)
         + torch.diag(betas[1:maxiter], -1))
    rhs = torch.zeros((maxiter,), dtype=b.dtype, device=b.device)
    rhs[0] = beta1
    eye = torch.eye(maxiter, dtype=b.dtype, device=b.device)
    y = torch.linalg.solve(T + 1e-12 * eye, rhs)
    return x0 + (V.T @ y).reshape(b.shape)


SOLVERS = {"cg": cg, "minres": minres}
