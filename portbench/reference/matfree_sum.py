"""Plain reference of a type-I sum of conv-TTs and of its matrix-free node
update (the `cifar_minres` configuration).

Written from the model's equations in plain torch, in float64, with TF32
off; it imports nothing of the program (`tn.py` lends its rounding of a
product's operands for the control). The model is a sum of members; member
m is a conv-TT of n_m carriages over the shared patches X (s, P, q), cut to
its own first P_m patches and q_m pixels (the first member keeps the bias
patch and pixel, the others drop them). Carriage i of a member holds a core
A_i (r_i, k_i, p, r_i+1) and a conv block C_i (b_i, q, b_i+1), and

    y_m[s, c] = prod_i sum_{p,q} A_i[r, k, p, r'] X[s, p, q] C_i[b, q, b']

contracted along the r and b bonds, the C logits on A_1's k axis; the
model's logits are the sum over the members. The loss is the cross entropy
of the logits scaled by w with a zero logit appended; g and H are its
gradient and Hessian in the C logits.

A node update (the matrix-free branch of the sweep): linearise at the
state: the logits of the whole sum, each row's loss, g and H;
b = sum_s J_s^T g_s, J the Jacobian of the node's member in the node;
b_aug = b + 2 eps node. The operator A v = sum_s J_s^T H_s J_s v + 2 eps v
is applied as contractions of the member's own environments, so J is never
formed, and is divided by its norm along b_aug (one probe,
||A u|| with u = b_aug / ||b_aug||). Then x = MINRES(A / scale,
-b_aug / scale, x0), the recurrence of the Lanczos process with Givens
rotations, run for a given number k of iterations, and the node moves by
x. Fixing k makes x a function of A, b and x0: a program that stopped after
k iterations differs from this by its rounding alone.

A run (`swipe`) updates every train node of every member (A_1..A_n, then
C_1..C_n, member by member) and then the same in reverse, skipping in the
second pass the nodes in the column of the first pass's last node; eps is
eps0 in the first pass and eps0 * decay in the second; each node's MINRES
starts from its previous solution (zeros on its first visit).

`aux` selects the arithmetic of the environments and the members' forwards
(the program's auxiliary contractions): `tn.Numerics` kinds, "f64" or the
control's rounded operands; the matvec, b and the solve stay in float64.
`weights`, per row, weigh the rows of the matvec alone (the fault of half
the chunks in the matvec). `mv` rounds the operands of every product of the
matvec (J v, H·, J^T u) to TF32's 10 or bf16's 7 mantissa bits (the
matvec's controls); b, the loss and MINRES stay in float64.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from .tn import Numerics

ROWS = 2048  # rows a block of the reference works on at once
DROPPED_BITS = {"tf32": 13, "bf16": 16}  # of f32's 23 mantissa bits


def rounded(x: torch.Tensor, kind: Optional[str]) -> torch.Tensor:
    """x as float64 after rounding to f32 and then to nearest on the
    mantissa bits `kind` drops (None: x itself)."""
    if kind is None:
        return x
    drop = DROPPED_BITS[kind]
    i = x.float().contiguous().view(torch.int32)
    i = (i + (1 << (drop - 1))) & ~((1 << drop) - 1)
    return i.view(torch.float32).double()


def xe(pred: torch.Tensor, y: torch.Tensor, w: float):
    """Per-row loss, g (s, C) and H (s, C, C) of the cross entropy of w·pred
    with a zero logit appended."""
    z = torch.cat([w * pred, torch.zeros_like(pred[:, :1])], dim=1)
    ls = torch.log_softmax(z, dim=1)
    s = ls.exp()
    loss = -(y * ls).sum(dim=1)
    g = w * (s - y)[:, :-1]
    H = w * w * (torch.diag_embed(s) - s[:, :, None] * s[:, None, :])[:, :-1, :-1]
    return loss, g, H


class Member:
    """One conv-TT of the sum: its canonical cores (float64), carriages,
    and the patches and pixels it reads."""

    def __init__(self, cores: Dict[str, torch.Tensor], n: int, patches: int, pixels: int):
        self.n, self.P, self.q = n, patches, pixels
        self.p = {k: v.detach().to(torch.float64).clone() for k, v in cores.items()}
        self.train = [f"A{i}" for i in range(1, n + 1)] + [f"C{i}" for i in range(1, n + 1)]

    def x(self, X: torch.Tensor) -> torch.Tensor:
        return X[:, :self.P, :self.q].to(torch.float64)

    def left(self, X, upto: int, nm: Numerics) -> torch.Tensor:
        """Left environment (s, c, r, b) of carriages 1..upto."""
        L = torch.ones((X.shape[0], 1, 1, 1), dtype=torch.float64, device=X.device)
        for i in range(1, upto + 1):
            A, C = self.p[f"A{i}"], self.p[f"C{i}"]
            XC = torch.einsum("spq,bqB->spbB", nm.op(X), nm.op(C))
            LXC = torch.einsum("scrb,spbB->scrpB", nm.op(L), nm.op(XC))
            L = torch.einsum("scrpB,rkpR->sckRB", nm.op(LXC), nm.op(A))
            L = L.reshape(L.shape[0], -1, L.shape[3], L.shape[4])
        return L

    def right(self, X, start: int, nm: Numerics) -> torch.Tensor:
        """Right environment (s, r, b) of carriages start..n."""
        R = torch.ones((X.shape[0], 1, 1), dtype=torch.float64, device=X.device)
        for i in range(self.n, start - 1, -1):
            A, C = self.p[f"A{i}"], self.p[f"C{i}"]
            XC = torch.einsum("spq,bqB->spbB", nm.op(X), nm.op(C))
            XCR = torch.einsum("spbB,sRB->spbR", nm.op(XC), nm.op(R))
            R = torch.einsum("spbR,rpR->srb", nm.op(XCR), nm.op(A[:, 0]))
        return R

    def forward(self, X, nm: Numerics) -> torch.Tensor:
        """y (s, C) of the member on the block's patches X (s, P, q)."""
        return self.left(self.x(X), self.n, nm)[:, :, 0, 0]


class NodeOps:
    """J v and J^T u of one node on one block of rows, from the member's
    environments: L (s, C, r, b) left of the node's carriage, R (s, r', b')
    right of it, and the carriage's other factors (X·C for a core, X and
    A for a conv block)."""

    def __init__(self, mem: Member, X: torch.Tensor, name: str, aux: Numerics):
        i = int(name[1:])
        Xm = mem.x(X)
        self.core = name[0] == "A"
        self.L = mem.left(Xm, i - 1, aux)
        self.R = mem.right(Xm, i + 1, aux)
        if self.core:
            self.XC = torch.einsum("spq,bqB->spbB", aux.op(Xm), aux.op(mem.p[f"C{i}"]))
        else:
            self.X, self.A = Xm, mem.p[f"A{i}"]

    def jv(self, v: torch.Tensor, mv: Optional[str] = None) -> torch.Tensor:
        """(J v)[s, C], v in the node's canonical shape; `mv` rounds every
        product's operands."""
        def ein(sub, a, b):
            return torch.einsum(sub, rounded(a, mv), rounded(b, mv))
        if self.core:
            t = ein("rkpR,sRB->srkpB", v, self.R)
            t = ein("srkpB,spbB->srkb", t, self.XC)
        else:
            t = ein("spq,bqB->spbB", self.X, v)
            t = ein("spbB,sRB->spbR", t, self.R)
            t = ein("spbR,rkpR->srkb", t, self.A)
        y = ein("scrb,srkb->sck", self.L, t)
        return y.reshape(y.shape[0], -1)

    def jtu(self, u: torch.Tensor, mv: Optional[str] = None) -> torch.Tensor:
        """(J^T u) in the node's canonical shape, u (s, C); `mv` rounds
        every product's operands."""
        def ein(sub, a, b):
            return torch.einsum(sub, rounded(a, mv), rounded(b, mv))
        c = self.L.shape[1]
        Lu = ein("scrb,sck->srkb", self.L, u.reshape(u.shape[0], c, -1))
        if self.core:
            t = ein("srkb,spbB->srkpB", Lu, self.XC)
            return ein("srkpB,sRB->rkpR", t, self.R)
        t = ein("srkb,rkpR->spbR", Lu, self.A)
        t = ein("spbR,sRB->spbB", t, self.R)
        return ein("spbB,spq->bqB", t, self.X)


class Sum:
    """The type-I sum: its members and each node's last MINRES solution."""

    def __init__(self, members: Sequence[Member]):
        self.members = list(members)
        self.sols: Dict[Tuple[int, str], torch.Tensor] = {}

    def forward(self, X: torch.Tensor, aux: Optional[Numerics] = None) -> torch.Tensor:
        """The sum's logits (s, C), in blocks of rows."""
        aux = aux or Numerics()
        outs = []
        for a in range(0, X.shape[0], ROWS):
            Xb = X[a:a + ROWS]
            outs.append(sum(m.forward(Xb, aux) for m in self.members))
        return torch.cat(outs)


def minres(matvec, b: torch.Tensor, x0: torch.Tensor, k: int) -> torch.Tensor:
    """k iterations of MINRES from x0 (the program's recurrence and
    clamps)."""
    def floor(t):
        return torch.clamp(t, min=1e-30)

    x = x0.clone()
    r0 = b - matvec(x)
    beta0 = torch.linalg.vector_norm(r0)
    v = r0 / floor(beta0)
    zero = torch.zeros((), dtype=b.dtype, device=b.device)
    one = torch.ones((), dtype=b.dtype, device=b.device)
    v_prev = d_pprev = d_prev = torch.zeros_like(b)
    beta, c_prev, s_prev, c, s, phi = zero, one, zero, one, zero, beta0
    for _ in range(k):
        Av = matvec(v)
        alpha = torch.dot(v, Av)
        w = Av - alpha * v - beta * v_prev
        beta_new = torch.linalg.vector_norm(w)
        v_new = w / floor(beta_new)
        delta = c * alpha - c_prev * s * beta
        gamma_bar = s * alpha + c_prev * c * beta
        eps_next = s_prev * beta
        gamma = floor(torch.sqrt(delta ** 2 + beta_new ** 2))
        c_new, s_new = delta / gamma, beta_new / gamma
        d = (v - gamma_bar * d_prev - eps_next * d_pprev) / gamma
        x = x + c_new * phi * d
        v_prev, v, beta = v, v_new, beta_new
        c_prev, s_prev, c, s = c, s, c_new, s_new
        d_pprev, d_prev, phi = d_prev, d, -s_new * phi
    return x


def update(model: Sum, X, y, w: float, m: int, name: str, eps: float, k: int,
           x0: Optional[torch.Tensor] = None, aux: Optional[Numerics] = None,
           weights: Optional[torch.Tensor] = None,
           mv: Optional[str] = None) -> Tuple[float, torch.Tensor]:
    """One matrix-free update of node `name` of member m over every row,
    MINRES for k iterations from x0 (zeros where None), the matvec's
    operands rounded by `mv`. Moves the node; returns (the mean loss of the
    state before it, x)."""
    aux = aux or Numerics()
    mem = model.members[m]
    core = mem.p[name]
    y = y.to(torch.float64)
    b = torch.zeros_like(core)
    total, blocks = 0.0, []
    for a in range(0, X.shape[0], ROWS):
        Xb, yb = X[a:a + ROWS], y[a:a + ROWS]
        pred = sum(mm.forward(Xb, aux) for mm in model.members)
        lo, g, H = xe(pred, yb, w)
        ops = NodeOps(mem, Xb, name, aux)
        total += float(lo.sum())
        b += ops.jtu(g)
        if weights is not None:
            H = H * weights[a:a + ROWS, None, None].to(H)
        blocks.append((ops, H))

    def raw(v):
        v = v.reshape(core.shape)
        out = torch.zeros_like(core)
        for ops, H in blocks:
            Hu = torch.einsum("scd,sd->sc", rounded(H, mv), rounded(ops.jv(v, mv), mv))
            out += ops.jtu(Hu, mv)
        return out.reshape(-1)

    two_eps = 2.0 * eps
    b_aug = b.reshape(-1) + two_eps * core.reshape(-1)
    unit = b_aug / torch.clamp(torch.linalg.vector_norm(b_aug), min=1e-30)
    scale = torch.linalg.vector_norm(raw(unit) + two_eps * unit)
    scale = scale if float(scale) > 0 else torch.ones_like(scale)

    def matvec(v):
        return (raw(v) + two_eps * v) / scale

    x0 = (torch.zeros_like(b_aug) if x0 is None
          else x0.reshape(-1).to(b_aug))
    x = minres(matvec, -b_aug / scale, x0, k)
    mem.p[name] = core + x.reshape(core.shape)
    return total / X.shape[0], x


def schedule(model: Sum) -> List[List[Tuple[int, str]]]:
    """The (member, node) updates of the two passes of one swipe."""
    seq = [(m, n) for m, mem in enumerate(model.members) for n in mem.train]
    first = list(seq)
    m_last, n_last = first[-1]
    frozen = (m_last, int(n_last[1:]))
    second = [(m, n) for m, n in reversed(seq) if (m, int(n[1:])) != frozen]
    return [first, second]


def swipe(model: Sum, X, y, w: float, eps0: float, decay: float, ks: Sequence[int],
          aux: Optional[Numerics] = None) -> List[float]:
    """One swipe in place, the i-th update running ks[i] MINRES iterations
    from the node's previous solution. Returns each update's loss."""
    losses, it = [], iter(ks)
    for ns, order in enumerate(schedule(model)):
        for m, name in order:
            loss, x = update(model, X, y, w, m, name, eps0 * decay ** ns, next(it),
                             model.sols.get((m, name)), aux)
            model.sols[(m, name)] = x
            losses.append(loss)
    return losses
