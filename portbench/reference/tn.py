"""Plain reference of the benchmark's networks and of the sweep that fits them.

Written from the model's equations in plain torch, in float64, with TF32
off; it imports nothing of the program. A network is N carriages; carriage
i holds a core A_i (r_i, k_i, p, r_i+1) and, for a conv-TT, a conv block
C_i (b_i, q, b_i+1); the input X (s, p, q) is shared by every carriage (a
TT's X is (s, p, 1) and its conv blocks are ones (1, 1, 1)). The output is

    y[s, (c, k)] = prod_i sum_{p,q} A_i[r, k, p, r'] X[s, p, q] C_i[b, q, b']

contracted along the r and b bonds; the C logits sit on A_1's k axis.

A node update is the ridge Gauss-Newton step of the sweep: with J the
Jacobian of y in the node, g and H the loss's gradient and Hessian in y,
A = sum_s J_s^T H_s J_s and b = sum_s J_s^T g_s, both divided by the mean
of |diag A|, the node moves by x = -(A + 2 eps I)^-1 (b + 2 eps node). A
run is `swipes` swipes, each a pass over the train nodes in order and one
back, eps = eps0 * decay^(half-sweep) counted from the run's start; a pass
after the first skips the nodes in the column of the node its predecessor
updated last.

`numerics` selects the arithmetic of the products (the control): "f64";
"tf32" or "fp8", every product's operands rounded to TF32's 10 or e4m3's 3
mantissa bits (fp8's exponent range is not modelled: a per-tensor scale
would keep the operands in it); "int4", the Gram's two operands quantised
to 4-bit codes by absmax per block of 2,048 rows and column, as the
program's int8 tier quantises them to 8 bits.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

QBLOCK = 2048  # rows of a quantisation block (the program's int8 tier's)
ROWS = 2048    # rows a block of the reference works on at once


class Numerics:
    def __init__(self, kind: str = "f64"):
        if kind not in ("f64", "tf32", "fp8", "int4"):
            raise ValueError(f"unknown reference numerics {kind!r}")
        self.kind = kind

    def op(self, x: torch.Tensor) -> torch.Tensor:
        """An operand of a product."""
        drop = DROPPED_BITS.get(self.kind)
        if drop is None:
            return x
        i = x.float().contiguous().view(torch.int32)
        # round to nearest on the dropped mantissa bits
        i = (i + (1 << (drop - 1))) & ~((1 << drop) - 1)
        return i.view(torch.float32).double()

    def gram(self, Jf: torch.Tensor, Kf: torch.Tensor, A: torch.Tensor) -> None:
        """A += the upper column blocks of Jf^T Kf over rows (rows, D); the
        caller mirrors A once the rows are summed."""
        if self.kind in LEVELS:
            for blk in range(0, Jf.shape[0], QBLOCK):
                qj, sj = _quant(Jf[blk:blk + QBLOCK], LEVELS[self.kind])
                qk, sk = _quant(Kf[blk:blk + QBLOCK], LEVELS[self.kind])
                _upper(qj, qk, A, sj, sk)
        else:
            _upper(self.op(Jf), self.op(Kf), A)


def _upper(X, Y, A, sx=None, sy=None, blocks: int = 8):
    """A[i, j] += X[:, i]^T Y[:, j] for column blocks j >= i (scaled per
    column by sx, sy)."""
    D = X.shape[1]
    step = -(-D // blocks)
    for a in range(0, D, step):
        blk = X[:, a:a + step].T @ Y[:, a:]
        if sx is not None:
            blk = blk * sx[a:a + step, None] * sy[None, a:]
        A[a:a + step, a:] += blk


def mirror(A: torch.Tensor) -> torch.Tensor:
    """The symmetric matrix whose upper triangle A holds."""
    return torch.triu(A) + torch.triu(A, 1).T


LEVELS = {"int4": 7.0}
DROPPED_BITS = {"tf32": 13, "fp8": 20}  # of float32's 23 mantissa bits


def _quant(x: torch.Tensor, levels: float):
    m = x.abs().amax(dim=0)
    s = torch.where(m > 0, m / levels, torch.ones_like(m))
    return torch.round(x / s), s


class Net:
    """Cores of one network (canonical shapes, float64) and its layout."""

    def __init__(self, cores: Dict[str, torch.Tensor], n: int, conv: bool):
        self.n = n
        self.conv = conv
        self.p = {k: v.detach().to(torch.float64).clone() for k, v in cores.items()}
        if not conv:
            for i in range(1, n + 1):
                self.p[f"C{i}"] = torch.ones((1, 1, 1), dtype=torch.float64,
                                             device=cores["A1"].device)
        self.train = ([f"A{i}" for i in range(1, n + 1)]
                      + ([f"C{i}" for i in range(1, n + 1)] if conv else []))

    @staticmethod
    def col(name: str) -> int:
        return int(name[1:]) - 1

    def inputs(self, X: torch.Tensor) -> torch.Tensor:
        X = X.to(torch.float64)
        return X if self.conv else X[:, :, None]

    # ------------------------------------------------------------ environments
    def left(self, X, upto: int, nm: Numerics):
        """Left environment (s, c, r, b) of carriages 0..upto-1."""
        S = X.shape[0]
        L = torch.ones((S, 1, 1, 1), dtype=torch.float64, device=X.device)
        for i in range(upto):
            A, C = self.p[f"A{i+1}"], self.p[f"C{i+1}"]
            XA = torch.einsum("spq,rkpR->srkqR", nm.op(X), nm.op(A))
            V = torch.einsum("scrb,srkqR->sckbqR", nm.op(L), nm.op(XA))
            L = torch.einsum("sckbqR,bqB->sckRB", nm.op(V), nm.op(C))
            L = L.reshape(S, -1, L.shape[3], L.shape[4])
        return L

    def right(self, X, start: int, nm: Numerics):
        """Right environment (s, r, b) of carriages start..n-1."""
        S = X.shape[0]
        R = torch.ones((S, 1, 1), dtype=torch.float64, device=X.device)
        for i in range(self.n - 1, start - 1, -1):
            A, C = self.p[f"A{i+1}"], self.p[f"C{i+1}"]
            XA = torch.einsum("spq,rkpR->srkqR", nm.op(X), nm.op(A))
            V = torch.einsum("srkqR,sRB->srkqB", nm.op(XA), nm.op(R))
            R = torch.einsum("srkqB,bqB->srkb", nm.op(V), nm.op(C))[:, :, 0]
        return R

    def forward(self, X, nm: Optional[Numerics] = None) -> torch.Tensor:
        """y (s, C), in blocks of rows."""
        nm = nm or Numerics()
        X = self.inputs(X)
        outs = []
        for a in range(0, X.shape[0], ROWS):
            L = self.left(X[a:a + ROWS], self.n, nm)
            outs.append(L[:, :, 0, 0])
        return torch.cat(outs)

    def jacobian(self, X, name: str, nm: Numerics) -> torch.Tensor:
        """J (s, C, D) of y in node `name`, D in the node's layout."""
        i = self.col(name)
        L = self.left(X, i, nm)
        R = self.right(X, i + 1, nm)
        S = X.shape[0]
        if name[0] == "A":
            C = self.p[f"C{i+1}"]
            W = torch.einsum("scrb,bqB->scrqB", nm.op(L), nm.op(C))
            W = torch.einsum("scrqB,sRB->scrqR", nm.op(W), nm.op(R))
            G = torch.einsum("scrqR,spq->scrpR", nm.op(W), nm.op(X))
            k = self.p[name].shape[1]
            if k == 1:
                return G.reshape(S, G.shape[1], -1)
            eye = torch.eye(k, dtype=torch.float64, device=X.device)
            return torch.einsum("srpR,jk->sjrkpR", G[:, 0], eye).reshape(S, k, -1)
        A = self.p[f"A{i+1}"]
        XA = torch.einsum("spq,rkpR->srkqR", nm.op(X), nm.op(A))
        M = torch.einsum("scrb,srkqR->sckbqR", nm.op(L), nm.op(XA))
        J = torch.einsum("sckbqR,sRB->sckbqB", nm.op(M), nm.op(R))
        return J.reshape(S, J.shape[1] * J.shape[2], -1)


# ------------------------------------------------------------------ losses
def xe(pred, y):
    """Cross entropy on C-1 logits with an appended zero logit: per-sample
    loss, gradient (s, C-1) and Hessian (s, C-1, C-1)."""
    z = torch.cat([pred, torch.zeros_like(pred[:, :1])], dim=1)
    ls = torch.log_softmax(z, dim=1)
    s = ls.exp()
    loss = -(y * ls).sum(dim=1)
    g = (s - y)[:, :-1]
    H = (torch.diag_embed(s) - s[:, :, None] * s[:, None, :])[:, :-1, :-1]
    return loss, g, H


def square(pred, y):
    """Squared error: loss, gradient 2(p - y), diagonal Hessian 2."""
    d = pred - y
    return (d * d).sum(dim=1), 2 * d, torch.full_like(pred, 2.0)


LOSSES = {"xe": xe, "square": square}


def loss_of(kind: str, pred, y) -> float:
    return float(LOSSES[kind](pred.double(), y.double())[0].mean())


# ------------------------------------------------------------------ the sweep
def update(net: Net, name: str, X, y, loss: str, eps: float, nm: Numerics,
           keep: Optional[torch.Tensor] = None) -> float:
    """One ridge Gauss-Newton update of node `name` over every row (`keep`:
    per-row weights, the fault of a batch half left out). Returns the mean
    loss of the state before it (over the rows, weighted by `keep`)."""
    core = net.p[name]
    D = core.numel()
    A = torch.zeros((D, D), dtype=torch.float64, device=X.device)
    b = torch.zeros((D,), dtype=torch.float64, device=X.device)
    y = y.to(torch.float64)
    total = 0.0
    for a in range(0, X.shape[0], ROWS):
        Xb, yb = X[a:a + ROWS], y[a:a + ROWS]
        J = net.jacobian(Xb, name, nm)
        pred = torch.einsum("scd,d->sc", nm.op(J), nm.op(core.reshape(-1)))
        lo, g, H = LOSSES[loss](pred, yb)
        if keep is not None:
            w = keep[a:a + ROWS].to(torch.float64)
            lo = lo * w
            g = g * w[:, None]
            H = H * (w[:, None, None] if H.ndim == 3 else w[:, None])
        total += float(lo.sum())
        K = (torch.einsum("sce,sed->scd", nm.op(H), nm.op(J)) if H.ndim == 3
             else J * H[:, :, None])
        # rows (c, s) within the block, as the program's class-major layout
        nm.gram(J.transpose(0, 1).reshape(-1, D), K.transpose(0, 1).reshape(-1, D), A)
        b += torch.einsum("sc,scd->d", nm.op(g), nm.op(J))
        del J, K
    A = mirror(A)
    scale = A.diagonal().abs().mean()
    scale = scale if float(scale) != 0 else torch.ones_like(scale)
    A = A / scale
    b = b / scale
    A.diagonal().add_(2.0 * eps)
    b = b + 2.0 * eps * core.reshape(-1)
    Lc = torch.linalg.cholesky(A)
    x = torch.cholesky_solve(-b[:, None], Lc)[:, 0]
    net.p[name] = core + x.reshape(core.shape)
    return total / X.shape[0]


def schedule(net: Net, swipes: int, eps0: float, decay: float):
    """(node, eps) of each update of one run, in order."""
    order = net.train
    last_col = None
    ns = 0
    for _ in range(swipes):
        for rev in (False, True):
            frozen = last_col
            eps = eps0 * decay ** ns
            for name in (reversed(order) if rev else order):
                if frozen is not None and net.col(name) == frozen:
                    continue
                yield name, eps
                last_col = net.col(name)
            ns += 1


def run(net: Net, X, y, loss: str, swipes: int, eps0: float, decay: float,
        nm: Optional[Numerics] = None, keep: Optional[torch.Tensor] = None,
        updates: Optional[int] = None) -> List[float]:
    """One run of the sweep over X's rows (its first `updates` node updates
    when given), in place. Returns each update's loss."""
    nm = nm or Numerics()
    X = net.inputs(X)
    losses = []
    for i, (name, eps) in enumerate(schedule(net, swipes, eps0, decay)):
        if updates is not None and i >= updates:
            break
        losses.append(update(net, name, X, y, loss, eps, nm, keep))
    return losses


def cores_in(net: Net, names: Sequence[str]) -> Dict[str, torch.Tensor]:
    return {k: net.p[k] for k in names}


def leaf_change_gap(p0: Dict[str, torch.Tensor], got: Dict[str, torch.Tensor],
                    ref: Dict[str, torch.Tensor]) -> Tuple[float, List[str]]:
    """The worst leaf's gap between the program's and the reference's norms
    of change, over the larger of that leaf's and the median leaf's
    reference change. Leaves the reference leaves unmoved (a change under a
    thousandth of the median leaf's) are left out; returns the gap and
    their names."""
    dref = {k: float(torch.linalg.vector_norm(ref[k].double() - p0[k].double())) for k in ref}
    dgot = {k: float(torch.linalg.vector_norm(got[k].double().reshape(p0[k].shape)
                                              - p0[k].double())) for k in ref}
    moved = [v for v in dref.values() if v > 0]
    med = float(torch.tensor(moved).median())
    out = [k for k, v in dref.items() if v < 1e-3 * med]
    gaps = [abs(dgot[k] - dref[k]) / max(dref[k], med) for k in dref if k not in out]
    # a leaf the reference leaves where it was must stay there
    gaps += [float("inf") for k in out if dgot[k] > 0 and dref[k] == 0]
    return max(gaps), out
