"""libsvm's C-SVC and epsilon-SVR, written out in torch.

sklearn's `SVC` and `SVR` are libsvm (sklearn/svm/src/libsvm/svm.cpp);
the card's machine has no sklearn, so the port carries the solver itself:

- `Solver::Solve`: SMO over the dual  min ½ αᵀQα + pᵀα,  yᵀα = 0,
  0 <= α <= C, from α = 0, with the second-order working-set selection
  (`select_working_set`, TAU = 1e-12, stop at Gmax + Gmax2 < eps), the
  two-variable update clipped to the box, shrinking (`do_shrinking`,
  `reconstruct_gradient`) and `calculate_rho`.
- Q as libsvm keeps it: each kernel entry computed in float64 (or read
  from a precomputed Gram matrix) and rounded to float32 (`Qfloat`), the
  diagonal QD, the gradient G and α in float64, each update in libsvm's
  order of operations.
- `SVC_Q` (C-SVC on ±1 labels, p = -1) and `SVR_Q` (ε-SVR over 2l
  variables, p = ε ∓ y).

Ties in the selection go to the variable at the last place of libsvm's
arrays, as its `>=` scans give them; shrinking permutes those places as
libsvm's swaps do (`_shrink`). Without shrinking the iterates are
libsvm's bit for bit. With it, the rebuilt gradient of the shrunk
variables is summed in another order than libsvm's, so they agree to
rounding (bit for bit on every table of the tests).

Several problems (the k(k-1)/2 one-vs-one pairs of a classifier) run as
one padded batch: each pass selects, updates and shrinks every running
problem at once, on device tensors, without reading a value back to the
host. A problem that meets its stop freezes, so its iterates are the ones
it would take alone. Shrinking is a per-problem mask of active variables.
libsvm's two events that rebuild the gradient of the shrunk variables (the
active set looks optimal; the gap first falls under 10 eps) pause the
problem; every `SYNC_EVERY` passes the host reads the flags, rebuilds the
paused problems' gradients in one batched product, and resumes them. On
a CUDA device each pass replays a CUDA graph (`_GraphedStep`).
"""
from __future__ import annotations

import copy
import warnings
from dataclasses import dataclass, field
from typing import List

import numpy as np
import torch

TAU = 1e-12
# passes between two reads of the problems' flags by the host
SYNC_EVERY = 64
# rows of a float64 pairwise-difference block (rows x cols x features)
_DIFF_BLOCK = 1 << 22

RUNNING, DONE, PAUSE_OPTIMAL, PAUSE_UNSHRINK = 0, 1, 2, 3

# libsvm's kernels; "precomputed" takes the Gram matrix (n, n) as X at fit
# and the test-train kernel (m, n) at predict
KERNELS = ("linear", "poly", "rbf", "sigmoid", "precomputed")


def pair_sums(A: torch.Tensor, B: torch.Tensor, fn) -> torch.Tensor:
    """fn(a - b) summed over the features for every row pair, in blocks of
    rows so the (rows, cols, features) difference stays small."""
    out = torch.empty((A.shape[0], B.shape[0]), dtype=A.dtype, device=A.device)
    step = max(1, _DIFF_BLOCK // max(1, B.shape[0] * A.shape[1]))
    for s in range(0, A.shape[0], step):
        out[s:s + step] = fn(A[s:s + step, None, :] - B[None, :, :]).sum(-1)
    return out


def sq_dists(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """||a - b||² of every row pair, summed over the differences (as libsvm
    and scipy's pdist sum them, not as ||a||² + ||b||² - 2ab)."""
    return pair_sums(A, B, lambda d: d * d)


def kernel_matrix(A: torch.Tensor, B: torch.Tensor, kernel: str, gamma: float,
                  coef0: float = 0.0, degree: int = 3) -> torch.Tensor:
    """libsvm's `k_function` between the rows of A and B, in their dtype."""
    if kernel == "rbf":
        return torch.exp(-gamma * sq_dists(A, B))
    dot = A @ B.T
    if kernel == "linear":
        return dot
    if kernel == "poly":
        return (gamma * dot + coef0) ** degree
    if kernel == "sigmoid":
        return torch.tanh(gamma * dot + coef0)
    raise ValueError(f"kernel {kernel!r} is not one of {KERNELS}")


@dataclass
class Problems:
    """B dual problems over the rows of one kernel matrix, padded to L
    variables. Variable t of problem b is row `idx[b, t]` with label
    `y[b, t]` (±1), linear term `p`, upper bound `C`; `valid` marks the
    real variables."""
    K32: torch.Tensor          # (n, n) float32: libsvm's Qfloat entries
    QD: torch.Tensor           # (B, L) float64: K(x, x) unrounded
    idx: torch.Tensor          # (B, L) long
    y: torch.Tensor            # (B, L) float64
    p: torch.Tensor            # (B, L) float64
    C: torch.Tensor            # (B, L) float64
    valid: torch.Tensor        # (B, L) bool


@dataclass
class Solution:
    alpha: torch.Tensor        # (B, L) float64, α of each problem
    rho: torch.Tensor          # (B,) float64
    n_iter: List[int] = field(default_factory=list)
    timed_out: List[bool] = field(default_factory=list)


class _State:
    """The solver's arrays for every problem. `pos` is each variable's place
    in libsvm's arrays, which do_shrinking permutes: ties in the selection
    go to the last place, as libsvm's `>=` scans give them."""

    def __init__(self, pr: Problems, eps: float, shrinking: bool):
        B, L = pr.y.shape
        dev = pr.y.device
        self.alpha = torch.zeros((B, L), dtype=torch.float64, device=dev)
        self.G = pr.p.clone()
        self.G_bar = torch.zeros_like(self.G)
        self.active = pr.valid.clone()
        self.status = torch.full((B,), RUNNING, dtype=torch.long, device=dev)
        self.n_iter = torch.zeros((B,), dtype=torch.long, device=dev)
        self.timed_out = torch.zeros((B,), dtype=torch.bool, device=dev)
        self.unshrunk = torch.zeros((B,), dtype=torch.bool, device=dev)
        self.gmax = torch.zeros((B, 2), dtype=torch.float64, device=dev)
        self.eps, self.shrinking = eps, shrinking
        self.rows = torch.arange(B, device=dev)
        self.pos = torch.arange(L, device=dev).expand(B, L).clone()


def _bounds(alpha, C):
    upper = alpha >= C
    lower = ~upper & (alpha <= 0)
    return upper, lower


def _last_place(hit: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Each problem's variable at the last place among `hit` (-1: none)."""
    key = torch.where(hit, pos, -1)
    return torch.where(hit.any(1), key.argmax(1), -1)


def _q_rows(pr: Problems, st: _State, t: torch.Tensor) -> torch.Tensor:
    """Q[b, t_b, :] in float64: y_t y_s float32(K(x_t, x_s))."""
    row = pr.idx[st.rows, t]
    q = pr.K32[row].gather(1, pr.idx).double()
    return (pr.y[st.rows, t][:, None] * pr.y) * q


def _scan(pr: Problems, st: _State):
    """-yG's max over I_up (Gmax) and yG's over I_low (Gmax2) on the active
    set, as do_shrinking and select_working_set scan them."""
    upper, lower = _bounds(st.alpha, pr.C)
    pos = pr.y > 0
    act = st.active & pr.valid
    i_up = act & torch.where(pos, ~upper, ~lower)
    i_low = act & torch.where(pos, ~lower, ~upper)
    yG = pr.y * st.G
    g1 = torch.where(i_up, -yG, float("-inf")).amax(1)
    g2 = torch.where(i_low, yG, float("-inf")).amax(1)
    return g1, g2, i_up, i_low, yG


def _select(pr: Problems, st: _State):
    """select_working_set for every problem: (i, j, optimal, Q_i). i is the
    last maximiser of -yG over I_up; j the last minimiser over I_low of
    -(Gmax + yG)² / quad among those with Gmax + yG > 0."""
    gmax, gmax2, i_up, i_low, yG = _scan(pr, st)
    i = _last_place(i_up & (-yG == gmax[:, None]), st.pos).clamp(min=0)
    Qi = _q_rows(pr, st, i)
    QDi = pr.QD[st.rows, i]
    grad_diff = gmax[:, None] + yG
    # QD_i + QD_j - 2 K_ij: Qi carries y_i y_j, as libsvm's Q_i[j] does
    quad = (QDi[:, None] + pr.QD) - (2.0 * pr.y[st.rows, i][:, None] * pr.y) * Qi
    neg_obj = (grad_diff * grad_diff) / torch.where(quad > 0, quad, TAU)
    cand = i_low & (grad_diff > 0)
    best = torch.where(cand, neg_obj, float("-inf")).amax(1)
    j = _last_place(cand & (neg_obj == best[:, None]), st.pos)
    optimal = (gmax + gmax2 < st.eps) | (j < 0)
    return i, j.clamp(min=0), optimal, Qi


def _shrink(pr: Problems, st: _State, which: torch.Tensor, g1, g2) -> None:
    """do_shrinking's loop for the problems in `which`: drop from the active
    set each variable at a bound whose gradient keeps it there, and permute
    the places as libsvm's swaps do (the k-th dropped place from the front
    takes the k-th kept place from the back of the active set)."""
    upper, lower = _bounds(st.alpha, pr.C)
    pos = pr.y > 0
    G = st.G
    gone = ((upper & torch.where(pos, -G > g1[:, None], -G > g2[:, None]))
            | (lower & torch.where(pos, G > g2[:, None], G > g1[:, None])))
    region = st.active & pr.valid & which[:, None]
    gone = gone & region
    kept = (region & ~gone).sum(1, keepdim=True)
    front = gone & (st.pos < kept)
    back = region & ~gone & (st.pos >= kept)
    L = st.pos.shape[1]
    kf = torch.where(front, st.pos, 2 * L).argsort(1)
    kb = torch.where(back, -st.pos, 2 * L).argsort(1)
    take = torch.arange(L, device=G.device) < front.sum(1, keepdim=True)
    pf, pb = st.pos.gather(1, kf), st.pos.gather(1, kb)
    ext = torch.cat([st.pos, st.pos[:, :1]], 1)
    ext.scatter_(1, torch.where(take, kf, L), pb)
    ext.scatter_(1, torch.where(take, kb, L), pf)
    st.pos = ext[:, :L]
    st.active = st.active & ~gone


def _update_pair(ai, aj, Gi, Gj, QDi, QDj, Qij, Ci, Cj, differ):
    """The two-variable step of Solver::Solve, clipped to the box, for a
    batch of (i, j): returns the new α_i, α_j."""
    # y_i != y_j
    quad = QDi + QDj + 2 * Qij
    quad = torch.where(quad <= 0, TAU, quad)
    delta = (-Gi - Gj) / quad
    diff = ai - aj
    a1, a2 = ai + delta, aj + delta
    pos = diff > 0
    m = pos & (a2 < 0)
    a1, a2 = torch.where(m, diff, a1), torch.where(m, 0.0, a2)
    m = ~pos & (a1 < 0)
    a1, a2 = torch.where(m, 0.0, a1), torch.where(m, -diff, a2)
    over = diff > Ci - Cj
    m = over & (a1 > Ci)
    a1, a2 = torch.where(m, Ci, a1), torch.where(m, Ci - diff, a2)
    m = ~over & (a2 > Cj)
    a1, a2 = torch.where(m, Cj + diff, a1), torch.where(m, Cj, a2)
    # y_i == y_j
    quad = QDi + QDj - 2 * Qij
    quad = torch.where(quad <= 0, TAU, quad)
    delta = (Gi - Gj) / quad
    s = ai + aj
    b1, b2 = ai - delta, aj + delta
    over = s > Ci
    m = over & (b1 > Ci)
    b1, b2 = torch.where(m, Ci, b1), torch.where(m, s - Ci, b2)
    m = ~over & (b2 < 0)
    b1, b2 = torch.where(m, s, b1), torch.where(m, 0.0, b2)
    over = s > Cj
    m = over & (b2 > Cj)
    b1, b2 = torch.where(m, s - Cj, b1), torch.where(m, Cj, b2)
    m = ~over & (b1 < 0)
    b1, b2 = torch.where(m, 0.0, b1), torch.where(m, s, b2)
    return torch.where(differ, a1, b1), torch.where(differ, a2, b2)


def _step(pr: Problems, st: _State, max_iter: int, hit=None) -> None:
    """One pass of Solver::Solve's loop for every running problem; `hit`
    marks the problems whose shrinking counter runs out at this pass."""
    run = st.status == RUNNING
    if max_iter != -1:
        out = run & (st.n_iter >= max_iter)
        st.timed_out |= out
        st.status = torch.where(out, DONE, st.status)
        run = run & ~out
    if hit is not None:
        hit = hit & run
        g1, g2 = _scan(pr, st)[:2]
        # the first gap under 10 eps rebuilds the shrunk gradient: the host
        # does that, then this pass's shrink (with the Gmax pair saved here)
        unshrink = hit & ~st.unshrunk & (g1 + g2 <= st.eps * 10)
        st.gmax = torch.where(unshrink[:, None], torch.stack([g1, g2], 1), st.gmax)
        st.status = torch.where(unshrink, PAUSE_UNSHRINK, st.status)
        run = run & ~unshrink
        _shrink(pr, st, hit & ~unshrink, g1, g2)
    i, j, optimal, Qi = _select(pr, st)
    whole = (st.active | ~pr.valid).all(1)
    st.status = torch.where(run & optimal, torch.where(whole, DONE, PAUSE_OPTIMAL),
                            st.status)
    go = run & ~optimal
    st.n_iter += go
    r = st.rows
    Qj = _q_rows(pr, st, j)
    ai, aj = st.alpha[r, i], st.alpha[r, j]
    Ci, Cj = pr.C[r, i], pr.C[r, j]
    ni, nj = _update_pair(ai, aj, st.G[r, i], st.G[r, j], pr.QD[r, i], pr.QD[r, j],
                          Qi[r, j], Ci, Cj, pr.y[r, i] != pr.y[r, j])
    ni, nj = torch.where(go, ni, ai), torch.where(go, nj, aj)
    dai, daj = ni - ai, nj - aj
    st.G = torch.where(st.active & go[:, None],
                       st.G + (Qi * dai[:, None] + Qj * daj[:, None]), st.G)
    st.alpha = st.alpha.index_put((r, i), ni).index_put((r, j), nj)
    if st.shrinking:
        # G_bar: the gradient's part from the variables at their upper bound
        ui, uj = ai >= Ci, aj >= Cj
        ci = torch.where(ui != (ni >= Ci), torch.where(ui, -Ci, Ci), 0.0)
        cj = torch.where(uj != (nj >= Cj), torch.where(uj, -Cj, Cj), 0.0)
        st.G_bar = st.G_bar + ci[:, None] * Qi
        st.G_bar = st.G_bar + cj[:, None] * Qj


def _reconstruct(pr: Problems, st: _State, sel: torch.Tensor) -> None:
    """reconstruct_gradient for the problems in `sel`: G of each shrunk
    variable from G_bar, p and the free variables; then all active."""
    upper, lower = _bounds(st.alpha, pr.C)
    free = st.active & pr.valid & ~upper & ~lower
    v = torch.where(free & sel[:, None], st.alpha * pr.y, 0.0)
    w = torch.zeros((v.shape[0], pr.K32.shape[0]), dtype=v.dtype, device=v.device)
    Kw = w.scatter_add_(1, pr.idx, v) @ pr.K32.double()
    g = pr.y * Kw.gather(1, pr.idx) + (st.G_bar + pr.p)
    st.G = torch.where(sel[:, None] & pr.valid & ~st.active, g, st.G)
    st.active = torch.where(sel[:, None], pr.valid, st.active)


def _calculate_rho(pr: Problems, st: _State) -> torch.Tensor:
    upper, lower = _bounds(st.alpha, pr.C)
    act = st.active & pr.valid
    yG = pr.y * st.G
    pos = pr.y > 0
    free = act & ~upper & ~lower
    to_ub = act & ((upper & ~pos) | (lower & pos))
    to_lb = act & ((upper & pos) | (lower & ~pos))
    ub = torch.where(to_ub, yG, float("inf")).amin(1)
    lb = torch.where(to_lb, yG, float("-inf")).amax(1)
    nr_free = free.sum(1)
    sum_free = torch.where(free, yG, 0.0).sum(1)
    return torch.where(nr_free > 0, sum_free / nr_free.clamp(min=1), (ub + lb) / 2)


_FIELDS = ("alpha", "G", "G_bar", "active", "status", "n_iter", "timed_out", "unshrunk",
           "gmax", "pos")


class _GraphedStep:
    """_step recorded as a CUDA graph (one without the shrink scan and one
    with it, its hit mask read from a fixed buffer) and replayed a pass at a
    time. A pass is some 250 small kernels: launched one by one from the
    host they take longer to launch than the card takes to run them. The
    state's tensors are the graphs' fixed buffers; a field that eager code
    replaced between passes is copied into its buffer before a replay."""

    def __init__(self, pr: Problems, st: _State, max_iter: int):
        self.pr, self.st, self.max_iter = pr, st, max_iter
        self.static = {f: getattr(st, f) for f in _FIELDS}
        self.hit = torch.zeros(pr.y.shape[0], dtype=torch.bool, device=pr.y.device)
        self.graphs = {}

    def _bind(self) -> None:
        for f, buf in self.static.items():
            cur = getattr(self.st, f)
            if cur is not buf:
                buf.copy_(cur)
                setattr(self.st, f, buf)

    def _record(self, with_hit: bool):
        st, hit = self.st, self.hit if with_hit else None
        # a warm-up pass on a copy of the state: capture records, runs nothing
        scratch = copy.copy(st)
        for f in _FIELDS:
            setattr(scratch, f, getattr(st, f).clone())
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            _step(self.pr, scratch, self.max_iter, hit)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            _step(self.pr, st, self.max_iter, hit)
            for f, buf in self.static.items():
                if getattr(st, f) is not buf:
                    buf.copy_(getattr(st, f))
        for f, buf in self.static.items():
            setattr(st, f, buf)
        return graph

    def __call__(self, hit=None) -> None:
        self._bind()
        if hit is not None:
            self.hit.copy_(hit)
        key = hit is not None
        if key not in self.graphs:
            self.graphs[key] = self._record(key)
        self.graphs[key].replay()


def solve(pr: Problems, eps: float = 1e-3, shrinking: bool = True,
          max_iter: int = -1) -> Solution:
    """Solver::Solve for every problem of `pr` at once, from α = 0.

    The shrinking counters live on the host: each problem's counter runs
    down one a pass while it runs, so the passes of a chunk at which one
    runs out are known before the chunk starts, and only those passes scan
    for shrinking. A problem that pauses in a chunk has its counter set
    again when it resumes, as libsvm sets it. On a CUDA device the passes
    replay CUDA graphs."""
    st = _State(pr, eps, shrinking)
    dev = st.status.device
    graphed = dev.type == "cuda"
    step = (_GraphedStep(pr, st, max_iter) if graphed
            else lambda hit: _step(pr, st, max_iter, hit))
    sync_every = SYNC_EVERY
    B = pr.y.shape[0]
    cap = pr.valid.sum(1).clamp(max=1000).cpu().numpy()
    counter = cap + 1                   # libsvm's min(l, 1000) + 1
    running = np.ones(B, dtype=bool)
    while True:
        hits = {}
        if shrinking:
            for b in np.flatnonzero(running):
                for t in range(int(counter[b]) - 1, sync_every, int(cap[b])):
                    hits.setdefault(t, np.zeros(B, dtype=bool))[b] = True
                left = (int(counter[b]) - 1 - sync_every) % int(cap[b])
                counter[b] = left + 1 if sync_every >= counter[b] else counter[b] - sync_every
        hit_t = {t: torch.as_tensor(h, device=dev) for t, h in hits.items()}
        for t in range(sync_every):
            step(hit_t.get(t))
        status = st.status.cpu().numpy()
        running = status == RUNNING
        unshrink, optimal = status == PAUSE_UNSHRINK, status == PAUSE_OPTIMAL
        if unshrink.any() or optimal.any():
            u, o = torch.as_tensor(unshrink, device=dev), torch.as_tensor(optimal, device=dev)
            _reconstruct(pr, st, u | o)
            # the pass's shrink after its rebuild, with the Gmax pair it saved
            st.unshrunk |= u
            _shrink(pr, st, u, st.gmax[:, 0], st.gmax[:, 1])
            # the whole set optimal stops the problem; otherwise it goes on
            # and shrinks at its next pass (libsvm's counter = 1)
            done = o & _select(pr, st)[2]
            st.status = torch.where(done, DONE, torch.where(u | o, RUNNING, st.status))
            status = st.status.cpu().numpy()
            running = status == RUNNING
            counter[optimal] = 2
            counter[unshrink] = cap[unshrink] + 1
        if (status == DONE).all():
            break
    if graphed:
        step._bind()
    return Solution(alpha=st.alpha, rho=_calculate_rho(pr, st),
                    n_iter=st.n_iter.tolist(), timed_out=st.timed_out.tolist())


# ---------------------------------------------------------------------------
# svm_train / svm_predict_values: the C-SVC one-vs-one model and the ε-SVR
# model over the solver, in sklearn's layout (support vectors grouped by
# class, dual_coef_ (k-1, nSV), intercept_ = -rho, libsvm's signs)


@dataclass
class SVMModel:
    """A fitted libsvm model. `coef` (nSV, P) holds each of the P decision
    functions' coefficients on the support vectors (zero on the classes a
    pair does not hold); decision p = K(x, SV) @ coef[:, p] + intercept[p].
    Under a precomputed kernel K(x, SV) is the columns `support` of the
    test-train kernel handed to `decision`."""
    support_vectors: torch.Tensor     # (nSV, d) float64; (nSV, n) precomputed
    dual_coef: torch.Tensor           # (max(k-1, 1), nSV) float64
    intercept: torch.Tensor           # (P,) float64, -rho
    n_support: List[int]              # support vectors per class ([] for SVR)
    kernel: str
    gamma: float
    coef0: float
    degree: int
    n_iter: List[int] = field(default_factory=list)
    coef: torch.Tensor = None
    support: torch.Tensor = None      # (nSV,) long: sklearn's support_

    def __post_init__(self):
        if self.coef is None:
            self.coef = _pair_coef(self.dual_coef, self.n_support)

    @property
    def n_class(self) -> int:
        return len(self.n_support)

    def decision(self, X: torch.Tensor) -> torch.Tensor:
        """svm_predict_values' decision values (m, P), libsvm's signs; X is
        (m, n_train) kernel values under a precomputed kernel."""
        if self.kernel == "precomputed":
            K = X[:, self.support]
        else:
            K = kernel_matrix(X, self.support_vectors, self.kernel, self.gamma,
                              self.coef0, self.degree)
        return K @ self.coef + self.intercept

    def vote(self, dec: torch.Tensor) -> torch.Tensor:
        """svm_predict_values' one-vs-one vote: pair (a, b) votes for a when
        its decision is > 0, else for b; the first class with most votes."""
        k = self.n_class
        a, b = pair_classes(k, dec.device)
        win = torch.where(dec > 0, a, b)
        votes = torch.zeros((dec.shape[0], k), dtype=torch.long, device=dec.device)
        votes.scatter_add_(1, win, torch.ones_like(win))
        return votes.argmax(1)


def pair_classes(k: int, device=None):
    """The classes (a, b), a < b, of libsvm's k(k-1)/2 pairs, in its order."""
    a, b = torch.triu_indices(k, k, 1, device=device)
    return a, b


def _pair_coef(dual_coef: torch.Tensor, n_support: List[int]) -> torch.Tensor:
    """(nSV, P) coefficients from sklearn's dual_coef_ layout: pair (a, b)
    finds class a's coefficients in row b - 1 and class b's in row a."""
    if not n_support:                       # regression: one function
        return dual_coef.T.contiguous()
    k = len(n_support)
    start = [0]
    for c in n_support:
        start.append(start[-1] + c)
    a, b = pair_classes(k)
    coef = dual_coef.new_zeros((dual_coef.shape[1], a.numel()))
    for p, (ca, cb) in enumerate(zip(a.tolist(), b.tolist())):
        coef[start[ca]:start[ca + 1], p] = dual_coef[cb - 1, start[ca]:start[ca + 1]]
        coef[start[cb]:start[cb + 1], p] = dual_coef[ca, start[cb]:start[cb + 1]]
    return coef


def _solve_warned(pr: Problems, tol, shrinking, max_iter) -> Solution:
    """solve, warning as sklearn does where max_iter stopped a problem."""
    sol = solve(pr, tol, shrinking, max_iter)
    if any(sol.timed_out):
        warnings.warn(f"Solver terminated early (max_iter={max_iter}). Consider "
                      "pre-processing your data with StandardScaler or MinMaxScaler.",
                      RuntimeWarning)
    return sol


def _kernel_problems(X: torch.Tensor, kernel, gamma, coef0, degree):
    """libsvm's Qfloat kernel matrix (float32) and its float64 diagonal; X
    is the Gram matrix itself under a precomputed kernel."""
    K = X if kernel == "precomputed" else kernel_matrix(X, X, kernel, gamma, coef0, degree)
    return K.float(), K.diagonal().clone()


def fit_svc(X: torch.Tensor, labels: torch.Tensor, n_class: int, C: float,
            kernel: str, gamma: float, coef0: float, degree: int, tol: float,
            shrinking: bool, max_iter: int, class_weight=None) -> SVMModel:
    """svm_train for C_SVC: one problem per class pair (a, b), a < b, over
    class a's rows (y = +1) then class b's (y = -1), each in data order;
    labels are 0..n_class-1. All pairs solve as one batch. `class_weight`
    (one factor a class) gives libsvm's weighted_C[c] = C * w[c]: class a's
    rows of pair (a, b) are bounded by weighted_C[a], class b's by
    weighted_C[b]."""
    dev = X.device
    weights = [1.0] * n_class if class_weight is None else [float(w) for w in class_weight]
    weighted_C = [float(C) * w for w in weights]
    K32, kd = _kernel_problems(X, kernel, gamma, coef0, degree)
    rows = [torch.nonzero(labels == c).flatten() for c in range(n_class)]
    a, b = pair_classes(n_class)
    pairs = list(zip(a.tolist(), b.tolist()))
    L = max(rows[i].numel() + rows[j].numel() for i, j in pairs)
    P = len(pairs)
    idx = torch.zeros((P, L), dtype=torch.long, device=dev)
    y = torch.ones((P, L), dtype=torch.float64, device=dev)
    valid = torch.zeros((P, L), dtype=torch.bool, device=dev)
    Cb = torch.full((P, L), float(C), dtype=torch.float64, device=dev)
    for p, (i, j) in enumerate(pairs):
        ni, nj = rows[i].numel(), rows[j].numel()
        idx[p, :ni + nj] = torch.cat([rows[i], rows[j]])
        y[p, ni:ni + nj] = -1.0
        valid[p, :ni + nj] = True
        Cb[p, :ni] = weighted_C[i]
        Cb[p, ni:ni + nj] = weighted_C[j]
    pr = Problems(K32=K32, QD=kd[idx], idx=idx, y=y,
                  p=torch.where(valid, -1.0, 0.0).double(), C=Cb, valid=valid)
    sol = _solve_warned(pr, tol, shrinking, max_iter)
    # α_i y_i on each row of the data, one line per pair
    n = X.shape[0]
    full = torch.zeros((P, n), dtype=torch.float64, device=dev)
    full.scatter_add_(1, idx, torch.where(valid, sol.alpha * y, 0.0))
    nonzero = (full != 0).any(0)
    sv_rows = torch.cat([r[nonzero[r]] for r in rows])
    n_support = [int(nonzero[r].sum()) for r in rows]
    coef = full[:, sv_rows].T.contiguous()
    dual = _dual_from_coef(coef, n_support)
    return SVMModel(support_vectors=X[sv_rows], dual_coef=dual,
                    intercept=-sol.rho, n_support=n_support, kernel=kernel,
                    gamma=gamma, coef0=coef0, degree=degree, n_iter=sol.n_iter,
                    coef=coef, support=sv_rows)


def _dual_from_coef(coef: torch.Tensor, n_support: List[int]) -> torch.Tensor:
    """sklearn's dual_coef_ (k-1, nSV) from the (nSV, P) pair coefficients."""
    k = len(n_support)
    start = [0]
    for c in n_support:
        start.append(start[-1] + c)
    dual = coef.new_zeros((k - 1, coef.shape[0]))
    a, b = pair_classes(k)
    for p, (ca, cb) in enumerate(zip(a.tolist(), b.tolist())):
        dual[cb - 1, start[ca]:start[ca + 1]] = coef[start[ca]:start[ca + 1], p]
        dual[ca, start[cb]:start[cb + 1]] = coef[start[cb]:start[cb + 1], p]
    return dual


def fit_svr(X: torch.Tensor, target: torch.Tensor, C: float, epsilon: float,
            kernel: str, gamma: float, coef0: float, degree: int, tol: float,
            shrinking: bool, max_iter: int) -> SVMModel:
    """svm_train for EPSILON_SVR: one problem over 2l variables (α⁺ with
    y = +1, p = ε - t; α⁻ with y = -1, p = ε + t); coef = α⁺ - α⁻."""
    dev = X.device
    n = X.shape[0]
    K32, kd = _kernel_problems(X, kernel, gamma, coef0, degree)
    ar = torch.arange(n, device=dev)
    idx = torch.cat([ar, ar])[None]
    y = torch.cat([torch.ones(n, dtype=torch.float64, device=dev),
                   -torch.ones(n, dtype=torch.float64, device=dev)])[None]
    t = target.to(torch.float64)
    pr = Problems(K32=K32, QD=kd[idx], idx=idx, y=y,
                  p=torch.cat([epsilon - t, epsilon + t])[None],
                  C=torch.full((1, 2 * n), float(C), dtype=torch.float64, device=dev),
                  valid=torch.ones((1, 2 * n), dtype=torch.bool, device=dev))
    sol = _solve_warned(pr, tol, shrinking, max_iter)
    coef = sol.alpha[0, :n] - sol.alpha[0, n:]
    sv = (coef != 0).nonzero().squeeze(1)
    return SVMModel(support_vectors=X[sv], dual_coef=coef[sv][None],
                    intercept=-sol.rho, n_support=[], kernel=kernel, gamma=gamma,
                    coef0=coef0, degree=degree, n_iter=sol.n_iter, support=sv)


def ovr_decision(dec: torch.Tensor, k: int) -> torch.Tensor:
    """sklearn's `_ovr_decision_function(dec < 0, -dec, k)` of libsvm's
    pair decision values."""
    return ovo_to_ovr(dec < 0, -dec, k)


def ovo_to_ovr(won: torch.Tensor, confidence: torch.Tensor, k: int) -> torch.Tensor:
    """sklearn's `_ovr_decision_function(won, confidence, k)`: pair (a, b),
    a < b, votes for b where `won` (its binary prediction is 1), else for a,
    and its confidence counts for b and against a; votes plus the summed
    confidences squashed into (-1/3, 1/3)."""
    a, b = pair_classes(k, confidence.device)
    m = confidence.shape[0]
    votes = torch.zeros((m, k), dtype=confidence.dtype, device=confidence.device)
    conf = torch.zeros_like(votes)
    for p, (ca, cb) in enumerate(zip(a.tolist(), b.tolist())):
        conf[:, ca] -= confidence[:, p]
        conf[:, cb] += confidence[:, p]
        votes[:, ca] += (~won[:, p]).to(votes.dtype)
        votes[:, cb] += won[:, p].to(votes.dtype)
    return votes + conf / (3 * (conf.abs() + 1))
