"""Label-driven einsum contraction (port of tensornetworksfork_tpu/core/contract.py).

Axes are integer ids (assigned by `topology.Topology`); two operands sharing
an axis id are connected on it. An id appearing in `keep` survives as a batch
axis; ids absent from `keep` are summed. Hyperedges (one id on 3+ operands)
follow einsum semantics: multiplied elementwise across all carriers, then
summed once.

`torch.einsum` contracts more than two operands left to right unless the
`opt_einsum` package is installed, and the GPU machine has none. So the path
is planned here, cached per (expression, shapes), and executed as a
sequence of pairwise `torch.einsum` calls: up to 6 operands by
`numpy.einsum_path`'s "optimal" search over zero-stride dummy operands
(shapes only, no data), more by `_greedy_path`, numpy's greedy planner
written out here.

An expression may carry any number of axes: past the 52 ASCII letters the
labeller goes on in unicode, as the JAX package's does (a 30-feature TNML,
one core per feature, has about 61). `numpy.einsum_path` and `torch.einsum`
accept only the ASCII letters, so such an expression is planned by
`_greedy_path` whatever its operand count, and each of its pairwise steps
is written in letters of its own: a step holds only its two operands' axes.

`precision` is the JAX package's dot precision, by name. "highest" runs
each pairwise step in f32. "default" runs it as the TPU runs a
`Precision.DEFAULT` dot: operands rounded to bf16, products summed in f32,
an f32 result. "high" runs it as the TPU runs a `Precision.HIGH` dot
(bf16x3): each f32 operand split into a bf16 part and the bf16 rounding of
its remainder, and the three products of parts hi·hi, hi·lo and lo·hi
summed in f32 (`matmul`). A product of two bf16 values is exact in f32, so
on the card's bf16 tensor cores, which sum in f32 as the TPU's MXU does,
these are the TPU's products, summed in another order.
"""
from __future__ import annotations

import functools
import itertools
import os
import string
from typing import List, Sequence, Tuple

import numpy as np
import torch

_LETTERS = string.ascii_lowercase + string.ascii_uppercase

Axes = Tuple[int, ...]


def _symbol(i: int) -> str:
    """Einsum symbol #i: the ASCII letters first, then unicode from
    chr(192), the JAX package's scheme (opt_einsum's get_symbol)."""
    if i < len(_LETTERS):
        return _LETTERS[i]
    return chr(140 + i)


class Labeler:
    """Assigns einsum symbols to axis ids, first-come first-served."""

    def __init__(self):
        self._map = {}

    def __getitem__(self, axis_id) -> str:
        if axis_id not in self._map:
            self._map[axis_id] = _symbol(len(self._map))
        return self._map[axis_id]

    def __contains__(self, axis_id) -> bool:
        return axis_id in self._map


def einsum_expr(operand_axes: Sequence[Axes], keep: Axes) -> str:
    """Builds the einsum string for contracting operands down to `keep`."""
    lab = Labeler()
    terms = ["".join(lab[a] for a in axes) for axes in operand_axes]
    out = "".join(lab[a] for a in keep)
    return ",".join(terms) + "->" + out


# Largest intermediate (in ELEMENTS) a path may materialise. The planner is
# asked for the cheapest path under this cap; when no pairwise path fits (e.g.
# the output itself exceeds it) the unconstrained path is used, as in the JAX
# package. TNF_CONTRACT_MAX_ELEMS overrides (0 disables the cap).
_DEFAULT_MAX_ELEMS = 1 << 28
_UNCAPPED = float(1 << 62)


def max_elems() -> int:
    """The intermediate cap of the plans, read from TNF_CONTRACT_MAX_ELEMS
    on every call."""
    cap_s = os.environ.get("TNF_CONTRACT_MAX_ELEMS", "")
    return int(cap_s) if cap_s else _DEFAULT_MAX_ELEMS


def _local(terms: Sequence[str], out: str) -> str:
    """`terms` -> `out` in ASCII letters of its own, given in order of first
    appearance (one pairwise step: at most its two operands' axes)."""
    sub = ",".join(terms) + "->" + out
    if sub.isascii():
        return sub
    own = {}
    for ch in sub:
        if ch not in ",->" and ch not in own:
            if len(own) == len(_LETTERS):
                raise ValueError(
                    f"one contraction step has more than {len(_LETTERS)} "
                    "distinct axes; torch.einsum takes only the ASCII letters")
            own[ch] = _LETTERS[len(own)]
    return "".join(own.get(ch, ch) for ch in sub)


def _greedy_path(terms: Sequence[str], out_s: str, size, cap: float):
    """numpy.einsum_path's greedy path (numpy's `_greedy_path`, with
    einsum_path's one-step cases), over symbols of any kind. At each step,
    of the pairs that share an axis (none sharing: of all pairs), the one
    whose result removes the most elements, then the one of fewest flops,
    ties to the pair found first; a pair whose result exceeds `cap`
    elements, or whose flops would take the path past the one-step
    einsum's, is passed over, and when none is left the rest is one step.
    Returns numpy's path format (positions in the working list, the result
    appended)."""
    def elems(idx):
        n = 1
        for ch in idx:
            n *= size[ch]
        return n

    sets = [frozenset(t) for t in terms]
    out = frozenset(out_s)
    every = frozenset().union(*sets)
    if len(sets) <= 2 or every == out:
        return [tuple(range(len(sets)))]
    cap = int(cap)
    naive = elems(every) * (len(sets) - 1 + bool(every - out))

    def parse(pos, sets, path_cost):
        # (sort key, pair, the working list after contracting it) or None
        picked = sets[pos[0]] | sets[pos[1]]
        rest = [s for k, s in enumerate(sets) if k not in pos]
        res = picked & out.union(*rest)
        if elems(res) > cap:
            return None
        cost = elems(picked) * (1 + bool(picked - res))
        if path_cost + cost > naive:
            return None
        gone = elems(sets[pos[0]]) + elems(sets[pos[1]]) - elems(res)
        return (-gone, cost), pos, rest + [res]

    pairs = itertools.combinations(range(len(sets)), 2)
    known, path, path_cost = [], [], 0
    for _ in range(len(sets) - 1):
        for pos in pairs:
            if not sets[pos[0]].isdisjoint(sets[pos[1]]):
                found = parse(pos, sets, path_cost)
                if found is not None:
                    known.append(found)
        if not known:  # outer products only
            for pos in itertools.combinations(range(len(sets)), 2):
                found = parse(pos, sets, path_cost)
                if found is not None:
                    known.append(found)
            if not known:
                path.append(tuple(range(len(sets))))
                break
        key, (bx, by), sets = min(known, key=lambda r: r[0])
        # the pairs found before stay candidates, renumbered for the new list
        kept = []
        for k, (x, y), after in known:
            if x in (bx, by) or y in (bx, by):
                continue
            after = list(after)
            del after[by - (by > x) - (by > y)]
            del after[bx - (bx > x) - (bx > y)]
            after.insert(-1, sets[-1])
            kept.append((k, (x - (x > bx) - (x > by), y - (y > bx) - (y > by)), after))
        known = kept
        last = len(sets) - 1
        pairs = ((i, last) for i in range(last))
        path.append((bx, by))
        path_cost += key[1]
    return path


@functools.lru_cache(maxsize=4096)
def _plan(expr: str, shapes: Tuple[Tuple[int, ...], ...], cap: int):
    """Pairwise contraction plan: a list of (operand positions, einsum
    sub-expression) steps over a working list in numpy's convention (the
    contracted operands are removed, the result appended). Keyed on the
    whole expression, so two expressions never share a plan; each step's
    sub-expression is in ASCII letters (`_local`)."""
    inputs_s, out_s = expr.split("->")
    terms = inputs_s.split(",")
    if len(terms) == 1:
        return [((0,), _local(terms, out_s))]
    if len(terms) <= 6 and expr.isascii():
        dummies = [np.broadcast_to(np.empty((), np.float32), s) for s in shapes]

        def planned(limit):
            return np.einsum_path(expr, *dummies, optimize=("optimal", limit))[0][1:]
    else:
        size = {}
        for t, shp in zip(terms, shapes):
            for ch, d in zip(t, shp):
                if size.get(ch, 1) == 1:  # a size-1 axis broadcasts, as in numpy
                    size[ch] = d

        def planned(limit):
            return _greedy_path(terms, out_s, size, limit)
    path = None
    if cap > 0:
        path = planned(float(cap))
        if any(len(step) > 2 for step in path):
            path = None  # no pairwise path fits the cap
    if path is None:
        path = planned(_UNCAPPED)
    steps = []
    work = list(terms)
    for step in path:
        picked = [work[i] for i in step]
        for i in sorted(step, reverse=True):
            del work[i]
        rest = set("".join(work)) | set(out_s)
        seen = []
        for t in picked:
            for ch in t:
                if ch in rest and ch not in seen:
                    seen.append(ch)
        res = "".join(seen) if work else out_s
        steps.append((tuple(step), _local(picked, res)))
        work.append(res)
    return steps


PRECISIONS = ("highest", "high", "default")


def check_precision(precision: str) -> str:
    """`precision` if it is one of PRECISIONS; ValueError otherwise."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, not {precision!r}")
    return precision


def split_bf16(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo): hi = bf16(a), lo = bf16(a - hi), the split of an f32
    operand that a `Precision.HIGH` dot multiplies (a - hi is exact in
    f32)."""
    hi = a.to(torch.bfloat16)
    return hi, (a.float() - hi.float()).to(torch.bfloat16)


def _bf16_products(a: torch.Tensor, b: torch.Tensor, precision: str, fn):
    """fn over the bf16 parts of a and b, summed in f32: one product of
    the rounded operands ("default"), or the three of bf16x3 ("high"),
    hi·hi + (hi·lo + lo·hi)."""
    if precision == "default":
        return fn(a.to(torch.bfloat16), b.to(torch.bfloat16))
    (ah, al), (bh, bl) = split_bf16(a), split_bf16(b)
    return fn(ah, bh) + (fn(ah, bl) + fn(al, bh))


def matmul(a: torch.Tensor, b: torch.Tensor,
           precision: str = "highest") -> torch.Tensor:
    """a @ b of 2-D or batched 3-D operands at `precision`, f32 out.

    "highest": in the operands' promoted dtype, bf16 operands upcast to f32
    (their products are exact in f32). "default": the operands rounded to
    bf16, the products summed in f32 and returned in f32 (the JAX package's
    DEFAULT dot with `preferred_element_type=float32`). "high": bf16x3, the
    three products of the operands' bf16 parts (`split_bf16`) summed in f32.
    On the card each product is a bf16 product with an f32 output
    (`out_dtype`), never a bf16-output product, which rounds its result; on
    the CPU, whose torch has no such kernel, the bf16 parts are multiplied
    in f32: the same products, summed in another order. Complex operands
    run at "highest"."""
    if precision != "highest" and not (a.is_complex() or b.is_complex()):
        if a.device.type == "cpu":
            def fn(x, y):
                return x.float() @ y.float()
        else:
            mm = torch.bmm if a.ndim == 3 else torch.mm

            def fn(x, y):
                return mm(x, y, out_dtype=torch.float32)
        return _bf16_products(a, b, precision, fn)
    rt = torch.promote_types(a.dtype, b.dtype)
    if rt == torch.bfloat16:
        rt = torch.float32
    return a.to(rt) @ b.to(rt)


def _einsum_pair(sub: str, x: torch.Tensor, y: torch.Tensor, precision: str
                 ) -> torch.Tensor:
    """One pairwise einsum step "x,y->z" of real operands lowered to
    `matmul(..., precision)` ("default" or "high"): letters of one operand
    that the result drops are summed first (in f32, as XLA reduces before
    its dot), then the operands are permuted to (batch, free, contracted)
    and (batch, contracted, free) and multiplied."""
    ins, out = sub.split("->")
    tx, ty = ins.split(",")
    if len(set(tx)) != len(tx) or len(set(ty)) != len(ty):
        # a repeated letter takes a diagonal, which no product lowers
        return _bf16_products(x, y, precision, lambda p, q: torch.einsum(
            sub, p.float(), q.float()))

    def drop_own(t, arr, other):
        own = [ch for ch in t if ch not in other and ch not in out]
        if not own:
            return t, arr
        return ("".join(ch for ch in t if ch not in own),
                arr.sum(dim=[t.index(ch) for ch in own]))

    tx, x = drop_own(tx, x, ty)
    ty, y = drop_own(ty, y, tx)
    batch = [ch for ch in tx if ch in ty and ch in out]
    contr = [ch for ch in tx if ch in ty and ch not in out]
    fx = [ch for ch in tx if ch not in ty]
    fy = [ch for ch in ty if ch not in tx]
    size = {ch: d for t, arr in ((tx, x), (ty, y)) for ch, d in zip(t, arr.shape)}

    def prod(chs):
        n = 1
        for ch in chs:
            n *= size[ch]
        return n

    xm = x.permute(*[tx.index(ch) for ch in batch + fx + contr])
    ym = y.permute(*[ty.index(ch) for ch in batch + contr + fy])
    if batch:
        xm = xm.reshape(prod(batch), prod(fx), prod(contr))
        ym = ym.reshape(prod(batch), prod(contr), prod(fy))
    else:
        xm = xm.reshape(prod(fx), prod(contr))
        ym = ym.reshape(prod(contr), prod(fy))
    z = matmul(xm, ym, precision).reshape([size[ch] for ch in batch + fx + fy])
    cur = batch + fx + fy
    return z.permute(*[cur.index(ch) for ch in out])


def _size(d) -> int:
    """A dimension as an int. A symbolic one (the batch of a
    `torch.export` trace) gives its example value, so that the plan is made
    once from concrete sizes and never hashes or guards on the batch."""
    if isinstance(d, torch.SymInt):
        hint = d.node.hint
        if hint is None:
            raise ValueError(f"symbolic size {d} has no example value to plan from")
        return int(hint)
    return int(d)


def contract(operands: Sequence[Tuple[Axes, torch.Tensor]],
             keep: Axes, precision: str = "highest") -> torch.Tensor:
    """Contracts labelled operands into a tensor whose axes are `keep`, in
    order. Every axis id not in `keep` is summed over; ids shared between
    operands are matched (connected edges). Each pairwise step runs at
    `precision` (module docstring); a lone operand's sums are no product
    and stay f32."""
    expr = einsum_expr([axes for axes, _ in operands], keep)
    arrays: List[torch.Tensor] = [arr for _, arr in operands]
    steps = _plan(expr, tuple(tuple(_size(d) for d in a.shape) for a in arrays),
                  max_elems())
    work = list(arrays)
    for step, sub in steps:
        picked = [work[i] for i in step]
        for i in sorted(step, reverse=True):
            del work[i]
        if (precision != "highest" and len(picked) == 2
                and not any(p.is_complex() for p in picked)):
            work.append(_einsum_pair(sub, *picked, precision))
        else:
            work.append(torch.einsum(sub, *picked))
    (out,) = work
    # the final step's output order is `keep` by construction
    return out
