"""The contraction plan that the benchmark's FLOP counts follow, frozen.

A copy of the arithmetic of `tensornetworksfork_tpu_torch/utils/flops.py`
(`contraction_flops`) and of the plan it follows (`core/contract.py`
`_plan`: numpy's "optimal" path search under an intermediate cap of 2**28
elements, the unconstrained path where no pairwise path fits the cap). It
lives here so that a change to the program's planner does not move the
yardstick. Only expressions of at most six operands are planned, which
covers every contraction of the benchmark's networks.
"""
from __future__ import annotations

import functools
import string
from typing import Dict, Sequence, Tuple

import numpy as np

MAX_ELEMS = 1 << 28
_UNCAPPED = float(1 << 62)
_LETTERS = string.ascii_lowercase + string.ascii_uppercase


def einsum_expr(operand_axes: Sequence[Tuple[int, ...]], keep: Tuple[int, ...]) -> str:
    """The einsum string for contracting operands (tuples of axis ids) down
    to `keep`, letters given to axis ids in order of first appearance."""
    letters: Dict[int, str] = {}

    def lab(a):
        if a not in letters:
            letters[a] = _LETTERS[len(letters)]
        return letters[a]

    terms = ["".join(lab(a) for a in axes) for axes in operand_axes]
    return ",".join(terms) + "->" + "".join(lab(a) for a in keep)


@functools.lru_cache(maxsize=1024)
def plan(expr: str, shapes: Tuple[Tuple[int, ...], ...], cap: int = MAX_ELEMS):
    """Pairwise steps (operand positions, sub-expression) over a working
    list in numpy's convention: the contracted operands are removed and the
    result appended."""
    inputs_s, out_s = expr.split("->")
    terms = inputs_s.split(",")
    if len(terms) == 1:
        return [((0,), f"{terms[0]}->{out_s}")]
    if len(terms) > 6:
        raise ValueError(f"the frozen plan covers at most 6 operands: {expr}")
    dummies = [np.broadcast_to(np.empty((), np.float32), s) for s in shapes]

    def planned(limit):
        return np.einsum_path(expr, *dummies, optimize=("optimal", limit))[0][1:]

    path = planned(float(cap)) if cap > 0 else None
    if path is not None and any(len(step) > 2 for step in path):
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
        steps.append((tuple(step), ",".join(picked) + "->" + res))
        work.append(res)
    return steps


def contraction_flops(operand_axes, keep, sizes: Dict[int, int]) -> int:
    """Algorithmic FLOPs of contracting `operand_axes` down to `keep` along
    the frozen plan: each pairwise step costs the product of all its
    dimensions, times 2 where it sums an axis; a step of three or more
    operands is costed left to right."""
    shapes = [tuple(sizes[a] for a in axes) for axes in operand_axes]
    if len(shapes) < 2:
        return 0
    expr = einsum_expr(list(operand_axes), tuple(keep))
    work = list(shapes)
    total = 0
    for step, sub in plan(expr, tuple(shapes)):
        picked = [work[i] for i in step]
        for i in sorted(step, reverse=True):
            del work[i]
        ins, out = sub.split("->")
        terms = ins.split(",")
        dims: Dict[str, int] = {}
        for term, shp in zip(terms, picked):
            for ch, d in zip(term, shp):
                if dims.get(ch, 1) == 1:
                    dims[ch] = d
        cur = terms[0]
        for k, term in enumerate(terms[1:], 1):
            letters = "".join(dict.fromkeys(cur + term))
            later = set("".join(terms[k + 1:])) | set(out)
            res = "".join(ch for ch in letters if ch in later)
            size = int(np.prod([dims[ch] for ch in letters], dtype=np.int64))
            total += size * (1 + (len(res) < len(letters)))
            cur = res
        work.append(tuple(dims[ch] for ch in out))
    return total
