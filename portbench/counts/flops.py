"""Frozen FLOP and byte counts of the benchmark's work.

`run_flops` is the arithmetic of the port's `utils/flops.py` `epoch_flops`
for one `Sweeper.run`, over the frozen plan of `plan.py` and the written-out
networks of `networks.py`, with two departures: a symmetric Gram counts its
upper triangle with the diagonal (R*C*D*(D+1) FLOPs over R rows, where
`epoch_flops` counts 2*R*C*D*D), and a pass after the first skips the whole
column of the previous pass's last node, as the sweep does (`epoch_flops`
subtracts one mean node). `gram="full", junction="mean"` gives
`epoch_flops` itself, which the tests hold it to.

`run_least_s` is the least time of the Gram and rhs work of the nodes on
the program's kernel routes (every train node that does not own an output
axis), per call: the larger of its operations over the tier's peak and its
bytes over the HBM rate, each input byte read once and each output byte
written once. A call covers a chunk of rows, or all of them where the
sweep merges the chunks (its full-batch rule).
"""
from __future__ import annotations

import json
from typing import Dict, List, Tuple

import numpy as np

from ..harness import HERE
from .networks import Net
from .plan import contraction_flops

FULLBATCH_MAX_BYTES = 512 * 1024 * 1024


def peaks() -> dict:
    with open(HERE / "counts" / "peaks.json") as f:
        return json.load(f)


def _chunking(rows: int, chunk: int) -> Tuple[int, int]:
    B = rows if chunk <= 0 or chunk > rows else chunk
    return B, -(-rows // B)


def _chain_cost(net: Net, sizes, direction: str) -> int:
    ncols = len(net.columns)
    order = range(ncols) if direction == "left" else range(ncols - 1, -1, -1)
    total, seen, prev = 0, [], None
    for ci in order:
        seen.append(ci)
        ops = [net.node_axes[nj] for nj in net.columns[ci]]
        if prev is not None:
            ops = [prev] + ops
        keep = net.env_keep(tuple(seen))
        total += contraction_flops(ops, keep, sizes)
        prev = keep
    return total


def _cj(net: Net, ni: int) -> int:
    keep = net.jacobian_keep(ni, net.jacobian_operands(ni))
    return int(np.prod([net.size[a] for a in keep if a in net.outputs], dtype=np.int64))


def visits(net: Net, swipes: int, junction: str = "exact") -> List[List[int]]:
    """The train nodes each half-sweep of one run updates, in order."""
    out, last_col = [], None
    for _ in range(swipes):
        for rev in (False, True):
            order = list(reversed(net.train)) if rev else list(net.train)
            frozen = last_col
            if junction == "exact":
                order = [ni for ni in order if frozen is None or net.col_of[ni] != frozen]
            out.append(order)
            last_col = net.col_of[out[-1][-1]]
    return out


def run_flops(net: Net, rows: int, chunk: int, swipes: int, full_hessian: bool,
              gram: str = "upper", junction: str = "exact") -> Dict[str, float]:
    """Algorithmic FLOPs of one run of `swipes` swipes over `rows` rows."""
    B, nchunks = _chunking(rows, chunk)
    sizes = net.sizes(B)
    ncols = len(net.columns)
    far = _chain_cost(net, sizes, "right")
    near = _chain_cost(net, sizes, "left")
    env_half = (far + near * max(0, ncols - 1) / max(1, ncols)) * nchunks
    node, solve = {}, {}
    for ni in net.train:
        ops = net.jacobian_operands(ni)
        jcost = contraction_flops(ops, net.jacobian_keep(ni, ops), sizes)
        D, CJ = net.D(ni), _cj(net, ni)
        pred = 2 * B * CJ * D
        kbuild = 2 * B * CJ * CJ * D if full_hessian else B * CJ * D
        g = 2 * B * CJ * D * D if gram == "full" else B * CJ * D * (D + 1)
        rhs = 2 * B * CJ * D
        node[ni] = (jcost + pred + kbuild + g + rhs) * nchunks
        solve[ni] = D ** 3 // 3 + 2 * D * D
    passes = visits(net, swipes, junction)
    if junction == "exact":
        nodes = sum(node[ni] for p in passes for ni in p)
        solves = sum(solve[ni] for p in passes for ni in p)
        total = env_half * len(passes) + nodes + solves
    else:
        per_pass = env_half + sum(node.values()) + sum(solve.values())
        total = per_pass * len(passes) - (len(passes) - 1) * (
            float(np.mean(list(node.values()))) + float(np.mean(list(solve.values()))))
        nodes = sum(node.values()) * len(passes)
        solves = sum(solve.values()) * len(passes)
    return {"total": float(total), "env": float(env_half * len(passes)),
            "gram_and_jac": float(nodes), "solve": float(solves)}


def gram_call(R: int, CJ: int, D: int, full_hessian: bool, jbytes: int) -> Tuple[float, float]:
    """(operations, bytes) of one Gram-and-rhs call over R rows: the upper
    triangle of J^T H J with the diagonal, the class mix K = H J for a
    full Hessian and b = J^T g; J, H and g read once, A's upper triangle
    and b written once (f32)."""
    ops = R * CJ * D * (D + 1) + 2 * R * CJ * D
    if full_hessian:
        ops += 2 * R * CJ * CJ * D
    nbytes = (R * CJ * D * jbytes + R * CJ * (CJ if full_hessian else 1) * 4
              + R * CJ * 4 + D * (D + 1) // 2 * 4 + D * 4)
    return float(ops), float(nbytes)


def least_s(ops: float, nbytes: float, peak: float, hbm: float) -> float:
    return max(ops / peak, nbytes / hbm)


def run_least_s(net: Net, rows: int, chunk: int, swipes: int, full_hessian: bool,
                tier: str) -> float:
    """Least seconds of the kernel routes' Gram and rhs work in one run."""
    pk = peaks()
    peak = pk["gram_peak"][tier]
    jbytes = pk["j_bytes"][tier]
    B, nchunks = _chunking(rows, chunk)
    total = 0.0
    for p in visits(net, swipes):
        for ni in p:
            if net.owns_output(ni):
                continue
            D, CJ = net.D(ni), _cj(net, ni)
            merged = nchunks > 1 and nchunks * B * CJ * D * jbytes <= FULLBATCH_MAX_BYTES
            R, calls = (nchunks * B, 1) if merged or nchunks == 1 else (B, nchunks)
            ops, nb = gram_call(R, CJ, D, full_hessian, jbytes)
            total += calls * least_s(ops, nb, peak, pk["hbm_bytes_per_s"])
    return total


def forward_flops(net: Net, rows: int) -> float:
    """FLOPs of the forward over `rows` rows, carriage by carriage."""
    return float(_chain_cost(net, net.sizes(rows), "left"))
