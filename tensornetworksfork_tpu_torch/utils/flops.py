"""Analytic FLOP accounting for sweep epochs, and MFU (port of
tensornetworksfork_tpu/utils/flops.py).

Every contraction a sweep executes has shapes known before it runs, so an
epoch's algorithmic FLOPs are summed without running anything: 2 x the
product of every dimension per contracted multiply-add (the convention of
the scaling literature), whatever the hardware does with it, so a 3xTF32
or int8 product still counts its algorithmic flops once.

Covered, as in the JAX package: environment chains (the far precompute and
the near advances), per-node Jacobian builds, predictions, Gram and rhs
accumulation, and the dense Cholesky block solves (`epoch_flops`, keys
`total`, `per_pass`, `env`, `gram_and_jac`, `solve`).

Einsum-shaped costs come from the plan that the port's `core/contract.py`
`contract()` executes (`_plan`: numpy's "optimal" search up to 6 operands
under the TNF_CONTRACT_MAX_ELEMS cap, `_greedy_path` beyond), each pairwise
product costed by opt_einsum's and numpy's rule: the product of all its
dimensions, times 2 where it sums an axis (an outer or elementwise product
counts 1). The JAX package plans with opt_einsum ("optimal" up to 6
operands, "auto" beyond, no cap), the path its `contract()` executes. The
counts agree wherever the two plans do; they part where numpy's planner
leaves a contraction that sums no axis as one step of three or more
operands (a TT's middle-core Jacobian), which torch.einsum runs left to
right on the card's machine (it has no opt_einsum), and which is counted so.

`device_peak_flops` knows the NVIDIA H100 SXM's dense tensor-core peaks,
keyed on `torch.cuda.get_device_name()`: bf16 989 TFLOP/s and int8 1,979
TOP/s, the two dtypes the JAX API has. On any other card it returns None.
As in the JAX package, MFU counts the int8 Gram tier against the int8 peak
and every other tier against bf16's.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..core.contract import _plan, einsum_expr, max_elems

# dense tensor-core peaks by torch.cuda.get_device_name(): FLOP/s for bf16,
# OP/s for int8 (NVIDIA H100 SXM5 datasheet, without sparsity)
PEAK_FLOPS = {"NVIDIA H100 80GB HBM3": 989e12}
PEAK_OPS_INT8 = {"NVIDIA H100 80GB HBM3": 1979e12}


def device_peak_flops(dtype: str = "bf16") -> Optional[float]:
    """The visible card's dense peak for `dtype` ("bf16" or "int8"), or
    None without a card or on a card the table does not hold."""
    table = PEAK_OPS_INT8 if dtype == "int8" else PEAK_FLOPS
    if not torch.cuda.is_available():
        return None
    return table.get(torch.cuda.get_device_name())


def _axis_sizes(topology, B: int) -> Dict[int, int]:
    return {a: (B if sz is None else int(sz))
            for a, sz in topology.axis_size.items()}


def contraction_flops(operand_axes, keep, sizes) -> int:
    """FLOPs of contract(operands, keep) along the plan `contract()` runs."""
    shapes = [tuple(sizes[a] for a in axes) for axes in operand_axes]
    if len(shapes) < 2:
        return 0
    expr = einsum_expr(list(operand_axes), tuple(keep))
    work = list(shapes)
    total = 0
    for step, sub in _plan(expr, tuple(shapes), max_elems()):
        picked = [work[i] for i in step]
        for i in sorted(step, reverse=True):
            del work[i]
        ins, out = sub.split("->")
        terms = ins.split(",")
        dims = {}
        for term, shp in zip(terms, picked):
            for ch, d in zip(term, shp):
                if dims.get(ch, 1) == 1:  # a size-1 axis broadcasts
                    dims[ch] = d
        # a step of more than two operands (numpy's planner leaves a
        # contraction that sums no axis as one) runs in torch.einsum left to
        # right, as on a machine without opt_einsum: each partial result
        # keeps the letters a later operand or the output needs
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


def _chunking(cfg, S: int):
    B = cfg.batch_size
    if B is None or B <= 0 or B > S:
        B = S
    P = ((S + B - 1) // B) * B
    return B, P // B


def _probe_hessian(loss_fn, out_sizes, y):
    """(C_out, full_hessian) from the loss on two zero rows: the size of a
    row of its gradient, and whether its Hessian has an axis more."""
    pred = torch.zeros((2,) + tuple(out_sizes))
    _, g, H = loss_fn(pred, torch.zeros((2,) + tuple(y.shape[1:])))
    return int(np.prod(g.shape[1:], dtype=np.int64)), H.ndim > g.ndim


def epoch_flops(sweeper, x, y) -> Dict[str, float]:
    """Algorithmic FLOPs of ONE sweeper.run() call (num_swipes x <= 2
    passes), following `Sweeper.run`'s control flow: per half-sweep each
    member precomputes a far environment chain, advances the near one once
    per column and runs one accumulate-and-solve per train node; the
    junction rule skips one node on every pass after the first."""
    cfg = sweeper.cfg
    S = int(y.shape[0])
    B, nchunks = _chunking(cfg, S)

    env_half_sweep = 0
    node_costs = []   # per (member, node) update cost for one half-sweep
    solve_costs = []

    for m in sweeper.members:
        net = m.net
        t = net.topology
        sizes = _axis_sizes(t, B)
        out_sizes = tuple(sizes[a] for a in t.output_axes)
        C_out, full_hess = _probe_hessian(sweeper.loss_fn, out_sizes, y)
        ncols = len(t.columns)
        if not t.input_nodes:
            # standalone (input-less) path: jacobian over all nodes, full batch
            for ni in m.train_nodes:
                ops = [t.node_axes[nj] for nj in range(len(t.nodes)) if nj != ni]
                keep = net.jacobian_keep(ni, ops)
                D = int(np.prod([sizes[a] for a in t.node_axes[ni]], dtype=np.int64))
                jcost = contraction_flops(ops, keep, sizes)
                gram = 2 * S * C_out * D * D + (
                    2 * S * C_out * C_out * D if full_hess else 0)
                node_costs.append(jcost + gram + 4 * S * C_out * D)
                solve_costs.append(D ** 3 // 3 + 2 * D * D)
            continue

        def chain_cost(direction):
            order = (range(ncols) if direction == "left"
                     else range(ncols - 1, -1, -1))
            total, seen, prev_keep = 0, [], None
            for ci in order:
                seen.append(ci)
                ops = [t.node_axes[nj] for nj in t.columns[ci]]
                if prev_keep is not None:
                    ops = [prev_keep] + ops
                keep = net.env_keep(tuple(seen))
                total += contraction_flops(ops, keep, sizes)
                prev_keep = keep
            return total

        # the far chain covers all columns; the near advances ncols-1 of them
        far = chain_cost("right")
        near = chain_cost("left")
        env_half_sweep += (far + near * max(0, ncols - 1) / max(1, ncols)) * nchunks

        for ni in m.train_nodes:
            ci = t.col_of[ni]
            ops_axes = []
            if ci > 0:
                ops_axes.append(net.env_keep(tuple(range(0, ci))))
            ops_axes += [t.node_axes[nj] for nj in t.columns[ci] if nj != ni]
            if ci < ncols - 1:
                ops_axes.append(net.env_keep(tuple(range(ci + 1, ncols))))
            keep = net.jacobian_keep(ni, ops_axes)
            jcost = contraction_flops(ops_axes, keep, sizes)
            D = int(np.prod([sizes[a] for a in t.node_axes[ni]], dtype=np.int64))
            CJ = int(np.prod([sizes[a] for a in keep if a in t.output_axes],
                             dtype=np.int64))
            # pred = J.core; K build (full H); Gram; rhs
            pred = 2 * B * CJ * D
            kbuild = 2 * B * CJ * CJ * D if full_hess else B * CJ * D
            gram = 2 * B * CJ * D * D
            rhs = 2 * B * CJ * D
            node_costs.append((jcost + pred + kbuild + gram + rhs) * nchunks)
            solve_costs.append(D ** 3 // 3 + 2 * D * D)

    per_pass = env_half_sweep + sum(node_costs) + sum(solve_costs)
    npasses = cfg.num_swipes * (1 if cfg.skip_second else 2)
    total = per_pass * npasses
    # junction rule: one node (the previous pass's last) is skipped on every
    # pass after the first; subtract the mean node cost
    if npasses > 1 and node_costs:
        total -= (npasses - 1) * (float(np.mean(node_costs))
                                  + float(np.mean(solve_costs)))
    return {
        "total": float(total),
        "per_pass": float(per_pass),
        "env": float(env_half_sweep * npasses),
        "gram_and_jac": float(sum(node_costs) * npasses),
        "solve": float(sum(solve_costs) * npasses),
    }


def mfu(flops_total: float, seconds: float,
        peak: Optional[float] = None) -> Optional[float]:
    """flops_total / seconds over `peak` (the card's bf16 peak when None);
    None without a peak or a positive time."""
    if peak is None:
        peak = device_peak_flops()
    if not peak or seconds <= 0:
        return None
    return flops_total / seconds / peak
