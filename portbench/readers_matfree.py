"""The arithmetic of the matrix-free cell's per-layer metrics (`.minres`),
read from the traced window and from the driver's record of its epochs
(`drivers/matfree_sum.py` `detail`). A reader returns None where it finds
nothing to read: no trace, no solve span, or a program that keeps no matvec
count.
"""
from __future__ import annotations

from .counts import matfree
from .counts.flops import peaks


def _updates(ctx):
    ups = ctx.detail.get("updates")
    return ups if ups and len(ups) == ctx.stats["units"] else None


def step_mfu(ctx):
    """Algorithmic FLOPs of the traced swipes (`counts/matfree.py`, from the
    program's own k of each update) over the traced window and the tier's
    dense peak, in %."""
    t, ups = ctx.trace, _updates(ctx)
    if t is None or ups is None:
        return None
    rows = ctx.cell.workload["rows"]
    flops = sum(matfree.swipe_flops(ctx.cell.config, rows, u) for u in ups)
    return 100.0 * flops / t.window_s / peaks()["mfu_peak"][ctx.cell.workload["tier"]]


def _solve_s(ctx):
    t = ctx.trace
    if t is None:
        return None
    return t.split()["solve"]


def krylov_ms_per_swipe(ctx):
    """Device time of the kernels launched inside the benchmark's spans
    around the Krylov solver (`portbench.solve`) per swipe, ms."""
    s = _solve_s(ctx)
    if s is None:
        return None
    return 1e3 * s / (ctx.stats["units"] * ctx.cell.workload["swipes"])


def matvec_roofline(ctx):
    """The least time of the solves' matvecs (k + 1 a solve, the program's
    own k) over the solver's device time, in %."""
    s, ups = _solve_s(ctx), _updates(ctx)
    if not s or ups is None:
        return None
    rows = ctx.cell.workload["rows"]
    least = sum(matfree.least_matvec_s(ctx.cell.config, rows, u) for u in ups)
    return 100.0 * least / s


def krylov_matvecs_per_swipe(ctx):
    """Matvecs the program launched in the traced swipes
    (`Sweeper.krylov_matvecs`: the residual, the scale probe and every
    iteration the loop ran, masked ones included) per swipe."""
    mv = ctx.detail.get("matvecs")
    if not mv or len(mv) != ctx.stats["units"] or any(m is None for m in mv):
        return None
    return sum(mv) / (len(mv) * ctx.cell.workload["swipes"])
