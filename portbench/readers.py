"""The arithmetic of the metrics. Each metric is a file `metrics/<name>.py`
whose `read` is one of these; a quantity that cells reporting different
end-to-end metrics share (`.train` for the sweep cells, `.serve`) has one
file per split and one function here.

A reader returns None where it finds nothing to read; a share of a peak or
of a roofline is never made up as 0.
"""
from __future__ import annotations

import statistics

from .counts import cell as counts
from .counts.flops import peaks


def rate(ctx):
    """Work completed in the window (sample-swipes, images) over its length
    (host clock): whole units back to back, the last one finished and
    synchronised."""
    s = ctx.stats
    return s["work"] / s["seconds"]


def setup(ctx):
    """Seconds from the process's start to the window's."""
    return ctx.stats["setup_s"]


def step_mfu(ctx):
    """Algorithmic FLOPs of the traced units (the frozen counts) over the
    traced window and the tier's dense peak, in %."""
    t = ctx.trace
    if t is None:
        return None
    flops = counts.unit_flops(ctx.cell) * ctx.stats["units"]
    return 100.0 * flops / t.window_s / peaks()["mfu_peak"][ctx.cell.workload["tier"]]


def step_mfu_serve(ctx):
    """Algorithmic FLOPs of the traced batches' forwards over the traced
    window and the bf16 dense peak, in %."""
    t = ctx.trace
    if t is None:
        return None
    flops = counts.batch_flops(ctx.cell) * ctx.stats["units"]
    return 100.0 * flops / t.window_s / peaks()["serve_peak"]


def idle_share(ctx):
    """1 - the union of kernel, copy and set intervals over the traced
    window, in %."""
    t = ctx.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s() / t.window_s)


def kernel_roofline(ctx):
    """The least time of the Gram and rhs work on the kernel routes (the
    frozen counts) over the device time of the port's own kernels, in %;
    nothing where none of them ran."""
    t = ctx.trace
    if t is None:
        return None
    port = t.split()["port"]
    if port <= 0:
        return None
    return 100.0 * counts.unit_least_s(ctx.cell) * ctx.stats["units"] / port


def _per_swipe(ctx, part):
    t = ctx.trace
    if t is None or t.split()[part] is None:
        return None
    return 1e3 * t.split()[part] / (ctx.stats["units"] * ctx.cell.workload["swipes"])


def solve_ms_per_swipe(ctx):
    """Device time of the kernels launched inside the benchmark's spans
    around the program's solve (`portbench.solve`) per swipe, ms."""
    return _per_swipe(ctx, "solve")


def aux_ms_per_swipe(ctx):
    """Device time of every kernel that is neither the port's own nor the
    solve's (library GEMM and bmm, copies, elementwise) per swipe, ms."""
    return _per_swipe(ctx, "other")


def _timers(ctx, pick):
    d = ctx.detail
    if "timers" not in d:
        return None
    return 1e3 * sum(v[0] for k, v in d["timers"].items() if pick(k)) / d["timer_units"]


def env_advance_ms_per_swipe(ctx):
    """The sweep's phase timers `advance` and `far_envs` (TNF_SWEEP_TIMERS=1,
    a swipe of their own after the profiled window) per swipe, ms."""
    return _timers(ctx, lambda k: k in ("advance", "far_envs"))


def node_update_ms_per_swipe(ctx):
    """The sweep's phase timers `update:<node>` per swipe, ms."""
    return _timers(ctx, lambda k: k.startswith("update:"))


def serve_enqueue_us(ctx):
    """Host time from the call of the served artifact until it returns,
    before the read-back waits for the device, per batch, us."""
    e = ctx.detail.get("enqueue_s")
    if not e:
        return None
    return 1e6 * sum(e) / len(e)


def serve_p95_ms(ctx):
    """The 95th percentile of the served batches' latency, from the call
    until the predictions are on the host, ms (at least 200 calls)."""
    lat = ctx.detail.get("latency_s")
    if not lat or len(lat) < 200:
        return None
    return 1e3 * statistics.quantiles(lat, n=20)[-1]
