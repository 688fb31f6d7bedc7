"""Runs one cell of the port's benchmark once and prints its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (inputs and weights from the seed, the program's objects, its first
steps, every shape warmed) counts as `setup_s`; then the window runs whole
units for `--seconds`. With `--trace 1` the window runs under
`torch.profiler` and the cell's per-layer metrics are read from it and from
a detail segment after it. Then the program's state is freed and the plain
reference decides `correct`, which a unit that failed (a singular solve)
makes false. The last line of standard output is one JSON
object; the numbers compared, each beside its limit, are the last lines of
standard error. Without a CUDA card, or with fewer than the cell asks for,
it exits 2 and prints no result.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402

from portbench import harness  # noqa: E402


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main(argv=None, require_cuda: bool = True, cell=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    harness.set_env()

    import torch
    torch.set_num_threads(1)
    bench = harness.benchmark()
    entry = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    chips = entry["chips"] if entry else 1
    if require_cuda:
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            n = torch.cuda.device_count() if torch.cuda.is_available() else 0
            log(f"portbench: the cell needs {chips} CUDA card(s), this machine has {n}")
            sys.exit(2)
        device = torch.device("cuda", 0)
    else:
        device = torch.device("cpu")
    if cell is None:
        cell = harness.Cell(args.workload, args.seed, device)
    e2e, layer = harness.cell_metrics(bench, args.workload)

    drv = harness.driver_for(cell)
    log(f"[portbench] process start to the driver's set-up {time.perf_counter() - T_START:.2f} s")
    drv.setup()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    gc.collect()
    setup_s = time.perf_counter() - T_START
    log(f"[portbench] {args.workload} seed {args.seed}: set-up {setup_s:.3f} s")

    trace = detail = None
    if args.trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        from portbench.trace import Trace
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
        spans = getattr(drv, "spans", contextlib.nullcontext)
        with profile(activities=acts) as prof, spans():
            with record_function("portbench.window"):
                stats = harness.window(drv, args.seconds, cell.workload.get("trace_units"))
        t0 = time.perf_counter()
        trace = Trace(prof)
        del prof
        log(f"[portbench] traced {stats['units']} {drv.unit_name}(s) in {stats['seconds']:.3f} s;"
            f" trace read in {time.perf_counter() - t0:.1f} s; launch found for {trace.launched}"
            f" of {len(trace.dev)} device operations; {len(trace.solve_spans)} solve spans")
        detail = drv.detail()
    else:
        stats = harness.window(drv, args.seconds)
    stats["setup_s"] = setup_s
    log(f"[portbench] window: {stats['units']} {drv.unit_name}(s), {stats['work']} units of work"
        f" in {stats['seconds']:.4f} s, {stats['failed']} failed")
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0

    ctx = harness.Context(cell, stats, trace, detail, drv)
    metrics = {}
    for m in (layer if args.trace else e2e):
        v = harness.reader(m["name"])(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": harness.value(v), "unit": m["unit"]}

    drv.release()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    readings = drv.check()
    limits = cell.workload["limits"]
    # a unit whose solve failed is not correct, however close its numbers
    cmp = [("failed_units", float(stats["failed"]), 0.0)]
    cmp += [(k, float(readings["program"][k]), float(limits[k])) for k in limits]
    correct = all(v <= lim for _, v, lim in cmp)

    bad = harness.forbidden_modules()
    if bad:
        log(f"portbench: modules of JAX or the JAX package are loaded: {bad}")
        sys.exit(3)

    if device.type == "cuda":
        kind = torch.cuda.get_device_name(device)
    else:
        kind = "cpu"
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu", "kind": kind,
           "count": chips, "memory_peak_bytes": int(peak)}
    out = {"correct": correct, "attempted": stats["units"], "failed": stats["failed"],
           "metrics": metrics, "device": dev}
    if trace is not None:
        dev["busy_s"] = trace.busy_s()
        dev["window_s"] = trace.window_s
        out["breakdown"] = {"device_ops": [[n[:160], s] for n, s in trace.top_ops()],
                            "idle_gaps": [[n[:160], s] for n, s in trace.idle_gaps()]}
    # a reading that is not a number (a diverged run) is not correct, and
    # JSON has no NaN: it is written as null
    out["compared"] = {k: {"value": v if math.isfinite(v) else None, "limit": lim}
                       for k, v, lim in cmp}
    for k, v, lim in cmp:
        log(f"[compared] {k} {v!r} limit {lim!r}")
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
