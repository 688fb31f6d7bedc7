"""What every cell shares: its files, found by name, its metrics, and the
window.

A cell is `workloads/<cell>.json`, which names its configuration
(`configs/<config>.json`) and its entry (`drivers/<entry>.py`). The cell's
metrics are those of `BENCHMARK.json` that list it (or, without a
`workloads` key, every cell that reports the metric a per-layer metric
moves), each read by `metrics/<metric>.py`. A driver is a class `Driver(cell)`
with `setup()`, `unit()` -> (work, ok), `detail()` -> what the per-layer
readers take beyond the trace, `release()` (frees the program's state) and
`check(variants)` -> {variant: {number: reading}}, "program" the one the
cell's limits hold; optionally `spans()`, a context in which the traced
window runs (the benchmark's own spans around parts of the program).
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path
from typing import List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "tensornetworksfork_tpu")


class Cell:
    def __init__(self, name: str, seed: int, device, config: Optional[dict] = None,
                 workload: Optional[dict] = None):
        self.name = name
        self.seed = int(seed)
        self.device = device
        self.workload = workload if workload is not None else load_json("workloads", name)
        cname = self.workload["config"]
        self.config = config if config is not None else load_json("configs", cname)


def load_json(kind: str, name: str) -> dict:
    with open(HERE / kind / f"{name}.json") as f:
        return json.load(f)


def benchmark() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def cell_metrics(bench: dict, cell: str):
    """(end-to-end metrics, per-layer metrics) of the cell."""
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or cell in m["workloads"]]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (cell in m["workloads"] if "workloads" in m else m["moves"] in names)]
    return e2e, layer


def driver_for(cell: Cell):
    mod = importlib.import_module(f"portbench.drivers.{cell.workload['entry']}")
    return mod.Driver(cell)


def reader(metric: str):
    """`read(ctx)` of `metrics/<metric>.py` (a metric's name may hold dots)."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"portbench.metrics.{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def set_env() -> None:
    """Before torch is imported: build and kernel caches at fixed paths
    inside the checkout, one host thread for torch's own CPU work (the
    host's part of a run is dispatch, and idle worker threads only add
    jitter), and no JAX behind a library."""
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    base = ROOT / "build" / "portbench" / "cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = str(base / sub)
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")


def window(drv, seconds: float, limit_units: Optional[int] = None) -> dict:
    """Whole units back to back until `seconds` have passed (the unit
    running at the deadline finishes and counts), or `limit_units`."""
    t0 = time.perf_counter()
    deadline = t0 + seconds
    units = work = failed = 0
    while True:
        w, ok = drv.unit()
        units += 1
        work += w
        failed += 0 if ok else 1
        now = time.perf_counter()
        if now >= deadline or (limit_units is not None and units >= limit_units):
            break
    return {"units": units, "work": work, "failed": failed, "seconds": now - t0}


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


class Context:
    """What a metric reader reads."""

    def __init__(self, cell: Cell, stats: dict, trace=None, detail=None, drv=None):
        self.cell = cell
        self.stats = stats
        self.trace = trace
        self.detail = detail or {}
        self.drv = drv


def value(x: float) -> float:
    if x is None or not math.isfinite(x):
        raise ValueError(f"metric value {x!r}")
    return float(x)
