"""Cells at test size on the CPU: the real cells' names, traffic and limits
with tiny widths and rows."""
import json
import os

import torch

from portbench import harness

HERE = os.path.dirname(os.path.abspath(__file__))
CONV = {"source": "test", "family": "conv_tt",
        "model": {"N": 3, "r": 6, "CB": 4, "patches": 17, "patch_pixels": 17, "logits": 9},
        "training": {"loss": "xe", "method": "ridge_cholesky", "eps": 5.0, "eps_decay": 0.25,
                     "chunk": 128},
        "data": {"side": 16, "kernel": 4, "classes": 10, "noise": 1.5}}


def cell(name: str, seed: int = 7, **over) -> harness.Cell:
    wl = harness.load_json("workloads", name)
    wl.update(rows=1024, trace_units=2)
    if "batch" in wl:
        wl.update(batch=128, pool=4, detail_seconds=0.3)
    wl.update(over)
    return harness.Cell(name, seed, torch.device("cpu"), config=json.loads(json.dumps(CONV)),
                        workload=wl)


def run(c: harness.Cell, trace: int = 0, seconds: float = 0.3) -> dict:
    from portbench import run as prun
    return prun.main(["--workload", c.name, "--seed", str(c.seed), "--seconds", str(seconds),
                      "--trace", str(trace)], require_cuda=False, cell=c)
