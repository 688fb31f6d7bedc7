"""Image kernel-config sweep with per-run timeouts (port of
tensornetworksfork_tpu/experiments/image_sweep.py).

The reference's `train_image_sweep.py`: per-dataset kernel/stride grids with
a per-run wall-clock cap. In-process, the sweep's own `timeout` bounds the
training (checked between node updates); `subprocess_mode` runs each config
as `python -m tensornetworksfork_tpu_torch.experiments.train_image` under a
hard timeout. Both take their configuration from the environment
(train_image.get_config_from_env), DEVICE included.
"""
from __future__ import annotations

import itertools
import os
import subprocess
import sys
from pathlib import Path
from typing import Dict, List, Optional, Sequence

from ..utils.metrics import append_results_csv

# per-dataset kernel/stride grids (reference train_image_sweep.py:13-95)
KERNEL_GRIDS = {
    "MNIST": [(4, 4), (7, 7), (4, 2), (14, 14)],
    "FashionMNIST": [(4, 4), (7, 7), (4, 2)],
    "CIFAR10": [(4, 4), (8, 8), (4, 2)],
    "CIFAR100": [(4, 4), (8, 8)],
}


def run_config(env_overrides: Dict[str, str], timeout: Optional[float] = None,
               subprocess_mode: bool = False) -> Optional[dict]:
    """One training run, optionally in a subprocess with a hard timeout."""
    if subprocess_mode:
        env = dict(os.environ, **{k: str(v) for k, v in env_overrides.items()})
        # the child imports this package from where this process found it
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (str(Path(__file__).resolve().parents[2]), env.get("PYTHONPATH")) if p)
        try:
            subprocess.run(
                [sys.executable, "-m", "tensornetworksfork_tpu_torch.experiments.train_image"],
                env=env, timeout=timeout, check=True)
            return {"completed": True, **env_overrides}
        except subprocess.TimeoutExpired:
            return {"completed": False, "timeout": True, **env_overrides}
        except subprocess.CalledProcessError:
            return {"completed": False, "error": True, **env_overrides}
    # in-process: push the overrides through the env-config reader
    old = {k: os.environ.get(k) for k in env_overrides}
    os.environ.update({k: str(v) for k, v in env_overrides.items()})
    try:
        from . import train_image
        return train_image.train_model(train_image.get_config_from_env())
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def sweep(dataset: str = "MNIST", Ns: Sequence[int] = (2, 3, 4),
          rs: Sequence[int] = (8, 12, 18), CBs: Sequence[int] = (4, 8),
          kernels: Optional[Sequence] = None, timeout: Optional[float] = 3600,
          results_file: Optional[str] = None,
          subprocess_mode: bool = False) -> List[dict]:
    kernels = kernels or KERNEL_GRIDS.get(dataset, [(4, 4)])
    results_file = results_file or f"build/{dataset}_image_sweep.csv"
    rows = []
    for (k, s), N, r, CB in itertools.product(kernels, Ns, rs, CBs):
        overrides = {"DATASET": dataset, "KERNEL_SIZE": k, "KERNEL_STRIDE": s,
                     "N": N, "R": r, "CB": CB, "VERBOSE": 0}
        res = run_config(overrides, timeout=timeout, subprocess_mode=subprocess_mode)
        if res is not None:
            append_results_csv(res, results_file)
            rows.append(res)
    return rows


if __name__ == "__main__":
    sweep(sys.argv[1] if len(sys.argv) > 1 else "MNIST")
