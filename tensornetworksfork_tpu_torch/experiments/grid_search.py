"""Grid search and seed-replicated ablations (port of
tensornetworksfork_tpu/experiments/grid_search.py).

The reference's `train_grid_search*.py` protocol: fixed seed lists, a
validation grid over N x r through `train_tabular.run`, then the best point
re-run over the test seeds, each test row appended to
`build/{dataset}_ablation_results_{model_type}.csv`. Runs on cfg.device (the
card unless `--device cpu`).

Run:  python -m tensornetworksfork_tpu_torch.experiments.grid_search --model_type tt
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Sequence

import numpy as np

from ..utils.config import RunConfig
from ..utils.metrics import append_results_csv
from . import train_tabular

# reference fixed seed lists (train_grid_search.py:11-13)
VAL_SEEDS = [42, 43, 44]
TEST_SEEDS = [52, 53, 54, 55, 56, 57, 58, 59, 60, 61]


def grid_search(cfg: RunConfig, grid: Dict[str, Sequence],
                val_seeds: Sequence[int] = VAL_SEEDS,
                test_seeds: Sequence[int] = TEST_SEEDS,
                metric: str = "val_rmse", minimize: bool = True) -> dict:
    """Evaluate every grid point over val_seeds; re-run the best over
    test_seeds; append every test row to the ablation CSV."""
    keys = list(grid.keys())
    best = None
    history: List[dict] = []
    for values in itertools.product(*(grid[k] for k in keys)):
        overrides = dict(zip(keys, values))
        scores = []
        for seed in val_seeds:
            r = train_tabular.run(cfg, {**overrides, "seed": seed})
            if r.get("singular") or metric not in r:
                continue
            scores.append(r[metric])
            history.append(r)
        if not scores:
            continue
        mean = float(np.mean(scores))
        if best is None or (mean < best[0]) == minimize:
            best = (mean, overrides)
    if best is None:
        raise RuntimeError("every grid point failed")

    out_file = f"build/{cfg.dataset}_ablation_results_{cfg.model_type}.csv"
    rows = []
    for seed in test_seeds:
        r = train_tabular.run(cfg, {**best[1], "seed": seed})
        r["phase"] = "test"
        append_results_csv(r, out_file)
        rows.append(r)
    return {"best_overrides": best[1], f"{metric}_val_mean": best[0],
            "test_rows": rows, "history": history}


# the reference's 8 ablation drivers (train_grid_search_ablation_*.py) as
# named configurations
ABLATIONS = {
    "tt": {"model_type": "tt"},
    "tt_type1": {"model_type": "tt_type1"},
    "cpd": {"model_type": "cpd"},
    "cpd_type1": {"model_type": "cpd_type1"},
    "tt_cumsum": {"model_type": "tt", "cum_sum": True},
    "tt_cumsum_type1": {"model_type": "tt_type1", "cum_sum": True},
    "tt_lin": {"model_type": "tt", "linear_dim": 4},
    "tt_lin_type1": {"model_type": "tt_type1", "linear_dim": 4},
}


def run_ablation(cfg: RunConfig, name: str, **grid) -> dict:
    """Run one of the reference's named ablations."""
    c = cfg.merge(ABLATIONS[name])
    return ablation(c, c.model_type, **grid)


def ablation(cfg: RunConfig, model_type: str, **grid_overrides) -> dict:
    """One reference-style ablation: fixes the model family, sweeps N x r
    (train_grid_search_ablation_tt.py:40-130)."""
    cfg = dataclasses.replace(cfg, model_type=model_type)
    grid = {"N": grid_overrides.get("N", [2, 3, 4]),
            "r": grid_overrides.get("r", [2, 4, 8])}
    return grid_search(cfg, grid)


def main(argv=None):
    cfg = RunConfig.from_args(argv)
    out = ablation(cfg, cfg.model_type)
    print({k: v for k, v in out.items() if k not in ("history", "test_rows")})


if __name__ == "__main__":
    main()
